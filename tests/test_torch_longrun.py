"""PyTorch port: the reference's long integrations
(``gcmiipy_tpu_torch/longrun_flagship.py``) against the JAX package's
``scripts/longrun_flagship.py`` at float64 on the CPU.

Each of the five cases over 64 steps on 'xla' and on 'mega4' (K6's plain
version on the CPU): the energy and kinetic-energy traces and p's range
within 1e-10 of the JAX trace's scale (tests/test_parity.py's run bound),
the guard's flag and first bad step equal.  The bare grey physics run to
6,400 steps trips the guard at JAX's step (6308).  ``main()`` writes JAX's
keys and keeps its exit-code rule; the committed JAX yardstick that
``chip_smoke.py`` reads (``artifacts/longrun_energy.json``) still matches a
fresh JAX run over its first 64 trace points; and K6's CUDA source, run
through the host emulation, matches its plain version at the long runs'
grids (8x8x3, and 24x36x9 over the Hansen terrain).
"""

import json
import os

import pytest
import torch

from gcmiipy_tpu_torch import longrun_flagship as lr
from scripts import longrun_flagship as jlr

torch.set_num_threads(1)
RUN = 1e-10
STEPS = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "longrun_energy.json")
# the keys of a record of the JAX script, as its artifact holds them
JAX_KEYS = ("physics", "convection", "drag_tau", "seasonal", "terrain",
            "grid", "dt", "steps", "ok", "blown_step", "p_finite",
            "p_range_pa", "energy_first", "energy_last",
            "energy_max_rel_drift", "walltime_s", "energy_trace", "ke_trace",
            "healthy")

_jax_runs = {}


def _case_kwargs(name, steps):
    kw = lr.case_args(*lr.CASES[lr.CASE_NAMES.index(name)], steps)
    kw["steps"] = steps
    return kw


def _jax_run(name, steps):
    """JAX's record of a case over ``steps`` steps, run once a module."""
    if (name, steps) not in _jax_runs:
        _jax_runs[name, steps] = jlr.run_case(**_case_kwargs(name, steps))
    return _jax_runs[name, steps]


@pytest.mark.parametrize("backend", ["xla", "mega4"])
@pytest.mark.parametrize("name", lr.CASE_NAMES)
def test_case_matches_jax(name, backend):
    ref = _jax_run(name, STEPS)
    rec = lr.run_case(backend=backend, device="cpu",
                      **_case_kwargs(name, STEPS))
    assert (rec["backend"], rec["device"]) == (backend, "cpu")
    assert (rec["ok"], rec["blown_step"]) == (ref["ok"], ref["blown_step"])
    assert rec["p_finite"] and ref["p_finite"]
    assert len(rec["energy_trace"]) == STEPS // lr.TRACE_EVERY
    for key in ("energy_trace", "ke_trace", "p_range_pa"):
        assert lr.trace_rel(rec[key], ref[key]) < RUN, key
    # a drift of E/E0 from 1: the traces' relative bound, absolute here
    assert abs(rec["energy_max_rel_drift"] - ref["energy_max_rel_drift"]) \
        < RUN


def test_bare_physics_trips_at_jax_step():
    """The bare grey physics heats the reference's 360 K start until the
    surface pressure passes the guard: at step 6308 in JAX, and at the
    same step in the port ('xla', the plain core), whose energy trace
    stays within 1e-10 of JAX's up to step 6000."""
    steps = 6400
    ref = _jax_run("bare_physics", steps)
    rec = lr.run_case(backend="xla", device="cpu",
                      **_case_kwargs("bare_physics", steps))
    assert ref["blown_step"] == 6308 and not ref["ok"]
    assert (rec["ok"], rec["blown_step"]) == (False, ref["blown_step"])
    assert rec["p_finite"]
    n = 6000 // lr.TRACE_EVERY + 1
    assert lr.trace_rel(rec["energy_trace"][:n], ref["energy_trace"][:n]) < RUN


def test_main_writes_jax_keys_and_exit_code(tmp_path, monkeypatch, capsys):
    """``main()`` over the five cases (the seasonal case's year cut to the
    run's steps): JAX's keys in every record, 0 when every case is healthy
    under JAX's rules, 1 when one is not (an energy-drift bound below the
    dynamics' drift)."""
    monkeypatch.setattr(lr, "SEASONAL_STEPS", 32)
    out = tmp_path / "longrun.json"
    args = ["--device", "cpu", "--steps", "32", "--flagship-steps", "0",
            "--out", str(out)]
    assert lr.main(args) == 0
    doc = json.load(open(out))
    with open(ARTIFACT) as fh:
        jax_doc = json.load(fh)
    assert set(jax_doc) <= set(doc) and doc["card"] is None
    assert set(jax_doc["results"][0]) == set(JAX_KEYS)
    names = [rec["case"] for rec in doc["results"]]
    assert names == list(lr.CASE_NAMES)
    for rec, jrec in zip(doc["results"], jax_doc["results"]):
        assert set(JAX_KEYS) <= set(rec)
        assert (rec["grid"], rec["dt"]) == (jrec["grid"], jrec["dt"])
        assert [rec[k] for k in JAX_KEYS[:5]] == [jrec[k] for k in
                                                  JAX_KEYS[:5]]
        assert rec["healthy"] and rec["steps"] == 32
        assert (rec["backend"], rec["device"]) == ("mega4", "cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and all("energy_trace" not in ln for ln in lines)

    assert lr.main(args + ["--energy-drift-bound", "1e-12"]) == 1
    doc = json.load(open(out))
    assert [rec["healthy"] for rec in doc["results"]] == [
        False, True, True, True, True]


def test_health_rules_are_jax_s():
    """Each branch of JAX's rule: bare physics and terrain pass a trip
    after their minimum horizon and fail one before it; the stabilised,
    seasonal and flagship runs must stay guard-clean."""
    base = dict(physics=True, convection=False, seasonal=False,
                terrain=False, dt=1800.0, ok=False, p_finite=True,
                energy_max_rel_drift=0.3)
    assert lr.healthy(dict(base, blown_step=6308))
    assert not lr.healthy(dict(base, blown_step=4999))
    terr = dict(base, convection=True, terrain=True, dt=225.0)
    assert lr.healthy(dict(terr, blown_step=3028))
    assert not lr.healthy(dict(terr, blown_step=int(7 * 86400 / 225) - 1))
    for extra in (dict(convection=True), dict(convection=True, seasonal=True),
                  dict(flagship=True)):
        assert not lr.healthy(dict(base, blown_step=9000, **extra))
        assert lr.healthy(dict(base, ok=True, blown_step=-1, **extra))
    dyn = dict(base, physics=False, ok=True, blown_step=-1,
               energy_max_rel_drift=4.5e-7)
    assert lr.healthy(dyn) and not lr.healthy(dyn, energy_drift_bound=1e-7)
    assert not lr.healthy(dict(dyn, p_finite=False))


@pytest.mark.parametrize("name", lr.CASE_NAMES)
def test_jax_artifact_matches_fresh_jax(name):
    """The first 64 trace points (1024 steps) of the committed JAX
    artifact, the yardstick of chip_smoke.py's phase longrun, equal a
    fresh JAX run at float64 within 1e-12 of the trace's scale."""
    with open(ARTIFACT) as fh:
        art = json.load(fh)["results"][lr.CASE_NAMES.index(name)]
    case = lr.CASES[lr.CASE_NAMES.index(name)]
    assert (art["physics"], art["convection"], art["drag_tau"],
            art["seasonal"], art["terrain"]) == case
    n = 64
    ref = _jax_run(name, n * lr.TRACE_EVERY)
    for key in ("energy_trace", "ke_trace"):
        assert lr.trace_rel(art[key][:n], ref[key]) < 1e-12, key


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host emulation")
    return str(tmp_path_factory.mktemp("host_emulation"))


@pytest.mark.parametrize("terrain", [False, True])
def test_k6_source_at_longrun_grids(build_dir, terrain):
    """K6's CUDA source through the host emulation at 3x8x8 (narrower than
    one 8x32 tile, one tile row, the general FFT at a 5-wavenumber row)
    and 9x24x36 over the Hansen terrain, float64, against its plain
    version with the kernel's FFT plan and with the banded DFT: within
    1e-11 of each field's scale (tests/test_torch_host_emulation.py)."""
    from gcmiipy_tpu_torch.grid import geometry, topography
    from gcmiipy_tpu_torch.model.state import random_prognostics
    from gcmiipy_tpu_torch.ops import mega_step as ms
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter_ref
    from torch_host_emulation import kernels_on_cpu
    kw = _case_kwargs("terrain" if terrain else "dynamics", 1)
    H, W, L = kw["grid"]
    hm = (topography.resample_map(topography.TOPOGRAPHY_M, H, W)
          if terrain else None)
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=torch.float64,
                                 device="cpu")
    state = random_prognostics(geom, 55)
    step = ms.MegaStep(geom, kw["dt"], coriolis=True)
    before = ms.mega_step.launches
    with kernels_on_cpu(build_dir):
        out = step(*state)
    assert ms.mega_step.launches == before + 1
    fc = step.consts
    for filter_ref in (lambda X: fft_filter_ref(X, fc), None):
        ref = ms.mega_step_ref(*state, kw["dt"], geom, fc, coriolis=True,
                               filter_ref=filter_ref)
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(out, ref))
        assert err <= 1e-11
    assert bool((out[2][:, -1] == 0).all())


def test_flagship_record_at_a_small_grid(monkeypatch):
    """``run_flagship``'s two legs and its float64 day at a small grid on
    'stream' (K7's plain version with its physics epilogue, 20 steps a
    call) on the CPU: guard-clean, one trace entry a call, and the float32
    run within float32's reach of the float64 run at the day's end."""
    monkeypatch.setattr(lr, "FLAGSHIP", dict(height=16, width=128, layers=3,
                                             dt=300.0))
    rec = lr.run_flagship(steps=80, device="cpu", check_steps=40)
    assert rec["ok"] and rec["p_finite"] and rec["blown_step"] == -1
    assert rec["trace_every"] == 20 and len(rec["energy_trace"]) == 4
    assert len(rec["p_mean_pa"]) == 3
    day = rec["float64_day"]
    assert day["ok"] and len(day["energy_trace"]) == 2
    assert day["energy_max_rel_diff"] < 1e-5
    assert day["p_mean_rel_diff"] < 1e-5
    assert rec["p_mean_rel_drift"] == pytest.approx(
        rec["p_mean_pa"][-1] / rec["p_mean_pa"][0] - 1.0, rel=1e-9)
    assert lr.healthy(rec)


def test_compare_holds_a_run_to_the_jax_artifact():
    """``compare`` of the JAX artifact with itself: no difference, JAX's
    trips, and each blow-up case's span cut TRIP_MARGIN steps before its
    trip (6308 and 3028)."""
    with open(ARTIFACT) as fh:
        art = json.load(fh)
    rows = lr.compare(art, art)
    assert [row["case"] for row in rows] == list(lr.CASE_NAMES)
    for row, rec in zip(rows, art["results"]):
        assert row["blown_step"] == [rec["blown_step"]] * 2
        assert row["energy_trace_rel"] == row["ke_trace_rel"] == 0.0
        assert row["trace_points"] == len(rec["energy_trace"])
    pre = {row["case"]: row["pre_trip_points"] for row in rows}
    assert pre["bare_physics"] == (6308 - lr.TRIP_MARGIN) // 16 + 1
    assert pre["terrain"] == (3028 - lr.TRIP_MARGIN) // 16 + 1
    assert pre["dynamics"] == 900


def test_committed_card_run_is_healthy_beside_jax():
    """The committed card run of the module
    (``artifacts/longrun_energy_torch.json``): the card's name and power
    limit, JAX's keys, every case healthy under JAX's rules at JAX's
    horizons, the trips at JAX's steps."""
    with open(os.path.join(REPO, "artifacts",
                           "longrun_energy_torch.json")) as fh:
        doc = json.load(fh)
    with open(ARTIFACT) as fh:
        art = json.load(fh)
    assert "W" in doc["card"]
    names = [rec["case"] for rec in doc["results"]]
    assert names == list(lr.CASE_NAMES) + ["flagship"]
    for rec, ref in zip(doc["results"], art["results"]):
        assert set(JAX_KEYS) <= set(rec) and rec["device"] == "cuda"
        assert rec["healthy"] and lr.healthy(rec)
        assert (rec["steps"], rec["blown_step"]) == (ref["steps"],
                                                     ref["blown_step"])
    flagship = doc["results"][-1]
    assert flagship["healthy"] and flagship["steps"] == 14400
    assert flagship["float64_day"]["steps"] == 2880
