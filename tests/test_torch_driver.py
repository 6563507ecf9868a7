"""PyTorch port: ``run_model`` and the driver against the JAX driver, the
port's import boundary, and its refusal to run a CUDA request without a
card.  Parity runs are float64 on the CPU at the 1e-10 bound of
tests/test_parity.py."""

import ast
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig

from torch_port_helpers import FIELDS, assert_close

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "gcmiipy_tpu_torch")


def _both(args, **cfg):
    """(port, JAX) run_model outputs for the same arguments and config."""
    port = driver.run_model(*args, config=ModelConfig(**cfg), device="cpu")
    ref = jdriver.run_model(*args, config=JModelConfig(**cfg))
    return port, ref


def _compare(port, ref, rtol, atol):
    assert_close(port[:5], ref[:5], rtol, atol, FIELDS)
    assert_close(port[5], ref[5], rtol, atol, port[5]._fields)
    assert_close(port[7], ref[7], rtol, atol, port[7]._fields)


@pytest.mark.parametrize("backend,steps", [("fused", 2), ("xla", 10)])
def test_run_model_matches_jax(backend, steps):
    port, ref = _both((16, 128, 3, 300.0, steps), backend=backend,
                      dtype="float64")
    assert port[7].total_energy.shape == (steps,)
    _compare(port, ref, 1e-10, 1e-10)


def test_reference_main_config_matches_jax_float64():
    port, ref = _both((8, 8, 3, 1800.0, 20), dtype="float64")
    _compare(port, ref, 1e-10, 1e-10)


def _scaled_err(a, b):
    """Max error over the reference field's scale (scripts/tpu_parity.py)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_reference_main_config_float32_as_close_as_jax_float32():
    """The default float32 run.  From the quiescent start u and v are small
    and float32 rounding alone moves them by about 1% of their scale (JAX
    float32 against JAX float64), so the port's float32 run is held to the
    float64 truth within four times the JAX float32 run's distance (two
    independent float32 roundings of a noise-driven field)."""
    port = driver.run_model(8, 8, 3, 1800.0, 20, device="cpu")
    ref32 = jdriver.run_model(8, 8, 3, 1800.0, 20)
    ref64 = jdriver.run_model(8, 8, 3, 1800.0, 20,
                              config=JModelConfig(dtype="float64"))
    assert port[0].dtype == torch.float32
    pairs = list(zip(FIELDS, port[:5], ref32[:5], ref64[:5]))
    pairs += list(zip(port[7]._fields, port[7], ref32[7], ref64[7]))
    for name, a, b32, b64 in pairs:
        err, jax_err = _scaled_err(a, b64), _scaled_err(b32, b64)
        assert err <= 4 * jax_err + 1e-6, (name, err, jax_err)


def test_giss_grid_guard_names_step_106():
    cfg = dict(giss_sige=True, dtype="float64", guard=True)
    with pytest.warns(RuntimeWarning, match="at step 106"):
        port = driver.run_model(24, 36, 9, 900.0, 110,
                                config=ModelConfig(**cfg), device="cpu")
    with pytest.warns(RuntimeWarning, match="at step 106"):
        ref = jdriver.run_model(24, 36, 9, 900.0, 110,
                                config=JModelConfig(**cfg))
    # the run is unstable: by step 106 float64 rounding differences have
    # grown to about 1e-9 of each field's scale
    for name, a, b in zip(FIELDS, port[:5], ref[:5]):
        assert _scaled_err(a, b) < 1e-8, name


def test_guard_clean_run_reports_ok():
    geom = geometry.gen_geometry(8, 8, 3, device="cpu")
    config = ModelConfig(guard=True, dtype="float64", dt=1800.0)
    state = driver.gen_model_state(geom, config)
    out_state, stats, info = driver.make_run_fn(geom, config, 5)(state)
    assert bool(info.ok) and int(info.blown_step) == -1
    assert int(out_state.step) == 5 and float(out_state.utc) == 5 * 1800.0


def test_callback_path_matches_loop_path():
    seen = []
    cb = driver.run_model(8, 8, 3, 1800.0, 4, device="cpu",
                          callback=lambda *s: seen.append(s[0].clone()),
                          config=ModelConfig(dtype="float64"))
    loop = driver.run_model(8, 8, 3, 1800.0, 4, device="cpu",
                            config=ModelConfig(dtype="float64"))
    assert len(seen) == 4 and torch.equal(seen[-1], loop[0])
    for a, b in zip(cb[:5] + tuple(cb[7]), loop[:5] + tuple(loop[7])):
        assert torch.equal(a, b)


def test_stats_off_returns_none():
    out = driver.run_model(8, 8, 3, 1800.0, 2, device="cpu",
                           config=ModelConfig(stats=False))
    assert out[7] is None


@pytest.mark.parametrize("field,value", [
    ("backend", "v9"), ("polar_filter", "spectral"),
    ("filter_precision", "fwd_high")])
def test_unported_features_raise(field, value):
    """Every ModelConfig field is ported; check_ported still refuses the
    values the port does not run."""
    with pytest.raises(NotImplementedError, match=field):
        driver.run_model(8, 8, 3, 1800.0, 1, device="cpu",
                         config=ModelConfig(**{field: value}))


def test_stream_wide_native_reaches_the_driver_choice():
    """'stream' with extras on a grid wider than 2048 and taller than 64:
    stream_wide_native=True streams K7 natively with the extras between
    calls (no warning, calls of 2 steps) and equals JAX's run at 1e-10;
    False takes the per-step 'mega4' path with JAX's warning, as the JAX
    driver leaves its streaming kernel there."""
    H, W, L, dt, steps = 72, 2176, 2, 300.0, 4
    cfg = dict(backend="stream", stream_steps=2, drag_tau=86400.0,
               physics_every=2, dtype="float64", stats=False)
    geom = driver.gen_model_geometry(ModelConfig(H, W, L, **cfg), "cpu")
    for native in (False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = driver.make_run_fn(geom, ModelConfig(
                H, W, L, **cfg, stream_wide_native=native), steps)
        per_step = any("per-step 'mega4' path" in str(w.message)
                       for w in caught)
        assert per_step == (not native)
        assert getattr(run, "chunk_steps", None) == (2 if native else None)
    port = driver.run_model(H, W, L, dt, steps, device="cpu",
                            config=ModelConfig(**cfg,
                                               stream_wide_native=True))
    ref = jdriver.run_model(H, W, L, dt, steps, config=JModelConfig(
        **dict(cfg, backend="xla")))
    assert_close(port[:5], ref[:5], 1e-10, 1e-10, FIELDS)


@pytest.mark.parametrize("field,value", [
    ("checkpoint_dir", "ck"), ("checkpoint_every", 5),
    ("metrics_path", "metrics.jsonl")])
def test_run_services_are_ported(field, value, tmp_path, monkeypatch):
    """The run services check_ported refused until they were ported run,
    each alone, and leave the fields equal to JAX's run within 1e-10
    (float64, 4 steps; tests/test_torch_checkpoint.py covers them)."""
    monkeypatch.chdir(tmp_path)
    port, ref = _both((8, 8, 3, 1800.0, 4), dtype="float64",
                      **{field: value})
    _compare(port, ref, 1e-10, 1e-10)


@pytest.mark.parametrize("field,value,extra", [
    ("evaporation", True, dict(physics=True, gw0=0.05)),
    ("stream_pipeline", True, dict(backend="stream")),
    ("shapiro_every", 2, dict(shapiro_fields="pt")),
    ("topography", "hansen", {}),
    ("precipitation", True, dict(physics=True, rh_crit=0.8))])
def test_newly_ported_features_run(field, value, extra):
    """Each feature the port once refused runs through run_model: finite,
    and equal to JAX's run within 1e-10 (float64, 4 steps)."""
    args = ((16, 128, 3, 300.0, 4) if field == "stream_pipeline"
            else (8, 8, 3, 1800.0, 4))
    port, ref = _both(args, dtype="float64", **{field: value}, **extra)
    assert all(torch.isfinite(x).all() for x in port[:5] + tuple(port[5]))
    _compare(port, ref, 1e-10, 1e-10)


def test_bad_dtype_raises():
    with pytest.raises(ValueError):
        driver.run_model(8, 8, 3, 1800.0, 1, device="cpu",
                         config=ModelConfig(dtype="float16"))


def test_config_fields_match_jax():
    import dataclasses
    port = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    assert port.keys() == ref.keys()
    for k in port:
        if k != "sig_func":
            assert port[k] == ref[k], k


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PACKAGE):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_port_sources_import_no_jax():
    """AST scan: no module of the port and not chip_smoke.py names jax,
    the JAX package or its scripts in an import."""
    offenders = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "gcmiipy_tpu",
                                       "scripts"):
                    offenders.append(f"{path}: {n}")
    assert len(_port_sources()) > 15
    assert not offenders, offenders


def test_port_imports_with_jax_blocked():
    """Import every port module and chip_smoke.py with jax and the JAX
    package made unimportable."""
    mods = sorted(
        "gcmiipy_tpu_torch." + os.path.relpath(p, PACKAGE)[:-3]
        .replace(os.sep, ".").replace(".__init__", "")
        for p in _port_sources() if p.startswith(PACKAGE))
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'gcmiipy_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        driver.run_model(8, 8, 3, 1800.0, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        geometry.gen_geometry(8, 8, 3)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
