"""The reference's long integrations, on the port.

    python -m gcmiipy_tpu_torch.longrun_flagship [--steps 14400]
        [--dtype float64] [--device cuda] [--backend mega4]
        [--energy-drift-bound 0.05] [--physics-min-steps 5000]
        [--flagship-steps 14400] [--out artifacts/longrun_energy_torch.json]
    python -m gcmiipy_tpu_torch.longrun_flagship --compare RUN.json REF.json

Port of ``scripts/longrun_flagship.py``.  The reference's ``main()`` runs
8x8x3 at dt = 1800 s for 14,400 steps (``no_limits_2_5d.py:263``).  This
runs that configuration with the blow-up guard on, in the five cases of
:data:`CASES`: the dynamics alone; the bare grey physics; the physics
stabilised by convection and a two-day surface drag; the seasonal year of
17,520 steps with a one-day drag; and the Hansen terrain at 24x36x9 with
dt = 225 s, the sea-level Shapiro filter every 4 steps.  Each case runs
through ``driver.make_run_fn`` on ``--backend`` ('mega4': K6,
``csrc/mega_step.cu``, a step, the physics, the drag and the Shapiro filter
in plain PyTorch at their cadence; 'xla': the plain core).  Then the
flagship case, :func:`run_flagship`: the 9x512x1024 grid at dt = 30 s with
the per-step grey physics, convection and a one-day drag on 'stream' (K7,
``csrc/stream_steps.cu``, with its physics epilogue), in float32 for
``--flagship-steps`` steps and in float64 over its first model day
(``--flagship-steps 0`` leaves it out).

Each case prints one JSON line (its record without the traces), and the
JSON file at ``--out`` holds the records with their traces and the card's
name and power limit.  The health rules are those of the JAX script: the
dynamics guard-clean with the energy within ``--energy-drift-bound``; the
bare physics finite and guard-clean for ``--physics-min-steps`` (it trips
near step 6308); the stabilised and seasonal cases guard-clean; the
terrain case finite and guard-clean for 7 model days (it trips near step
3028); the flagship guard-clean.  The exit code is 0 when every case is
healthy.  ``--device cpu`` runs the kernels' plain versions on the CPU.

``--compare RUN.json REF.json`` runs nothing: it holds the five cases of
one such file against another's (the JAX script's
``artifacts/longrun_energy.json``, say) and prints one JSON line a case
(:func:`compare`).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from gcmiipy_tpu_torch.device import resolve_device, torch_dtype
from gcmiipy_tpu_torch.grid import geometry, topography
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig

# (physics, convection, drag_tau, seasonal, terrain), the JAX script's order
CASES = (
    (False, False, 0.0, False, False),
    (True, False, 0.0, False, False),
    (True, True, 2 * 86400.0, False, False),
    (True, True, 86400.0, True, False),
    (True, True, 86400.0, False, True),
)
CASE_NAMES = ("dynamics", "bare_physics", "stabilized", "seasonal", "terrain")
# one model year of the seasonal case at dt = 1800 s
SEASONAL_STEPS = 17520
TRACE_EVERY = 16
# the flagship case: chip_smoke.py's MAIN grid and its per-step PHYSICS
FLAGSHIP = dict(height=512, width=1024, layers=9, dt=30.0)
FLAGSHIP_PHYSICS = dict(physics=True, physics_every=1, convection=True,
                        drag_tau=86400.0)
MODEL_DAY = 86400


def case_args(physics, convection, drag_tau, seasonal, terrain, steps):
    """``run_case``'s keywords for one case of :data:`CASES` at the JAX
    script's grid, dt and horizon (a full year for the seasonal case)."""
    return dict(physics=physics, convection=convection, drag_tau=drag_tau,
                seasonal=seasonal, terrain=terrain,
                steps=max(steps, SEASONAL_STEPS) if seasonal else steps,
                grid=(24, 36, 9) if terrain else (8, 8, 3),
                # steep polar terrain at 8x10 degrees needs dt <= 225 s
                dt=225.0 if terrain else 1800.0)


def case_geometry(grid, terrain=False, dtype="float64", device="cuda"):
    """The JAX script's geometry of one case: Manabe sigma, over the Hansen
    terrain and land cover resampled to the grid when ``terrain``."""
    H, W, L = grid
    hm = topography.resample_map(topography.TOPOGRAPHY_M, H, W) \
        if terrain else None
    lf = topography.resample_map(topography.LAND_COVER, H, W) \
        if terrain else None
    return geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, land_fraction=lf,
                                 dtype=torch_dtype(dtype), device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _record(state, stats, info, wall, every):
    """The JAX script's record of one run, read back once: the guard, p's
    range, the energy and its traces every ``every`` entries of the
    stats."""
    p = state.prog.p.double().cpu().numpy()
    te = stats.total_energy.double().cpu().numpy()
    return {
        "ok": bool(info.ok),
        "blown_step": int(info.blown_step),
        "p_finite": bool(np.isfinite(p).all()),
        "p_range_pa": [float(p.min()), float(p.max())],
        "energy_first": float(te[0]),
        "energy_last": float(te[-1]),
        "energy_max_rel_drift": float(np.max(np.abs(te / te[0] - 1.0))),
        "walltime_s": wall,
        "energy_trace": [float(x) for x in te[::every]],
        "ke_trace": [float(x) for x in
                     stats.ke.double().cpu().numpy()[::every]],
    }


def run_case(physics, steps, dtype="float64", convection=False, drag_tau=0.0,
             seasonal=False, terrain=False, grid=(8, 8, 3), dt=1800.0,
             backend="mega4", device="cuda"):
    """One long run of the reference's configuration (JAX
    ``scripts/longrun_flagship.run_case``): the JAX script's
    ``ModelConfig`` with the guard on, the initial pressure balanced
    against the start's own 360 K isothermal atmosphere and, over the
    Hansen terrain, the Shapiro filter every 4 steps; ``steps`` steps of
    ``make_run_fn`` from the reference's start.  Returns the JAX script's
    record (``ok``, ``blown_step``, the 0-based index of the first bad
    step or -1, p's range, the energies, the wall seconds, ``energy_trace``
    and ``ke_trace`` every 16th step) with ``backend`` and ``device``."""
    device = resolve_device(device)
    H, W, L = grid
    config = driver.normalize_config(ModelConfig(
        height=H, width=W, layers=L, dt=dt, dtype=dtype, backend=backend,
        physics=physics, guard=True, convection=convection,
        drag_tau=drag_tau, seasonal=seasonal,
        topography="hansen" if terrain else "flat",
        land_cover="hansen" if terrain else "none",
        shapiro_every=4 if terrain else 0, sea_level_temp=360.0))
    geom = case_geometry(grid, terrain, dtype, device)
    state = driver.gen_model_state(geom, config)
    run = driver.make_run_fn(geom, config, steps)
    _sync(device)
    t0 = time.perf_counter()
    out_state, stats, info = run(state)
    _sync(device)
    wall = time.perf_counter() - t0
    rec = {"physics": physics, "convection": convection,
           "drag_tau": drag_tau, "seasonal": seasonal, "terrain": terrain,
           "grid": list(grid), "dt": dt, "steps": steps}
    rec.update(_record(out_state, stats, info, wall, TRACE_EVERY))
    rec.update(backend=backend, device=str(device))
    return rec


def global_mean_p(p, geom):
    """The area-weighted global mean of the surface pressure, float64."""
    area = geom.area.double()
    return float((p.double() * area).sum() / (area.sum() * p.shape[-1]))


def run_flagship(steps=14400, dtype="float32", backend="stream",
                 device="cuda", check_steps=2880):
    """The flagship long run: 9x512x1024, dt = 30 s, Manabe sigma, the
    per-step grey physics with convection and a one-day drag, guard on,
    from the reference's quiescent start, ``steps`` steps on ``backend``
    ('stream': K7 with its physics epilogue, 20 steps a call), run as a
    first leg of ``check_steps`` (one model day) and the rest.  The same
    configuration then runs in float64 over ``check_steps``, and the
    record holds the float32 run against it at that step: the energy
    trace and the global-mean surface pressure.  The stats of 'stream'
    are one entry a call: the traces hold every entry, ``trace_every``
    steps apart, and ``blown_step`` names the first step of the call that
    went bad."""
    device = resolve_device(device)
    check_steps = min(check_steps, steps)

    def leg_runs(dtype_name, n_steps):
        config = driver.normalize_config(ModelConfig(
            height=FLAGSHIP["height"], width=FLAGSHIP["width"],
            layers=FLAGSHIP["layers"], dt=FLAGSHIP["dt"], dtype=dtype_name,
            backend=backend, guard=True, **FLAGSHIP_PHYSICS))
        geom = driver.gen_model_geometry(config, device)
        state = driver.gen_model_state(geom, config)
        legs = [n for n in (check_steps, n_steps - check_steps) if n > 0]
        stats_all, means = [], [global_mean_p(state.prog.p, geom)]
        _sync(device)
        t0 = time.perf_counter()
        info = None
        for n in legs:
            if info is not None and not bool(info.ok):
                break  # the first leg blew up: its frozen state is the end
            run = driver.make_run_fn(geom, config, n)
            state, stats, gi = run(state)
            stats_all.append(stats)
            if info is None:
                info = gi
            else:  # the second leg's first bad step, counted from the start
                blown = torch.where(
                    info.ok & (gi.blown_step >= 0),
                    gi.blown_step + check_steps, info.blown_step)
                info = driver.GuardInfo(info.ok & gi.ok, blown)
            means.append(global_mean_p(state.prog.p, geom))
        _sync(device)
        wall = time.perf_counter() - t0
        stats = driver.StepStats(*(torch.cat(col)
                                   for col in zip(*stats_all)))
        every = getattr(run, "chunk_steps", 1)
        rec = _record(state, stats, info, wall, 1)
        rec.update(trace_every=every, p_mean_pa=means,
                   p_mean_rel_drift=(means[-1] - means[0]) / means[0])
        return rec

    rec = {"flagship": True, "grid": [FLAGSHIP["height"], FLAGSHIP["width"],
                                      FLAGSHIP["layers"]],
           "dt": FLAGSHIP["dt"], "steps": steps, "dtype": dtype,
           **FLAGSHIP_PHYSICS}
    rec.update(leg_runs(dtype, steps))
    ref = leg_runs("float64", check_steps)
    n = len(ref["energy_trace"])
    e32 = np.asarray(rec["energy_trace"][:n])
    e64 = np.asarray(ref["energy_trace"])
    rec["float64_day"] = {
        "steps": check_steps, "ok": ref["ok"], "blown_step":
        ref["blown_step"], "walltime_s": ref["walltime_s"],
        "energy_trace": ref["energy_trace"], "ke_trace": ref["ke_trace"],
        "p_mean_pa": ref["p_mean_pa"],
        "energy_max_rel_diff": float(np.max(np.abs(e32 / e64 - 1.0))),
        "p_mean_rel_diff": abs(rec["p_mean_pa"][1] / ref["p_mean_pa"][1]
                               - 1.0),
    }
    rec.update(backend=backend, device=str(device))
    return rec


def healthy(rec, energy_drift_bound=0.05, physics_min_steps=5000):
    """The JAX script's health rule for one record."""
    if rec.get("flagship"):
        return rec["ok"] and rec["p_finite"]
    if rec["terrain"]:
        # survived 7 model days with the guard naming the step
        min_steps = int(7 * MODEL_DAY / rec["dt"])
        return rec["p_finite"] and (rec["ok"]
                                    or rec["blown_step"] >= min_steps)
    if rec["seasonal"]:
        return rec["ok"] and rec["p_finite"]
    if rec["physics"] and not rec["convection"]:
        return rec["p_finite"] and (rec["ok"]
                                    or rec["blown_step"] >= physics_min_steps)
    if rec["physics"]:
        return rec["ok"] and rec["p_finite"]
    return (rec["ok"] and rec["p_finite"]
            and rec["energy_max_rel_drift"] < energy_drift_bound)


# the span of a trace held to a reference that tripped the guard ends this
# many steps before the trip, where the run still changes smoothly
TRIP_MARGIN = 128


def trace_rel(got, ref):
    """The largest difference of two traces (or ranges) of one length, over
    the reference's scale; NaN where ``got`` is not finite."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        raise ValueError(f"traces of {got.shape} and {ref.shape} points")
    if not np.isfinite(got).all():
        return float("nan")
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def compare(run, reference):
    """The five cases of ``run`` (a document this module writes) against
    those of ``reference`` (the JAX script's): one dict a case with both
    guards' outcome, the wall seconds, and the largest differences over
    the trace's scale of the energy and KE traces (the common span, and
    the span up to TRIP_MARGIN steps before the reference's trip), of p's
    range and of the energy drift."""
    out = []
    for name, rec, ref in zip(CASE_NAMES, run["results"],
                              reference["results"]):
        n = min(len(rec["energy_trace"]), len(ref["energy_trace"]))
        pre = n
        if not ref["ok"]:
            pre = min(n, (ref["blown_step"] - TRIP_MARGIN)
                      // TRACE_EVERY + 1)
        row = {"case": name, "steps": [rec["steps"], ref["steps"]],
               "ok": [rec["ok"], ref["ok"]],
               "blown_step": [rec["blown_step"], ref["blown_step"]],
               "walltime_s": [rec["walltime_s"], ref["walltime_s"]],
               "trace_points": n, "pre_trip_points": pre}
        for key in ("energy_trace", "ke_trace"):
            row[key + "_rel"] = trace_rel(rec[key][:n], ref[key][:n])
            row[key + "_rel_pre_trip"] = trace_rel(rec[key][:pre],
                                                   ref[key][:pre])
        row["p_range_rel"] = trace_rel(rec["p_range_pa"], ref["p_range_pa"])
        row["energy_max_rel_drift"] = [rec["energy_max_rel_drift"],
                                       ref["energy_max_rel_drift"]]
        out.append(row)
    return out


def card_name():
    """The card's name and power limit as nvidia-smi prints them, or None
    without a card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    ap.add_argument("--steps", type=int, default=14400)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="mega4")
    ap.add_argument("--out", default="artifacts/longrun_energy_torch.json")
    ap.add_argument("--energy-drift-bound", type=float, default=0.05)
    ap.add_argument("--physics-min-steps", type=int, default=5000)
    ap.add_argument("--flagship-steps", type=int, default=14400)
    ap.add_argument("--compare", nargs=2, metavar=("RUN", "REF"))
    args = ap.parse_args(argv)
    if args.compare:
        docs = []
        for path in args.compare:
            with open(path) as fh:
                docs.append(json.load(fh))
        for row in compare(*docs):
            print(json.dumps(row), flush=True)
        return 0
    if args.device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    results = []
    failed = False
    for name, case in zip(CASE_NAMES, CASES):
        rec = run_case(dtype=args.dtype, backend=args.backend,
                       device=args.device, **case_args(*case, args.steps))
        results.append(dict(case=name, **rec))
    if args.flagship_steps > 0:
        rec = run_flagship(args.flagship_steps, device=args.device,
                           check_steps=min(2880, args.flagship_steps))
        results.append(dict(case="flagship", **rec))
    for rec in results:
        rec["healthy"] = healthy(rec, args.energy_drift_bound,
                                 args.physics_min_steps)
        failed |= not rec["healthy"]
        print(json.dumps({k: v for k, v in rec.items()
                          if not k.endswith("_trace")
                          and k != "float64_day"}), flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"config": "8x8x3 dt=1800s (no_limits_2_5d.py:263)",
                   "card": card_name() if args.device != "cpu" else None,
                   "torch": torch.__version__, "results": results}, fh)
    print(f"# wrote {args.out}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
