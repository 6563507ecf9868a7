"""The CPU rehearsal of ``chip_smoke.py``'s phase ``longrun``: the port's
long runs at float64 against the JAX package's, here on the CPU, from
which the phase's bounds are set.

    python tests/longrun_rehearsal.py cases [--backend mega4] [NAME ...]
    python tests/longrun_rehearsal.py flagship HEIGHT WIDTH [--steps 2880]

``cases`` runs each named case of ``gcmiipy_tpu_torch.longrun_flagship``
over the phase's horizon (:data:`HORIZONS`) through the port
(``device='cpu'``: the kernels' plain versions) and through JAX's
``scripts/longrun_flagship.run_case``, and prints one JSON line a case:
both guards' outcome and the largest differences of the energy and KE
traces over the trace's scale, over the phase's span and over the whole
run, and JAX's trace against its committed artifact.  ``flagship`` runs
``run_flagship`` on a cut grid (9 layers, dt = 30 s, 'stream') for one
model day in float32 and float64 and prints the float32 run against the
float64 one, and JAX's own float64 run of that configuration's global-mean
surface pressure.  The flagship's full grid is not for this CPU.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from gcmiipy_tpu_torch import longrun_flagship as lr  # noqa: E402
from scripts import longrun_flagship as jlr  # noqa: E402

# the phase's horizons: (steps run, the span held to JAX's trace)
HORIZONS = {"dynamics": (14400, 14400), "bare_physics": (6500, 6000),
            "stabilized": (4000, 4000), "seasonal": (4000, 4000),
            "terrain": (3200, 2900)}


def cases(names, backend):
    with open(os.path.join(REPO, "artifacts", "longrun_energy.json")) as fh:
        art = dict(zip(lr.CASE_NAMES, json.load(fh)["results"]))
    for name in names:
        steps, span = HORIZONS[name]
        kw = lr.case_args(*lr.CASES[lr.CASE_NAMES.index(name)], steps)
        kw["steps"] = steps
        ref = jlr.run_case(**kw)
        t0 = time.perf_counter()
        rec = lr.run_case(backend=backend, device="cpu", **kw)
        n = span // lr.TRACE_EVERY + 1
        m = len(rec["energy_trace"])
        row = {"case": name, "steps": steps, "span": span,
               "ok": [rec["ok"], ref["ok"]],
               "blown_step": [rec["blown_step"], ref["blown_step"],
                              art[name]["blown_step"]],
               "port_s": time.perf_counter() - t0}
        for key in ("energy_trace", "ke_trace"):
            row[key + "_span"] = lr.trace_rel(rec[key][:n], ref[key][:n])
            row[key + "_all"] = lr.trace_rel(rec[key], ref[key])
        row["jax_against_artifact"] = lr.trace_rel(
            ref["energy_trace"], art[name]["energy_trace"][:m])
        print(json.dumps(row), flush=True)


def flagship(height, width, steps):
    from gcmiipy_tpu.grid import geometry as jgeometry
    from gcmiipy_tpu.model import driver as jdriver
    from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
    lr.FLAGSHIP = dict(lr.FLAGSHIP, height=height, width=width)
    rec = lr.run_flagship(steps=steps, device="cpu", check_steps=steps)
    day = rec["float64_day"]
    config = jdriver.normalize_config(JModelConfig(
        height=height, width=width, layers=lr.FLAGSHIP["layers"],
        dt=lr.FLAGSHIP["dt"], dtype="float64", guard=True,
        **lr.FLAGSHIP_PHYSICS))
    geom = jgeometry.gen_geometry(height, width, lr.FLAGSHIP["layers"],
                                  sig_func=jgeometry.manabe_sig)
    geom = geom.astype(np.float64)
    state = jdriver.gen_model_state(geom, config)
    area = np.asarray(geom.area)

    def mean_p(p):
        p = np.asarray(p)
        return float((p * area).sum() / (area.sum() * p.shape[-1]))

    start = mean_p(state.prog.p)  # the run donates the state's buffers
    out, _, info = jdriver.make_run_fn(geom, config, steps)(state)
    jax_means = [start, mean_p(out.prog.p)]
    print(json.dumps({
        "grid": [lr.FLAGSHIP["layers"], height, width], "steps": steps,
        "ok": [rec["ok"], day["ok"], bool(info.ok)],
        "energy_rel_float32_float64": day["energy_max_rel_diff"],
        "p_mean_rel_float32_float64": day["p_mean_rel_diff"],
        "p_mean_drift": [rec["p_mean_rel_drift"],
                         day["p_mean_pa"][-1] / day["p_mean_pa"][0] - 1.0,
                         jax_means[1] / jax_means[0] - 1.0]}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cases")
    c.add_argument("names", nargs="*", default=list(lr.CASE_NAMES))
    c.add_argument("--backend", default="mega4")
    f = sub.add_parser("flagship")
    f.add_argument("height", type=int)
    f.add_argument("width", type=int)
    f.add_argument("--steps", type=int, default=2880)
    args = ap.parse_args()
    torch.set_num_threads(2)
    if args.what == "cases":
        cases(args.names, args.backend)
    else:
        flagship(args.height, args.width, args.steps)


if __name__ == "__main__":
    main()
