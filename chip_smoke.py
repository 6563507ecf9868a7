import os, sys; sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # noqa: E401,E702
# Smoke run of the PyTorch port (gcmiipy_tpu_torch) on one NVIDIA GPU.
#
#     python3 chip_smoke.py
#
# Phases, one log line each (with elapsed seconds); any failure exits
# non-zero and prints no result:
#   device   the card's name and power limit (nvidia-smi) and torch's name;
#   build    nvcc builds the kernel source of the path (csrc/fused_parts.cu);
#   kernels  each kernel against its plain PyTorch version on the card;
#   main     run_model(512, 1024, 9, 30.0, 20, backend='fused', guard=True)
#            with the launch counts read around it, held against the same
#            run on the plain core (backend='xla'); then both backends from
#            a perturbed start, compared after 1 and after 20 steps;
#   timing   ms/step of both backends (windows of 20 steps between CUDA
#            events), each kernel's ms beside its bound.
# The line before the last is the kernels JSON, the last the result JSON.
# Imports nothing of JAX: the card's machine needs none.

import json
import statistics
import subprocess
import time
import warnings

import numpy as np
import torch

T0 = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}  # non-tensor-core
# bounds of scripts/tpu_parity.py: fused pipeline vs the plain core
STEP1_REL, RUN_REL, DRIFT_PA = 1e-4, 2e-3, 0.5
# kernel vs its plain version: same operations in the same order (fmad off),
# so only pow/sin ulps and the compiler's choices can differ
KERNEL_REL = {torch.float32: 1e-5, torch.float64: 1e-12}
# The flagship bench grid at its full width.  dt is bench.py's for this grid:
# at 512 latitude rows dt=900 breaks the meridional CFL limit (the polar
# filter acts zonally only), and the guard stops the run at step 1-2, in the
# JAX package as in the port.
MAIN = dict(height=512, width=1024, layers=9, dt=30.0, steps=20)
STEP_WINDOW = 20  # steps per timing window


def log(phase, msg):
    print(f"[{time.perf_counter() - T0:7.2f}s] {phase}: {msg}", flush=True)


def fail(phase, msg):
    log(phase, "FAIL " + msg)
    sys.exit(1)


def rel_err(out, ref):
    """Max per-field error over the field's scale (scripts/tpu_parity.py)."""
    return max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
               for a, b in zip(out, ref))


def abs_err(out, ref):
    return max(float((a - b).abs().max()) for a, b in zip(out, ref))


def random_state(geom, seed, device, dtype):
    """(p, u, v, t, q): the recipe of tests/test_pallas_fused.py:_initial."""
    from gcmiipy_tpu_torch import constants
    rng = np.random.default_rng(seed)
    L, H, W = geom.layers, geom.height, geom.width
    p = 1e5 * (1 + 1e-3 * rng.standard_normal((H, W)))
    u = 0.5 * rng.standard_normal((L, H, W))
    v = 0.5 * rng.standard_normal((L, H, W))
    tp = p[None] * geom.sig.double().cpu().numpy() + float(geom.ptop)
    t = ((300 + 5 * rng.standard_normal((L, H, W)))
         * (constants.P0 / tp) ** constants.kappa)
    q = 1e-5 * (1 + 0.1 * rng.random((L, H, W)))
    return tuple(torch.as_tensor(x).to(device=device, dtype=dtype)
                 for x in (p, u, v, t, q))


def k1_inputs(shape, dtype, hill, device):
    """Geometry and the 11 K1 inputs: base and evaluated states from two
    seeds, spu the filtered zonal mass flux of the evaluated state."""
    from gcmiipy_tpu_torch.dynamics import core25d
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.ops import polar_filter
    L, H, W = shape
    hm = None
    if hill:
        hm = np.zeros((H, W))
        hm[H // 4:H // 2, W // 8:W // 3] = 1500.0
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=dtype, device=device)
    base = random_state(geom, 0, device, dtype)
    seval = random_state(geom, 1, device, dtype)
    spu = polar_filter.arakawa_1977(core25d.calc_pu(seval[0], seval[1]), geom)
    return geom, base + seval + (spu,)


def count_ops(fn, *args, **kw):
    """Arithmetic operations the plain version performs: one per output
    element of each elementwise arithmetic op (rolls, copies and
    concatenations move data and are not counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    arith = {"add", "sub", "mul", "div", "pow", "neg", "reciprocal", "sin",
             "maximum", "minimum", "clamp", "rsub"}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__.split(".")[0] in arith and torch.is_tensor(out):
                Count.ops += out.numel()
            return out

    with Count():
        fn(*args, **kw)
    return Count.ops


def cuda_ms(fn, reps, warmup=3):
    """Mean ms per call from CUDA events over ``reps`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is False: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind}; {torch.cuda.device_count()} card(s); "
                  f"torch {torch.__version__} cuda {torch.version.cuda}")
    return card, kind


def phase_build():
    from gcmiipy_tpu_torch.ops import cuda_lib
    t = time.perf_counter()
    text = cuda_lib.build("fused_parts")
    entry = "?"
    for line in (text or "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            log("build", f"fused_parts {entry}: {line.split(':', 1)[-1].strip()}")
    log("build", f"fused_parts {'built' if text is not None else 'found'} in "
                 f"{time.perf_counter() - t:.1f}s ({cuda_lib.BUILD_DIR})")


def phase_kernels(device):
    """K1 against its plain version at the main path's shape (float32) and
    at two small shapes (float64; 24x36 is off the JAX package's (8,128)
    tiles), each flag on and off, one run with terrain."""
    from gcmiipy_tpu_torch.ops.fused_parts import fused_parts, fused_parts_ref
    cases = [(False, False, False), (True, False, False),
             (False, True, False), (True, True, True)]
    worst = {}
    main_abs = 0.0
    for shape, dtype in (((MAIN["layers"], MAIN["height"], MAIN["width"]),
                          torch.float32), ((3, 16, 128), torch.float64),
                         ((9, 24, 36), torch.float64)):
        for coriolis, q_limiter, hill in cases:
            geom, args = k1_inputs(shape, dtype, hill, device)
            out = fused_parts(*args, MAIN["dt"], geom, coriolis=coriolis,
                              q_limiter=q_limiter)
            torch.cuda.synchronize()
            ref = fused_parts_ref(*args, MAIN["dt"], geom, coriolis=coriolis,
                                  q_limiter=q_limiter)
            if any(tuple(a.shape) != tuple(b.shape) for a, b in zip(out, ref)):
                fail("kernels", "fused_parts output shapes differ")
            if not all(torch.isfinite(a).all() for a in out):
                fail("kernels", "fused_parts output not finite")
            rel = rel_err(out, ref)
            tag = (f"fused_parts {tuple(shape)} {str(dtype)[6:]} coriolis="
                   f"{coriolis} q_limiter={q_limiter} hill={hill}")
            log("kernels", f"{tag}: max rel {rel:.3e} (bound {KERNEL_REL[dtype]:g})")
            if not rel <= KERNEL_REL[dtype]:
                fail("kernels", tag + " disagrees with fused_parts_ref")
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
            if dtype == torch.float32:
                main_abs = max(main_abs, abs_err(out, ref))
    log("kernels", "fused_parts ok: max rel float32 "
                   f"{worst[torch.float32]:.3e}, float64 {worst[torch.float64]:.3e}")
    return main_abs


def _config(backend):
    from gcmiipy_tpu_torch.model.config import ModelConfig
    return ModelConfig(height=MAIN["height"], width=MAIN["width"],
                       layers=MAIN["layers"], dt=MAIN["dt"], backend=backend,
                       guard=True)


def _check_run(tag, state, stats, guard=None):
    if guard is not None and not bool(guard.ok):
        fail("main", f"{tag}: guard tripped at step {int(guard.blown_step)}")
    for name, x in zip("puvtq", state):
        if not torch.isfinite(x).all():
            fail("main", f"{tag}: field {name} not finite")
    if not all(torch.isfinite(s).all() for s in stats):
        fail("main", f"{tag}: stats not finite")


def _run_model(backend, device):
    """The user's entry point, from the reference's quiescent start."""
    from gcmiipy_tpu_torch.model.driver import run_model
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run_model(MAIN["height"], MAIN["width"], MAIN["layers"],
                        MAIN["dt"], MAIN["steps"], config=_config(backend),
                        device=device)
        torch.cuda.synchronize()
    for w in caught:
        if "blew up" in str(w.message):
            fail("main", f"run_model {backend}: {w.message}")
        log("main", f"run_model {backend} warned: {w.message}")
    _check_run(f"run_model {backend}", out[:5], out[7])
    return out[:5], out[7]


def perturbed_state(geom, device):
    """The reference's start with the prognostics replaced by the random
    state of :func:`random_state`, so that every field moves from step 1."""
    from gcmiipy_tpu_torch.model.driver import gen_model_state
    from gcmiipy_tpu_torch.model.state import PrognosticVars
    state = gen_model_state(geom, _config("xla"))
    return state._replace(prog=PrognosticVars(
        *random_state(geom, 5, device, torch.float32)))


def _run_from(backend, geom, state, steps):
    """``make_run_fn`` (the loop under ``run_model``) from ``state``."""
    from gcmiipy_tpu_torch.model.driver import make_run_fn
    state, stats, guard = make_run_fn(geom, _config(backend), steps)(state)
    _check_run(f"{backend} from the perturbed state", state.prog, stats, guard)
    return state


def phase_main(device):
    """The main path: run_model with backend='fused', launches counted
    around it, held against the plain core (backend='xla') at the bounds of
    scripts/tpu_parity.py; then the same comparison from a perturbed start,
    where every field moves, after 1 and after 20 steps."""
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.ops.fused_parts import fused_parts
    n = MAIN["steps"]
    fused_parts.launches = 0
    t = time.perf_counter()
    fused_n, stats = _run_model("fused", device)
    launches = fused_parts.launches
    log("main", f"run_model fused {n} steps in {time.perf_counter() - t:.2f}s, "
                f"fused_parts launches {launches}, total energy drift "
                f"{float(stats.total_energy[-1] / stats.total_energy[0] - 1):.3e}")
    if launches != 2 * n:
        fail("main", f"fused_parts launched {launches} times, expected {2 * n}")
    xla_n, _ = _run_model("xla", device)
    rel_n = rel_err(fused_n, xla_n)
    drift = float((fused_n[0] - xla_n[0]).abs().max())
    log("main", f"run_model fused vs plain core: {n}-step rel {rel_n:.3e} "
                f"(< {RUN_REL:g}), p drift {drift:.3e} Pa (< {DRIFT_PA:g})")
    if not (rel_n < RUN_REL and drift < DRIFT_PA):
        fail("main", "run_model fused outside the tpu_parity.py bounds")

    geom = geometry.gen_geometry(MAIN["height"], MAIN["width"], MAIN["layers"],
                                 sig_func=geometry.manabe_sig,
                                 dtype=torch.float32, device=device)
    start = perturbed_state(geom, device)
    out = {b: (_run_from(b, geom, start, 1), _run_from(b, geom, start, n))
           for b in ("fused", "xla")}
    rel1 = rel_err(out["fused"][0].prog, out["xla"][0].prog)
    rel_n = rel_err(out["fused"][1].prog, out["xla"][1].prog)
    drift = float((out["fused"][1].prog.p - out["xla"][1].prog.p).abs().max())
    moved = rel_err(out["xla"][1].prog, start.prog)
    moved_p = float((out["xla"][1].prog.p - start.prog.p).abs().max())
    log("main", f"perturbed start, fused vs plain core: step-1 rel {rel1:.3e} "
                f"(< {STEP1_REL:g}), {n}-step rel {rel_n:.3e} (< {RUN_REL:g}), "
                f"p drift {drift:.3e} Pa (< {DRIFT_PA:g}); the plain run moved "
                f"the state by rel {moved:.3e}, p by {moved_p:.3e} Pa")
    if not (rel1 < STEP1_REL and rel_n < RUN_REL and drift < DRIFT_PA):
        fail("main", "fused run outside the tpu_parity.py bounds")
    if not moved_p > DRIFT_PA:
        fail("main", "the perturbed run did not move p past the drift bound")
    return launches, geom, start


def phase_timing(device, launches, max_abs, geom, start):
    from gcmiipy_tpu_torch.model.driver import make_run_fn
    from gcmiipy_tpu_torch.ops.fused_parts import fused_parts, fused_parts_ref

    # ms/step of the whole loop (make_run_fn with the guard and the stats):
    # windows of STEP_WINDOW steps between CUDA events, no host sync inside
    # a window, in the order plain, fused, fused, plain.
    runs = {b: make_run_fn(geom, _config(b), STEP_WINDOW)
            for b in ("xla", "fused")}
    for run in runs.values():
        run(start)
    windows = {"xla": [], "fused": []}
    for backend in ("xla", "fused", "fused", "xla"):
        ms = cuda_ms(lambda: runs[backend](start), 1, warmup=0)
        windows[backend].append(ms / STEP_WINDOW)
    step_ms = {b: statistics.mean(v) for b, v in windows.items()}
    log("timing", f"ms/step over 2 windows of {STEP_WINDOW} steps: fused "
                  f"{step_ms['fused']:.4f} ({windows['fused'][0]:.4f}, "
                  f"{windows['fused'][1]:.4f}), plain core {step_ms['xla']:.4f} "
                  f"({windows['xla'][0]:.4f}, {windows['xla'][1]:.4f})")

    # K1 alone at the main path's shape
    geom, args = k1_inputs((MAIN["layers"], MAIN["height"], MAIN["width"]),
                           torch.float32, False, device)
    call = (*args, MAIN["dt"], geom)
    ms = cuda_ms(lambda: fused_parts(*call), 50)
    plain_ms = cuda_ms(lambda: fused_parts_ref(*call), 10)
    outs = fused_parts_ref(*call)
    geo = [getattr(geom, n) for n in ("dx_j", "dx_h", "lat", "heightmap", "sig",
                                      "sigt", "sigb", "dsig", "dy", "ptop")]
    nbytes = sum(x.numel() * x.element_size() for x in (*args, *geo, *outs))
    ops = count_ops(fused_parts_ref, *call)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_OPS_PER_S[torch.float32]
    bound_ms = max(bytes_ms, ops_ms)
    log("timing", f"fused_parts {ms:.4f} ms/launch, plain {plain_ms:.4f} ms; "
                  f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB -> "
                  f"{bytes_ms:.4f} ms; {ops / 1e9:.3f} Gop -> {ops_ms:.4f} ms); "
                  f"{100 * bound_ms / ms:.1f}% of bound")
    return {"name": "fused_parts", "route": "cuda",
            "source": "gcmiipy_tpu_torch/csrc/fused_parts.cu",
            "replaces": "gcmiipy_tpu/ops/pallas_stencil.py:221",
            "launches": launches, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def main():
    card, kind = phase_device()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    max_abs = phase_kernels(device)
    launches, geom, start = phase_main(device)
    row = phase_timing(device, launches, max_abs, geom, start)
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
