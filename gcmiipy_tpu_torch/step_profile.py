"""Where the time of one Matsuno step goes on the GPU.

    python -m gcmiipy_tpu_torch.step_profile [--height 512 --width 1024
        --layers 9 --dt 30 --steps 10 --backend stream mega4 mega v2 fused
        xla --physics --surface --trace-dir DIR]

For each backend it runs ``--steps`` warm steps under ``torch.profiler``
(CPU + CUDA activities) and prints one JSON line: the wall ms per step
(host clock around as many synchronised steps run without the profiler),
the device busy ms per step (sum of the device-side events' time; one
stream, so they do not overlap), the idle share, and the kernels by device
time.  'stream' runs its steps as one K7 call (``--steps`` even), the
others one step at a time; 'v2' is the v2 pipeline
(``dynamics.fused.make_fused_matsuno_v2``: K3, the FFT filter, K4), which
no ``ModelConfig`` backend names.  ``--physics`` adds the reference's
per-step grey radiation, convection and surface drag (two days): inside
K7's steps for 'stream', as plain PyTorch after each step for the others.
``--surface`` runs the surface configuration instead (:data:`SURFACE`: the
Hansen terrain and land cover, four-band radiation, convection, the water
cycle and the Shapiro filter, the physics every 2nd step) through
``make_run_fn`` from a cooled start whose lowest layer is supersaturated
(``model.state.moist_start``): 'stream' as
K7 calls of 2 steps with the extras and the filter between them; its timed
and profiled calls replay the run's walk as one CUDA graph
(``model/run_graph.py``).  With
``--trace-dir`` it also writes a Chrome trace per backend there.

The line's ``spans`` give, for each of the program's own spans
(``gcm.dynamics``, ``gcm.physics.convection``, ``gcm.physics.sun`` where
the sun is seasonal, ``gcm.sync``, ...:
:func:`model.observability.span`), its calls, host ms and device ms a
step, the device ms being that of the work launched inside it; with
``--surface`` the profiled call is a replay, whose spans are
``gcm.graph.replay`` and the step counter's ``gcm.sync``.  Its
``convection_sweeps_max`` is the most sweeps any column of the adaptive
convection's kernel ran over the timed steps
(``ops/convection.sweeps_max``, read once after them; 0 where the kernel
did not run).  The device side's copies of user annotations
(``record_function`` ranges) are not kernels, and :func:`kernel_ms` and
the breakdown leave them out.

In the breakdown a half step of 'mega4', 'mega' and 'stream' shows three
launches: the pgf tile (``gcm::pgf_tile<float>``, also K3's one launch in
'v2'), the filter (``gcm::fft_filter_pow2<float, 1024>``) and the rest
tile with its aflux prologue (``gcm::tile_stencil<float,
gcm::RestOut<float>>``, also K4's one launch in 'v2'), six a step;
'stream' with ``--physics`` adds K7's epilogue
(``gcm::column_physics<float>``), seven a step.  A half step of 'fused'
shows K1's column pass (``column_pass<float>``) and its tiled launch
(``gcm::tile_stencil<float, gcm::PartsOut<float>>``).
"""

import argparse
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from gcmiipy_tpu_torch.device import resolve_device
from gcmiipy_tpu_torch.dynamics import fused
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import moist_start
from gcmiipy_tpu_torch.ops import convection, stream_steps

# the per-step physics of the main path: grey radiation every step,
# convection and a two-day surface drag
PHYSICS = dict(physics=True, physics_every=1, convection=True,
               drag_tau=2 * 86400.0)
# the program's spans (model.observability.span) start with it
SPAN_PREFIX = "gcm."
# the surface configuration (chip_smoke.py's Config S)
SURFACE = dict(topography="hansen", land_cover="hansen", physics=True,
               convection=True, radiation="4band", evaporation=True,
               gw0=0.05, precipitation=True, rh_crit=0.8, drag_tau=86400.0,
               shapiro_every=4, shapiro_fields="pt", physics_every=2)


def _device_us(event):
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def _on_device(event):
    """Whether a profiler event is device work: on the device, and not the
    device side's copy of a user annotation or a program span."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False)
            and not event.key.startswith(SPAN_PREFIX))


def kernel_ms(fn, calls=20):
    """Device ms a call of each kernel that ``fn`` launches, by kernel
    name (:func:`_kernel_name`), from ``torch.profiler``
    over ``calls`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {_kernel_name(e.key): _device_us(e) / 1e3 / calls
            for e in prof.key_averages() if _on_device(e)}


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_table(events, steps):
    """``{name: {calls, host_ms, device_ms}}`` a step of the program's
    spans among a profiler's ``events()``: their count, the union of their
    host ranges, and the device time of the work whose launch (the CUDA
    runtime call of the same correlation id) lies inside them."""
    launches, spans, work = {}, {}, []
    for e in events:
        rng = (e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if _on_device(e):
                work.append((rng, e.id))
        elif e.name.startswith(SPAN_PREFIX):
            spans.setdefault(e.name, []).append(rng)
        elif e.name.startswith("cu"):
            launches[e.id] = rng[0]
    table = {}
    for name, ranges in sorted(spans.items()):
        merged = _merged(ranges)

        def inside(t):
            return any(s <= t < e for s, e in merged)
        device = _merged([rng for rng, i in work
                          if i in launches and inside(launches[i])])
        table[name] = {
            "calls": len(ranges) / steps,
            "host_ms": sum(e - s for s, e in merged) / 1e3 / steps,
            "device_ms": sum(e - s for s, e in device) / 1e3 / steps}
    return table


def _kernel_name(key):
    """A kernel's signature without its return type and argument list."""
    depth = 0
    for n in range(len(key) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(key[n], 0)
        if depth == 0 and key[n] == "(":
            key = key[:n]
            break
    return key.removeprefix("void ")


def _stepper(backend, geom, config, steps):
    """``advance()``: ``steps`` steps of ``backend`` from the reference's
    start, on state held in the closure (the dynamics step alone without
    the physics)."""
    state = driver.gen_model_state(geom, config)
    if backend == "stream":
        physics = (stream_steps.make_physics(
            geom, drag_tau=config.drag_tau, convection=config.convection)
            if config.physics else None)
        multi = stream_steps.StreamSteps(geom, config.dt, physics=physics)
        packed = stream_steps.pack_state(
            *state.prog, gt=state.ground.gt if config.physics else None)
        S = torch.stack([packed, torch.zeros_like(packed)])
        return lambda: multi(S, state.utc, steps)
    if backend == "v2":
        step = fused.make_fused_matsuno_v2(geom, config.dt)
    else:
        step = driver.make_dynamics_step(geom, config,
                                         driver.make_filter_fn(config, geom))
    box = [state]

    def advance():
        for _ in range(steps):
            if config.physics:
                box[0] = driver.full_timestep(box[0], geom, config, None,
                                              step)
            else:
                box[0] = box[0]._replace(prog=step(*box[0].prog))
    return advance


def _surface_stepper(backend, config, steps, device):
    """``advance()``: ``steps`` steps of ``make_run_fn`` with the surface
    configuration over the terrain, from the reference's start cooled
    with a supersaturated lowest layer (``state.moist_start``)."""
    config = driver.normalize_config(config)
    geom = driver.gen_model_geometry(config, device)
    state = moist_start(driver.gen_model_state(geom, config), geom)
    run = driver.make_run_fn(geom, config, steps)
    return lambda: run(state)


def profile_backend(backend, height, width, layers, dt, steps, device,
                    trace_dir=None, top=8, physics=False, surface=False):
    """Profile ``steps`` steps of one backend; returns the summary dict."""
    if surface:
        if backend == "v2":
            raise ValueError("--surface needs a ModelConfig backend, not v2")
        config = ModelConfig(backend=backend, dt=dt, height=height,
                             width=width, layers=layers, stats=False,
                             **SURFACE)
        advance = _surface_stepper(backend, config, steps, device)
    else:
        # 'v2' takes the 'fused' config: the same FFT filter, outside the
        # kernels
        config = ModelConfig(backend="fused" if backend == "v2" else backend,
                             dt=dt, **(PHYSICS if physics else {}))
        geom = geometry.gen_geometry(height, width, layers,
                                     sig_func=geometry.manabe_sig,
                                     dtype=torch.float32, device=device)
        advance = _stepper(backend, geom, config, steps)
    # the first call warms; a run function's second captures its walk as
    # one CUDA graph, which the timed and the profiled calls replay
    advance()
    advance()
    torch.cuda.synchronize()
    convection.sweeps_max(device, reset=True)
    t = time.perf_counter()
    advance()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / steps
    sweeps = convection.sweeps_max(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        advance()
        torch.cuda.synchronize()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        suffix = "-surface" if surface else "-physics" if physics else ""
        prof.export_chrome_trace(os.path.join(trace_dir,
                                              f"{backend}{suffix}.json"))
    # the device-side events themselves (kernels, copies), not the host ops
    # that launched them, so no time is counted twice
    kernels = [(e.key, _device_us(e) / 1e3 / steps, e.count // steps)
               for e in prof.key_averages() if _on_device(e)]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    return {
        "backend": backend, "physics": physics, "surface": surface,
        "grid": [layers, height, width], "dt": dt,
        "steps": steps, "device": torch.cuda.get_device_name(device),
        "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "kernels_per_step": sum(k[2] for k in kernels),
        "top": [{"name": n[:80], "ms_per_step": ms, "calls_per_step": c}
                for n, ms, c in kernels[:top]],
        "spans": span_table(prof.events(), steps),
        "convection_sweeps_max": sweeps,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=9)
    ap.add_argument("--dt", type=float, default=30.0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--backend", nargs="+", default=["fused", "xla"],
                    choices=["xla", "fused", "v2", "mega", "mega4",
                             "stream"])
    ap.add_argument("--physics", action="store_true")
    ap.add_argument("--surface", action="store_true")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    device = resolve_device("cuda")
    for backend in args.backend:
        print(json.dumps(profile_backend(
            backend, args.height, args.width, args.layers, args.dt,
            args.steps, device, args.trace_dir,
            physics=args.physics, surface=args.surface)), flush=True)


if __name__ == "__main__":
    main()
