import os, sys; sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))  # noqa: E401,E702
# Smoke run of the PyTorch port (gcmiipy_tpu_torch) on one NVIDIA GPU.
#
#     python3 chip_smoke.py [convection | radiation | kernels | forms | graph]
#
# Phases, one log line each (with elapsed seconds); any failure exits
# non-zero and prints no result:
#   device   the card's name and power limit (nvidia-smi) and torch's name;
#   build    nvcc builds the kernel sources of the paths (csrc/fused_parts.cu,
#            csrc/mega_step.cu, csrc/stream_steps.cu, csrc/pgf_rest.cu,
#            csrc/mega_half.cu, csrc/fft_filter.cu, csrc/convection.cu and
#            csrc/radiation.cu,
#            all at once, each into a library and, where its code calls
#            power, a float64 library of its own, ops/cuda_lib.py) and
#            prints ptxas' counts (from the log kept beside a library found
#            built), failing if the pgf tile, the column-physics epilogue,
#            the rest tile (tile_stencil<T, RestOut>), K1's tiled launch
#            (tile_stencil<T, PartsOut>), K1's column pass, the adaptive
#            convection or the four-band radiation spills or keeps a
#            per-layer array on its stack;
#   kernels  each kernel against its plain PyTorch version on the card: the
#            FFT filter stage (fft_filter, against its plain version and
#            the TPU kernels' banded DFT form), K1 (fused_parts), K6
#            (mega_step), K7 (stream_steps, with and without its
#            column-physics epilogue), K3 and K4 (pgf_parts, rest_parts)
#            and K5 (mega_half, against its plain version with the banded
#            and with the TPU kernel's unbanded DFT); K1 logs whether it
#            equals its plain version to the bit, and K3 (pgf_parts: the
#            pgf tile, stages 1-2 of K5, K6 and K7), K4 (rest_parts: the
#            rest tile with its aflux prologue, stages 4-5 of K5, K6 and
#            K7), K1 and K1's column pass alone (pgf_column) must, at the
#            main path's shape and on four edge grids at both types; K7's
#            column-physics epilogue alone (column_physics);
#            the adaptive convection's kernel (ops/convection.py) against
#            its plain loop on the card, to the bit (phase_convection, run
#            last, after timing; its row takes phase surface's count of the
#            kernel's launches; `python3 chip_smoke.py convection` runs
#            device, build and it alone, and prints its row without a
#            launch count); on DEEP_GRIDS beside the others, where the
#            pgf tile, the rest tile, K1's tiled launch, the epilogue and
#            the convection launch their deep forms above their HeldLayers
#            (csrc/gcm_limits.cuh; `python3 chip_smoke.py forms` times each
#            kernel's held and deep forms against each other, forced in
#            copies of csrc/, at 9 to 48 layers); the four-band radiation's
#            kernel with its update (ops/radiation.py) against the plain
#            function and update on the card, within RADIATION_REL, one
#            launch and no host read a call (phase_radiation, run after the
#            convection; its row takes phase surface's count; `python3
#            chip_smoke.py radiation` runs device, build, surface and it);
#   deep     GISS ModelE2.1's 40 layers under a 10 Pa top with the per-step
#            physics through make_run_fn on every backend, float32 on the
#            main grid and float64 on 64x128, each against 'xla', guard
#            clean, the column kernels' launches counted; then the rows of the
#            pgf tile, the rest tile and the epilogue at 40x512x1024
#            (`python3 chip_smoke.py kernels` runs device, build, the
#            kernel phases and this, then the convection, and prints their
#            rows); in the full run it runs after phase timing, before the
#            convection: its profiler sessions would cost timing's their
#            device events;
#   main     each path with its launch counts set to 0 just before it and
#            read just after: run_model(512, 1024, 9, 30.0, 20, guard=True)
#            with backend='fused' (K1) and backend='mega4' (K6), held against
#            the plain core (backend='xla', and for mega4 also xla with
#            polar_filter='dft' and the fused run); then the backends from a
#            perturbed start, compared after 1 and after 20 steps; then one
#            step of make_fused_matsuno (K2's path, K1's kernel); then
#            run_model with backend='stream' and the per-step grey physics
#            (one K7 call of 20 steps), stream against mega4 for the
#            dynamics alone, and stream+physics against mega4 with the
#            per-step physics in plain PyTorch, from the perturbed start;
#            then run_model with backend='mega' (K5 twice a step) against
#            the plain core with the DFT filter and against mega4, from the
#            quiescent and the perturbed start; then 20 steps of
#            make_fused_matsuno_v2 (K3, torch.fft, K4) from the perturbed
#            start against 'fused'; the launches of the pgf tile, the
#            filter, the rest tile, the epilogue and K1's two stages are
#            counted where the C entries make them: six kernel launches a
#            mega4 step, seven a stream step with the physics;
#   surface  the Hansen terrain, land cover, water cycle, Shapiro filter and
#            four-band radiation (Config S) through make_run_fn, 20 steps
#            from a cooled start whose lowest layer is supersaturated: on
#            'stream' (K7 calls of 2 steps, the extras and the filter
#            between calls) and 'mega4' (K6), held against each other, the
#            plain core (xla with the DFT filter) and 'mega' (K5), with the
#            launches counted (the adaptive convection's kernel and the
#            four-band radiation's one each a physics call, every 2nd step)
#            and rain required; Config T, the
#            grey per-step physics over the terrain in K7's epilogue, against
#            mega4 with the plain physics after 4 and 20 steps; Config W,
#            Config S without the land cover on mega4, whose global water
#            (atmosphere and ground) must change by less than 1e-5;
#   graph    a run function's walk as one CUDA graph (model/run_graph.py)
#            on the benchmark's grey configuration at grey-modelii's 24x36
#            (the per-step 'mega4' fallback) and at 9 and 40 layers of the
#            flagship's 512x1024 ('stream'): its second call captures, every
#            later one replays, each replay equal to the eager walk to the
#            bit and counting the eager call's launches on the ops'
#            counters; host ms a step eager against replay, the replay's
#            device ms, the copy-in's and copy-out's device ms (printed as
#            a `{"graph": [...]}` line; `python3 chip_smoke.py graph` runs
#            device, build and it);
#   services the run services on 'stream' (K7) and 'mega4' (K6): run_model
#            with checkpoint_every=10 and a metrics path over 20 steps (the
#            checkpoints named step_{step:010d}.npz, one metrics line a stats
#            entry), resumed from step 10 with make_run_fn(start_step=10) and
#            equal to the straight run to the bit; Config S on 'stream' split
#            at step 7, off its launch size K = 2, resumed behind a one-step
#            alignment head and equal to its straight run to the bit; python
#            -m gcmiipy_tpu_torch run as a subprocess (exit code 0);
#   sideband the side-band modules, plain PyTorch on the card at float64 held
#            to the same calls on the CPU at float64 (SIDEBAND_REL64 of each
#            field's scale), the runs also at float32 on the card
#            (SIDEBAND_REL32): the 1D advection config (161 cells, dx = 10
#            m, dt = 1 s) for 400 steps of upwind, third-order upwind and
#            Lax-Friedrichs through run_guarded; the 2D C-grid shallow water
#            (64x64, dx = 300 km, dt = 300 s) for 1000 steps through
#            run_guarded, stable, with a tensor's host reads made to raise;
#            the C-grid, A-grid, temperature-viscosity and GCM-form 2D cores
#            and ctu_step at 512x1024 for 20 steps; dynam_matsuno on 161
#            cells for 50 steps; grey_solar and grey_radiation at 9x512x1024;
#            each card run's ms by CUDA events;
#   longrun  the reference's long integrations (gcmiipy_tpu_torch.
#            longrun_flagship) held to the JAX package's outcome, which
#            artifacts/longrun_energy.json records: K6 against its plain
#            version at the long runs' grids (3x8x8, 9x24x36 over the
#            Hansen terrain, float64); then through run_case on 'mega4'
#            (K6 a step), float64: the bare grey physics over 6500 steps and
#            the terrain over 3200, whose guard must trip within 10 steps of
#            JAX's (6308, 3028), the dynamics over 14,400 steps, guard-clean
#            with an energy drift below 1e-5, each energy trace within
#            LONGRUN_E_REL of JAX's; run_flagship: 14,400 float32 steps of
#            the main grid on 'stream' with the per-step physics (K7 and its
#            epilogue), guard-clean, against its float64 first day
#            (FLAGSHIP_E_REL, FLAGSHIP_P_REL); then the stabilised and the
#            seasonal cases for what is left of a 120 s budget (at least
#            2000 steps each, cuts logged); the launches of K6 and K7
#            counted;
#   ring     the latitude ring: 4 ranks spawned on the one card over gloo
#            (after phase build, so that no rank builds); each holds its K6
#            shard block (128+16 rows) and K7 shard block (k=4: 128+64 rows)
#            against their plain versions at both types, runs
#            run_model(512, 1024, 9, 30.0, 20, mesh=ring) on 'stream' and
#            'mega4' with its launches counted (6 kernel launches a step, 5
#            calls of K7's shard form on 'stream') against the single-device
#            run (to the bit, else held to RING_REL and logged; the stats
#            within float32 summation order) and times the ring's loop (ranks
#            sharing one card over gloo: not a scaling figure); a
#            checkpointed ring run restores into a single-device run with the
#            same fields; torchrun runs the CLI on 4 ranks once;
#   mesh2d   the 2D (lat x lon) mesh and the ring's last forms, 4 ranks on
#            the card again: K3's and K4's shard forms (pgf_parts_shard,
#            rest_parts_shard) on each rank's 2x2 block (262 x 518) to the
#            bit, K5's (mega_half_shard) on its ring block and K6 on
#            fused4's overlap strips against their plain versions;
#            run_model(512, 1024, 9, 30.0, 20, mesh=2x2) on 'mega4'
#            (fused2d: K3, the spectral-psum filter, K4, twice a step,
#            counted) against the single-device plain core with the DFT
#            filter, and from the perturbed start 'mega4' and 'xla' on 2x2
#            and 'xla' on 1x4 (1 and 20 steps, tpu_parity.py's bounds;
#            float64 at 3 layers, 2 steps, within 1e-9); 'stream' on 2x2
#            (JAX's warning, mega4's fields to the bit); K5's ring
#            (make_shard_step_fused) against single-device 'mega' and
#            fused4 overlap=True against the one-kernel ring, to the bit
#            and timed; a checkpointed 2x2 run resumed to the bit; the 2x2
#            loop timed, its parts timed on every rank at once and rank
#            0's step profiled; stream_wide_native at 9x512x4096 against
#            mega4 to the bit; torchrun of the CLI with --mesh-shape 2,2;
#            the ensemble: 4 members on a pure 'e' mesh (K6) and 2 members on
#            an ('e','y','x') mesh of shape (2, 2, 1) (K6's ring form), 5
#            steps of 'mega4' at 9x512x1024, each member held against its
#            single-device run (to the bit expected; a float64 case at 3
#            layers within MESH2D_REL64);
#   timing   ms/step of the backends, mega4 and stream also with the
#            physics and with Config S (over the terrain from phase
#            surface's start), mega4 also with the physics every 4th step (windows
#            of 20 steps between CUDA events, each twice), the v2 step
#            beside the fused step (dynamics alone), each kernel's ms
#            beside its bound, its plain version's and, for the filter
#            stage and the filters of K5, K6 and K7, torch.fft's; K1's,
#            K3's and K4's rows also the device ms of each of their launches
#            (torch.profiler, step_profile.kernel_ms); a row for K1's column
#            pass alone (pgf_column) with its bytes bound; the row of the
#            rest tile (csrc/stencil_tile.cuh, stages 4-5 of K4-K7) is K4's
#            launch with the launches that the C entries of K4-K7 counted on
#            the main paths; K3's row is the pgf tile (csrc/pgf_tile.cuh)
#            with the launches the C entries of K3 and K5-K7 counted, and a
#            row for the epilogue alone (csrc/column_physics.cuh), launched
#            in place as K7 does; rows for K6's and K7's shard forms on rank
#            0's block with the launches rank 0 counted in phase ring, and
#            for K3's, K4's and K5's shard forms, K6 on the overlap strips
#            and the spectral-psum filter stage on rank 0's blocks with the
#            launches rank 0 counted in phase mesh2d.
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
# Peak rate of each arithmetic type: float32 outside the tensor cores, and
# float64 on them (DMMA; 34e12 outside), the least time the work could take
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 67e12}
# bounds of scripts/tpu_parity.py: fused pipeline vs the plain core
STEP1_REL, RUN_REL, DRIFT_PA = 1e-4, 2e-3, 0.5
# kernel vs its plain version: same operations in the same order (fmad off),
# so only pow/sin ulps and the compiler's choices can differ
KERNEL_REL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the column-physics epilogue alone vs its plain version, over each field's
# scale: float32 pow/log ulps (1.473e-7 measured on the card at the main
# path's shape with convection and drag), float64 as KERNEL_REL
EPILOGUE_REL = {torch.float32: 1e-6, torch.float64: 1e-12}
# the four-band radiation's kernel with its update vs the plain function and
# the update, over each field's scale: the plain operand order, the sums
# over the bands and the ground's layers in another (the CPU's emulated
# source read 1.0e-7 and 1.9e-16, tests/test_torch_host_emulation.py)
RADIATION_REL = {torch.float32: 1e-6, torch.float64: 1e-12}
# each case must move t (and u where the drag is on) by at least this many
# times EPILOGUE_REL over the field's scale, so that an epilogue that skips
# or mis-scales a term cannot pass within the bound
EPILOGUE_MOVE = 10.0
# K6 vs its plain version after one call: the kernel's filter is an FFT, the
# plain version's the TPU kernel's banded DFT, so agreement is to rounding
MEGA_REL = {torch.float32: 1e-4, torch.float64: 1e-11}
# the FFT filter stage vs its plain version and the banded DFT, over each
# field's scale: the float64 filter rounded once to float32 (one ulp apart
# at most), float64 sums in another order
FFT_REL = {torch.float32: 2e-7, torch.float64: 1e-13}
# the kernels against the float64 banded DFT on the stacked forces and the
# fields after them: above its own rounding on the cancelling polar rows,
# which reached 2.46e-11 of a field's scale (K7, 3x512x1024) and 5e-11 (K6,
# width 2048) on the card while the FFT-plan plain version stayed within
# 5.9e-14, and far below the 3.6e-8 of a float32 result (filter_accuracy)
BANDED_REL64 = 1e-10
# K7 vs its plain version after one call of several steps: K6's rounding,
# carried through the steps and the physics
STREAM_REL = {torch.float32: 1e-4, torch.float64: 1e-11}
# stream+physics vs mega4 with the per-step physics in plain PyTorch after a
# few steps: the bound of scripts/tpu_parity.py's gate 6b (:329-360)
PHYSICS_REL = 4e-4
SOURCES = ("fused_parts", "mega_step", "stream_steps", "pgf_rest", "mega_half",
           "fft_filter", "convection", "radiation")
# The flagship bench grid at its full width.  dt is bench.py's for this grid:
# at 512 latitude rows dt=900 breaks the meridional CFL limit (the polar
# filter acts zonally only), and the guard stops the run at step 1-2, in the
# JAX package as in the port.
MAIN = dict(height=512, width=1024, layers=9, dt=30.0, steps=20)
STEP_WINDOW = 20  # steps per timing window
# the per-step physics of the main path: grey radiation after every step
# (the reference's cadence), convection, a one-day surface drag
PHYSICS = dict(physics=True, physics_every=1, convection=True,
               drag_tau=86400.0)
# Config S of phase surface: the Hansen terrain and land cover, four-band
# radiation, convection, the water cycle, a one-day drag and the Shapiro
# filter of p and t (sea-level reduction on over the terrain), with the
# physics every 2nd step
SURFACE = dict(topography="hansen", land_cover="hansen", physics=True,
               convection=True, radiation="4band", evaporation=True,
               gw0=0.05, precipitation=True, rh_crit=0.8, drag_tau=86400.0,
               shapiro_every=4, shapiro_fields="pt", physics_every=2)
# Config T: the grey per-step physics over the Hansen terrain, which 'stream'
# runs in K7's epilogue
TERRAIN = dict(topography="hansen", physics=True, convection=True,
               drag_tau=86400.0, physics_every=1)
# Config W's global water (atmosphere and ground, float64 sums) over the run
WATER_REL = 1e-5
# phase ring: ranks spawned on the one card, K7's launch size on the ring
# (stream_steps 20 clamped to at most 4 by the JAX package's rule), the
# ranks' deadline; a ring run's fields against the single-device run's
# where they are not equal to the bit, and its energies (float32 sums over
# the bands, then across the ranks, in another order than one sum)
RING, RING_K, RING_DEADLINE_S = 4, 4, 600
RING_REL, RING_STATS_REL = 1e-6, 1e-5
# phase mesh2d: its float64 runs (3 layers of the main grid, 2 steps) against
# the single-device plain core within MULTICHIP_r05.json's bound; the
# stream_wide_native check at the flagship height and 4096 columns
MESH2D_REL64 = 1e-9
PSUM_REL = 1e-6  # the psum filter's float32 result, of the field's scale
MESH2D_F64 = dict(layers=3, steps=2)
WIDE = dict(height=512, width=4096, layers=9, dt=30.0, steps=4)
# phase mesh2d's ensembles: 'mega4' steps, the ('e','y','x') shape
ENSEMBLE_STEPS, ENSEMBLE_SHAPE = 5, (2, 2, 1)
# phase sideband: the card's float64 result held to the CPU's float64 result
# of the same call (both plain PyTorch: they differ by the rounding of pow,
# exp and log, by a division by a Python number, which the card does as a
# product with its reciprocal, and by the order of reductions), and a
# float32 run on the card held to the CPU's float64 run, of each field's
# scale: the 1000-step shallow water's float32 rounding grows to about 2e-3
SIDEBAND_REL64, SIDEBAND_REL32 = 1e-10, 1e-2
SIDEBAND_1D = dict(cells=161, dx=10.0, dt=1.0, steps=400, v=2.0)
SIDEBAND_SW = dict(side=64, dx=300e3, dt=300.0, steps=1000)
SIDEBAND_2D = dict(height=512, width=1024, steps=20)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
# phase longrun: the JAX package's outcome of scripts/longrun_flagship.py
# (CPU, float64), which a fresh JAX run reproduces to the bit
# (tests/test_torch_longrun.py); read here, since the smoke imports no JAX
LONGRUN_ARTIFACT = os.path.join(REPO_DIR, "artifacts", "longrun_energy.json")
# the cases of fixed horizon: (steps run, the span of the energy trace held
# to JAX's), the blow-up cases past JAX's trip (6308, 3028) and held to 300
# and 128 steps before it, where the trace still changes smoothly
LONGRUN = {"bare_physics": (6500, 6000), "terrain": (3200, 2900),
           "dynamics": (14400, 14400)}
# the stable cases: as many steps as the phase's budget leaves, at least
# LONGRUN_STABLE_MIN, of JAX's 14,400 and 17,520
LONGRUN_STABLE = ("stabilized", "seasonal")
LONGRUN_STABLE_MIN, LONGRUN_BUDGET_S = 2000, 120.0
# the guard's first bad step against JAX's; the dynamics' energy drift
# (the bound of tests/test_harness_extras.py:85)
LONGRUN_BLOWN_TOL, LONGRUN_DRIFT = 10, 1e-5
# the energy trace against JAX's over its span, of the trace's scale: about
# 150 times the largest difference of the port's float64 on the CPU from
# JAX's over these spans (tests/longrun_rehearsal.py: 9.7e-14, the bare
# physics to step 6000; 2.8e-15 the terrain to 2900; below 2e-15 the
# others), for the card's rounding (pow, sin, the FFT filter against the
# banded DFT) carried over thousands of steps
LONGRUN_E_REL = 1.5e-11
# the flagship long run: float32 steps on 'stream', and its float64 day;
# float32 against float64 at the day's end, the energy trace and the
# global-mean surface pressure: 10 times the CPU rehearsal's worst at 9
# layers, 16 and 64 rows of 128 (tests/longrun_rehearsal.py flagship: 6.0e-6
# and 1.2e-6), the float32 state's rounding carried over 2880 steps
FLAGSHIP_STEPS, FLAGSHIP_DAY = 14400, 2880
FLAGSHIP_E_REL, FLAGSHIP_P_REL = 6e-5, 1.2e-5
# phase deep: GISS ModelE2.1's 40 layers under a 0.1 hPa top (gcmbench's
# gcm2-grey-l40) with the main path's per-step physics through make_run_fn
# on every backend, float32 on the main grid and float64 on a grid of its
# own, each against 'xla' at its type after the steps: float32 within
# RUN_REL; float64 within DEEP_REL64, the kernels' FFT filter against
# torch.fft's and the card's pow carried over 20 steps
DEEP = dict(layers=40, ptop=10.0, steps=20, f64_grid=(64, 128))
DEEP_REL64 = 1e-9


def log(phase, msg):
    # one write a line, so that the lines of the ring's ranks do not mix
    sys.stdout.write(f"[{time.perf_counter() - T0:7.2f}s] {phase}: {msg}\n")
    sys.stdout.flush()


def fail(phase, msg):
    log(phase, "FAIL " + msg)
    sys.exit(1)


def rel_err(out, ref):
    """Max per-field error over the field's scale (scripts/tpu_parity.py)."""
    return max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
               for a, b in zip(out, ref))


def abs_err(out, ref):
    return max(float((a - b).abs().max()) for a, b in zip(out, ref))


def bit_equal(out, ref):
    return all(torch.equal(a, b) for a, b in zip(out, ref))


def random_state(geom, seed, device, dtype):
    """(p, u, v, t, q): the recipe of tests/test_pallas_fused.py:_initial."""
    from gcmiipy_tpu_torch.model.state import random_prognostics
    return tuple(random_prognostics(geom, seed, dtype))


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


def count_ops(fn, *args, dtypes=None, **kw):
    """Arithmetic operations the plain version performs: one per output
    element of each elementwise arithmetic op (rolls, copies and
    concatenations move data and are not counted), of the ``dtypes`` given
    (all when None)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    arith = {"add", "sub", "mul", "div", "pow", "neg", "reciprocal", "sin",
             "cos", "log", "lt", "maximum", "minimum", "clamp", "rsub"}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.__name__.split(".")[0] in arith and torch.is_tensor(out)
                    and (dtypes is None or out.dtype in dtypes)):
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


def device_ms(fn, reps):
    """Mean device ms per call over ``reps`` calls queued behind a sleeping
    kernel, so that the host's launches do not pace them (CUDA events)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
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


# The kernels that phase build holds to ptxas' report: a name, the source
# whose libraries hold it, and the mangled-name piece of each type's
# instantiation (float, double)
REDESIGNED = (
    ("pgf_tile", "pgf_rest", "pgf_tileIfEEv", "pgf_tileIdEEv"),
    ("column_physics", "stream_steps", "column_physicsIfEEv",
     "column_physicsIdEEv"),
    ("tile_stencil<T, RestOut>", "pgf_rest",
     "tile_stencilIfNS_7RestOutIfEEEEv", "tile_stencilIdNS_7RestOutIdEEEEv"),
    ("tile_stencil<T, PartsOut>", "fused_parts",
     "tile_stencilIfNS_8PartsOutIfEEEEv", "tile_stencilIdNS_8PartsOutIdEEEEv"),
    ("column_pass (K1)", "fused_parts", "column_passIfEEv",
     "column_passIdEEv"),
    ("column_convection", "convection", "column_convectionIfEEv",
     "column_convectionIdEEv"),
    # the deep forms, above each kernel's HeldLayers (gcm_limits.cuh)
    ("pgf_tile_deep", "pgf_rest", "pgf_tile_deepIfEEv", "pgf_tile_deepIdEEv"),
    ("column_physics_deep", "stream_steps", "column_physics_deepIfEEv",
     "column_physics_deepIdEEv"),
    ("tile_stencil_deep<T, RestOut>", "pgf_rest",
     "tile_stencil_deepIfNS_7RestOutIfEEEEv",
     "tile_stencil_deepIdNS_7RestOutIdEEEEv"),
    ("tile_stencil_deep<T, PartsOut>", "fused_parts",
     "tile_stencil_deepIfNS_8PartsOutIfEEEEv",
     "tile_stencil_deepIdNS_8PartsOutIdEEEEv"),
    ("column_convection_deep", "convection", "column_convection_deepIfEEv",
     "column_convection_deepIdEEv"),
    # one form at every L
    ("column_four_band", "radiation", "column_four_bandIfEEv",
     "column_four_bandIdEEv"),
)


def phase_build():
    """Every source at once (one nvcc each), with ptxas' register counts;
    fails if a kernel of REDESIGNED (the pgf tile, the column-physics
    epilogue, the rest tile, K1's tiled launch and column pass) spills or
    keeps a stack frame of a per-layer array (32 values of its
    type)."""
    from gcmiipy_tpu_torch.ops import cuda_lib
    t = time.perf_counter()
    # a source whose code calls power has a float64 library of its own
    built = cuda_lib.build_many(sorted({cuda_lib.library_name(s, double)
                                        for s in SOURCES
                                        for double in (False, True)}))
    for name, (text, seconds) in built.items():
        entry = "?"
        for line in (text or "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log("build", f"{name} {entry}: {line.split(':', 1)[-1].strip()}")
        log("build", f"{name} {'built' if text is not None else 'found'} in "
                     f"{seconds:.1f}s")
    log("build", f"all sources in {time.perf_counter() - t:.1f}s "
                 f"({cuda_lib.BUILD_DIR})")
    for kernel, source, key_f, key_d in REDESIGNED:
        for dtype, key, size in (("float", key_f, 4), ("double", key_d, 8)):
            # each type from the library its tensors launch
            name = cuda_lib.library_name(source, dtype == "double")
            # a library found built is read from the log kept beside it
            text = built[name][0] or cuda_lib.build_log(name)
            if text is None:
                fail("build", f"{name} was found built without its compiler "
                              "log: no ptxas report to check")
            usage = ptxas_usage(text, key)
            log("build", f"{kernel} {dtype}: {usage['registers']} registers, "
                         f"{usage['stack']} bytes stack frame, "
                         f"{usage['spill_stores']} bytes spill stores, "
                         f"{usage['spill_loads']} bytes spill loads")
            if (usage["spill_stores"] or usage["spill_loads"]
                    or usage["stack"] >= 32 * size):
                fail("build", f"{kernel} {dtype} spills or keeps a per-layer "
                              "array on its stack")


def ptxas_usage(text, key):
    """Registers, stack frame and spills that ``ptxas -v`` printed for the
    entry function whose mangled name holds ``key``; fails if none."""
    usage, entry, props = None, "", ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Function properties for" in line:
            props = line.split("Function properties for")[1].strip()
        elif key in props and "stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            usage = dict(stack=nums[0], spill_stores=nums[1],
                         spill_loads=nums[2], registers="?")
        elif key in entry and "Used" in line and "registers" in line and usage:
            usage["registers"] = int(line.split("Used")[1].split()[0])
    if usage is None:
        fail("build", f"ptxas printed nothing for an entry holding {key}")
    return usage


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
            log("kernels", f"{tag}: max rel {rel:.3e} (bound {KERNEL_REL[dtype]:g}), "
                           f"equal to the bit: {bit_equal(out, ref)}")
            if not rel <= KERNEL_REL[dtype]:
                fail("kernels", tag + " disagrees with fused_parts_ref")
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
            if dtype == torch.float32:
                main_abs = max(main_abs, abs_err(out, ref))
    log("kernels", "fused_parts ok: max rel float32 "
                   f"{worst[torch.float32]:.3e}, float64 {worst[torch.float64]:.3e}")
    return main_abs


def fft_inputs(shape, dtype, device, planes=None):
    """Geometry, filter constants and the stacked [spu_raw; pg_phi] of a
    random state (seed 2), the filter stage's real input, cut to ``planes``
    planes when given."""
    from gcmiipy_tpu_torch.dynamics import core25d
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.ops.mega_step import build_filter_consts
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=dtype, device=device)
    s = random_state(geom, 2, device, dtype)
    X = torch.cat(core25d.pgf_forces(s[0], s[1], s[3], geom)[:2])
    if planes is not None:
        X = X[:planes].contiguous()
    return geom, build_filter_consts(geom), X


def fields(X, L):
    """The fields of a stack, each held to its own scale: the spu_raw
    planes and the pg_phi planes of 2L planes, else the whole stack."""
    return [X[:L], X[L:]] if X.shape[0] == 2 * L else [X]


def phase_kernels_fft(device):
    """The FFT filter stage alone against its plain version (the same plan
    and pairing in complex128) and against the TPU kernels' banded DFT form
    (banded_filter_ref), on the stacked forces of a random state and on
    standard-normal planes of the same shape: float32 and float64 at the
    main path's shape (the register-tiled path) and at 3x128x384 (the
    general path, radices 4, 2 and 3), float64 at 3x24x36 (radix 3),
    3x20x100 (radix 5), 2x16x37 (a prime) and an odd plane count."""
    from gcmiipy_tpu_torch.ops import fft_filter as ff
    from gcmiipy_tpu_torch.ops.mega_step import banded_round
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    cases = [(main_shape, torch.float32, None),
             (main_shape, torch.float64, None),
             ((3, 128, 384), torch.float32, None),
             ((3, 128, 384), torch.float64, None),
             ((3, 24, 36), torch.float64, None),
             ((3, 20, 100), torch.float64, None),
             ((2, 16, 37), torch.float64, None),
             ((3, 24, 36), torch.float64, 5)]
    worst, main_abs = {}, 0.0
    for shape, dtype, planes in cases:
        geom, fc, forces = fft_inputs(shape, dtype, device, planes)
        normal = torch.as_tensor(np.random.default_rng(shape[2]).standard_normal(
            tuple(forces.shape))).to(device=device, dtype=dtype)
        L = shape[0] if forces.shape[0] == 2 * shape[0] else forces.shape[0]
        banded = banded_round(geom)
        for name, X in (("forces", forces), ("normal planes", normal)):
            out = ff.fft_filter(X.clone(), fc)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail("kernels", "fft_filter output not finite")
            plain = {"FFT plan": ff.fft_filter_ref(X, fc),
                     "banded DFT": banded(X)}
            tag = (f"fft_filter {name} {tuple(X.shape)} {str(dtype)[6:]} "
                   f"plan {ff.radix_plan(shape[2])}, {int(fc.lats.numel())} "
                   f"of {shape[1]} latitudes, moved by rel "
                   f"{rel_err(fields(out, L), fields(X, L)):.3e}")
            rel, err = held_to_plain(
                tag, fields(out, L),
                {n: fields(y, L) for n, y in plain.items()}, FFT_REL[dtype],
                FFT_REL[dtype] if dtype == torch.float32
                or name == "normal planes" else BANDED_REL64)
            worst[dtype] = max(worst.get(dtype, 0.0), rel)
            if dtype == torch.float32 and name == "forces":
                main_abs = max(main_abs, err)
    log("kernels", "fft_filter ok, max rel held: float32 "
                   f"{worst[torch.float32]:.3e}, float64 {worst[torch.float64]:.3e}")
    return main_abs


def held_to_plain(tag, out, plain, bound, banded_bound):
    """Hold a kernel's output (a list of fields) against its plain
    versions: ``plain`` maps a name to their outputs, first the plain
    version with the kernel's FFT plan (fft_filter_ref), held within
    ``bound``, then those with the TPU kernels' banded DFT, held within
    ``banded_bound``: ``bound`` at float32 and on fields of no polar
    cancellation, BANDED_REL64 at float64 on the stacked forces and the
    fields after them, where the banded DFT's own float64 rounding on the
    cancelling polar rows reaches 1e-12 of the filtered field's scale and
    1e-11 of u's after a half step at width 1024, while the FFT plan stays
    within 1e-13 of a long-double DFT (tests/test_torch_fft_filter.py).
    Returns the largest relative and absolute errors."""
    rels = {name: rel_err(out, ref) for name, ref in plain.items()}
    bounds = {name: bound if n == 0 else banded_bound
              for n, name in enumerate(rels)}
    log("kernels", f"{tag}: max rel " + ", ".join(
        f"{r:.3e} against the plain version with the {name} (bound "
        f"{bounds[name]:g})" for name, r in rels.items()))
    if not all(rels[name] <= bounds[name] for name in rels):
        fail("kernels", tag + " disagrees with its plain version")
    return (max(rels.values()),
            max(abs_err(out, ref) for ref in plain.values()))


def fft_plan(fc):
    """The filter round of the kernels' FFT plan (fft_filter_ref) with the
    constants ``fc``, as a plain version's ``filter_ref``."""
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter_ref
    return lambda X: fft_filter_ref(X, fc)


def banded_bound(dtype, bound):
    """The bound of a K5/K6/K7 output against the plain version with the
    banded DFT: ``bound`` at float32, BANDED_REL64 at float64."""
    return bound if dtype == torch.float32 else BANDED_REL64


def k6_inputs(shape, dtype, hill, device):
    """Geometry, the K6 step (:class:`MegaStep`) and a random state."""
    from gcmiipy_tpu_torch.grid import geometry
    L, H, W = shape
    hm = None
    if hill:
        hm = np.zeros((H, W))
        hm[H // 4:H // 2, W // 8:W // 3] = 1500.0
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=dtype, device=device)
    return geom, random_state(geom, 2, device, dtype)


def phase_kernels_k6(device):
    """K6 against its plain version after one call: float32 at the main
    path's shape (flat without Coriolis; hill with Coriolis; the q limiter),
    float64 at 3x24x36 (rows of 0 and 1 chunk, and the q limiter) and at
    3x512x1024 (128 rows each of 1, 2, 3 and 4 chunks)."""
    from gcmiipy_tpu_torch.ops import polar_filter
    from gcmiipy_tpu_torch.ops.mega_step import MegaStep, mega_step_ref
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    cases = [(main_shape, torch.float32, False, False, False),
             (main_shape, torch.float32, True, False, True),
             (main_shape, torch.float32, False, True, False),
             ((3, 24, 36), torch.float64, False, False, False),
             ((3, 24, 36), torch.float64, True, True, True),
             ((3, 512, 1024), torch.float64, True, False, True)]
    worst = {}
    main_abs = 0.0
    for shape, dtype, coriolis, q_limiter, hill in cases:
        geom, state = k6_inputs(shape, dtype, hill, device)
        step = MegaStep(geom, MAIN["dt"], coriolis=coriolis,
                        q_limiter=q_limiter)
        out = step(*state)
        torch.cuda.synchronize()
        plain = {name: mega_step_ref(*state, MAIN["dt"], geom, step.consts,
                                     coriolis=coriolis, q_limiter=q_limiter,
                                     filter_ref=filter_ref)
                 for name, filter_ref in (("FFT plan", fft_plan(step.consts)),
                                          ("banded DFT", None))}
        if any(tuple(a.shape) != tuple(b.shape)
               for a, b in zip(out, plain["FFT plan"])):
            fail("kernels", "mega_step output shapes differ")
        if not all(torch.isfinite(a).all() for a in out):
            fail("kernels", "mega_step output not finite")
        if not bool((out[2][:, -1] == 0).all()):
            fail("kernels", "mega_step: v not 0 on the wall row")
        chunks = np.bincount(polar_filter.band_chunk_counts(geom.polar_mask))
        tag = (f"mega_step {tuple(shape)} {str(dtype)[6:]} coriolis={coriolis}"
               f" q_limiter={q_limiter} hill={hill} (rows by chunk count "
               f"{chunks.tolist()})")
        rel, err = held_to_plain(tag, out, plain, MEGA_REL[dtype],
                                 banded_bound(dtype, MEGA_REL[dtype]))
        worst[dtype] = max(worst.get(dtype, 0.0), rel)
        if dtype == torch.float32:
            main_abs = max(main_abs, err)
    log("kernels", "mega_step ok, max rel held: float32 "
                   f"{worst[torch.float32]:.3e}, float64 {worst[torch.float64]:.3e}")
    return main_abs


def k7_inputs(shape, dtype, physics, device, utc0=3.1e4, seed=2, **kw):
    """Geometry, the K7 module (:class:`StreamSteps`) with the physics of
    ``PHYSICS`` (when ``physics``), the packed buffer of a random state
    (with a ground-temperature plane from ``seed``) and the clock."""
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.ops import stream_steps as ss
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=dtype, device=device)
    gt = None
    if physics:
        rng = np.random.default_rng(seed + 50)
        gt = torch.as_tensor(290.0 + 20.0 * rng.random((H, W))).to(
            device=device, dtype=dtype)
    packed = ss.pack_state(*random_state(geom, seed, device, dtype), gt=gt)
    S = torch.stack([packed, torch.zeros_like(packed)])
    phys = (ss.make_physics(geom, **{"drag_tau": PHYSICS["drag_tau"],
                                     "convection": PHYSICS["convection"],
                                     **kw})
            if physics else None)
    step = ss.StreamSteps(geom, MAIN["dt"], physics=phys)
    return geom, step, S, torch.tensor(utc0, dtype=dtype, device=device)


def _planes(S, L):
    """p, u, v, t, q (and the ground temperature) of buffer 0."""
    from gcmiipy_tpu_torch.ops import stream_steps as ss
    extra = (S[0, ss.n_planes(L)],) if S.shape[1] > ss.n_planes(L) else ()
    return ss.unpack_state(S[0], L) + extra


def phase_kernels_k7(device):
    """K7 against its plain version after one call of k steps: float32 at
    the main path's shape with the physics (k=4, with and without the
    convection) and without it (k=2), and float64 at 3x24x36 (seasonal
    clock) and 3x512x1024, and every stage in its deep form at 40 layers
    (float32 on the main grid, float64 at 40x24x36 with the seasonal
    clock), every field and the ground temperature held to its own
    scale."""
    from gcmiipy_tpu_torch.ops.stream_steps import stream_steps_ref
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    cases = [(main_shape, torch.float32, True, 4, {}),
             (main_shape, torch.float32, True, 4, {"convection": False}),
             (main_shape, torch.float32, False, 2, {}),
             ((3, 24, 36), torch.float64, True, 4, {"seasonal": True}),
             ((3, 24, 36), torch.float64, False, 2, {}),
             ((3, 512, 1024), torch.float64, True, 4, {}),
             (DEEP_GRIDS[0], torch.float32, True, 4, {}),
             (DEEP_GRIDS[1], torch.float64, True, 4, {"seasonal": True})]
    worst, main_abs = {}, 0.0
    for shape, dtype, physics, k, kw in cases:
        geom, step, S, utc0 = k7_inputs(shape, dtype, physics, device, **kw)
        out = step(S.clone(), utc0, k)
        torch.cuda.synchronize()
        got = _planes(out, shape[0])
        plain = {name: _planes(stream_steps_ref(
                     S.clone(), utc0, k, MAIN["dt"], geom, step.consts,
                     physics=step.physics, filter_ref=filter_ref), shape[0])
                 for name, filter_ref in (("FFT plan", fft_plan(step.consts)),
                                          ("banded DFT", None))}
        if not all(torch.isfinite(a).all() for a in got):
            fail("kernels", "stream_steps output not finite")
        if not bool((got[2][:, -1] == 0).all()):
            fail("kernels", "stream_steps: v not 0 on the wall row")
        moved = rel_err(got, _planes(S, shape[0]))
        tag = (f"stream_steps {tuple(shape)} {str(dtype)[6:]} k={k} "
               f"physics={physics}{' ' + str(kw) if kw else ''} over p,u,v,"
               f"t,q{',gt' if physics else ''}, the call moving the state "
               f"by rel {moved:.3e}")
        rel, err = held_to_plain(tag, got, plain, STREAM_REL[dtype],
                                 banded_bound(dtype, STREAM_REL[dtype]))
        worst[dtype] = max(worst.get(dtype, 0.0), rel)
        if shape == main_shape and dtype == torch.float32 and physics \
                and not kw:
            main_abs = err
    log("kernels", "stream_steps ok, max rel held: float32 "
                   f"{worst[torch.float32]:.3e}, float64 {worst[torch.float64]:.3e}")
    return main_abs


def k3k4_inputs(shape, dtype, hill, device):
    """Geometry, base and evaluated states (seeds 0 and 1, as K1's), and the
    evaluated state's stack and pg_phiv from K3's plain version with the
    FFT filter applied to the stack: K4's inputs."""
    from gcmiipy_tpu_torch.ops import polar_filter
    from gcmiipy_tpu_torch.ops.pgf_rest import pgf_parts_ref
    geom, args = k1_inputs(shape, dtype, hill, device)
    base, seval = args[:5], args[5:10]
    stack, pg_phiv = pgf_parts_ref(seval[0], seval[1], seval[3], geom)
    return geom, base, seval, polar_filter.arakawa_1977(stack, geom), pg_phiv


# Grids off every tile multiple (32 columns, 8 rows a tile), smaller than
# one tile, and 32 layers; then the deep column: 40 layers on the main
# grid and off the tiles, kMaxLayers off the tiles.  Over these grids each
# column kernel launches both of its forms (csrc/gcm_limits.cuh), but the
# rest tile's held form at float64, which no L launches
EDGE_GRIDS = ((9, 24, 36), (3, 20, 100), (1, 2, 36), (32, 16, 128))
DEEP_GRIDS = ((40, 512, 1024), (40, 24, 36), (64, 16, 100))


def _bits(tag, out, ref, counter, before):
    """Fail unless the kernel's outputs equal its plain version's to the
    bit and its stage launched once (``counter.launches`` from
    ``before``)."""
    if counter.launches != before + 1:
        fail("kernels", f"{tag}: launched {counter.launches - before} times")
    if any(tuple(a.shape) != tuple(b.shape) for a, b in zip(out, ref)):
        fail("kernels", f"{tag}: output shapes differ")
    if not all(torch.isfinite(a).all() for a in out):
        fail("kernels", f"{tag}: output not finite")
    if not bit_equal(out, ref):
        differ = [int((a != b).sum()) for a, b in zip(out, ref)]
        fail("kernels", f"{tag}: not equal to its plain version to the bit "
                        f"(max rel {rel_err(out, ref):.3e}; {differ} "
                        "elements differ)")


def phase_kernels_bits(device):
    """The tiled kernels against their plain versions bit for bit, at the
    main path's shape and on the edge grids, float32 and float64 (whose
    libraries take PyTorch's rounding of double pow, csrc/gcm_pow.cu),
    flat and with a hill: K3 (the pgf tile of K3 and K5-K7), K4 (the rest
    tile of K4-K7, aflux in its prologue) and K1 (its column pass, then its
    tiled launch with the aflux prologue) with Coriolis and the q limiter,
    and K1's column pass alone.  Returns the float32 errors by op on the
    main shape and on DEEP_GRIDS[0], as measured (all 0 when it passes)."""
    from gcmiipy_tpu_torch.dynamics import core25d
    from gcmiipy_tpu_torch.ops import fused_parts as fp, polar_filter
    from gcmiipy_tpu_torch.ops.pgf_rest import (
        pgf_parts, pgf_parts_ref, pgf_tile, rest_parts, rest_parts_ref,
        rest_stencil)
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    flags = dict(coriolis=True, q_limiter=True)
    cases, errors = 0, {main_shape: {}, DEEP_GRIDS[0]: {}}
    for shape in (main_shape,) + EDGE_GRIDS + DEEP_GRIDS:
        for dtype in (torch.float32, torch.float64):
            for hill in (False, True):
                geom, base, seval, filt, pg_phiv = k3k4_inputs(
                    shape, dtype, hill, device)
                spu = polar_filter.arakawa_1977(
                    core25d.calc_pu(seval[0], seval[1]), geom)
                sp, su, st = seval[0], seval[1], seval[3]
                tag = f"{tuple(shape)} {str(dtype)[6:]} hill={hill}"
                outs = {}
                before = pgf_tile.launches
                out = pgf_parts(sp, su, st, geom)
                torch.cuda.synchronize()
                outs["pgf_parts"] = out, pgf_parts_ref(sp, su, st, geom)
                _bits(f"pgf_parts {tag}", *outs["pgf_parts"], pgf_tile, before)
                before = rest_stencil.launches
                k4_args = (*base, *seval, filt, pg_phiv, MAIN["dt"], geom)
                out = rest_parts(*k4_args, **flags)
                torch.cuda.synchronize()
                outs["rest_parts"] = out, rest_parts_ref(*k4_args, **flags)
                _bits(f"rest_parts {tag}", *outs["rest_parts"], rest_stencil,
                      before)
                before = fp.parts_stencil.launches, fp.column_pass.launches
                k1_args = (*base, *seval, spu, MAIN["dt"], geom)
                out = fp.fused_parts(*k1_args, **flags)
                torch.cuda.synchronize()
                outs["fused_parts"] = out, fp.fused_parts_ref(*k1_args, **flags)
                _bits(f"fused_parts {tag}", *outs["fused_parts"],
                      fp.parts_stencil, before[0])
                if fp.column_pass.launches != before[1] + 1:
                    fail("kernels", f"fused_parts {tag}: column pass launched "
                                    f"{fp.column_pass.launches - before[1]} "
                                    "times")
                before = fp.column_pass.launches
                out = fp.pgf_column(sp, st, geom)
                torch.cuda.synchronize()
                outs["pgf_column"] = out, core25d.pgf_column(sp, st, geom)
                _bits(f"pgf_column {tag}", *outs["pgf_column"], fp.column_pass,
                      before)
                if shape in errors and dtype == torch.float32:
                    for name, (o, r) in outs.items():
                        errors[shape][name] = max(
                            errors[shape].get(name, 0.0), abs_err(o, r))
                cases += 1
    log("kernels", f"pgf_parts (the pgf tile), rest_parts (the rest tile), "
                   f"fused_parts and pgf_column (K1's column pass) equal their "
                   f"plain versions to the bit in {cases} cases each: "
                   f"{main_shape} and "
                   f"{', '.join(map(str, EDGE_GRIDS + DEEP_GRIDS))}, "
                   "float32 and float64, flat and with a hill")
    return errors[main_shape], errors[DEEP_GRIDS[0]]


def physics_inputs(shape, dtype, device, seed=2, **kw):
    """Geometry, a random state's p, u, v, t, a ground temperature from
    ``seed``, the clock and the epilogue's parameters (the main path's
    convection and drag, updated by ``kw``)."""
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.ops import stream_steps as ss
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=dtype, device=device)
    p, u, v, t, _ = random_state(geom, seed, device, dtype)
    rng = np.random.default_rng(seed + 50)
    gt = torch.as_tensor(290.0 + 20.0 * rng.random((H, W))).to(
        device=device, dtype=dtype)
    ph = ss.make_physics(geom, **{"drag_tau": PHYSICS["drag_tau"],
                                  "convection": PHYSICS["convection"], **kw})
    return geom, (p, u, v, t, gt), torch.tensor(3.1e4, dtype=dtype,
                                                device=device), ph


def phase_kernels_physics(device):
    """The column-physics epilogue alone (K7's last launch a step) against
    physics_epilogue_ref: float32 at the main path's shape with the main
    path's convection and drag and with neither, float64 at 3x24x36 with
    the seasonal clock, at 9x512x1024 and at 32x16x128; the deep form at
    40x512x1024 at both types and at kMaxLayers (64x16x128, float64, the
    largest block).  The
    same operations in the same order, so only pow/log/sin/cos ulps
    differ: held within EPILOGUE_REL, each case moving t (and u with the
    drag) by EPILOGUE_MOVE times that bound or more.  Returns the float32
    errors with the main path's physics on the main shape and on
    DEEP_GRIDS[0]."""
    from gcmiipy_tpu_torch.ops.stream_steps import (
        column_physics, physics_epilogue_ref)
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    cases = [(main_shape, torch.float32, {}),
             (main_shape, torch.float32, {"convection": False,
                                          "drag_tau": 0.0}),
             ((3, 24, 36), torch.float64, {"seasonal": True}),
             (main_shape, torch.float64, {}),
             ((32, 16, 128), torch.float64, {}),
             (DEEP_GRIDS[0], torch.float32, {}),
             (DEEP_GRIDS[0], torch.float64, {}),
             ((64, 16, 128), torch.float64, {})]
    worst, errors = {}, {}
    for shape, dtype, kw in cases:
        geom, (p, u, v, t, gt), utc, ph = physics_inputs(shape, dtype, device,
                                                         **kw)
        before = column_physics.launches
        out = column_physics(p, u, v, t, gt, utc, geom, MAIN["dt"], ph)
        torch.cuda.synchronize()
        ref = physics_epilogue_ref(p, u, v, t, gt, utc, geom, MAIN["dt"], ph)
        bound = EPILOGUE_REL[dtype]
        moved = {"t": rel_err([ref[2]], [t])}
        if ph.drag_tau:
            moved["u"] = rel_err([ref[0]], [u])
        tag = (f"column_physics {tuple(shape)} {str(dtype)[6:]}"
               f"{' ' + str(kw) if kw else ''} over u,v,t,gt, moving "
               + ", ".join(f"{k} by rel {x:.3e}" for k, x in moved.items()))
        for name, x in moved.items():
            if not x >= EPILOGUE_MOVE * bound:
                fail("kernels", f"{tag}: the plain version moves {name} by "
                                f"less than {EPILOGUE_MOVE:g} times the bound "
                                f"{bound:g}; the case cannot tell a fault")
        if column_physics.launches != before + 1:
            fail("kernels", f"{tag}: launched "
                            f"{column_physics.launches - before} times")
        if any(tuple(a.shape) != tuple(b.shape) for a, b in zip(out, ref)):
            fail("kernels", f"{tag}: output shapes differ")
        if not all(torch.isfinite(a).all() for a in out):
            fail("kernels", f"{tag}: output not finite")
        rel = rel_err(out, ref)
        log("kernels", f"{tag}: max rel {rel:.3e} (bound {bound:g}), "
                       f"equal to the bit: {bit_equal(out, ref)}")
        if not rel <= bound:
            fail("kernels", f"{tag}: disagrees with physics_epilogue_ref")
        worst[dtype] = max(worst.get(dtype, 0.0), rel)
        if dtype == torch.float32 and not kw:
            errors[shape] = abs_err(out, ref)
    log("kernels", "column_physics ok, max rel: float32 "
                   f"{worst[torch.float32]:.3e}, float64 {worst[torch.float64]:.3e}")
    return errors[main_shape], errors[DEEP_GRIDS[0]]


def convection_field(shape, dtype, device, seed=3):
    """(tt, tp, dp) of the adaptive convection on the Manabe ladder: warm,
    noisy lower layers (many superadiabatic pairs, up to 2L sweeps) in
    every other column, isothermal columns (no unstable pair) between."""
    from gcmiipy_tpu_torch.grid import geometry
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(seed)
    p = 1e5 * (1 + 0.01 * torch.randn((H, W), generator=g,
                                      dtype=torch.float64))
    tt = 280.0 + 8.0 * torch.randn((L, H, W), generator=g,
                                   dtype=torch.float64)
    tt[:3] += torch.tensor([40.0, 20.0, 8.0], dtype=torch.float64)[:, None,
                                                                    None]
    tt[:, :, 1::2] = 250.0
    tp = p * geom.sig.reshape(L, 1, 1) + geom.ptop
    dp = p * geom.dsig.reshape(L, 1, 1)
    return tuple(x.to(dtype=dtype, device=device) for x in (tt, tp, dp))


def phase_convection(device, launches=None, deep_launches=None):
    """The adaptive convection's kernel (ops/convection.py, one launch a
    call) against its plain loop run on the card (``on_card`` turned off:
    a host read a sweep), to the bit at float32 and float64 on the main
    grid, on GCM-II's 9x24x36, at 40 layers on the main grid
    (DEEP_GRIDS[0]) and on 24x36 and at kMaxLayers on 24x36, with its
    largest sweep count the plain loop's sweeps; then the float32 calls of
    the main grid and of DEEP_GRIDS[0] timed against the plain loop.
    Returns the kernels table's two rows, with ``launches``: the kernel's
    launches on the main path (phase surface's count), and
    ``deep_launches['column_adjustment']``: phase deep's float32 count
    (None where a phase did not run)."""
    from gcmiipy_tpu_torch.ops import convection as cv
    from gcmiipy_tpu_torch.physics.convection import convective_adjustment
    from gcmiipy_tpu_torch.step_profile import kernel_ms

    def plain(tt, tp, dp):
        saved, cv.on_card = cv.on_card, lambda tt: False
        try:
            return convective_adjustment(tt, tp, dp)
        finally:
            cv.on_card = saved

    def plain_sweeps(tt, tp, dp):
        """The plain loop's field and its sweeps (a host read each)."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            out = plain(tt, tp, dp)
        return out, sum(e.name == "aten::_local_scalar_dense"
                        for e in prof.events())

    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    errors = {}
    for shape in (main_shape, (9, 24, 36), DEEP_GRIDS[0], DEEP_GRIDS[1],
                  (64, 24, 36)):
        for dtype in (torch.float32, torch.float64):
            tt, tp, dp = convection_field(shape, dtype, device)
            ref, sweeps = plain_sweeps(tt, tp, dp)
            cv.sweeps_max(device, reset=True)
            before = cv.column_adjustment.launches
            out = convective_adjustment(tt, tp, dp)
            most = cv.sweeps_max(device, reset=True)
            tag = (f"convection {shape} {str(dtype)[6:]}: {sweeps} sweeps "
                   f"of the plain loop, {most} the most a column ran")
            if cv.column_adjustment.launches != before + 1:
                fail("kernels", f"{tag}: launched "
                                f"{cv.column_adjustment.launches - before} "
                                "times")
            errors[shape, dtype] = abs_err([out], [ref])
            if not torch.equal(out, ref) or most != sweeps:
                fail("kernels", f"{tag}: differs from the plain loop by "
                                f"{errors[shape, dtype]:.3e}")
            log("kernels", f"{tag}, equal to the bit")
    rows = []
    for shape, counted in ((main_shape, launches),
                           (DEEP_GRIDS[0], (deep_launches or {}).get(
                               "column_adjustment"))):
        tt, tp, dp = convection_field(shape, torch.float32, device)
        call = lambda: convective_adjustment(tt, tp, dp)  # noqa: E731
        ms = cuda_ms(call, 50)
        plain_ms = cuda_ms(lambda: plain(tt, tp, dp), 3)
        L, H, W = shape
        # the call reads tt, tp and dp and writes its result; the launch
        # alone reads tt, dp and the two tables and writes the result
        nbytes, launch_bytes = 4 * L * H * W * 4, (5 * L - 2) * H * W * 4
        log("timing", f"convection {shape} launch alone: "
                      f"{launch_bytes / 1e6:.1f} MB -> "
                      f"{1e3 * launch_bytes / HBM_BYTES_PER_S:.4f} ms")
        rows.append(_row(
            "column_convection" if shape == main_shape
            else f"column_convection {shape}",
            "gcmiipy_tpu_torch/csrc/convection.cu",
            "none (gcmiipy_tpu/physics/convection.py, lax.while_loop)",
            counted, errors[shape, torch.float32], ms, plain_ms, nbytes, {},
            None, f"convection {shape} float32", launch_ms=kernel_ms(call)))
        del tt, tp, dp
    return rows


def radiation_inputs(shape, dtype, device, seed=5):
    """The arguments of the four-band radiation's block, (p, tt, q, gt,
    albedo, utc, dt, geom, t_sw): noisy true temperatures of 200-300 K, q
    of up to 0.02 (the strong water-vapour band opaque where it is high),
    the ground 280-310 K, an albedo field (the land cover's blend over a
    land fraction running 0 to 1 along each row), the clock a 0-dim
    tensor that leaves about half the longitudes in the night, and Config
    S's dt and t_sw."""
    import dataclasses
    from gcmiipy_tpu_torch.grid import geometry
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 ptop=10.0 if L > 9 else 0.0,
                                 dtype=torch.float64, device="cpu")
    geom = dataclasses.replace(geom, land_fraction=torch.linspace(
        0, 1, W, dtype=torch.float64).expand(H, W).contiguous())
    g = torch.Generator().manual_seed(seed)

    def rand(*size):
        return torch.rand(size, generator=g, dtype=torch.float64)

    p = 1e5 * (1 + 0.01 * (2 * rand(H, W) - 1))
    tt, q = 200.0 + 100.0 * rand(L, H, W), 0.02 * rand(L, H, W) ** 2
    gt = 280.0 + 30.0 * rand(H, W)
    f_land = geom.land_fraction
    albedo = 0.3 * (1.0 - f_land) + 0.35 * f_land
    utc = torch.tensor(3.1e4, dtype=torch.float64)
    return (*(x.to(dtype=dtype, device=device)
              for x in (p, tt, q, gt, albedo, utc)),
            SURFACE["physics_every"] * MAIN["dt"],
            geom.to(dtype=dtype, device=device), 0.9)


def phase_radiation(device, launches=None):
    """The four-band radiation's kernel (ops/radiation.py, one launch a
    call: the radiation and both updates) against the plain function and
    the updates on the card, within RADIATION_REL of each field's scale,
    at float32 and float64 on the main grid, on GCM-II's 9x24x36 and at
    40 layers on the main grid (float32) and on 64x128 (float64), with no
    host read; then the main grid's float32 call timed against the plain
    block.  Returns the kernels table's row, with ``launches``: the
    kernel's launches on the main path (phase surface's count; None where
    it did not run)."""
    from gcmiipy_tpu_torch.ops import radiation as rop
    from gcmiipy_tpu_torch.physics.radiation import four_band_radiation
    from gcmiipy_tpu_torch.step_profile import kernel_ms

    def plain(p, tt, q, gt, albedo, utc, dt, geom, t_sw):
        dt_air, dt_ground = four_band_radiation(p, None, tt, q, gt, t_sw,
                                                albedo, utc, geom)
        return tt + dt_air * dt, gt + dt_ground * dt

    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    errors = {}
    for shape, dtype in ((main_shape, torch.float32),
                         (main_shape, torch.float64),
                         ((9, 24, 36), torch.float32),
                         ((9, 24, 36), torch.float64),
                         (DEEP_GRIDS[0], torch.float32),
                         ((DEEP["layers"],) + DEEP["f64_grid"], torch.float64)):
        args = radiation_inputs(shape, dtype, device)
        ref = plain(*args)
        rop.four_band_column(*args)  # build and load
        torch.cuda.synchronize()
        before = rop.four_band_column.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            out = rop.four_band_column(*args)
            torch.cuda.synchronize()
        reads = sum(e.name == "aten::_local_scalar_dense"
                    for e in prof.events())
        rel = rel_err(out, ref)
        moved = rel_err(ref, (args[1], args[3]))
        errors[shape, dtype] = abs_err(out, ref)
        tag = f"four-band radiation {shape} {str(dtype)[6:]}"
        log("kernels", f"{tag}: rel {rel:.3e} (bound "
                       f"{RADIATION_REL[dtype]:g}), max abs "
                       f"{errors[shape, dtype]:.3e}, the update moves the "
                       f"fields by rel {moved:.3e}, {reads} host reads, "
                       f"equal to the bit: {bit_equal(out, ref)}")
        if rop.four_band_column.launches != before + 1 or reads:
            fail("kernels", f"{tag}: {rop.four_band_column.launches - before}"
                            f" launches and {reads} host reads a call")
        if not rel <= RADIATION_REL[dtype] or not moved > EPILOGUE_MOVE * (
                RADIATION_REL[dtype]):
            fail("kernels", f"{tag} disagrees with the plain function")
        del args, ref, out
    args = radiation_inputs(main_shape, torch.float32, device)
    call = lambda: rop.four_band_column(*args)  # noqa: E731
    ms = cuda_ms(call, 50)
    plain_ms = cuda_ms(lambda: plain(*args), 10)
    L, H, W = main_shape
    # reads tt, q, p, gt and the albedo; writes tt and gt
    nbytes = (3 * L + 4) * H * W * 4
    return [_row("column_four_band", "gcmiipy_tpu_torch/csrc/radiation.cu",
                 "none (gcmiipy_tpu/physics/radiation.py:four_band_radiation"
                 ", plain jnp)", launches, errors[main_shape, torch.float32],
                 ms, plain_ms, nbytes, {}, None,
                 f"four-band radiation {main_shape} float32",
                 launch_ms=kernel_ms(call))]


def _deep_start(geom, cfg):
    """The reference's start (360 K at rest, stable: the adaptive
    convection of 'xla' and the epilogue's four sweeps adjust nothing)
    with smooth winds of 1 m/s and a 0.5 K wave in t, as the benchmark's
    members have, so that u and v have a scale that rounding does not
    set."""
    from gcmiipy_tpu_torch.model import driver
    state = driver.gen_model_state(geom, cfg)
    lat, lon = geom.lat.reshape(-1, 1), geom.long.reshape(1, -1)
    prog = state.prog
    return state._replace(prog=prog._replace(
        u=prog.u + torch.cos(lat) * torch.cos(2 * lon),
        v=prog.v + torch.cos(lat) * torch.sin(3 * lon),
        t=prog.t + 0.5 * torch.sin(lon + 2 * lat)))


def phase_deep(device):
    """The deep column through make_run_fn on every backend of BACKENDS
    (DEEP: 40 layers, 10 Pa top, the per-step physics), float32 on the main
    grid and float64 on DEEP's, from :func:`_deep_start`, guard clean,
    each held to 'xla' at its type; the launches of the pgf tile, the rest
    tile, K1's tiled launch, the epilogue and the adaptive convection
    counted where the C entries make them (the per-step physics of every
    backend but 'stream' launches the convection once a step, K7's
    epilogue runs its fixed sweeps instead).  Returns the float32 runs'
    launches by kernel: the stream run's, and the convection's from the
    mega4 run."""
    from gcmiipy_tpu_torch.model import driver
    from gcmiipy_tpu_torch.model.config import BACKENDS, ModelConfig
    from gcmiipy_tpu_torch.ops import convection as cv
    from gcmiipy_tpu_torch.ops import fused_parts as fp, pgf_rest as pr
    from gcmiipy_tpu_torch.ops import stream_steps as ss
    kernels = {"pgf_tile": pr.pgf_tile, "rest_stencil": pr.rest_stencil,
               "parts_stencil": fp.parts_stencil,
               "column_physics": ss.column_physics,
               "column_adjustment": cv.column_adjustment}
    steps, counted = DEEP["steps"], {}
    for dtype, (H, W) in (("float32", (MAIN["height"], MAIN["width"])),
                          ("float64", DEEP["f64_grid"])):
        outs = {}
        for backend in BACKENDS:
            cfg = ModelConfig(height=H, width=W, layers=DEEP["layers"],
                              ptop=DEEP["ptop"], dt=MAIN["dt"],
                              backend=backend, dtype=dtype, guard=True,
                              stream_steps=DEEP["steps"], **PHYSICS)
            geom = driver.gen_model_geometry(cfg, device)
            state = _deep_start(geom, cfg)
            run = driver.make_run_fn(geom, cfg, steps)
            (st, stats, guard), counts = _counted(
                kernels.values(), lambda: run(state))
            tag = f"deep {DEEP['layers']}x{H}x{W} {dtype} {backend}"
            if not bool(guard.ok):
                fail("deep", f"{tag}: guard tripped at step "
                             f"{int(guard.blown_step)}")
            out = tuple(st.prog) + (st.ground.gt,)
            if not all(torch.isfinite(x).all() for x in out):
                fail("deep", f"{tag}: not finite")
            launched = dict(zip(kernels, counts))
            want = {"xla": {"column_adjustment": steps},
                    "fused": {"parts_stencil": 2 * steps,
                              "column_adjustment": steps},
                    "mega": {"pgf_tile": 2 * steps, "rest_stencil": 2 * steps,
                             "column_adjustment": steps},
                    "mega4": {"pgf_tile": 2 * steps,
                              "rest_stencil": 2 * steps,
                              "column_adjustment": steps},
                    "stream": {"pgf_tile": 2 * steps,
                               "rest_stencil": 2 * steps,
                               "column_physics": steps}}[backend]
            if launched != {k: want.get(k, 0) for k in kernels}:
                fail("deep", f"{tag}: launches {launched}, expected {want}")
            outs[backend] = out
            counted[dtype, backend] = launched
            log("deep", f"{tag}: guard clean, launches {launched}")
        bound = RUN_REL if dtype == "float32" else DEEP_REL64
        for backend, out in outs.items():
            rel = rel_err(out, outs["xla"])
            log("deep", f"{DEEP['layers']}x{H}x{W} {dtype} {backend} against "
                        f"xla: max rel {rel:.3e} (bound {bound:g})")
            if not rel <= bound:
                fail("deep", f"{backend} {dtype} departs from xla")
    return {**counted["float32", "stream"], "column_adjustment":
            counted["float32", "mega4"]["column_adjustment"]}


def timing_deep(device, launches, max_abs):
    """The rows of the kernels whose work a column's depth sets, at
    40x512x1024 float32 (DEEP_GRIDS[0]) in the forms their C entries
    launch there: the pgf tile (K3's launch), the rest tile (K4's) and the
    epilogue (in place, as K7 launches it), on the inputs of the bit and
    epilogue checks, with the launches of phase deep's float32 stream run
    and ``max_abs``, the errors the bit and epilogue checks measured there
    (by op: pgf_parts, rest_parts, column_physics)."""
    from gcmiipy_tpu_torch.ops.fused_parts import GEOM_FIELDS
    from gcmiipy_tpu_torch.ops.pgf_rest import (
        pgf_parts, pgf_parts_ref, rest_parts, rest_parts_ref)
    from gcmiipy_tpu_torch.ops.stream_steps import (
        column_physics_inplace, physics_epilogue_ref, physics_table)
    from gcmiipy_tpu_torch.step_profile import kernel_ms
    shape, dt, rows = DEEP_GRIDS[0], MAIN["dt"], []
    geom, base, seval, filt, pg_phiv = k3k4_inputs(shape, torch.float32,
                                                   False, device)
    geo = [getattr(geom, n) for n in GEOM_FIELDS]
    k3 = (seval[0], seval[1], seval[3], geom)
    outs = pgf_parts_ref(*k3)
    rows.append(_row(
        f"pgf_parts {shape}",
        "gcmiipy_tpu_torch/csrc/pgf_tile.cuh",
        "gcmiipy_tpu/ops/pallas_stencil.py:398", launches["pgf_tile"],
        max_abs["pgf_parts"],
        cuda_ms(lambda: pgf_parts(*k3), 50),
        cuda_ms(lambda: pgf_parts_ref(*k3), 5),
        _bytes((*k3[:3], *geo, *outs)),
        {torch.float32: count_ops(pgf_parts_ref, *k3)}, None,
        f"pgf_parts {shape}", launch_ms=kernel_ms(lambda: pgf_parts(*k3))))
    k4 = (*base, *seval, filt, pg_phiv, dt, geom)
    outs = rest_parts_ref(*k4)
    rows.append(_row(
        f"rest_parts {shape}",
        "gcmiipy_tpu_torch/csrc/stencil_tile.cuh",
        "gcmiipy_tpu/ops/pallas_stencil.py:492", launches["rest_stencil"],
        max_abs["rest_parts"], cuda_ms(lambda: rest_parts(*k4), 50),
        cuda_ms(lambda: rest_parts_ref(*k4), 5),
        _bytes((*k4[:12], *geo, *outs)),
        {torch.float32: count_ops(rest_parts_ref, *k4)}, None,
        f"rest_parts {shape}", launch_ms=kernel_ms(lambda: rest_parts(*k4))))
    del base, seval, filt, pg_phiv, outs
    geom, (p, u, v, t, gt), utc, ph = physics_inputs(shape, torch.float32,
                                                     device)
    args = (p, u, v, t, gt, utc, geom, dt, ph)
    table = physics_table(ph, dt, device)
    work = [x.clone() for x in (u, v, t)]
    gt_out = torch.empty_like(gt)

    def launch():
        column_physics_inplace(p, *work, gt, gt_out, utc, geom, table)

    rows.append(_row(
        f"column_physics {shape}",
        "gcmiipy_tpu_torch/csrc/column_physics.cuh",
        "gcmiipy_tpu/ops/pallas_stream.py:314", launches["column_physics"],
        max_abs["column_physics"], cuda_ms(launch, 50),
        cuda_ms(lambda: physics_epilogue_ref(*args), 5),
        _bytes((p, t, gt, u[0], v[0])) + _bytes((t, gt, u[0], v[0])),
        {torch.float32: count_ops(physics_epilogue_ref, *args,
                                  dtypes=(torch.float32,))},
        None, f"column_physics {shape}", launch_ms=kernel_ms(launch)))
    return rows


# `python3 chip_smoke.py forms`: each column kernel in its held and in its
# deep form, timed against each other on FORMS' grid at these layer counts,
# the evidence for csrc/gcm_limits.cuh's k...HeldLayers
FORMS = dict(grid=(512, 1024), layers={torch.float32: (9, 12, 16, 20, 24, 32, 40, 48),
                                       torch.float64: (9, 20, 32, 40)})
FORM_SOURCES = ("pgf_rest", "stream_steps", "convection")


def form_calls(shape, dtype, device):
    """The column kernels' ops on one set of inputs of ``shape``: the pgf
    tile (K3's launch), the rest tile (K4's), the epilogue and the adaptive
    convection, each a call returning its outputs, with the name its
    kernel's launch has in a trace."""
    from gcmiipy_tpu_torch.ops.pgf_rest import pgf_parts, rest_parts
    from gcmiipy_tpu_torch.ops.stream_steps import column_physics, physics_table
    from gcmiipy_tpu_torch.physics.convection import convective_adjustment
    geom, base, seval, filt, pg_phiv = k3k4_inputs(shape, dtype, False,
                                                   device)
    k3 = (seval[0], seval[1], seval[3], geom)
    k4 = (*base, *seval, filt, pg_phiv, MAIN["dt"], geom)
    pgeom, pargs, utc, ph = physics_inputs(shape, dtype, device)
    table = physics_table(ph, MAIN["dt"], device)
    conv = convection_field(shape, dtype, device)
    return {"pgf_tile": lambda: pgf_parts(*k3),
            "tile_stencil": lambda: rest_parts(*k4),
            "column_physics": lambda: column_physics(
                *pargs, utc, pgeom, MAIN["dt"], ph, table=table),
            "column_convection": lambda: (convective_adjustment(*conv),)}


def phase_forms(device):
    """Each column kernel's held and deep forms timed against each other
    (step_profile.kernel_ms: the kernel's device ms a launch) at FORMS'
    layer counts, float32 and float64, the forms forced in copies of csrc/
    (cuda_lib.forced_form_sources); the two forms' outputs must agree to the bit but the
    epilogue's (whose deep form forms the Exner factor again: logged).
    Returns rows {kernel, L, dtype, held_ms, deep_ms}, held_ms None where
    the held block does not fit the card."""
    from gcmiipy_tpu_torch.ops import cuda_lib
    from gcmiipy_tpu_torch.step_profile import kernel_ms
    csrc = {form: cuda_lib.forced_form_sources(
        form, os.path.join(cuda_lib.BUILD_DIR, f"forms-{form}"))
        for form in ("held", "deep")}
    for form, path in csrc.items():
        with cuda_lib.sources_from(path):
            t = time.perf_counter()
            cuda_lib.build_many(sorted({cuda_lib.library_name(s, double)
                                        for s in FORM_SOURCES
                                        for double in (False, True)}))
            log("forms", f"{form} forms built in {time.perf_counter() - t:.1f}s")
    rows = []
    for dtype, layers in FORMS["layers"].items():
        for L in layers:
            shape = (L, *FORMS["grid"])
            calls = form_calls(shape, dtype, device)
            for kernel, call in calls.items():
                row, outs = {"kernel": kernel, "L": L,
                             "dtype": str(dtype)[6:]}, {}
                for form, path in csrc.items():
                    with cuda_lib.sources_from(path):
                        try:
                            outs[form] = call()
                        except RuntimeError as e:
                            log("forms", f"{kernel} {shape} {form}: {e}")
                            row[f"{form}_ms"] = None
                            continue
                        ms = {k: v for k, v in kernel_ms(call).items()
                              if kernel in k}
                        if len(ms) != 1 or (form == "deep") != ("_deep" in
                                                                next(iter(ms))):
                            fail("forms", f"{kernel} {shape} {form}: "
                                          f"launched {sorted(ms)}")
                        row[f"{form}_ms"] = next(iter(ms.values()))
                if len(outs) == 2:
                    row["max_abs_diff"] = abs_err(outs["held"], outs["deep"])
                    if kernel != "column_physics" and not bit_equal(
                            outs["held"], outs["deep"]):
                        fail("forms", f"{kernel} {shape}: the forms differ "
                                      f"by {row['max_abs_diff']:.3e}")
                log("forms", json.dumps(row))
                rows.append(row)
            del calls
            torch.cuda.empty_cache()
    return rows


def phase_kernels_k3k4(device):
    """K3 and K4 (one launch of the rest tile, aflux in its prologue)
    against their plain versions: float32 at the main path's shape (flat;
    a hill with Coriolis; the q limiter) and float64 on two small grids,
    every flag on.  K4 leaves v's wall row to its caller."""
    from gcmiipy_tpu_torch.ops.pgf_rest import (
        pgf_parts, pgf_parts_ref, rest_parts, rest_parts_ref)
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    cases = [(main_shape, torch.float32, False, False, False),
             (main_shape, torch.float32, True, False, True),
             (main_shape, torch.float32, False, True, False),
             ((3, 16, 128), torch.float64, True, True, True),
             ((9, 24, 36), torch.float64, True, True, True)]
    worst, main_abs = {}, {"k3": 0.0, "k4": 0.0}
    for shape, dtype, coriolis, q_limiter, hill in cases:
        geom, base, seval, filt, pg_phiv = k3k4_inputs(shape, dtype, hill,
                                                       device)
        sp, su, st = seval[0], seval[1], seval[3]
        k3 = pgf_parts(sp, su, st, geom)
        rest_args = (*base, *seval, filt, pg_phiv, MAIN["dt"], geom)
        k4 = rest_parts(*rest_args, coriolis=coriolis, q_limiter=q_limiter)
        torch.cuda.synchronize()
        ref3 = pgf_parts_ref(sp, su, st, geom)
        ref4 = rest_parts_ref(*rest_args, coriolis=coriolis,
                              q_limiter=q_limiter)
        tag = (f"{tuple(shape)} {str(dtype)[6:]} coriolis={coriolis} "
               f"q_limiter={q_limiter} hill={hill}")
        for name, out, ref in (("pgf_parts", k3, ref3),
                               ("rest_parts", k4, ref4)):
            if any(tuple(a.shape) != tuple(b.shape) for a, b in zip(out, ref)):
                fail("kernels", f"{name} output shapes differ")
            if not all(torch.isfinite(a).all() for a in out):
                fail("kernels", f"{name} {tag}: output not finite")
            rel = rel_err(out, ref)
            log("kernels", f"{name} {tag}: max rel {rel:.3e} (bound "
                           f"{KERNEL_REL[dtype]:g}), equal to the bit: "
                           f"{bit_equal(out, ref)}")
            if not rel <= KERNEL_REL[dtype]:
                fail("kernels", f"{name} {tag} disagrees with its plain version")
            if not bit_equal(out, ref):
                fail("kernels", f"{name} {tag} not equal to the bit")
            worst[name, dtype] = max(worst.get((name, dtype), 0.0), rel)
        if bool((k4[2][:, -1] == 0).all()):
            fail("kernels", f"rest_parts {tag}: v walled inside the kernel")
        if dtype == torch.float32:
            main_abs["k3"] = max(main_abs["k3"], abs_err(k3, ref3))
            main_abs["k4"] = max(main_abs["k4"], abs_err(k4, ref4))
    log("kernels", "pgf_parts and rest_parts ok: max rel " + ", ".join(
        f"{n} {str(d)[6:]} {r:.3e}" for (n, d), r in worst.items()))
    return main_abs


def phase_kernels_k5(device):
    """K5 against its plain version after one half step: float32 at the
    main path's shape (a predictor half, flat; a corrector half with a hill
    and Coriolis; the q limiter), float64 at 3x24x36 and 3x512x1024.  The
    plain version runs the kernel's FFT plan, the banded DFT (MegaHalf's)
    and the TPU kernel's unbanded one (every row over every chunk)."""
    from gcmiipy_tpu_torch.ops.mega_half import MegaHalf, mega_half_ref
    from gcmiipy_tpu_torch.ops.mega_step import banded_round
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    cases = [(main_shape, torch.float32, False, False, False, True),
             (main_shape, torch.float32, True, False, True, False),
             (main_shape, torch.float32, False, True, False, False),
             ((3, 24, 36), torch.float64, True, True, True, False),
             ((3, 512, 1024), torch.float64, True, False, True, False)]
    worst, main_abs = {}, 0.0
    for shape, dtype, coriolis, q_limiter, hill, predictor in cases:
        geom, base = k6_inputs(shape, dtype, hill, device)
        seval = base if predictor else random_state(geom, 3, device, dtype)
        half = MegaHalf(geom, MAIN["dt"], coriolis=coriolis,
                        q_limiter=q_limiter)
        out = half(base, seval)
        torch.cuda.synchronize()
        if not all(torch.isfinite(a).all() for a in out):
            fail("kernels", "mega_half output not finite")
        if not bool((out[2][:, -1] == 0).all()):
            fail("kernels", "mega_half: v not 0 on the wall row")
        tag = (f"mega_half {tuple(shape)} {str(dtype)[6:]} "
               f"{'predictor' if predictor else 'corrector'} coriolis="
               f"{coriolis} q_limiter={q_limiter} hill={hill} "
               f"({int(half.lats.numel())} latitudes listed)")
        plain = {name: mega_half_ref(base, seval, MAIN["dt"], geom,
                                     half.consts, coriolis=coriolis,
                                     q_limiter=q_limiter,
                                     filter_ref=filter_ref)
                 for name, filter_ref in (
                     ("FFT plan", fft_plan(half.consts)),
                     ("banded DFT", banded_round(geom)),
                     ("unbanded DFT", banded_round(geom, band_limit=False)))}
        if any(tuple(a.shape) != tuple(b.shape)
               for a, b in zip(out, plain["FFT plan"])):
            fail("kernels", "mega_half output shapes differ")
        rel, err = held_to_plain(tag, out, plain, MEGA_REL[dtype],
                                 banded_bound(dtype, MEGA_REL[dtype]))
        worst[dtype] = max(worst.get(dtype, 0.0), rel)
        if dtype == torch.float32:
            main_abs = max(main_abs, err)
    log("kernels", "mega_half ok, max rel held: float32 "
                   f"{worst[torch.float32]:.3e}, float64 {worst[torch.float64]:.3e}")
    return main_abs


def _config(backend, polar_filter="fft", **extra):
    from gcmiipy_tpu_torch.model.config import ModelConfig
    return ModelConfig(height=MAIN["height"], width=MAIN["width"],
                       layers=MAIN["layers"], dt=MAIN["dt"], backend=backend,
                       polar_filter=polar_filter, guard=True, **extra)


def _check_run(tag, state, stats, guard=None):
    if guard is not None and not bool(guard.ok):
        fail("main", f"{tag}: guard tripped at step {int(guard.blown_step)}")
    for name, x in zip(("p", "u", "v", "t", "q", "gt"), state):
        if not torch.isfinite(x).all():
            fail("main", f"{tag}: field {name} not finite")
    if not all(torch.isfinite(s).all() for s in stats):
        fail("main", f"{tag}: stats not finite")


def _run_model(backend, device, steps, polar_filter="fft", **extra):
    """The user's entry point, from the reference's quiescent start."""
    from gcmiipy_tpu_torch.model.driver import run_model
    tag = (f"run_model {backend}/{polar_filter}"
           f"{'+physics' if extra else ''} {steps} steps")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run_model(MAIN["height"], MAIN["width"], MAIN["layers"],
                        MAIN["dt"], steps,
                        config=_config(backend, polar_filter, **extra),
                        device=device)
        torch.cuda.synchronize()
    for w in caught:
        if "blew up" in str(w.message):
            fail("main", f"{tag}: {w.message}")
        log("main", f"{tag} warned: {w.message}")
    _check_run(tag, (*out[:5], out[5].gt), out[7])
    return out[:5], out[7]


def perturbed_state(geom, device):
    """The reference's start with the prognostics replaced by the random
    state of :func:`random_state`, so that every field moves from step 1."""
    from gcmiipy_tpu_torch.model.driver import gen_model_state
    from gcmiipy_tpu_torch.model.state import PrognosticVars
    state = gen_model_state(geom, _config("xla"))
    return state._replace(prog=PrognosticVars(
        *random_state(geom, 5, device, torch.float32)))


def _run_from(backend, geom, state, steps, polar_filter="fft", **extra):
    """``make_run_fn`` (the loop under ``run_model``) from ``state``: the
    prognostics, and with the physics the ground temperature after them."""
    from gcmiipy_tpu_torch.model.driver import make_run_fn
    state, stats, guard = make_run_fn(
        geom, _config(backend, polar_filter, **extra), steps)(state)
    out = tuple(state.prog) + ((state.ground.gt,) if extra else ())
    _check_run(f"{backend}/{polar_filter}{'+physics' if extra else ''} "
               "from the perturbed state", out, stats, guard)
    return out


def _held(tag, one, run, one_ref, run_ref, moved=None, short=1,
          short_rel=STEP1_REL, phase="main"):
    """The tpu_parity.py bounds: rel after ``short`` steps (1 unless
    given; logged only where ``short_rel`` is None), rel after the run, p
    drift."""
    rel1 = rel_err(one, one_ref) if one is not None else None
    rel_n = rel_err(run, run_ref)
    drift = float((run[0] - run_ref[0]).abs().max())
    bound = "logged" if short_rel is None else f"< {short_rel:g}"
    msg = (f"{tag}: " + (f"{short}-step rel {rel1:.3e} ({bound}), "
                         if rel1 is not None else "")
           + f"{MAIN['steps']}-step rel {rel_n:.3e} (< {RUN_REL:g}), "
           f"p drift {drift:.3e} Pa (< {DRIFT_PA:g})")
    log(phase, msg + (f"; {moved}" if moved else ""))
    if not ((rel1 is None or short_rel is None or rel1 < short_rel)
            and rel_n < RUN_REL and drift < DRIFT_PA):
        fail(phase, tag + " outside the tpu_parity.py bounds")


def _counted(kernels, fn):
    """Run ``fn`` with the kernels' launch counts set to 0 just before it;
    returns (fn's result, the counts just after)."""
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, [k.launches for k in kernels]


def phase_main(device):
    """Each path with its launches counted: run_model with backend='fused'
    (K1) against the plain core; run_model with backend='mega4' (K6)
    against the plain core with the DFT filter and against 'fused'; both
    from a perturbed start after 1 and 20 steps; one step of K2's path."""
    from gcmiipy_tpu_torch.dynamics import core25d, fused
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter
    from gcmiipy_tpu_torch.ops.fused_parts import (
        column_pass, fused_parts, parts_stencil)
    from gcmiipy_tpu_torch.ops.mega_step import mega_step
    from gcmiipy_tpu_torch.ops.pgf_rest import pgf_tile, rest_stencil
    kernels = (fused_parts, mega_step, fft_filter, rest_stencil, pgf_tile,
               column_pass, parts_stencil)
    n = MAIN["steps"]
    launches = {}

    t = time.perf_counter()
    (fused_n, stats), counts = _counted(kernels, lambda: _run_model(
        "fused", device, n))
    launches["fused_parts"] = counts[0]
    launches["column_pass"] = counts[5]
    log("main", f"run_model fused {n} steps in {time.perf_counter() - t:.2f}s, "
                f"launches fused_parts {counts[0]} mega_step {counts[1]} "
                f"fft_filter {counts[2]} rest_stencil {counts[3]} pgf_tile "
                f"{counts[4]} column_pass {counts[5]} parts_stencil "
                f"{counts[6]}, total energy drift "
                f"{float(stats.total_energy[-1] / stats.total_energy[0] - 1):.3e}")
    if counts != [2 * n, 0, 0, 0, 0, 2 * n, 2 * n]:
        fail("main", f"run_model fused launched {counts}, expected "
                     f"[{2 * n}, 0, 0, 0, 0, {2 * n}, {2 * n}]")

    t = time.perf_counter()
    (mega_n, stats), counts = _counted(kernels, lambda: _run_model(
        "mega4", device, n))
    launches["mega_step"] = counts[1]
    launches["fft_filter mega4"] = counts[2]
    launches["rest_stencil mega4"] = counts[3]
    launches["pgf_tile mega4"] = counts[4]
    log("main", f"run_model mega4 {n} steps in {time.perf_counter() - t:.2f}s, "
                f"launches fused_parts {counts[0]} mega_step {counts[1]} "
                f"fft_filter {counts[2]} rest_stencil {counts[3]} pgf_tile "
                f"{counts[4]}: {sum(counts[2:5]) / n:g} kernel launches a step, "
                f"total energy drift "
                f"{float(stats.total_energy[-1] / stats.total_energy[0] - 1):.3e}")
    # K6's C entry counts every launch it makes: the pgf tile, the filter
    # and the rest tile (aflux in its prologue) twice a step, six in all
    if counts != [0, n, 2 * n, 2 * n, 2 * n, 0, 0]:
        fail("main", f"run_model mega4 launched {counts}, expected "
                     f"[0, {n}, {2 * n}, {2 * n}, {2 * n}, 0, 0]")

    xla_n, _ = _run_model("xla", device, n)
    dft_n, _ = _run_model("xla", device, n, "dft")
    one = {b: _run_model(b, device, 1, pf)[0] for b, pf in
           (("mega4", "fft"), ("fused", "fft"), ("xla", "dft"))}
    _held("run_model fused vs plain core (fft)", None, fused_n, None, xla_n)
    _held("run_model mega4 vs plain core (dft)", one["mega4"], mega_n,
          one["xla"], dft_n)
    _held("run_model mega4 vs fused", one["mega4"], mega_n, one["fused"],
          fused_n)

    geom = geometry.gen_geometry(MAIN["height"], MAIN["width"], MAIN["layers"],
                                 sig_func=geometry.manabe_sig,
                                 dtype=torch.float32, device=device)
    start = perturbed_state(geom, device)
    runs = (("fused", "fft"), ("mega4", "fft"), ("xla", "fft"), ("xla", "dft"))
    out = {(b, pf): (_run_from(b, geom, start, 1, pf),
                     _run_from(b, geom, start, n, pf)) for b, pf in runs}
    moved = (f"the plain run moved the state by rel "
             f"{rel_err(out['xla', 'fft'][1], start.prog):.3e}, p by "
             f"{float((out['xla', 'fft'][1][0] - start.prog.p).abs().max()):.3e} Pa")
    _held("perturbed start, fused vs plain core (fft)", *out["fused", "fft"],
          *out["xla", "fft"], moved)
    _held("perturbed start, mega4 vs plain core (dft)", *out["mega4", "fft"],
          *out["xla", "dft"])
    _held("perturbed start, mega4 vs fused", *out["mega4", "fft"],
          *out["fused", "fft"])
    if not float((out["xla", "fft"][1][0] - start.prog.p).abs().max()) > DRIFT_PA:
        fail("main", "the perturbed run did not move p past the drift bound")

    # K2's path: make_fused_matsuno on unpadded fields, one step
    prog = tuple(start.prog)
    k2_step = fused.make_fused_matsuno(geom, MAIN["dt"])
    k2_out, counts = _counted(kernels, lambda: k2_step(*prog))
    launches["k2"] = counts[0]
    if counts != [2, 0, 0, 0, 0, 2, 2]:
        fail("main", f"make_fused_matsuno launched {counts}, expected "
                     "[2, 0, 0, 0, 0, 2, 2]")
    ref = core25d.matsuno_timestep(*prog, MAIN["dt"], geom)
    k2_rel = rel_err(k2_out, ref)
    log("main", f"make_fused_matsuno (K2's path) one step, fused_parts "
                f"launches {counts[0]}: vs plain core rel {k2_rel:.3e} "
                f"(< {STEP1_REL:g})")
    if not k2_rel < STEP1_REL:
        fail("main", "make_fused_matsuno outside the step-1 bound")
    return launches, geom, start, abs_err(k2_out, ref), out


def phase_main_stream(device, geom, start):
    """The 'stream' path with its launches counted: run_model with the
    per-step physics (one K7 call of 20 steps); stream against mega4 for
    the dynamics alone after 2 (one K=2 call) and 20 steps; stream+physics
    (convection off) against mega4 with the per-step physics in plain
    PyTorch after 4 and 20 steps, from the perturbed start."""
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter
    from gcmiipy_tpu_torch.ops.fused_parts import fused_parts
    from gcmiipy_tpu_torch.ops.mega_step import mega_step
    from gcmiipy_tpu_torch.ops.pgf_rest import pgf_tile, rest_stencil
    from gcmiipy_tpu_torch.ops.stream_steps import column_physics, stream_steps
    kernels = (fused_parts, mega_step, stream_steps, fft_filter, rest_stencil,
               pgf_tile, column_physics)
    n = MAIN["steps"]

    t = time.perf_counter()
    (_, stats), counts = _counted(kernels, lambda: _run_model(
        "stream", device, n, **PHYSICS))
    log("main", f"run_model stream+physics {n} steps in "
                f"{time.perf_counter() - t:.2f}s, launches fused_parts "
                f"{counts[0]} mega_step {counts[1]} stream_steps {counts[2]} "
                f"fft_filter {counts[3]} rest_stencil {counts[4]} pgf_tile "
                f"{counts[5]} column_physics {counts[6]}: "
                f"{sum(counts[3:]) / n:g} kernel launches a step, total energy "
                f"drift "
                f"{float(stats.total_energy[-1] / stats.total_energy[0] - 1):.3e}")
    if counts != [0, 0, 1, 2 * n, 2 * n, 2 * n, n]:
        fail("main", f"run_model stream+physics launched {counts}, "
                     f"expected [0, 0, 1, {2 * n}, {2 * n}, {2 * n}, {n}]")
    launches = {"stream_steps": counts[2], "fft_filter stream": counts[3],
                "rest_stencil stream": counts[4], "pgf_tile stream": counts[5],
                "column_physics": counts[6]}

    runs = {}
    for backend in ("stream", "mega4"):
        for steps in (2, n):
            runs[backend, steps], counts = _counted(
                kernels, lambda: _run_from(backend, geom, start, steps))
            want = ([0, 0, 1] if backend == "stream" else [0, steps, 0]) + [
                2 * steps, 2 * steps, 2 * steps, 0]
            if counts != want:
                fail("main", f"{backend} {steps} steps launched {counts}, "
                             f"expected {want}")
    _held("perturbed start, stream vs mega4 (dynamics)", runs["stream", 2],
          runs["stream", n], runs["mega4", 2], runs["mega4", n], short=2)

    physics = dict(PHYSICS, convection=False)
    for backend in ("stream", "mega4"):
        for steps in (4, n):
            runs[backend, steps], counts = _counted(
                kernels, lambda: _run_from(backend, geom, start, steps,
                                           **physics))
            want = ([0, 0, 1] if backend == "stream" else [0, steps, 0]) + [
                2 * steps, 2 * steps, 2 * steps,
                steps if backend == "stream" else 0]
            if counts != want:
                fail("main", f"{backend}+physics {steps} steps launched "
                             f"{counts}, expected {want}")
    moved = (f"the physics moved the ground temperature by "
             f"{float((runs['mega4', n][5] - start.ground.gt).abs().max()):.3e}"
             " K")
    _held("perturbed start, stream+physics vs mega4+physics (p,u,v,t,q,gt)",
          runs["stream", 4], runs["stream", n], runs["mega4", 4],
          runs["mega4", n], moved, short=4, short_rel=PHYSICS_REL)
    return launches


def _same(tag, a, b):
    """Fail unless the two runs are equal to the bit (every field)."""
    rel = rel_err(a, b)
    log("main", f"{tag}: rel {rel:.3e}, equal to the bit: {bit_equal(a, b)}")
    if not bit_equal(a, b):
        fail("main", tag + " differ")


def phase_main_mega_v2(device, geom, start, runs):
    """The 'mega' and v2 paths with their launches counted: run_model with
    backend='mega' (K5 twice a step) against the plain core with the DFT
    filter and against mega4 (equal to the bit: K5 is K6's half with the
    same banded filter), from the quiescent and the perturbed start; 20 steps of
    make_fused_matsuno_v2 (K3, torch.fft, K4) from the perturbed start
    against 'fused' (``runs``: phase_main's perturbed runs)."""
    from gcmiipy_tpu_torch.dynamics import fused
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter
    from gcmiipy_tpu_torch.ops.fused_parts import fused_parts
    from gcmiipy_tpu_torch.ops.mega_half import mega_half
    from gcmiipy_tpu_torch.ops.mega_step import mega_step
    from gcmiipy_tpu_torch.ops.pgf_rest import (
        pgf_parts, pgf_tile, rest_parts, rest_stencil)
    kernels = (fused_parts, mega_step, mega_half, pgf_parts, rest_parts,
               fft_filter, rest_stencil, pgf_tile)
    n = MAIN["steps"]
    launches = {}

    t = time.perf_counter()
    (mega_n, stats), counts = _counted(kernels, lambda: _run_model(
        "mega", device, n))
    launches["mega_half"] = counts[2]
    launches["fft_filter mega"] = counts[5]
    launches["rest_stencil mega"] = counts[6]
    launches["pgf_tile mega"] = counts[7]
    log("main", f"run_model mega {n} steps in {time.perf_counter() - t:.2f}s, "
                f"launches fused_parts {counts[0]} mega_step {counts[1]} "
                f"mega_half {counts[2]} pgf_parts {counts[3]} rest_parts "
                f"{counts[4]} fft_filter {counts[5]} rest_stencil "
                f"{counts[6]} pgf_tile {counts[7]}, total energy drift "
                f"{float(stats.total_energy[-1] / stats.total_energy[0] - 1):.3e}")
    if counts != [0, 0, 2 * n, 0, 0, 2 * n, 2 * n, 2 * n]:
        fail("main", f"run_model mega launched {counts}, expected "
                     f"[0, 0, {2 * n}, 0, 0, {2 * n}, {2 * n}, {2 * n}]")
    mega4_n, _ = _run_model("mega4", device, n)
    dft_n, _ = _run_model("xla", device, n, "dft")
    one = {b: _run_model(b, device, 1, pf)[0] for b, pf in
           (("mega", "fft"), ("mega4", "fft"), ("xla", "dft"))}
    _held("run_model mega vs plain core (dft)", one["mega"], mega_n,
          one["xla"], dft_n)
    _held("run_model mega vs mega4", one["mega"], mega_n, one["mega4"],
          mega4_n)
    _same(f"run_model mega vs mega4, {n} steps", mega_n, mega4_n)

    mega_p = {}
    for steps in (1, n):
        mega_p[steps], counts = _counted(kernels, lambda: _run_from(
            "mega", geom, start, steps))
        if counts != [0, 0, 2 * steps, 0, 0, 2 * steps, 2 * steps,
                      2 * steps]:
            fail("main", f"mega {steps} steps launched {counts}")
    _held("perturbed start, mega vs plain core (dft)", mega_p[1], mega_p[n],
          *runs["xla", "dft"])
    _same(f"perturbed start, mega vs mega4, {n} steps", mega_p[n],
          runs["mega4", "fft"][1])

    v2 = fused.make_fused_matsuno_v2(geom, MAIN["dt"])

    def v2_run(steps):
        state = tuple(start.prog)
        for _ in range(steps):
            state = v2(*state)
        return state

    v2_1, _ = _counted(kernels, lambda: v2_run(1))
    t = time.perf_counter()
    v2_n, counts = _counted(kernels, lambda: v2_run(n))
    launches["pgf_parts"], launches["rest_parts"] = counts[3], counts[4]
    launches["rest_stencil v2"] = counts[6]
    launches["pgf_tile v2"] = counts[7]
    log("main", f"make_fused_matsuno_v2 {n} steps from the perturbed start in "
                f"{time.perf_counter() - t:.2f}s, launches fused_parts "
                f"{counts[0]} mega_step {counts[1]} mega_half {counts[2]} "
                f"pgf_parts {counts[3]} rest_parts {counts[4]} fft_filter "
                f"{counts[5]} rest_stencil {counts[6]} pgf_tile {counts[7]}")
    if counts != [0, 0, 0, 2 * n, 2 * n, 0, 2 * n, 2 * n]:
        fail("main", f"make_fused_matsuno_v2 launched {counts}, expected "
                     f"[0, 0, 0, {2 * n}, {2 * n}, 0, {2 * n}, {2 * n}]")
    _check_run("make_fused_matsuno_v2 from the perturbed state", v2_n, ())
    if not bool((v2_n[2][:, -1] == 0).all()):
        fail("main", "make_fused_matsuno_v2: v not 0 on the wall row")
    _held("perturbed start, v2 vs fused", v2_1, v2_n, *runs["fused", "fft"])
    return launches


def per_field(out, ref, names=("p", "u", "v", "t", "q", "gt", "gw")):
    """Each field's max error over its scale, and the cells off by more
    than 1e-4 of it."""
    parts = []
    for name, a, b in zip(names, out, ref):
        scale = max(float(b.abs().max()), 1e-30)
        err = (a - b).abs() / scale
        parts.append(f"{name} {float(err.max()):.3e} "
                     f"({int((err > 1e-4).sum())} cells > 1e-4)")
    return ", ".join(parts)


def moist_start(geom, config):
    """The reference's start over the config's terrain (the surface pressure
    in barometric balance, gw at gw0), cooled with a supersaturated lowest
    layer (``state.moist_start``), so that rain falls from the first
    physics step: the 360 K start is a steam bath that blows up over the
    terrain with the evaporation on."""
    from gcmiipy_tpu_torch.model import state
    from gcmiipy_tpu_torch.model.driver import gen_model_state
    return state.moist_start(gen_model_state(geom, config), geom)


def _surface_run(tag, backend, geom, state, steps, polar_filter="fft",
                 **extra):
    """``make_run_fn`` from ``state``: (p, u, v, t, q, gt, gw), guard clean
    and finite."""
    from gcmiipy_tpu_torch.model.driver import make_run_fn
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, stats, guard = make_run_fn(
            geom, _config(backend, polar_filter, **extra), steps)(state)
        torch.cuda.synchronize()
    for w in caught:
        log("surface", f"{tag} {backend} warned: {w.message}")
    out = tuple(state.prog) + (state.ground.gt, state.ground.gw)
    if not bool(guard.ok):
        fail("surface", f"{tag} {backend}: guard tripped at step "
                        f"{int(guard.blown_step)}")
    for name, x in zip(("p", "u", "v", "t", "q", "gt", "gw"), out):
        if not torch.isfinite(x).all():
            fail("surface", f"{tag} {backend}: field {name} not finite")
    if not all(torch.isfinite(x).all() for x in stats):
        fail("surface", f"{tag} {backend}: stats not finite")
    return out


def phase_surface(device):
    """The Hansen terrain, land cover, water cycle, Shapiro filter and
    four-band radiation through make_run_fn (SURFACE, Config S) from the
    moist start, 20 steps: on 'stream' (K7 calls of K = 2, the gcd of the
    cadences, with the extras and the filter between calls) and on 'mega4'
    (K6), each with its launches counted, held against each other (and
    logged as equal to the bit or not), against the plain core (xla with
    the DFT filter) and once against 'mega' (K5); rain must fall.  Config T
    (TERRAIN): grey physics at physics_every=1 over the terrain on 'stream',
    where K7's epilogue runs the physics, against mega4 with the per-step
    physics in plain PyTorch.  Config W: Config S without the land cover on
    mega4, its global water at steps 0 and 20.  The adaptive convection's
    kernel and the four-band radiation's are counted with the others: one
    launch each a plain physics call (none where K7's epilogue runs the
    physics).  Returns the geometry and start of Config S, for phase
    timing, and the two kernels' launches in Config S's 20 steps on
    'stream', by name."""
    from gcmiipy_tpu_torch.diagnostics import global_water
    from gcmiipy_tpu_torch.model.driver import gen_model_geometry
    from gcmiipy_tpu_torch.ops.convection import column_adjustment
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter
    from gcmiipy_tpu_torch.ops.mega_half import mega_half
    from gcmiipy_tpu_torch.ops.mega_step import mega_step
    from gcmiipy_tpu_torch.ops.pgf_rest import pgf_tile, rest_stencil
    from gcmiipy_tpu_torch.ops.radiation import four_band_column
    from gcmiipy_tpu_torch.ops.stream_steps import column_physics, stream_steps
    kernels = (stream_steps, mega_step, mega_half, fft_filter, rest_stencil,
               pgf_tile, column_physics, column_adjustment, four_band_column)
    names = ("stream_steps", "mega_step", "mega_half", "fft_filter",
             "rest_stencil", "pgf_tile", "column_physics", "column_adjustment",
             "four_band_column")
    n = MAIN["steps"]
    config = _config("stream", **SURFACE)
    geom = gen_model_geometry(config, device)
    start = moist_start(geom, config)
    log("surface", f"Hansen terrain {float(geom.heightmap.min()):.1f}.."
                   f"{float(geom.heightmap.max()):.1f} m, land fraction "
                   f"mean {float(geom.land_fraction.mean()):.4f}, surface "
                   f"pressure {float(start.prog.p.min()):.1f}.."
                   f"{float(start.prog.p.max()):.1f} Pa")

    def counted(tag, backend, steps, want, polar_filter="fft", cfg=SURFACE,
                state=start, g=geom):
        t = time.perf_counter()
        out, counts = _counted(kernels, lambda: _surface_run(
            tag, backend, g, state, steps, polar_filter, **cfg))
        got = dict(zip(names, counts))
        log("surface", f"{tag} {backend} {steps} steps in "
                       f"{time.perf_counter() - t:.2f}s, launches " + " ".join(
                           f"{k} {v}" for k, v in got.items()))
        if got != dict(dict.fromkeys(names, 0), **want):
            fail("surface", f"{tag} {backend} {steps} steps launched {got}, "
                            f"expected {want}")
        return out

    # the adaptive convection and the four-band radiation: one launch each
    # a physics call, every 2nd step
    runs = {}
    for steps in (2, n):
        column = dict(column_adjustment=steps // 2,
                      four_band_column=steps // 2)
        # K = 2: one K7 call a 2 steps, the extras and the filter between
        runs["stream", steps] = counted("S", "stream", steps, dict(
            stream_steps=steps // 2, fft_filter=2 * steps,
            rest_stencil=2 * steps, pgf_tile=2 * steps, **column))
        if steps == n:
            column_launches = {"column_adjustment": column_adjustment.launches,
                               "four_band_column": four_band_column.launches}
        runs["mega4", steps] = counted("S", "mega4", steps, dict(
            mega_step=steps, fft_filter=2 * steps, rest_stencil=2 * steps,
            pgf_tile=2 * steps, **column))
        runs["xla", steps] = counted("S", "xla", steps, column, "dft")
    mega_n = counted("S", "mega", n, dict(
        mega_half=2 * n, fft_filter=2 * n, rest_stencil=2 * n,
        pgf_tile=2 * n, column_adjustment=n // 2, four_band_column=n // 2))
    gw0 = start.ground.gw
    rained = int((runs["mega4", n][6] > gw0).sum())
    dried = int((runs["mega4", n][6] < gw0).sum())
    moved = (f"gw rose (rain) in {rained} of {gw0.numel()} cells, fell "
             f"(evaporation) in {dried}; q moved by rel "
             f"{rel_err(runs['mega4', n][4:5], start.prog.q[None]):.3e}")
    log("surface", f"S stream vs mega4, {n} steps: equal to the bit: "
                   f"{bit_equal(runs['stream', n], runs['mega4', n])}")
    for steps in (2, n):
        log("surface", f"S mega4 vs plain core (dft) after {steps} steps, "
                       "rel per field: " + per_field(
                           runs["mega4", steps], runs["xla", steps]))
    _held("S stream vs mega4 (p,u,v,t,q,gt,gw)", runs["stream", 2],
          runs["stream", n], runs["mega4", 2], runs["mega4", n], short=2,
          phase="surface")
    # the 2-step difference is logged, not held to the dynamics' step-1
    # limit: over the terrain the pressure-gradient force is the small
    # difference of two large terms, and u and v start at rest, so the
    # float32 rounding of the kernel's FFT filter against the plain core's
    # DFT is 6.1e-4 of u's scale after 2 steps and stays there (6.3e-4
    # after 20; p, t, q, gt and gw within 1.3e-5, NVIDIA H100 80GB HBM3)
    _held("S mega4 vs plain core (dft) (p,u,v,t,q,gt,gw)",
          runs["mega4", 2], runs["mega4", n], runs["xla", 2],
          runs["xla", n], moved, short=2, short_rel=None, phase="surface")
    log("surface", f"S mega vs mega4, {n} steps: equal to the bit: "
                   f"{bit_equal(mega_n, runs['mega4', n])}")
    _held("S mega vs mega4 (p,u,v,t,q,gt,gw)", None, mega_n, None,
          runs["mega4", n], phase="surface")
    if not rained:
        fail("surface", "no rain fell: gw rose nowhere")

    # Config T: K7's epilogue over the terrain, one call of 20 steps
    t_cfg = _config("stream", **TERRAIN)
    t_geom = gen_model_geometry(t_cfg, device)
    from gcmiipy_tpu_torch.model.driver import gen_model_state
    t_start = gen_model_state(t_geom, t_cfg)
    for steps in (4, n):
        runs["T stream", steps] = counted(
            "T", "stream", steps, dict(
                stream_steps=1, fft_filter=2 * steps, rest_stencil=2 * steps,
                pgf_tile=2 * steps, column_physics=steps),
            cfg=TERRAIN, state=t_start, g=t_geom)
        runs["T mega4", steps] = counted(
            "T", "mega4", steps, dict(
                mega_step=steps, fft_filter=2 * steps, rest_stencil=2 * steps,
                pgf_tile=2 * steps, column_adjustment=steps), cfg=TERRAIN,
            state=t_start, g=t_geom)
    moved = (f"the run moved p by "
             f"{float((runs['T mega4', n][0] - t_start.prog.p).abs().max()):.3e}"
             f" Pa, the ground temperature by "
             f"{float((runs['T mega4', n][5] - t_start.ground.gt).abs().max()):.3e} K")
    _held("T stream (K7 epilogue) vs mega4+physics over the terrain",
          runs["T stream", 4][:6], runs["T stream", n][:6],
          runs["T mega4", 4][:6], runs["T mega4", n][:6], moved, short=4,
          short_rel=PHYSICS_REL, phase="surface")

    # Config W: no land cover, so that every cell's evaporation draws on gw
    w_cfg = dict(SURFACE, land_cover="none")
    w_geom = gen_model_geometry(_config("mega4", **w_cfg), device)
    w_start = moist_start(w_geom, _config("mega4", **w_cfg))
    from gcmiipy_tpu_torch.model.state import (
        GroundVars, ModelState, PrognosticVars)
    w_out = counted("W", "mega4", n, dict(
        mega_step=n, fft_filter=2 * n, rest_stencil=2 * n, pgf_tile=2 * n,
        column_adjustment=n // 2, four_band_column=n // 2), cfg=w_cfg,
        state=w_start, g=w_geom)
    w_end = ModelState(PrognosticVars(*w_out[:5]), GroundVars(
        w_out[5], w_out[6], w_start.ground.snow, w_start.ground.ice),
        w_start.utc, w_start.step)
    before = float(global_water(w_start, w_geom))
    after = float(global_water(w_end, w_geom))
    change = after / before - 1
    log("surface", f"W global water, atmosphere and ground (float64 sums): "
                   f"{before:.10e} kg at step 0, {after:.10e} kg at step {n}"
                   f": relative change {change:.3e} (< {WATER_REL:g}); gw "
                   f"moved by {float((w_out[6] - w_start.ground.gw).abs().max()):.3e} m")
    if not abs(change) < WATER_REL:
        fail("surface", "Config W does not conserve its water")
    return (geom, start), column_launches


def phase_services(device):
    """The run services on 'stream' (K7) and 'mega4' (K6): run_model with
    checkpoint_every=10 and a metrics path over 20 steps, its checkpoints
    (named as the JAX package names them) and metrics lines (one a stats
    entry) checked, then a resume from the step-10 checkpoint through
    make_run_fn(start_step=10), equal to the bit to the straight 20-step
    run; Config S on 'stream' (K = 2) split at step 7, off the launch size,
    resumed behind its one-step alignment head on 'mega4', equal to the
    bit to its straight run; python -m gcmiipy_tpu_torch run with the same
    flags as a subprocess, exit code 0.  Returns the launches of K6 and K7
    on these paths."""
    import shutil
    import tempfile
    from gcmiipy_tpu_torch.model import checkpoint
    from gcmiipy_tpu_torch.model.driver import (
        gen_model_geometry, make_run_fn, run_model)
    from gcmiipy_tpu_torch.ops.mega_step import mega_step
    from gcmiipy_tpu_torch.ops.stream_steps import stream_steps
    kernels = (stream_steps, mega_step)
    n = MAIN["steps"]
    every = n // 2
    dims = (MAIN["height"], MAIN["width"], MAIN["layers"], MAIN["dt"])
    launches = {}
    tmp = tempfile.mkdtemp(prefix="gcm_services_")
    try:
        for backend, want in (("stream", [2, 0]), ("mega4", [0, n])):
            ck = os.path.join(tmp, backend)
            metrics = os.path.join(tmp, backend + ".jsonl")
            cfg = _config(backend, checkpoint_dir=ck, checkpoint_every=every,
                          metrics_path=metrics)
            t = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out, counts = _counted(kernels, lambda: run_model(
                    *dims, n, config=cfg, device=device))
            for w in caught:
                if "blew up" in str(w.message):
                    fail("services", f"{backend}: {w.message}")
            launches[f"services {backend}"] = counts
            names = sorted(os.listdir(ck))
            with open(metrics) as f:
                lines = [json.loads(ln) for ln in f]
            log("services", f"run_model {backend} {n} steps, checkpoint_every"
                            f" {every}, in {time.perf_counter() - t:.2f}s: "
                            f"launches stream_steps {counts[0]} mega_step "
                            f"{counts[1]}; checkpoints {names}; "
                            f"{len(lines)} metrics lines, steps "
                            f"{[ln['step'] for ln in lines]}")
            if counts != want:
                fail("services", f"{backend} launched {counts}, expected "
                                 f"{want}")
            if names != [f"step_{s:010d}.npz" for s in (every, n)]:
                fail("services", f"{backend}: checkpoints {names}")
            if len(lines) != len(out[7].total_energy) or not all(
                    np.isfinite(ln["total_energy"]) for ln in lines):
                fail("services", f"{backend}: {len(lines)} metrics lines for "
                                 f"{len(out[7].total_energy)} stats entries")
            straight = run_model(*dims, n, config=_config(backend),
                                 device=device)
            geom = gen_model_geometry(_config(backend), device)
            state, step = checkpoint.restore_checkpoint(ck, every,
                                                        device=device)
            resumed, counts = _counted(kernels, lambda: make_run_fn(
                geom, _config(backend), n - every, start_step=step)(state))
            last, _ = checkpoint.restore_checkpoint(ck, device=device)
            same = (bit_equal(resumed[0].prog, straight[:5]),
                    bit_equal(out[:5], straight[:5]),
                    bit_equal(last.prog, out[:5]))
            log("services", f"{backend}: resumed from step {step} "
                            f"({counts[0]} stream_steps, {counts[1]} "
                            f"mega_step launches) equals the straight run to "
                            f"the bit: {same[0]}; the checkpointed run: "
                            f"{same[1]}; the step-{n} checkpoint holds the "
                            f"run's fields: {same[2]}")
            if not all(same):
                fail("services", f"{backend}: a resumed or checkpointed run "
                                 "differs from the straight run")

        # Config S off its launch size: K = 2, split at step 7
        cfg = _config("stream", **SURFACE)
        geom = gen_model_geometry(cfg, device)
        start = moist_start(geom, cfg)
        split = 7
        straight = _surface_run("services S straight", "stream", geom, start,
                                n, **SURFACE)
        (part, _, _), c1 = _counted(kernels, lambda: make_run_fn(
            geom, cfg, split)(start))
        ck = os.path.join(tmp, "S")
        checkpoint.save_checkpoint(ck, part, split)
        state, step = checkpoint.restore_checkpoint(ck, device=device)
        run = make_run_fn(geom, cfg, n - split, start_step=step)
        (resumed, _, guard), c2 = _counted(kernels, lambda: run(state))
        counts = [a + b for a, b in zip(c1, c2)]
        launches["services S"] = counts
        got = tuple(resumed.prog) + (resumed.ground.gt, resumed.ground.gw)
        same = bit_equal(got, straight)
        log("services", f"Config S on stream split at step {split} (K = 2), "
                        f"resumed behind a {run.head_steps}-step head: "
                        f"launches stream_steps {counts[0]} mega_step "
                        f"{counts[1]}; equal to the straight run to the bit "
                        f"(p,u,v,t,q,gt,gw): {same}; rel "
                        f"{rel_err(got, straight):.3e}")
        if not (same and bool(guard.ok) and run.head_steps == 1):
            fail("services", "Config S resumed off its launch size differs "
                             "from its straight run")
        if counts != [9, 2]:
            fail("services", f"Config S split launched {counts}, expected "
                             "[9, 2]")

        # the CLI, as a user runs it
        metrics = os.path.join(tmp, "cli.jsonl")
        cmd = [sys.executable, "-m", "gcmiipy_tpu_torch", "run", "--height",
               str(MAIN["height"]), "--width", str(MAIN["width"]),
               "--layers", str(MAIN["layers"]), "--dt", str(MAIN["dt"]),
               "--steps", str(n), "--backend", "stream", "--guard",
               "--checkpoint-dir", os.path.join(tmp, "cli"),
               "--checkpoint-every", str(every), "--metrics", metrics,
               "--device", device.type]
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO_DIR, capture_output=True,
                              text=True, timeout=600)
        log("services", f"python -m gcmiipy_tpu_torch run ({' '.join(cmd[3:])}"
                        f") exit code {proc.returncode} in "
                        f"{time.perf_counter() - t:.1f}s: "
                        + " | ".join(proc.stdout.strip().splitlines()))
        if proc.returncode != 0:
            fail("services", "the CLI run failed: " + proc.stderr[-2000:])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def _sideband_inputs():
    """The side band's starts as float64 CPU tensors, from a seed."""
    from gcmiipy_tpu_torch import constants
    from gcmiipy_tpu_torch.model import ctu_model
    rng = np.random.default_rng(7)
    c = SIDEBAND_1D["cells"]
    q1 = np.zeros(c)
    q1[c // 4:c // 2] = 1.0
    n = SIDEBAND_SW["side"]
    x = np.arange(n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    bump = 8000.0 + 10.0 * np.exp(-((X - n / 2) ** 2 + (Y - n / 2) ** 2)
                                  / (2 * 4.0 ** 2))
    H, W = SIDEBAND_2D["height"], SIDEBAND_2D["width"]
    X, Y = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    hump = np.exp(-((X - H / 2) ** 2 + (Y - W / 2) ** 2) / (2 * 16.0 ** 2))
    small = 0.1 * rng.standard_normal((2, H, W))
    t0 = constants.standard_temperature * (
        constants.P0 / constants.standard_pressure) ** constants.kappa
    impulse = np.zeros((H, W))
    impulse[H // 2, W // 2] = 1.5
    gcm = (constants.standard_pressure * (1 + 1e-4 * rng.standard_normal(
        (H, W))), 1.0 + 0.1 * rng.standard_normal((H, W)),
        0.1 * rng.standard_normal((H, W)),
        t0 + 0.1 * rng.standard_normal((H, W)),
        0.1 + 0.01 * rng.random((H, W)))
    dyn = (np.full(c, 10.0), np.full(c, constants.standard_pressure),
           np.full(c, constants.standard_temperature), 1e-3 * q1)
    return {
        "q1": torch.as_tensor(q1), "sw": tuple(torch.as_tensor(a) for a in (
            np.zeros((n, n)), np.zeros((n, n)), bump)),
        "c_grid": tuple(torch.as_tensor(a) for a in (
            small[0], small[1], 8000.0 + 10.0 * hump)),
        "a_grid": tuple(torch.as_tensor(a) for a in (
            small[0], small[1], 1000.0 + hump)),
        "temp": tuple(torch.as_tensor(a) for a in (
            impulse, np.zeros((H, W)),
            np.full((H, W), constants.standard_pressure),
            np.full((H, W), constants.standard_temperature))),
        "gcm": tuple(torch.as_tensor(a) for a in gcm),
        "ctu": ctu_model.get_initial_conditions((H, W), device="cpu"),
        "dyn": tuple(torch.as_tensor(a) for a in dyn),
    }


def _sideband_radiation_inputs():
    """The grey schemes' random but physical columns at 9x512x1024 (JAX
    tests/test_radiation.py's recipe) on the CPU at float64, and their
    geometry."""
    from gcmiipy_tpu_torch import constants
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.model.state import GroundVars
    L, H, W = MAIN["layers"], SIDEBAND_2D["height"], SIDEBAND_2D["width"]
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(3)
    p = torch.as_tensor(1e5 * (1 + 0.02 * rng.standard_normal((H, W))))
    tp = p * geom.sig + geom.ptop
    tt = torch.as_tensor(260.0 + 60.0 * rng.random((L, H, W)))
    t = tt * (constants.P0 / tp) ** constants.kappa
    q = torch.as_tensor(10.0 ** rng.uniform(-5, -2, (L, H, W)))
    gt = torch.as_tensor(270.0 + 50.0 * rng.random((H, W)))
    zero = torch.zeros_like(gt)
    return geom, (p, q, t, tt, GroundVars(gt, zero, zero, zero))


def _to(x, device, dtype):
    """A tensor, or each tensor of a (named)tuple, on ``device`` in
    ``dtype``."""
    if isinstance(x, tuple):
        items = [_to(v, device, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.to(device=device, dtype=dtype)


def _timed(fn, device):
    """``fn()`` and the ms it took on the card (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_sideband(device, card):
    """The side-band modules on the card: each run (and each single call)
    at float64 against the same call on the CPU at float64 within
    SIDEBAND_REL64 of each field's scale; each run also at float32 on the
    card against the CPU's float64 run within SIDEBAND_REL32; the guarded
    runs stable; the 1000-step 2D shallow-water run with every host read
    of a tensor made to raise.  Logs each card run's ms (CUDA events)."""
    from gcmiipy_tpu_torch.dynamics import advection_schemes as sch
    from gcmiipy_tpu_torch.dynamics import gcm_sequence
    from gcmiipy_tpu_torch.dynamics import shallow_water_2d as sw2
    from gcmiipy_tpu_torch.model import ctu_model, harness
    from gcmiipy_tpu_torch.physics import radiation
    inputs = _sideband_inputs()
    o, sw, two = SIDEBAND_1D, SIDEBAND_SW, SIDEBAND_2D
    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64

    def looped(step, steps):
        def run(state):
            for _ in range(steps):
                state = step(*state)
            return state
        return run

    def guarded(step, steps, variation_of=None):
        return lambda state: harness.run_guarded(
            step, state, steps, variation_of=variation_of)

    v1 = torch.full((o["cells"],), o["v"], dtype=f64)
    runs = {}
    for name in ("ft_upwind", "upwind_third_order", "lax_friedrichs"):
        scheme = getattr(sch, name)
        runs[f"1D {name} {o['cells']} cells {o['steps']} steps"] = (
            lambda s, scheme=scheme: guarded(
                lambda q: scheme(o["dt"], o["dx"], v1.to(q), q),
                o["steps"])(s), inputs["q1"], True)
    runs[f"2D C-grid SW {sw['side']}x{sw['side']} {sw['steps']} steps"] = (
        guarded(lambda s: sw2.matsuno_scheme_c_grid(*s, sw["dx"], sw["dt"]),
                sw["steps"], variation_of=lambda s: s[2]), inputs["sw"], True)
    shape = f"{two['height']}x{two['width']} {two['steps']} steps"
    n2 = two["steps"]
    runs[f"matsuno_scheme_c_grid {shape}"] = (looped(
        lambda *s: sw2.matsuno_scheme_c_grid(*s, 300e3, 300.0), n2),
        inputs["c_grid"], False)
    runs[f"matsuno_scheme_a_grid {shape}"] = (looped(
        lambda *s: sw2.matsuno_scheme_a_grid(*s, 300e3, 900.0), n2),
        inputs["a_grid"], False)
    runs[f"matsuno_scheme_temp {shape}"] = (looped(
        lambda *s: sw2.matsuno_scheme_temp(*s, 300e3, 300.0), n2),
        inputs["temp"], False)
    runs[f"matsuno_timestep_2d {shape}"] = (looped(
        lambda *s: sw2.matsuno_timestep_2d(*s, 100.0, 100e3), n2),
        inputs["gcm"], False)
    runs[f"ctu_step {shape}"] = (looped(
        lambda *s: ctu_model.ctu_step(*s, dt=0.5, spatial_change=(1.0, 1.0)),
        n2), inputs["ctu"], False)
    runs[f"dynam_matsuno {o['cells']} cells 50 steps"] = (looped(
        lambda *s: gcm_sequence.dynam_matsuno(*s, 10.0, 100e3), 50),
        inputs["dyn"], False)

    def refuse(*args, **kwargs):
        raise RuntimeError("a host read of a tensor in run_guarded")

    ms, cpu_s = {}, {}
    for tag, (run, start, is_guarded) in runs.items():
        t0 = time.perf_counter()
        ref = run(_to(start, cpu, f64))
        cpu_s[tag] = time.perf_counter() - t0
        got = {}
        for dtype in (f64, f32):
            saved = {}
            if is_guarded:  # the guard stays on the device: no host read
                for name in ("item", "__bool__", "__float__", "__int__",
                             "tolist"):
                    saved[name] = getattr(torch.Tensor, name)
                    setattr(torch.Tensor, name, refuse)
            try:
                got[dtype], t = _timed(
                    lambda: run(_to(start, device, dtype)), device)
            finally:
                for name, fn in saved.items():
                    setattr(torch.Tensor, name, fn)
            ms[f"{tag} {str(dtype)[6:]}"] = t
        if is_guarded:
            flags = [bool(ref[1])] + [bool(got[d][1]) for d in (f64, f32)]
            if not all(flags):
                fail("sideband", f"{tag}: run_guarded not stable (CPU, card "
                                 f"float64, card float32: {flags})")
            ref, got = ref[0], {d: g[0] for d, g in got.items()}
        ref = [ref] if torch.is_tensor(ref) else list(ref)
        refc = [x.to(device) for x in ref]
        rel = {d: rel_err([x.to(f64) for x in ([got[d]] if torch.is_tensor(
            got[d]) else got[d])], refc) for d in (f64, f32)}
        finite = all(torch.isfinite(x).all() for x in ref)
        log("sideband", f"{tag}: card float64 against the CPU's float64 rel "
                        f"{rel[f64]:.3e} (< {SIDEBAND_REL64:g}), card float32 "
                        f"rel {rel[f32]:.3e} (< {SIDEBAND_REL32:g})"
                        + ("; run_guarded stable" if is_guarded else ""))
        if not (finite and rel[f64] < SIDEBAND_REL64
                and rel[f32] < SIDEBAND_REL32):
            fail("sideband", f"{tag} outside its bounds (finite: {finite})")

    geom, cols = _sideband_radiation_inputs()
    p, q, t, tt, g = cols
    calls = {
        "grey_solar": lambda geom, p, q, t, tt, g: radiation.grey_solar(
            p, q, t, 0.4, g.gt, 0.0, 600.0, geom),
        "grey_radiation": lambda geom, p, q, t, tt, g:
            radiation.grey_radiation(p, q, tt, 0.3, g, None, 600.0, geom),
    }
    shape = f"{MAIN['layers']}x{two['height']}x{two['width']}"
    for name, call in calls.items():
        t0 = time.perf_counter()
        ref = call(geom, *cols)
        cpu_s[name] = time.perf_counter() - t0
        gdev = geom.to(device=device)
        dev_cols = _to(cols, device, f64)
        got, t_ms = _timed(lambda: call(gdev, *dev_cols), device)
        ms[f"{name} {shape} float64"] = t_ms
        rel = rel_err(got, [x.to(device) for x in ref])
        log("sideband", f"{name} {shape}: card float64 against the CPU's "
                        f"float64 rel {rel:.3e} (< {SIDEBAND_REL64:g})")
        if not (rel < SIDEBAND_REL64
                and all(torch.isfinite(x).all() for x in got)):
            fail("sideband", f"{name} outside its bound")
    log("sideband", f"ms on the card ({card}; CUDA events around each run, "
        "plain PyTorch, one kernel an operation): " + ", ".join(
            f"{k} {v:.2f}" for k, v in ms.items()))
    log("sideband", "the CPU references, host seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in cpu_s.items()))
    return ms


def _longrun_geom_checks(device):
    """K6 against its plain version after one call at the long runs' grids
    (float64): 3x8x8, narrower than one 8x32 tile and one tile row, the
    general FFT at a 5-wavenumber row; 9x24x36 over the Hansen terrain."""
    from gcmiipy_tpu_torch import longrun_flagship as lr
    from gcmiipy_tpu_torch.ops.mega_step import MegaStep, mega_step_ref
    worst = 0.0
    for name in ("dynamics", "terrain"):
        kw = lr.case_args(*lr.CASES[lr.CASE_NAMES.index(name)], 1)
        geom = lr.case_geometry(kw["grid"], kw["terrain"], "float64", device)
        state = random_state(geom, 2, device, torch.float64)
        for q_limiter in (False, True):
            step = MegaStep(geom, kw["dt"], coriolis=True,
                            q_limiter=q_limiter)
            out = step(*state)
            torch.cuda.synchronize()
            plain = {label: mega_step_ref(*state, kw["dt"], geom, step.consts,
                                         coriolis=True, q_limiter=q_limiter,
                                         filter_ref=filter_ref)
                     for label, filter_ref in (
                         ("FFT plan", fft_plan(step.consts)),
                         ("banded DFT", None))}
            if not all(torch.isfinite(a).all() for a in out):
                fail("longrun", f"mega_step {kw['grid']} output not finite")
            tag = (f"longrun: mega_step {tuple(kw['grid'])} float64 "
                   f"terrain={kw['terrain']} q_limiter={q_limiter}")
            rel, _ = held_to_plain(tag, out, plain, MEGA_REL[torch.float64],
                                   BANDED_REL64)
            worst = max(worst, rel)
    return worst


def phase_longrun(device, card):
    """The reference's long integrations on the card through
    ``longrun_flagship``, each held to the JAX package's outcome in
    LONGRUN_ARTIFACT: K6 at its long runs' grids against its plain version;
    the bare physics to 6500 steps and the terrain to 3200 (the guard trips
    within LONGRUN_BLOWN_TOL of JAX's step), the dynamics over 14,400 steps
    (guard-clean, energy drift below LONGRUN_DRIFT), each energy trace
    within LONGRUN_E_REL of JAX's over LONGRUN's span; the flagship,
    14,400 float32 steps on 'stream' (K7 and its epilogue), guard-clean and
    within FLAGSHIP_E_REL / FLAGSHIP_P_REL of its float64 day; then the
    stabilised and seasonal cases for as many steps as LONGRUN_BUDGET_S
    leaves (at least LONGRUN_STABLE_MIN), guard-clean and within
    LONGRUN_E_REL.  The launches of K6 and K7 are counted and logged, and
    so are the adaptive convection's (one a plain physics call)."""
    from gcmiipy_tpu_torch import longrun_flagship as lr
    from gcmiipy_tpu_torch.ops.convection import column_adjustment
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter
    from gcmiipy_tpu_torch.ops.mega_step import mega_step
    from gcmiipy_tpu_torch.ops.pgf_rest import pgf_tile, rest_stencil
    from gcmiipy_tpu_torch.ops.stream_steps import column_physics, stream_steps
    t_phase = time.perf_counter()
    with open(LONGRUN_ARTIFACT) as fh:
        jax_recs = dict(zip(lr.CASE_NAMES, json.load(fh)["results"]))
    worst = _longrun_geom_checks(device)
    log("longrun", f"mega_step at the long runs' grids ok, max rel held "
                   f"{worst:.3e}")
    kernels = (mega_step, stream_steps, fft_filter, rest_stencil, pgf_tile,
               column_physics, column_adjustment)
    summary = {}

    def case(name, steps, compared):
        kw = lr.case_args(*lr.CASES[lr.CASE_NAMES.index(name)], steps)
        kw["steps"] = steps
        jrec = jax_recs[name]
        rec, counts = _counted(kernels, lambda: lr.run_case(
            device=device, backend="mega4", **kw))
        n = min(compared // lr.TRACE_EVERY + 1, len(rec["energy_trace"]))
        e_rel = lr.trace_rel(rec["energy_trace"][:n], jrec["energy_trace"][:n])
        ke_rel = lr.trace_rel(rec["ke_trace"][:n], jrec["ke_trace"][:n])
        want = [steps, 0, 2 * steps, 2 * steps, 2 * steps, 0]
        log("longrun", f"{name} {tuple(kw['grid'])} dt={kw['dt']:g} float64 "
                       f"mega4, {steps} steps in {rec['walltime_s']:.2f}s "
                       f"({1e3 * rec['walltime_s'] / steps:.3f} ms/step): ok "
                       f"{rec['ok']} blown_step {rec['blown_step']} (JAX "
                       f"{jrec['blown_step']}), energy trace against JAX's to "
                       f"step {compared} rel {e_rel:.3e} (< {LONGRUN_E_REL:g}),"
                       f" ke trace rel {ke_rel:.3e} (logged), energy drift "
                       f"{rec['energy_max_rel_drift']:.3e}, p range "
                       f"{rec['p_range_pa'][0]:.1f}-{rec['p_range_pa'][1]:.1f}"
                       f" Pa; launches mega_step {counts[0]} fft_filter "
                       f"{counts[2]} rest_stencil {counts[3]} pgf_tile "
                       f"{counts[4]} column_adjustment {counts[6]}")
        if counts[:6] != want:
            fail("longrun", f"{name} launched {counts}, expected {want}")
        if not rec["p_finite"] or not e_rel < LONGRUN_E_REL:
            fail("longrun", f"{name}: p finite {rec['p_finite']}, energy "
                            f"trace rel {e_rel:.3e}")
        if jrec["ok"] or jrec["blown_step"] >= steps:
            if not rec["ok"]:
                fail("longrun", f"{name}: the guard tripped at step "
                                f"{rec['blown_step']}; JAX's stayed clean")
        elif rec["ok"] or abs(rec["blown_step"] - jrec["blown_step"]) \
                > LONGRUN_BLOWN_TOL:
            fail("longrun", f"{name}: blown_step {rec['blown_step']}, JAX's "
                            f"{jrec['blown_step']} +- {LONGRUN_BLOWN_TOL}")
        summary[name] = dict(steps=steps, s=rec["walltime_s"])
        return rec

    for name, (steps, compared) in LONGRUN.items():
        rec = case(name, steps, compared)
        if name == "dynamics" and not (
                rec["energy_max_rel_drift"] < LONGRUN_DRIFT):
            fail("longrun", f"dynamics: energy drift "
                            f"{rec['energy_max_rel_drift']:.3e} (< "
                            f"{LONGRUN_DRIFT:g})")

    steps = FLAGSHIP_STEPS
    rec, counts = _counted(kernels, lambda: lr.run_flagship(
        steps, device=device, check_steps=FLAGSHIP_DAY))
    day = rec["float64_day"]
    k = rec["trace_every"]
    total = steps + FLAGSHIP_DAY
    want = [0, total // k, 2 * total, 2 * total, 2 * total, total, 0]
    log("longrun", f"flagship {tuple(rec['grid'])} dt={rec['dt']:g} "
                   f"stream+physics: "
                   f"float32 {steps} steps in {rec['walltime_s']:.2f}s "
                   f"({1e3 * rec['walltime_s'] / steps:.4f} ms/step), ok "
                   f"{rec['ok']}, energy drift "
                   f"{rec['energy_max_rel_drift']:.3e}, global-mean p "
                   f"{rec['p_mean_pa'][0]:.3f} -> {rec['p_mean_pa'][-1]:.3f} "
                   f"Pa (drift {rec['p_mean_rel_drift']:.3e}); float64 "
                   f"{FLAGSHIP_DAY} steps in {day['walltime_s']:.2f}s, ok "
                   f"{day['ok']}; float32 against float64 at step "
                   f"{FLAGSHIP_DAY}: energy trace rel "
                   f"{day['energy_max_rel_diff']:.3e} (< {FLAGSHIP_E_REL:g}),"
                   f" global-mean p rel {day['p_mean_rel_diff']:.3e} (< "
                   f"{FLAGSHIP_P_REL:g}); launches stream_steps {counts[1]} "
                   f"column_physics {counts[5]} fft_filter {counts[2]} "
                   f"rest_stencil {counts[3]} pgf_tile {counts[4]}")
    if counts != want:
        fail("longrun", f"flagship launched {counts}, expected {want}")
    if not (rec["ok"] and rec["p_finite"] and day["ok"]
            and day["energy_max_rel_diff"] < FLAGSHIP_E_REL
            and day["p_mean_rel_diff"] < FLAGSHIP_P_REL):
        fail("longrun", "flagship: guard tripped or outside its bounds")
    summary["flagship"] = dict(steps=steps, s=rec["walltime_s"])

    # the stable cases share what is left of the budget, each at least
    # LONGRUN_STABLE_MIN steps and at most JAX's horizon; the first is
    # sized by the terrain case's ms a step (more work a step than either),
    # the second by the first's
    per_step = summary["terrain"]["s"] / summary["terrain"]["steps"]
    for i, name in enumerate(LONGRUN_STABLE):
        remaining = LONGRUN_BUDGET_S - (time.perf_counter() - t_phase)
        horizon = jax_recs[name]["steps"]
        share = len(LONGRUN_STABLE) - i
        steps = int(remaining / share / per_step) // 16 * 16
        steps = max(LONGRUN_STABLE_MIN, min(steps, horizon))
        log("longrun", f"{name}: {steps} of JAX's {horizon} steps "
                       f"({remaining:.1f}s of the budget left, "
                       f"{1e3 * per_step:.3f} ms a step expected)"
                       + ("; cut to fit the budget" if steps < horizon
                          else ""))
        case(name, steps, steps)
        per_step = summary[name]["s"] / steps
    took = time.perf_counter() - t_phase
    log("longrun", f"phase {took:.1f}s (budget {LONGRUN_BUDGET_S:g}s) on "
                   f"{card}; " + ", ".join(
                       f"{k} {v['steps']} steps {v['s']:.2f}s"
                       for k, v in summary.items()))


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ring_rank(rank, world, port, device_type, tmp, out, work="ring"):
    """One rank of phase ``work`` (ring or mesh2d); puts (rank, traceback
    or None, results)."""
    import traceback
    works = {"ring": _ring_work, "mesh2d": _mesh2d_work}
    try:
        out.put((rank, None, works[work](rank, world, port, device_type,
                                         tmp)))
    except BaseException:  # a rank's failure (fail() exits) fails the phase
        out.put((rank, traceback.format_exc(), None))
        raise


def _ring_blocks(mesh):
    """K6's shard block (Hl + 16 rows) and K7's (K = RING_K: Hl + 2*K*8
    rows) of this rank against their plain versions, float32 at the main
    path's shape and float64 at 3 layers of its grid (the same blocks),
    with the kernels' FFT plan and with the TPU kernels' banded DFT
    (held_to_plain).  Returns the largest float32 absolute errors."""
    from gcmiipy_tpu_torch.ops import stream_steps as ss
    from gcmiipy_tpu_torch.ops.mega_step import MegaStep, mega_step_ref
    from gcmiipy_tpu_torch.parallel.mesh import block_rows
    from gcmiipy_tpu_torch.parallel.shard_step import PHJ
    errs = {}
    for shape, dtype in (((MAIN["layers"], MAIN["height"], MAIN["width"]),
                          torch.float32),
                         ((3, MAIN["height"], MAIN["width"]),
                          torch.float64)):
        geom, state = k6_inputs(shape, dtype, True, mesh.device)
        H, L = shape[1], shape[0]
        rows = block_rows(H, mesh.ny, mesh.index, PHJ)
        step = MegaStep(geom, MAIN["dt"], rows=rows)
        block = [x[..., rows, :].contiguous() for x in state]
        got = step(*block)
        torch.cuda.synchronize()
        plain = {name: mega_step_ref(*block, MAIN["dt"], step.geom,
                                     step.consts, filter_ref=f)
                 for name, f in (("FFT plan", fft_plan(step.consts)),
                                 ("banded DFT", None))}
        if not bool((got[2][:, torch.as_tensor(rows == H - 1)] == 0).all()):
            fail("ring", "mega_step_shard: v not 0 on the global wall row")
        tag = (f"rank {mesh.index} mega_step_shard block {len(rows)}x"
               f"{shape[2]}x{L} {str(dtype)[6:]}")
        _, err = held_to_plain(tag, got, plain, MEGA_REL[dtype],
                               banded_bound(dtype, MEGA_REL[dtype]))
        if dtype == torch.float32:
            errs["k6"] = err
        rows = block_rows(H, mesh.ny, mesh.index, RING_K * PHJ)
        multi = ss.StreamSteps(geom, MAIN["dt"], rows=rows)
        packed = ss.pack_state(*[x[..., rows, :].contiguous() for x in state])
        S = torch.stack([packed, torch.zeros_like(packed)])
        got = _planes(multi(S.clone(), None, RING_K), L)
        torch.cuda.synchronize()
        zero = torch.zeros((), dtype=dtype, device=mesh.device)
        plain = {name: _planes(ss.stream_steps_ref(
                     S.clone(), zero, RING_K, MAIN["dt"], multi.geom,
                     multi.consts, filter_ref=f), L)
                 for name, f in (("FFT plan", fft_plan(multi.consts)),
                                 ("banded DFT", None))}
        tag = (f"rank {mesh.index} stream_steps_shard k={RING_K} block "
               f"{len(rows)}x{shape[2]}x{L} {str(dtype)[6:]}")
        _, err = held_to_plain(tag, got, plain, STREAM_REL[dtype],
                               banded_bound(dtype, STREAM_REL[dtype]))
        if dtype == torch.float32:
            errs["k7"] = err
    return errs


def _ring_work(rank, world, port, device_type, tmp):
    """Phase ring's work on one rank (see phase_ring)."""
    import torch.distributed as dist
    from gcmiipy_tpu_torch.model import checkpoint
    from gcmiipy_tpu_torch.model.driver import (
        gen_model_geometry, gen_model_state, make_run_fn, run_model)
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter
    from gcmiipy_tpu_torch.ops.mega_step import mega_step_shard
    from gcmiipy_tpu_torch.ops.pgf_rest import pgf_tile, rest_stencil
    from gcmiipy_tpu_torch.ops.stream_steps import stream_steps_shard
    from gcmiipy_tpu_torch.parallel import distributed, mesh as mesh_mod
    distributed.initialize(f"127.0.0.1:{port}", world, rank,
                           device=device_type)
    mesh = mesh_mod.make_mesh(device=device_type)
    if mesh.device.type != device_type:
        raise RuntimeError(f"rank {rank} runs on {mesh.device}")
    res = {"backend": dist.get_backend(), "device": str(mesh.device),
           "max_abs": _ring_blocks(mesh)}
    kernels = (mega_step_shard, stream_steps_shard, pgf_tile, fft_filter,
               rest_stencil)
    n = MAIN["steps"]
    dims = (MAIN["height"], MAIN["width"], MAIN["layers"], MAIN["dt"])
    for backend in ("stream", "mega4"):
        cfg = _config(backend)
        dist.barrier()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ring, counts = _counted(kernels, lambda: run_model(
                *dims, n, config=cfg, mesh=mesh))
        # one device with the ring's launch size, so that the stats (one
        # entry a call on 'stream') compare entry by entry
        one = run_model(*dims, n, device=mesh.device, config=_config(
            backend, stream_steps=RING_K))
        torch.cuda.synchronize()
        # the ring's guarded loop on its bands, timed (second run)
        geom = gen_model_geometry(cfg, mesh.device)
        band = mesh_mod.shard_state(gen_model_state(geom, cfg), mesh)
        run = make_run_fn(geom, cfg, n, mesh=mesh)
        run(band)
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        run(band)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / n
        stats = {k: rel_err([getattr(ring[7], k)], [getattr(one[7], k)])
                 for k in ("ke", "ate", "geo", "total_energy")}
        extrema = all(torch.equal(getattr(ring[7], k), getattr(one[7], k))
                      for k in ("u_max", "u_min", "v_max", "v_min"))
        res[backend] = dict(
            counts=dict(zip(("mega_step_shard", "stream_steps_shard",
                             "pgf_tile", "fft_filter", "rest_stencil"),
                            counts)),
            bit_equal=bit_equal(ring[:5], one[:5]),
            rel=rel_err(ring[:5], one[:5]), stats_rel=stats,
            extrema_equal=extrema, ms_per_step=ms,
            warnings=[str(w.message) for w in caught])
    # a checkpointed ring run, restored into a single-device run
    ck = os.path.join(tmp, "ring_ck")
    cfg = _config("stream", checkpoint_dir=ck, checkpoint_every=n // 2)
    ring = run_model(*dims, n, config=cfg, mesh=mesh)
    if rank == 0:
        geom = gen_model_geometry(_config("stream"), mesh.device)
        state, step = checkpoint.restore_checkpoint(ck, n // 2,
                                                    device=mesh.device)
        out = make_run_fn(geom, _config("stream"), n - step,
                          start_step=step)(state)
        last, _ = checkpoint.restore_checkpoint(ck, device=mesh.device)
        res["restored"] = dict(
            files=sorted(os.listdir(ck)),
            bit_equal=bit_equal(out[0].prog, ring[:5]),
            rel=rel_err(out[0].prog, ring[:5]),
            last_equal=bit_equal(last.prog, ring[:5]))
    dist.barrier()
    dist.destroy_process_group()
    return res


def _spawn_ranks(phase, device):
    """RING ranks spawned on the one card, each running phase ``phase``'s
    work (ring_rank) within RING_DEADLINE_S; their results by rank.  The
    ranks are joined, and killed if they hang, before it returns."""
    import multiprocessing as mp
    import queue
    import shutil
    import tempfile
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    tmp = tempfile.mkdtemp(prefix=f"gcm_{phase}_")
    procs = [ctx.Process(target=ring_rank, args=(r, RING, port, device.type,
                                                 tmp, out, phase))
             for r in range(RING)]
    t = time.perf_counter()
    for p in procs:
        p.start()
    results, end = {}, time.monotonic() + RING_DEADLINE_S
    try:
        while len(results) < RING:
            try:
                rank, err, res = out.get(timeout=max(1.0, end - time.monotonic()))
            except queue.Empty:
                fail(phase, f"ranks {sorted(set(range(RING)) - set(results))}"
                            f" missed the {RING_DEADLINE_S} s deadline")
            if err is not None:
                fail(phase, f"rank {rank} failed:\n{err}")
            results[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    log(phase, f"{RING} ranks in {time.perf_counter() - t:.1f}s, backend "
               f"{results[0]['backend']} on {results[0]['device']}")
    return results


def phase_ring(device):
    """The lat ring: RING ranks spawned on the one card (gloo: NCCL refuses
    ranks that share a card), after phase build, so that no rank builds.
    Each rank holds its K6 and K7 shard blocks against their plain
    versions (both types), runs run_model(512, 1024, 9, 30.0, 20,
    mesh=ring) on 'stream' and 'mega4' with its launches counted, compares
    the full fields it receives with the single-device run of the same
    backend (to the bit expected; else held to RING_REL and logged) and the
    stats within float32 summation order (RING_STATS_REL; the extrema
    exactly), and times the ring's guarded loop (ranks sharing one card
    over gloo: not a scaling figure).  A checkpointed ring run (every 10
    steps) restores into a single-device run that gives the same fields.
    Then torchrun runs the CLI on RING ranks.  Returns rank 0's results."""
    results = _spawn_ranks("ring", device)
    n, K = MAIN["steps"], RING_K
    want = {"stream": dict(mega_step_shard=0, stream_steps_shard=n // K,
                           pgf_tile=2 * n, fft_filter=2 * n,
                           rest_stencil=2 * n),
            "mega4": dict(mega_step_shard=n, stream_steps_shard=0,
                          pgf_tile=2 * n, fft_filter=2 * n,
                          rest_stencil=2 * n)}
    for rank in range(RING):
        r = results[rank]
        if r["backend"] != "gloo" or not r["device"].startswith(device.type):
            fail("ring", f"rank {rank}: {r['backend']} on {r['device']}")
        for backend in ("stream", "mega4"):
            b = r[backend]
            log("ring", f"rank {rank} run_model {backend} {n} steps on the "
                        f"ring: launches {b['counts']}; fields equal to the "
                        f"single-device run to the bit: {b['bit_equal']} "
                        f"(rel {b['rel']:.3e}); stats rel " + ", ".join(
                            f"{k} {v:.3e}" for k, v in b["stats_rel"].items())
                        + f", extrema equal: {b['extrema_equal']}; "
                        f"{b['ms_per_step']:.4f} ms/step ({RING} ranks "
                        "sharing one card over gloo: not a scaling figure)"
                        + "".join(f"; warned: {w}" for w in b["warnings"]))
            if b["counts"] != want[backend]:
                fail("ring", f"rank {rank} {backend} launched {b['counts']},"
                             f" expected {want[backend]}")
            if not (b["bit_equal"] or b["rel"] <= RING_REL):
                fail("ring", f"rank {rank} {backend}: fields rel "
                             f"{b['rel']:.3e} from the single-device run")
            if max(b["stats_rel"].values()) > RING_STATS_REL \
                    or not b["extrema_equal"]:
                fail("ring", f"rank {rank} {backend}: stats differ")
    restored = results[0]["restored"]
    log("ring", f"checkpointed stream ring run: {restored['files']}; the "
                f"step-{n // 2} checkpoint restored and run {n // 2} steps on "
                f"one device equals the ring's fields to the bit: "
                f"{restored['bit_equal']} (rel {restored['rel']:.3e}); the "
                f"step-{n} checkpoint holds them: {restored['last_equal']}")
    if restored["files"] != [f"step_{s:010d}.npz" for s in (n // 2, n)] \
            or not (restored["bit_equal"] or restored["rel"] <= RING_REL) \
            or not restored["last_equal"]:
        fail("ring", "the ring's checkpoints do not restore its run")

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RING), "-m", "gcmiipy_tpu_torch", "run",
           "--mesh-shape", str(RING), "--height", str(MAIN["height"]),
           "--width", str(MAIN["width"]), "--layers", str(MAIN["layers"]),
           "--dt", str(MAIN["dt"]), "--steps", str(n), "--backend", "stream",
           "--guard", "--device", device.type]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=RING_DEADLINE_S)
    log("ring", f"torchrun --standalone --nproc-per-node {RING} -m "
                f"gcmiipy_tpu_torch run ... exit code {proc.returncode} in "
                f"{time.perf_counter() - t:.1f}s: "
                + " | ".join(proc.stdout.strip().splitlines()))
    if proc.returncode != 0:
        fail("ring", "torchrun failed: " + proc.stderr[-3000:])
    return results[0]


def _f64_case(device):
    """The float64 case of phase mesh2d: 3 layers of the main grid, its
    geometry and a perturbed start (random_state's recipe, seed 5)."""
    import dataclasses
    from gcmiipy_tpu_torch.model.driver import gen_model_geometry, gen_model_state
    from gcmiipy_tpu_torch.model.state import PrognosticVars
    cfg = dataclasses.replace(_config("xla"), layers=MESH2D_F64["layers"],
                              dtype="float64")
    geom = gen_model_geometry(cfg, device)
    state = gen_model_state(geom, cfg)
    return cfg, geom, state._replace(prog=PrognosticVars(
        *random_state(geom, 5, device, torch.float64)))


def _mesh2d_blocks(m22, ring):
    """K3's and K4's shard forms on this rank's block of the 2x2 mesh (its
    256 x 512 core and a halo of EX = 3: 262 x 518) against their plain
    versions to the bit, float32 at the main path's shape and float64 at 3
    layers, flat and with a hill, K4 with Coriolis and the q limiter, each
    launch counted; K5's shard form on this rank's block of the lat ring
    (Hl + 16 rows) against its plain version with the kernel's FFT plan and
    the banded DFT (held_to_plain), both types.  Returns the largest
    float32 absolute errors."""
    from gcmiipy_tpu_torch.ops import pgf_rest as pr
    from gcmiipy_tpu_torch.ops.mega_half import MegaHalf, mega_half_ref
    from gcmiipy_tpu_torch.ops.mega_step import MegaStep, mega_step_ref
    from gcmiipy_tpu_torch.parallel import shard_step as ss
    from gcmiipy_tpu_torch.parallel.mesh import block_cols, block_rows
    from gcmiipy_tpu_torch.parallel.shard_step import EX, PHJ
    H, W, dt = MAIN["height"], MAIN["width"], MAIN["dt"]
    errs, cases = {}, 0
    for L, dtype in ((MAIN["layers"], torch.float32), (3, torch.float64)):
        for hill in (False, True):
            geom, base, seval, filt, pg_phiv = k3k4_inputs(
                (L, H, W), dtype, hill, m22.device)
            rows = block_rows(H, m22.ny, m22.index, EX)
            cols = block_cols(W, m22.nx, m22.x_index, EX)
            bgeom = geom.take_block(rows, cols)

            def blk(a):
                return a[..., rows, :][..., cols].contiguous()

            tag = (f"rank {m22.index * m22.nx + m22.x_index} block "
                   f"{len(rows)}x{len(cols)}x{L} {str(dtype)[6:]} hill={hill}")
            k3 = (blk(seval[0]), blk(seval[1]), blk(seval[3]), bgeom)
            before = pr.pgf_parts_shard.launches
            out = pr.pgf_parts_shard(*k3)
            torch.cuda.synchronize()
            ref = pr.pgf_parts_ref(*k3)
            _bits(f"pgf_parts_shard {tag}", out, ref, pr.pgf_parts_shard,
                  before)
            if dtype == torch.float32:
                errs["k3"] = max(errs.get("k3", 0.0), abs_err(out, ref))
            k4 = (*map(blk, base), *map(blk, seval), blk(filt),
                  blk(pg_phiv), dt, bgeom)
            before = pr.rest_parts_shard.launches
            out = pr.rest_parts_shard(*k4, coriolis=True, q_limiter=True)
            torch.cuda.synchronize()
            ref = pr.rest_parts_ref(*k4, coriolis=True, q_limiter=True)
            _bits(f"rest_parts_shard {tag}", out, ref, pr.rest_parts_shard,
                  before)
            if dtype == torch.float32:
                errs["k4"] = max(errs.get("k4", 0.0), abs_err(out, ref))
            cases += 1
        geom, base = k6_inputs((L, H, W), dtype, True, ring.device)
        seval = random_state(geom, 3, ring.device, dtype)
        rows = block_rows(H, ring.ny, ring.index, PHJ)
        half = MegaHalf(geom, dt, coriolis=True, rows=rows)
        bb = [x[..., rows, :].contiguous() for x in base]
        bs = [x[..., rows, :].contiguous() for x in seval]
        out = half(bb, bs)
        torch.cuda.synchronize()
        if not bool((out[2][:, torch.as_tensor(rows == H - 1)] == 0).all()):
            fail("mesh2d", "mega_half_shard: v not 0 on the global wall row")
        plain = {name: mega_half_ref(bb, bs, dt, half.geom, half.consts,
                                     coriolis=True, filter_ref=f)
                 for name, f in (("FFT plan", fft_plan(half.consts)),
                                 ("banded DFT", None))}
        _, err = held_to_plain(
            f"rank {ring.index} mega_half_shard block {len(rows)}x{W}x{L} "
            f"{str(dtype)[6:]}", out, plain, MEGA_REL[dtype],
            banded_bound(dtype, MEGA_REL[dtype]))
        if dtype == torch.float32:
            errs["k5"] = err
            # K6 on fused4's overlap strips of this rank's band
            _, strips = ss._strips(H // ring.ny, 32, True)
            for lo, lh in strips:
                srows = np.arange(ring.index * (H // ring.ny) + lo - PHJ,
                                  ring.index * (H // ring.ny) + lo + lh
                                  + PHJ) % H
                step = MegaStep(geom, dt, coriolis=True, rows=srows)
                sb = [x[..., srows, :].contiguous() for x in base]
                out = step(*sb)
                torch.cuda.synchronize()
                plain = {name: mega_step_ref(*sb, dt, step.geom, step.consts,
                                             coriolis=True, filter_ref=f)
                         for name, f in (("FFT plan", fft_plan(step.consts)),
                                         ("banded DFT", None))}
                _, err = held_to_plain(
                    f"rank {ring.index} mega_step_shard strip {len(srows)}x"
                    f"{W}x{L}", out, plain, MEGA_REL[dtype], MEGA_REL[dtype])
                errs["k6_strips"] = max(errs.get("k6_strips", 0.0), err)
    log("mesh2d", f"pgf_parts_shard and rest_parts_shard equal their plain "
                  f"versions to the bit on this rank's block in {cases} cases "
                  "each")
    return errs


def _profile_split(step, band, steps, device):
    """Rank 0's split of ``steps`` calls of ``step`` (torch.profiler's
    device activity, after one warm-up call in the same session): device
    ms a step of the pgf tile (K3), the rest tile (K4), the float64
    matmuls (the spectral-psum filter), the host-device copies (gloo's
    staging) and the other kernels, and wall ms a step; the other ranks
    run the same 1 + ``steps`` steps unprofiled.  The host's collectives
    are timed by _mesh2d_parts.  The session's first start in a process
    costs about 8 s (chip call 7, PR 14)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from gcmiipy_tpu_torch.step_profile import _device_us
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        for k in range(1 + steps):
            if k == 1:
                torch.cuda.synchronize()
                t = time.perf_counter()
            band = step(*band)
            if k == steps:
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t) / steps
            prof.step()
    split = dict.fromkeys(("pgf_tile", "tile_stencil", "gemm", "memcpy",
                           "other kernels"), 0.0)
    for e in prof.key_averages():
        key = e.key.lower()
        # the step markers are annotations on the device's timeline
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or key.startswith("profilerstep")
                or getattr(e, "is_user_annotation", False)):
            continue
        name = next((k for k in ("pgf_tile", "tile_stencil", "memcpy")
                     if k in key), None)
        if name is None:
            name = "gemm" if "gemm" in key else "other kernels"
        split[name] += _device_us(e) / 1e3 / steps
    split["wall"] = wall
    return split


def _mesh2d_work(rank, world, port, device_type, tmp):
    """Phase mesh2d's work on one rank (see phase_mesh2d)."""
    import dataclasses

    import torch.distributed as dist
    from gcmiipy_tpu_torch.dynamics import fused
    from gcmiipy_tpu_torch.model import checkpoint
    from gcmiipy_tpu_torch.model.driver import (
        gen_model_geometry, make_run_fn, run_model)
    from gcmiipy_tpu_torch.ops import mega_half as mh, mega_step as ms
    from gcmiipy_tpu_torch.ops import pgf_rest as pr
    from gcmiipy_tpu_torch.parallel import distributed, ensemble
    from gcmiipy_tpu_torch.parallel import mesh as mesh_mod
    from gcmiipy_tpu_torch.parallel import shard_step as ss
    distributed.initialize(f"127.0.0.1:{port}", world, rank,
                           device=device_type)
    m22 = mesh_mod.make_mesh(device=device_type, shape=(2, 2))
    m14 = mesh_mod.make_mesh(device=device_type, shape=(1, 4))
    ring = mesh_mod.make_mesh(device=device_type)
    # the ensembles' meshes: every rank creates their groups, in one order
    e_pure = ensemble.make_ensemble_mesh(device=device_type)
    e_yx = ensemble.make_ensemble_mesh(device=device_type,
                                       shape=ENSEMBLE_SHAPE)
    dev = ring.device
    clock = [time.perf_counter()]

    def tick(part):  # this rank's seconds in each part of the work
        now = time.perf_counter()
        res["seconds"][part] = now - clock[0]
        clock[0] = now

    res = {"backend": dist.get_backend(), "device": str(dev), "seconds": {},
           "max_abs": _mesh2d_blocks(m22, ring)}
    tick("start and blocks")
    n, dt = MAIN["steps"], MAIN["dt"]
    dims = (MAIN["height"], MAIN["width"], MAIN["layers"], dt)
    geom = gen_model_geometry(_config("mega4"), dev)
    start = perturbed_state(geom, dev)
    ref0 = rank == 0  # the single-device references run on rank 0

    def gathered(state, mesh):
        return tuple(mesh_mod.gather_state(state, mesh).prog)

    def marked(cfg, state, marks, mesh=None, g=geom):
        """The fields of one run from ``state`` after each of ``marks``
        steps (the run carried on from one mark to the next), gathered on
        a mesh, and the ms a step of the last stretch (host clock, the
        ranks started together, the run fn built before)."""
        if mesh is not None:
            state = mesh_mod.shard_state(state, mesh)
        got, done = {}, 0
        for mark in marks:
            run = make_run_fn(g, cfg, mark - done, mesh=mesh, start_step=done)
            if mesh is not None:
                dist.barrier()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run(state)
            torch.cuda.synchronize()
            per_step = 1e3 * (time.perf_counter() - t) / (mark - done)
            if not bool(out[2].ok):
                fail("mesh2d", f"{cfg.backend} on "
                               f"{mesh.shape if mesh else 'one device'}: "
                               "guard tripped")
            state, done = out[0], mark
            got[mark] = (tuple(state.prog) if mesh is None
                         else gathered(state, mesh))
        return got, per_step

    # the main path, counted: run_model on the 2x2 mesh, 'mega4' -> fused2d,
    # checkpointed every n // 2 steps
    kernels = (pr.pgf_parts_shard, pr.rest_parts_shard, pr.pgf_tile,
               pr.rest_stencil, ss.spectral_psum)
    names = ("pgf_parts_shard", "rest_parts_shard", "pgf_tile",
             "rest_stencil", "spectral_psum")
    ck = os.path.join(tmp, "mesh2d_ck")
    dist.barrier()
    main, counts = _counted(kernels, lambda: run_model(
        *dims, n, mesh=m22, config=_config(
            "mega4", checkpoint_dir=ck, checkpoint_every=n // 2)))
    res["counts"] = dict(zip(names, counts))
    res["rel"] = {}
    if ref0:
        one = run_model(*dims, n, device=dev, config=_config("xla", "dft"))
        res["rel"]["run_model mega4 2x2"] = (
            rel_err(main[:5], one[:5]),
            float((main[0] - one[0]).abs().max()))
    tick("main run")
    # the untimed checks first: the CLI's torchrun starts beside the ranks
    # (phase_mesh2d) and is done before the timed runs begin
    # float64 at 3 layers, 2 steps
    cfg64, geom64, start64 = _f64_case(dev)
    n64 = MESH2D_F64["steps"]
    ref64 = (marked(dataclasses.replace(cfg64, polar_filter="dft"), start64,
                    (n64,), g=geom64)[0][n64] if ref0 else None)
    for backend, mesh, label in (("mega4", m22, "2x2"), ("xla", m22, "2x2"),
                                 ("xla", m14, "1x4")):
        got = marked(dataclasses.replace(cfg64, backend=backend), start64,
                     (n64,), mesh, geom64)[0][n64]
        if ref0:
            res["rel"][f"{backend} {label} float64"] = rel_err(got, ref64)
    tick("float64 runs")
    # 'stream' on 2x2: the warning, then fused2d's fields to the bit
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stream = run_model(*dims, n, config=_config("stream"), mesh=m22)
    res["stream"] = dict(bit_equal=bit_equal(stream[:5], main[:5]),
                         warned=[str(w.message) for w in caught])
    tick("stream")
    # the main run's checkpoints: the last, restored on one device, holds
    # its fields; the step-10 one, restored and cut into blocks, resumed
    # on the mesh gives them to the bit
    state, step = checkpoint.restore_checkpoint(ck, n // 2, device=dev)
    resumed = make_run_fn(geom, _config("mega4"), n - step, mesh=m22,
                          start_step=step)(mesh_mod.shard_state(state, m22))
    res["restored"] = dict(files=sorted(os.listdir(ck)),
                           resumed_equal=bit_equal(
                               gathered(resumed[0], m22), main[:5]))
    if ref0:
        last, _ = checkpoint.restore_checkpoint(ck, device=dev)
        res["restored"]["last_equal"] = bit_equal(last.prog, main[:5])
    tick("checkpoints")
    # from the perturbed start, one run each read after 1 and 20 steps:
    # mega4 on 2x2 (its last 19 steps timed: the 2x2 guarded loop's
    # ms/step), xla on 2x2 and on 1x4, against the single-device plain
    # core with the DFT filter
    refs = (marked(_config("xla", "dft"), start, (1, n))[0] if ref0
            else None)
    for backend, mesh, label in (("xla", m22, "2x2"), ("xla", m14, "1x4"),
                                 ("mega4", m22, "2x2")):
        got, ms_step = marked(_config(backend), start, (1, n), mesh)
        if backend == "mega4":
            res["ms_per_step"] = ms_step
        if ref0:
            res["rel"][f"{backend} {label}"] = (
                rel_err(got[1], refs[1]), rel_err(got[n], refs[n]),
                float((got[n][0] - refs[n][0]).abs().max()))
    tick("perturbed runs")
    # K5's ring against single-device 'mega'; fused4 overlap=True against
    # the one-kernel ring; each form's ms/step (20 steps after a counted
    # warm-up run, the ranks started together)
    band = tuple(mesh_mod.shard_state(start, ring).prog)

    def steps_of(step, k):
        s = band
        for _ in range(k):
            s = step(*s)
        return s

    forms = {"k5 ring": (ss.make_shard_step_fused(ring, geom, dt),
                         (mh.mega_half_shard,)),
             "fused4 overlap": (ss.make_shard_step_fused4(ring, geom, dt,
                                                          overlap=True),
                                (ms.mega_step_shard,)),
             "fused4": (ss.make_shard_step_fused4(ring, geom, dt),
                        (ms.mega_step_shard,))}
    res["forms"] = {}
    for name, (step, counters) in forms.items():
        dist.barrier()
        out, cnt = _counted(counters, lambda: steps_of(step, n))
        out = tuple(mesh_mod.gather_field(x, ring) for x in out)
        dist.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps_of(step, n)
        torch.cuda.synchronize()
        res["forms"][name] = dict(launches=cnt[0], out=out,
                                  ms=1e3 * (time.perf_counter() - t) / n)
    f = res["forms"]
    f["fused4 overlap"]["bit_equal"] = bit_equal(f["fused4 overlap"]["out"],
                                                 f["fused4"]["out"])
    if ref0:
        mega = fused.make_fused_step(geom, dt, pipeline="mega")
        s = tuple(start.prog)
        for _ in range(n):
            s = mega(*s)
        f["k5 ring"]["bit_equal"] = bit_equal(f["k5 ring"]["out"], s)
        f["k5 ring"]["rel"] = rel_err(f["k5 ring"]["out"], s)
    for v in f.values():
        del v["out"]
    tick("ring forms")
    # rank 0's profile of the 2x2 step
    blocks = mesh_mod.shard_state(start, m22)
    step = ss.make_shard_step_fused2d(m22, geom, dt)
    b = tuple(blocks.prog)
    dist.barrier()
    if ref0:
        res["split"] = _profile_split(step, b, 10, dev)
    else:
        for _ in range(11):
            step(*b)
        torch.cuda.synchronize()
    tick("profile")
    res["psum"] = _psum_check(m22, geom, start)
    res["parts"] = _mesh2d_parts(m22, geom, blocks)
    tick("psum check and parts")
    res["ensembles"] = _ensemble_checks(rank, e_pure, e_yx, geom, dev)
    tick("ensembles")
    dist.barrier()
    dist.destroy_process_group()
    return res


def _ensemble_checks(rank, e_pure, e_yx, geom, dev):
    """The ensembles of phase mesh2d on this rank: 4 members on the pure
    'e' mesh (one a rank, K6) and 2 on the ('e','y','x') mesh of
    ENSEMBLE_SHAPE (one a member group, its lat ring of 2 ranks running
    K6's ring form), ENSEMBLE_STEPS steps of 'mega4' each from a perturbed
    start of its own seed, with the launches counted; every rank receives
    all the members, and holds member ``rank % members`` against its
    single-device 'mega4' run.  Then the ('e','y','x') ensemble in float64
    at 3 layers against the single-device float64 runs."""
    import dataclasses

    import torch.distributed as dist
    from gcmiipy_tpu_torch.model.driver import gen_model_state, make_run_fn
    from gcmiipy_tpu_torch.model.state import PrognosticVars
    from gcmiipy_tpu_torch.ops import mega_step as ms
    from gcmiipy_tpu_torch.parallel import ensemble
    n = ENSEMBLE_STEPS
    out = {}

    def members(g, cfg, count, dtype):
        base = gen_model_state(g, cfg)
        return [base._replace(prog=PrognosticVars(
            *random_state(g, 20 + k, dev, dtype))) for k in range(count)]

    def one(g, cfg, state):
        return tuple(make_run_fn(g, dataclasses.replace(cfg, guard=False),
                                 n)(state)[0].prog)

    cases = (("pure 'e'", e_pure, 4, _config("mega4"), geom, torch.float32),
             (f"{ENSEMBLE_SHAPE}", e_yx, 2, _config("mega4"), geom,
              torch.float32))
    cfg64, geom64, _ = _f64_case(dev)
    cases += ((f"{ENSEMBLE_SHAPE} float64", e_yx, 2,
               dataclasses.replace(cfg64, backend="mega4"), geom64,
               torch.float64),)
    for tag, emesh, count, cfg, g, dtype in cases:
        starts = members(g, cfg, count, dtype)
        run = ensemble.make_ensemble_run_fn(g, cfg, n, emesh)
        dist.barrier()
        t = time.perf_counter()
        (states, stats), counts = _counted(
            (ms.mega_step, ms.mega_step_shard),
            lambda: run(ensemble.stack_states(starts)))
        seconds = time.perf_counter() - t
        k = rank % count
        ref = one(g, cfg, starts[k])
        got = tuple(x[k] for x in states.prog)
        out[tag] = dict(
            counts=dict(zip(("mega_step", "mega_step_shard"), counts)),
            member=k, bit_equal=bit_equal(got, ref), rel=rel_err(got, ref),
            members=int(states.step.shape[0]),
            stats_shape=tuple(stats.total_energy.shape), seconds=seconds,
            finite=all(bool(torch.isfinite(x).all()) for x in states.prog))
    return out


def _psum_check(m22, geom, start):
    """The spectral-psum filter on this rank's block held against an
    independent plain filter: K3's stack (its plain version) of the
    perturbed start's whole globe, cut to the rank's 256 x 512 core and
    filtered over the mesh row (float32 in and out, float64 sums), against
    torch.fft's filter (polar_filter.arakawa_1977) of the whole stack in
    float64, cut to the same core.  Returns (max abs error, the filtered
    field's max abs)."""
    from gcmiipy_tpu_torch.ops import pgf_rest as pr, polar_filter
    from gcmiipy_tpu_torch.parallel import shard_step as ss
    p, u, _, t, _ = start.prog
    stack = pr.pgf_parts_ref(p, u, t, geom)[0]
    hl, wl = geom.height // m22.ny, geom.width // m22.nx
    rows = slice(m22.index * hl, (m22.index + 1) * hl)
    cols = slice(m22.x_index * wl, (m22.x_index + 1) * wl)
    got = ss.spectral_psum_filter(m22, geom)(stack[:, rows, cols]
                                             .contiguous())
    want = polar_filter.arakawa_1977(stack.double(), geom)[:, rows, cols]
    return float((got.double() - want).abs().max()), float(want.abs().max())


def _mesh2d_parts(m22, geom, blocks):
    """Host ms a call of the 2x2 step's parts, each run on every rank at
    once (a barrier, 10 calls, a synchronise): the state's and spu's 2D
    halo exchanges, the spectral-psum filter, its all_reduce of the float64
    spectra alone (on the card, as gloo takes it, and through pinned host
    memory), K3's and K4's shard forms, and the guard's and the stats'
    reductions (driver._Ring)."""
    import torch.distributed as dist
    from gcmiipy_tpu_torch.model.driver import _Ring
    from gcmiipy_tpu_torch.ops import pgf_rest as pr, stream_steps
    from gcmiipy_tpu_torch.parallel import distributed, halo
    from gcmiipy_tpu_torch.parallel import shard_step as ss

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    L = geom.layers
    packed = stream_steps.pack_state(*blocks.prog)
    block = stream_steps.unpack_state(halo.exchange_2d(packed, ss.EX, m22), L)
    bgeom = ss._block_geom(m22, geom, ss.EX)
    stack, pg_phiv = pr.pgf_parts_shard(block[0], block[1], block[3], bgeom)
    core = halo.trim(stack, ss.EX, ss.BOTH).contiguous()
    fcore = ss.spectral_psum_filter(m22, geom)
    spec = torch.randn(core.shape[0] * core.shape[1], 2 * core.shape[-1],
                       dtype=torch.float64, device=core.device)
    filt = torch.cat([halo.exchange_2d(core[:L], ss.EX, m22),
                      torch.nn.functional.pad(core[L:], (ss.EX,) * 4)])

    def host_all_reduce():
        h = torch.empty(spec.shape, dtype=spec.dtype,
                        pin_memory=spec.is_cuda)
        h.copy_(spec)
        dist.all_reduce(h, group=m22.row_group)
        spec.copy_(h)

    ring = _Ring(m22, geom, _config("mega4"))
    return {
        "exchange_2d state": timed(
            lambda: halo.exchange_2d(packed, ss.EX, m22)),
        "exchange_2d spu": timed(
            lambda: halo.exchange_2d(core[:L], ss.EX, m22)),
        "psum filter": timed(lambda: fcore(core)),
        "all_reduce spectra (gloo, CUDA)": timed(
            lambda: distributed.all_reduce(spec, dist.ReduceOp.SUM,
                                           m22.row_group)),
        "all_reduce spectra (pinned host)": timed(host_all_reduce),
        "K3 + K4 shard forms": timed(lambda: pr.rest_parts_shard(
            *block, *block, filt, pg_phiv, MAIN["dt"], bgeom)
            + pr.pgf_parts_shard(block[0], block[1], block[3], bgeom)),
        "guard + stats": timed(lambda: (ring.bad(blocks),
                                        ring.stats(blocks))),
        "spectra MB": spec.numel() * 8 / 1e6,
    }


def _wide_native(device):
    """stream_wide_native: 'stream' with a one-day drag every 2nd step at
    512 x 4096 (over JAX's resident width, so the flag chooses K7 calls
    of 2 steps with the drag between them; off, per-step 'mega4'), 4 steps
    from the quiescent start, against 'mega4' to the bit; both loops'
    ms/step (the median of three more runs)."""
    from gcmiipy_tpu_torch.model.config import ModelConfig
    from gcmiipy_tpu_torch.model.driver import (
        gen_model_geometry, gen_model_state, make_run_fn)
    from gcmiipy_tpu_torch.ops.stream_steps import stream_steps
    base = dict(WIDE, backend="stream", stream_wide_native=True, guard=True,
                drag_tau=86400.0, physics_every=2)
    steps = base.pop("steps")
    cfgs = {"stream": ModelConfig(**base),
            "mega4": ModelConfig(**dict(base, backend="mega4"))}
    geom = gen_model_geometry(cfgs["mega4"], device)
    out, ms = {}, {}
    for name, cfg in cfgs.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run = make_run_fn(geom, cfg, steps)
        if caught:
            fail("mesh2d", f"wide {name} warned: {caught[0].message}")
        res, (calls,) = _counted((stream_steps,),
                                 lambda: run(gen_model_state(geom, cfg)))
        if not bool(res[2].ok):
            fail("mesh2d", f"wide {name}: guard tripped")
        out[name] = tuple(res[0].prog)
        if name == "stream" and (getattr(run, "chunk_steps", None) != 2
                                 or calls != steps // 2):
            fail("mesh2d", f"stream_wide_native made {calls} K7 calls, "
                           f"expected {steps // 2}")
        times = []
        for _ in range(3):
            state = gen_model_state(geom, cfg)
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(state)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t) / steps)
        ms[name] = statistics.median(times)
    equal = bit_equal(out["stream"], out["mega4"])
    log("mesh2d", f"stream_wide_native at {WIDE['layers']}x{WIDE['height']}x"
                  f"{WIDE['width']} float32 (drag every 2nd step), {steps} "
                  f"steps: K7 calls of 2 steps, equal to mega4 to the bit: "
                  f"{equal} (rel {rel_err(out['stream'], out['mega4']):.3e});"
                  f" {ms['stream']:.4f} ms/step on stream, {ms['mega4']:.4f} "
                  "on mega4")
    if not equal:
        fail("mesh2d", "stream_wide_native differs from mega4")
    return ms


def phase_mesh2d(device):
    """The 2D (lat x lon) mesh and the ring's last forms: RING ranks spawned
    on the one card over gloo, as phase ring.  Each rank holds K3's and K4's
    shard forms on its 2x2 block (262 x 518) against their plain versions
    to the bit and K5's on its ring block (144 rows) against its plain
    version; runs run_model(512, 1024, 9, 30.0, 20, mesh=2x2) on 'mega4'
    (fused2d), checkpointed every 10 steps, with its launches counted (K3's
    and K4's shard forms and the spectral-psum filter twice a step) against
    the single-device plain core with the DFT filter (tpu_parity.py's
    bounds), its last checkpoint restored on one device and its step-10
    one resumed on the mesh; from the perturbed start, one run each read
    after 1 and 20 steps, 'mega4' on 2x2 (its last 19 steps timed: the 2x2
    guarded loop) and 'xla' on 2x2 and 1x4; the same in float64 at 3
    layers for 2 steps within MESH2D_REL64; 'stream' on 2x2 (JAX's
    warning, fused2d's fields to the bit); K5's ring (make_shard_step_fused)
    against single-device 'mega' and fused4's overlap form against its
    one-kernel ring, each to the bit and timed; the spectral-psum filter
    against torch.fft's (PSUM_REL); rank 0's step profiled (ranks sharing
    one card over gloo: not a scaling figure).  Then stream_wide_native at
    512 x 4096.  torchrun of the CLI on a 2x2 mesh runs beside the ranks
    from their start; the ranks run their untimed checks first.  Returns
    rank 0's results."""
    import signal
    import tempfile
    # the CLI's torchrun starts beside the ranks: its start overlaps the
    # ranks' untimed checks, which they run before their timed ones
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(RING), "-m", "gcmiipy_tpu_torch", "run",
           "--mesh-shape", "2,2", "--height", str(MAIN["height"]),
           "--width", str(MAIN["width"]), "--layers", str(MAIN["layers"]),
           "--dt", str(MAIN["dt"]), "--steps", "4", "--backend", "mega4",
           "--guard", "--device", device.type]
    logs = [tempfile.TemporaryFile("w+") for _ in range(2)]
    cli = subprocess.Popen(cmd, cwd=REPO_DIR, stdout=logs[0], stderr=logs[1],
                           text=True, start_new_session=True)
    try:
        r0 = _mesh2d_checks(device)
        code = cli.wait(timeout=RING_DEADLINE_S)
    finally:
        if cli.poll() is None:
            os.killpg(cli.pid, signal.SIGKILL)
            cli.wait()
    out, err = [(f.seek(0), f.read())[1] for f in logs]
    for f in logs:
        f.close()
    log("mesh2d", f"torchrun --standalone --nproc-per-node {RING} -m "
                  f"gcmiipy_tpu_torch run --mesh-shape 2,2 ... (started "
                  f"with the ranks) exit code {code}: "
                  + " | ".join(out.strip().splitlines()))
    if code != 0:
        fail("mesh2d", "torchrun failed: " + err[-3000:])
    return r0


def _mesh2d_checks(device):
    """Phase mesh2d's ranks and their checks, then stream_wide_native;
    rank 0's results."""
    results = _spawn_ranks("mesh2d", device)
    n = MAIN["steps"]
    want = dict(pgf_parts_shard=2 * n, rest_parts_shard=2 * n,
                pgf_tile=2 * n, rest_stencil=2 * n, spectral_psum=2 * n)
    want_forms = {"k5 ring": 2 * n, "fused4 overlap": 3 * n, "fused4": n}
    for rank in range(RING):
        r = results[rank]
        if r["backend"] != "gloo" or not r["device"].startswith(device.type):
            fail("mesh2d", f"rank {rank}: {r['backend']} on {r['device']}")
        log("mesh2d", f"rank {rank} run_model mega4 {n} steps on the 2x2 "
                      f"mesh, checkpointed: launches {r['counts']}; the "
                      f"guarded loop {r['ms_per_step']:.4f} ms/step (steps "
                      f"2-{n} from the perturbed start; {RING} ranks sharing "
                      "one card over gloo: not a scaling figure)")
        if r["counts"] != want:
            fail("mesh2d", f"rank {rank} launched {r['counts']}, expected "
                           f"{want}")
        if not r["stream"]["bit_equal"] or not any(
                "latitude only" in w for w in r["stream"]["warned"]):
            fail("mesh2d", f"rank {rank}: 'stream' on 2x2 did not warn or "
                           "differs from mega4 on 2x2")
        for name, f in r["forms"].items():
            if f["launches"] != want_forms[name]:
                fail("mesh2d", f"rank {rank} {name} launched "
                               f"{f['launches']}, expected {want_forms[name]}")
        if not r["forms"]["fused4 overlap"]["bit_equal"]:
            fail("mesh2d", f"rank {rank}: the overlap ring differs from the "
                           "one-kernel ring")
        if not r["restored"]["resumed_equal"]:
            fail("mesh2d", f"rank {rank}: the resumed 2x2 run differs")
        err, scale = r["psum"]
        log("mesh2d", f"rank {rank} spectral-psum filter on its 256x512 "
                      f"core of the perturbed start's K3 stack against "
                      f"torch.fft's float64 filter of the whole stack: max "
                      f"abs {err:.3e}, {err / scale:.3e} of the field's "
                      f"scale (< {PSUM_REL:g})")
        if not err < PSUM_REL * scale:
            fail("mesh2d", f"rank {rank}: the spectral-psum filter is off "
                           "the plain filter")
    r0 = results[0]
    r0["psum_err"] = max(results[r]["psum"][0] for r in range(RING))
    log("mesh2d", "'stream' on 2x2 warned: " + r0["stream"]["warned"][0])
    for tag, v in r0["rel"].items():
        if "float64" in tag:
            log("mesh2d", f"{tag}, {MESH2D_F64['steps']} steps, against the "
                          f"single-device plain core with the DFT filter: "
                          f"rel {v:.3e} (< {MESH2D_REL64:g})")
            if not v < MESH2D_REL64:
                fail("mesh2d", f"{tag} outside {MESH2D_REL64:g}")
        elif len(v) == 2:
            log("mesh2d", f"{tag} (quiescent start) against the single-device "
                          f"plain core with the DFT filter: {n}-step rel "
                          f"{v[0]:.3e} (< {RUN_REL:g}), p drift {v[1]:.3e} Pa")
            if not (v[0] < RUN_REL and v[1] < DRIFT_PA):
                fail("mesh2d", tag + " outside the tpu_parity.py bounds")
        else:
            log("mesh2d", f"{tag} from the perturbed start against the "
                          f"single-device plain core with the DFT filter: "
                          f"1-step rel {v[0]:.3e} (< {STEP1_REL:g}), {n}-step"
                          f" rel {v[1]:.3e} (< {RUN_REL:g}), p drift "
                          f"{v[2]:.3e} Pa (< {DRIFT_PA:g})")
            if not (v[0] < STEP1_REL and v[1] < RUN_REL and v[2] < DRIFT_PA):
                fail("mesh2d", tag + " outside the tpu_parity.py bounds")
    f = r0["forms"]
    log("mesh2d", f"K5's ring (make_shard_step_fused, 4x1) {n} steps equal to "
                  f"single-device 'mega' to the bit: {f['k5 ring']['bit_equal']}"
                  f" (rel {f['k5 ring']['rel']:.3e}); {f['k5 ring']['ms']:.4f} "
                  f"ms/step; fused4 overlap=True equal to the one-kernel ring "
                  f"to the bit: {f['fused4 overlap']['bit_equal']}, "
                  f"{f['fused4 overlap']['ms']:.4f} ms/step against "
                  f"{f['fused4']['ms']:.4f} (rank 0, {RING} ranks on one card "
                  "over gloo)")
    if not f["k5 ring"]["bit_equal"]:
        fail("mesh2d", "K5's ring differs from single-device 'mega'")
    rs = r0["restored"]
    log("mesh2d", f"checkpointed 2x2 run: {rs['files']}; the last restored on "
                  f"one device holds its fields: {rs['last_equal']}; the "
                  f"step-{n // 2} one resumed on the mesh equals it to the "
                  f"bit: {rs['resumed_equal']}")
    if rs["files"] != [f"step_{s:010d}.npz" for s in (n // 2, n)] \
            or not rs["last_equal"]:
        fail("mesh2d", "the 2x2 run's checkpoints do not restore it")
    log("mesh2d", "rank 0's 2x2 step (torch.profiler, 10 steps after a "
        "warm-up step in the same session), ms a step: "
        + ", ".join(f"{k} {v:.4f}" for k, v in r0["split"].items()))
    log("mesh2d", "rank 0's seconds in each part of its work: " + ", ".join(
        f"{k} {v:.1f}" for k, v in r0["seconds"].items()))
    log("mesh2d", "the 2x2 step's parts, all ranks at once, host ms a call "
        "(rank 0): " + ", ".join(f"{k} {v:.4f}"
                                 for k, v in r0["parts"].items()))
    _log_ensembles(results)
    r0["wide_ms"] = _wide_native(device)
    return r0


def _log_ensembles(results):
    """Phase mesh2d's ensembles, every rank: all the members received, the
    launches of K6 (a member a rank on the pure 'e' mesh) and of K6's ring
    form (a member a group of 2 ranks), each member equal to its
    single-device run (to the bit expected; the float64 case within
    MESH2D_REL64, the float32 ones within RING_REL)."""
    n = ENSEMBLE_STEPS
    want = {"pure 'e'": dict(mega_step=n, mega_step_shard=0)}
    want[f"{ENSEMBLE_SHAPE}"] = dict(mega_step=0, mega_step_shard=n)
    want[f"{ENSEMBLE_SHAPE} float64"] = dict(mega_step=0, mega_step_shard=n)
    for rank in range(RING):
        for tag, e in results[rank]["ensembles"].items():
            bound = MESH2D_REL64 if "float64" in tag else RING_REL
            log("mesh2d", f"rank {rank} ensemble {tag}, {e['members']} "
                          f"members, {n} mega4 steps in {e['seconds']:.2f}s: "
                          f"launches {e['counts']}; member {e['member']} "
                          f"equal to its single-device run to the bit: "
                          f"{e['bit_equal']} (rel {e['rel']:.3e}, < "
                          f"{bound:g}); stats {e['stats_shape']}")
            if e["counts"] != want[tag]:
                fail("mesh2d", f"rank {rank} ensemble {tag} launched "
                               f"{e['counts']}, expected {want[tag]}")
            if not (e["finite"] and e["rel"] < bound
                    and e["stats_shape"] == (e["members"], n)):
                fail("mesh2d", f"rank {rank} ensemble {tag}: a member differs"
                               " from its single-device run")


def _bytes(tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def _filter_buffers(fc):
    """The filter buffers the kernels of K5, K6 and K7 read."""
    return fc.mask, fc.twiddle, fc.lats, fc.keep


def _filter_ops(fc, geom, rounds):
    """float64 operations of ``rounds`` FFT filter rounds on the stacked
    2L planes (fft_filter.round_ops: the radix plan's butterflies and
    twiddle products, the mask and the final adds)."""
    from gcmiipy_tpu_torch.ops import fft_filter as ff
    return rounds * ff.round_ops(2 * geom.layers, geom.width,
                                 int(fc.lats.numel()))


def _bound(nbytes, ops):
    """(bound ms, what bounds it, its working): the larger of ``nbytes``
    over the memory rate and ``ops`` (operations by arithmetic type) each
    over its type's peak rate."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = sum(1e3 * n / PEAK_OPS_PER_S[t] for t, n in ops.items())
    op_text = " + ".join(f"{n / 1e9:.3f} Gop {str(t)[6:]}"
                         for t, n in ops.items())
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB -> "
            f"{bytes_ms:.4f} ms; {op_text} -> {ops_ms:.4f} ms)")


def _row(name, source, replaces, launches, max_abs, ms, plain_ms, nbytes,
         ops, library_ms, tag, launch_ms=None):
    """A kernels-JSON row; ``ops`` maps each arithmetic type to the
    operations done in it, each timed at that type's peak rate.
    ``launch_ms``: the device ms of each kernel launch a call, by name
    (step_profile.kernel_ms), added to the row when given."""
    bound_ms, bound_by, text = _bound(nbytes, ops)
    log("timing", f"{tag} {ms:.4f} ms/call, plain {plain_ms:.4f} ms; bound "
                  f"{text}; {100 * bound_ms / ms:.1f}% of bound")
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": max_abs,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    if launch_ms is not None:
        log("timing", f"{tag} device ms a launch (torch.profiler): " + ", ".join(
            f"{k} {v:.4f}" for k, v in launch_ms.items()))
        row["launch_ms"] = launch_ms
    return row


def phase_timing(device, launches, max_abs, geom, start, surface):
    from gcmiipy_tpu_torch.dynamics import core25d, fused
    from gcmiipy_tpu_torch.model.driver import make_run_fn
    from gcmiipy_tpu_torch.ops import polar_filter
    from gcmiipy_tpu_torch.ops.fused_parts import (
        GEOM_FIELDS, fused_parts, fused_parts_ref, pgf_column)
    from gcmiipy_tpu_torch.ops.mega_step import (
        MegaStep, banded_round, mega_step_ref)
    from gcmiipy_tpu_torch.ops.stream_steps import stream_steps_ref
    from gcmiipy_tpu_torch.step_profile import kernel_ms

    # ms/step of the whole loop (make_run_fn with the guard and the stats):
    # windows of STEP_WINDOW steps between CUDA events, no host sync inside
    # a window, each backend twice, in the order x f m m4 s m4+p m4+p/4 s+p
    # s+surface m4+surface, then back.  mega4+physics/4 runs the per-step
    # physics every 4th step (the extras skipped off cadence, a host count
    # of the steps); the +surface runs are Config S of phase surface, over
    # the Hansen terrain from its moist start.
    configs = {"xla": _config("xla"), "fused": _config("fused"),
               "mega": _config("mega"),
               "mega4": _config("mega4"), "stream": _config("stream"),
               "mega4+physics": _config("mega4", **PHYSICS),
               "mega4+physics/4": _config("mega4", **dict(PHYSICS,
                                                          physics_every=4)),
               "stream+physics": _config("stream", **PHYSICS),
               "stream+surface": _config("stream", **SURFACE),
               "mega4+surface": _config("mega4", **SURFACE)}
    backends = tuple(configs)
    starts = {b: surface if b.endswith("+surface") else (geom, start)
              for b in backends}
    runs = {b: make_run_fn(starts[b][0], c, STEP_WINDOW)
            for b, c in configs.items()}
    for b, run in runs.items():
        run(starts[b][1])
    windows = {b: [] for b in backends}
    for backend in backends + backends[::-1]:
        ms = cuda_ms(lambda: runs[backend](starts[backend][1]), 1, warmup=0)
        windows[backend].append(ms / STEP_WINDOW)
    step_ms = {b: statistics.mean(v) for b, v in windows.items()}
    log("timing", f"ms/step over 2 windows of {STEP_WINDOW} steps: " + ", ".join(
        f"{b} {step_ms[b]:.4f} ({windows[b][0]:.4f}, {windows[b][1]:.4f})"
        for b in backends))

    # the v2 step beside the fused step, the dynamics alone (as bench.py
    # times 'fused2'): loops of STEP_WINDOW steps, in the order f v2 v2 f
    prog = tuple(start.prog)
    steps = {"fused": fused.make_fused_step(geom, MAIN["dt"]),
             "v2": fused.make_fused_matsuno_v2(geom, MAIN["dt"])}

    def loop(step):
        state = prog
        for _ in range(STEP_WINDOW):
            state = step(*state)

    for step in steps.values():
        loop(step)
    dyn = {b: [] for b in steps}
    for b in ("fused", "v2", "v2", "fused"):
        dyn[b].append(cuda_ms(lambda: loop(steps[b]), 1, warmup=0) / STEP_WINDOW)
    log("timing", f"dynamics alone, ms/step over 2 loops of {STEP_WINDOW} steps: "
                  + ", ".join(f"{b} {statistics.mean(v):.4f} ({v[0]:.4f}, "
                              f"{v[1]:.4f})" for b, v in dyn.items()))
    rows = []

    def k1_timed(args, kgeom):
        call = (*args, MAIN["dt"], kgeom)
        geo = [getattr(kgeom, n) for n in GEOM_FIELDS]
        return dict(source="gcmiipy_tpu_torch/csrc/fused_parts.cu",
                    ms=cuda_ms(lambda: fused_parts(*call), 50),
                    launch_ms=kernel_ms(lambda: fused_parts(*call)),
                    plain_ms=cuda_ms(lambda: fused_parts_ref(*call), 10),
                    nbytes=_bytes((*args, *geo, *fused_parts_ref(*call))),
                    ops={torch.float32: count_ops(fused_parts_ref, *call)},
                    library_ms=None)

    # K1 alone at the main path's shape
    kgeom, args = k1_inputs((MAIN["layers"], MAIN["height"], MAIN["width"]),
                            torch.float32, False, device)
    rows.append(_row("fused_parts", replaces="gcmiipy_tpu/ops/pallas_stencil.py:221",
                     launches=launches["fused_parts"], max_abs=max_abs["k1"],
                     tag="fused_parts", **k1_timed(args, kgeom)))
    # K1's column pass alone (pgf_column): reads sp, st and the heightmap,
    # writes rho and phi; its launches those K1's C entry counted on the
    # fused path.  Its ms is the launch's device time (torch.profiler): the
    # wrapper's host work takes longer than the launch, so CUDA events
    # around back-to-back calls time the host
    col_args = (args[5], args[8], kgeom)
    col_launch = kernel_ms(lambda: pgf_column(*col_args))
    if not sum(col_launch.values()) > 0:
        fail("timing", "torch.profiler saw no device time of the column pass")
    log("timing", f"pgf_column by CUDA events over back-to-back calls "
                  f"{cuda_ms(lambda: pgf_column(*col_args), 50):.4f} ms/call "
                  "(the wrapper's host work)")
    rows.append(_row(
        "fused_parts column pass (pgf_column)",
        "gcmiipy_tpu_torch/csrc/fused_parts.cu",
        "gcmiipy_tpu/ops/pallas_stencil.py:221", launches["column_pass"],
        max_abs["k1_column"], sum(col_launch.values()),
        cuda_ms(lambda: core25d.pgf_column(*col_args), 10),
        _bytes((args[5], args[8], kgeom.heightmap,
                *core25d.pgf_column(*col_args))),
        {torch.float32: count_ops(core25d.pgf_column, *col_args)}, None,
        "pgf_column", launch_ms=col_launch))
    # K2's path: the kernel on the inputs of make_fused_matsuno's predictor
    # half from the perturbed start (base and evaluated state both the start)
    spu = polar_filter.arakawa_1977(core25d.calc_pu(prog[0], prog[1]), geom)
    rows.append(_row("fused_parts (make_fused_matsuno, K2's path)",
                     replaces="gcmiipy_tpu/ops/pallas_stencil.py:41",
                     launches=launches["k2"], max_abs=max_abs["k2"],
                     tag="fused_parts on K2's path",
                     **k1_timed((*prog, *prog, spu), geom)))

    # K6 alone at the main path's shape, from the perturbed start; the plain
    # versions run the banded DFT with factors built once, outside the timing
    step = MegaStep(geom, MAIN["dt"])
    state = prog
    banded = banded_round(geom)
    ms = cuda_ms(lambda: step(*state), 20)
    plain_ms = cuda_ms(lambda: mega_step_ref(*state, MAIN["dt"], geom,
                                             step.consts, filter_ref=banded), 5)
    fc = step.consts
    geo = [getattr(geom, n) for n in GEOM_FIELDS]
    nbytes = _bytes((*state, *geo, *_filter_buffers(fc),
                     *mega_step_ref(*state, MAIN["dt"], geom, fc,
                                    filter_ref=banded)))
    # the float32 elementwise operations of the plain version (its float64
    # banded DFT is not the kernel's filter and is not counted), and the
    # FFT filter's float64 operations: 2 rounds
    filter_ops = _filter_ops(fc, geom, 2)
    ops = {torch.float32: count_ops(mega_step_ref, *state, MAIN["dt"], geom,
                                    fc, filter_ref=banded,
                                    dtypes=(torch.float32,)),
           torch.float64: filter_ops}
    # the library yardstick of the filter stage only: torch.fft on the same
    # stacked (2L,H,W) rows, twice (a step's two rounds, which are the four
    # L-plane filter calls of the fused step)
    stack = torch.cat(core25d.pgf_forces(state[0], state[1], state[3],
                                         geom)[:2], dim=0)
    fft_ms = cuda_ms(lambda: [polar_filter.arakawa_1977(stack, geom)
                              for _ in range(2)], 20)
    log("timing", f"mega_step filter stage: {filter_ops / 1e9:.3f} GFLOP "
                  f"double over {int(fc.lats.numel())} latitudes, 2 rounds; "
                  f"torch.fft rfft*mask*irfft of the same stacked rows, 2 "
                  f"rounds: {fft_ms:.4f} ms")
    rows.append(_row("mega_step", "gcmiipy_tpu_torch/csrc/mega_step.cu",
                     "gcmiipy_tpu/ops/pallas_stencil.py:1337",
                     launches["mega_step"], max_abs["k6"], ms, plain_ms, nbytes,
                     ops, fft_ms, "mega_step"))

    # K7 as the main path calls it: one call of STEP_WINDOW steps with the
    # physics, from a random state (each call restarts from it: the copy
    # is 0.1% of the call)
    k = STEP_WINDOW
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    kgeom, step, S0, utc0 = k7_inputs(main_shape, torch.float32, True, device)
    S = S0.clone()
    ms = cuda_ms(lambda: step(S.copy_(S0), utc0, k), 5)
    k7_banded = banded_round(kgeom)
    plain_ms = cuda_ms(lambda: stream_steps_ref(
        S.copy_(S0), utc0, k, MAIN["dt"], kgeom, step.consts,
        physics=step.physics, filter_ref=k7_banded), 1, warmup=1)
    dyn = k7_inputs(main_shape, torch.float32, False, device)
    S_dyn = dyn[2].clone()
    dyn_ms = cuda_ms(lambda: dyn[1](S_dyn.copy_(dyn[2]), utc0, k), 5)
    fc = step.consts
    geo = [getattr(kgeom, n) for n in GEOM_FIELDS]
    nbytes = _bytes((S0, S0, *geo, kgeom.long, *_filter_buffers(fc)))
    ops = {torch.float32: count_ops(
               stream_steps_ref, S.copy_(S0), utc0, k, MAIN["dt"], kgeom, fc,
               physics=step.physics, filter_ref=k7_banded,
               dtypes=(torch.float32,)),
           torch.float64: _filter_ops(fc, kgeom, 2 * k)}
    # the filter stage's library yardstick: torch.fft on the stacked rows of
    # the call's start, 2k rounds
    s0 = _planes(S0, MAIN["layers"])
    k7_stack = torch.cat(core25d.pgf_forces(s0[0], s0[1], s0[3], kgeom)[:2])
    k7_fft_ms = cuda_ms(lambda: [polar_filter.arakawa_1977(k7_stack, kgeom)
                                 for _ in range(2 * k)], 3)
    epi_bytes = (2 * MAIN["layers"] + 7) * MAIN["height"] * MAIN["width"] * 4
    log("timing", f"stream_steps k={k}: {ms / k:.4f} ms/step with the "
                  f"physics, {dyn_ms / k:.4f} without: the epilogue takes "
                  f"about {(ms - dyn_ms) / k:.4f} ms a step (its bytes bound "
                  f"{1e3 * epi_bytes / HBM_BYTES_PER_S:.4f} ms); torch.fft's "
                  f"filter stage, {2 * k} rounds: {k7_fft_ms:.4f} ms")
    rows.append(_row("stream_steps", "gcmiipy_tpu_torch/csrc/stream_steps.cu",
                     "gcmiipy_tpu/ops/pallas_stream.py:102",
                     launches["stream_steps"], max_abs["k7"], ms, plain_ms,
                     nbytes, ops, k7_fft_ms, f"stream_steps (k={k}, physics)"))
    rows.append(timing_physics(device, launches, max_abs))
    rows += timing_k345(launches, max_abs, geom, prog)
    return rows


def timing_shards(device, ring):
    """The rows of K6's and K7's shard forms: each on rank 0's block of the
    ring at the main path's shape (K6: Hl + 16 = 144 rows; K7, k = RING_K:
    Hl + 2*RING_K*8 = 192 rows), timed alone on the card by CUDA events,
    beside its plain version and its bytes bound on the block; the
    launches those rank 0 counted on phase ring's main paths (20 steps:
    K6's shard form once a step on the mega4 ring, K7's once a RING_K
    steps on the stream ring)."""
    from gcmiipy_tpu_torch.dynamics import core25d
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.ops import polar_filter
    from gcmiipy_tpu_torch.ops import stream_steps as ss
    from gcmiipy_tpu_torch.ops.fused_parts import GEOM_FIELDS
    from gcmiipy_tpu_torch.ops.mega_step import (
        MegaStep, banded_round, mega_step_ref)
    from gcmiipy_tpu_torch.parallel.mesh import block_rows
    from gcmiipy_tpu_torch.parallel.shard_step import PHJ
    L, H = MAIN["layers"], MAIN["height"]
    geom = geometry.gen_geometry(H, MAIN["width"], L,
                                 sig_func=geometry.manabe_sig,
                                 dtype=torch.float32, device=device)
    state = random_state(geom, 5, device, torch.float32)
    rows = []

    rb = block_rows(H, RING, 0, PHJ)
    step = MegaStep(geom, MAIN["dt"], rows=rb)
    bgeom, fc = step.geom, step.consts
    block = [x[..., rb, :].contiguous() for x in state]
    banded = banded_round(bgeom)
    ms = cuda_ms(lambda: step(*block), 20)
    plain_ms = cuda_ms(lambda: mega_step_ref(*block, MAIN["dt"], bgeom, fc,
                                             filter_ref=banded), 5)
    geo = [getattr(bgeom, n) for n in GEOM_FIELDS]
    nbytes = _bytes((*block, *geo, *_filter_buffers(fc),
                     *mega_step_ref(*block, MAIN["dt"], bgeom, fc,
                                    filter_ref=banded)))
    ops = {torch.float32: count_ops(mega_step_ref, *block, MAIN["dt"], bgeom,
                                    fc, filter_ref=banded,
                                    dtypes=(torch.float32,)),
           torch.float64: _filter_ops(fc, bgeom, 2)}
    stack = torch.cat(core25d.pgf_forces(block[0], block[1], block[3],
                                         bgeom)[:2], dim=0)
    fft_ms = cuda_ms(lambda: [polar_filter.arakawa_1977(stack, bgeom)
                              for _ in range(2)], 20)
    rows.append(_row(
        "mega_step_shard", "gcmiipy_tpu_torch/csrc/mega_step.cu",
        "gcmiipy_tpu/ops/pallas_stencil.py:1340",
        ring["mega4"]["counts"]["mega_step_shard"], ring["max_abs"]["k6"],
        ms, plain_ms, nbytes, ops, fft_ms,
        f"mega_step_shard (rank 0's block, {len(rb)} rows)"))

    rb = block_rows(H, RING, 0, RING_K * PHJ)
    multi = ss.StreamSteps(geom, MAIN["dt"], rows=rb)
    bgeom, fc = multi.geom, multi.consts
    packed = ss.pack_state(*[x[..., rb, :].contiguous() for x in state])
    S0 = torch.stack([packed, torch.zeros_like(packed)])
    S = S0.clone()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    ms = cuda_ms(lambda: multi(S.copy_(S0), None, RING_K), 20)
    banded = banded_round(bgeom)
    plain_ms = cuda_ms(lambda: ss.stream_steps_ref(
        S.copy_(S0), zero, RING_K, MAIN["dt"], bgeom, fc,
        filter_ref=banded), 2)
    geo = [getattr(bgeom, n) for n in GEOM_FIELDS]
    nbytes = _bytes((S0, S0, *geo, bgeom.long, *_filter_buffers(fc)))
    ops = {torch.float32: count_ops(
               ss.stream_steps_ref, S.copy_(S0), zero, RING_K, MAIN["dt"],
               bgeom, fc, filter_ref=banded, dtypes=(torch.float32,)),
           torch.float64: _filter_ops(fc, bgeom, 2 * RING_K)}
    s0 = _planes(S0, L)
    stack = torch.cat(core25d.pgf_forces(s0[0], s0[1], s0[3], bgeom)[:2])
    fft_ms = cuda_ms(lambda: [polar_filter.arakawa_1977(stack, bgeom)
                              for _ in range(2 * RING_K)], 5)
    rows.append(_row(
        "stream_steps_shard", "gcmiipy_tpu_torch/csrc/stream_steps.cu",
        "gcmiipy_tpu/ops/pallas_stream.py:108",
        ring["stream"]["counts"]["stream_steps_shard"],
        ring["max_abs"]["k7"], ms, plain_ms, nbytes, ops, fft_ms,
        f"stream_steps_shard (rank 0's block, {len(rb)} rows, "
        f"k={RING_K})"))
    return rows


def timing_mesh2d(device, m2d):
    """The rows of the 2D path's forms, each on rank 0's block at the main
    path's shape, timed alone on the card by CUDA events beside its plain
    version and its bound on the block, with the launches rank 0 counted in
    phase mesh2d: K3's and K4's shard forms on the 2x2 block (262 x 518),
    K5's on the ring block (144 rows), K6 on fused4's overlap strips (48,
    80 and 48 rows: a step's three calls).  The spectral-psum filter, a
    stage of torch.matmul calls with no kernel, is logged on a line of its
    own: its float64 matmuls on the 2L stacked 256 x 512 planes alone (no
    peer), its time on the mesh and its error against torch.fft's filter
    from phase mesh2d."""
    from gcmiipy_tpu_torch.dynamics import core25d
    from gcmiipy_tpu_torch.ops import pgf_rest as pr, polar_filter
    from gcmiipy_tpu_torch.ops.fused_parts import GEOM_FIELDS
    from gcmiipy_tpu_torch.ops.mega_half import MegaHalf, mega_half_ref
    from gcmiipy_tpu_torch.ops.mega_step import (
        MegaStep, banded_round, mega_step_ref)
    from gcmiipy_tpu_torch.parallel import shard_step as ss
    from gcmiipy_tpu_torch.parallel.mesh import (
        RingMesh, block_cols, block_rows)
    from gcmiipy_tpu_torch.step_profile import kernel_ms
    L, H, W, dt = MAIN["layers"], MAIN["height"], MAIN["width"], MAIN["dt"]
    geom, base, seval, filt, pg_phiv = k3k4_inputs((L, H, W), torch.float32,
                                                   True, device)
    rows, cols = block_rows(H, 2, 0, ss.EX), block_cols(W, 2, 0, ss.EX)
    bgeom = geom.take_block(rows, cols)
    geo = [getattr(bgeom, n) for n in GEOM_FIELDS]

    def blk(a):
        return a[..., rows, :][..., cols].contiguous()

    out_rows = []
    k3 = (blk(seval[0]), blk(seval[1]), blk(seval[3]), bgeom)
    outs = pr.pgf_parts_ref(*k3)
    out_rows.append(_row(
        "pgf_parts_shard (K3's shard form)",
        "gcmiipy_tpu_torch/csrc/pgf_tile.cuh",
        "gcmiipy_tpu/ops/pallas_stencil.py:477",
        m2d["counts"]["pgf_parts_shard"], m2d["max_abs"]["k3"],
        cuda_ms(lambda: pr.pgf_parts_shard(*k3), 50),
        cuda_ms(lambda: pr.pgf_parts_ref(*k3), 10),
        _bytes((*k3[:3], *geo, *outs)),
        {torch.float32: count_ops(pr.pgf_parts_ref, *k3)}, None,
        f"pgf_parts_shard (rank 0's 2x2 block {len(rows)}x{len(cols)})",
        launch_ms=kernel_ms(lambda: pr.pgf_parts_shard(*k3))))
    k4 = (*map(blk, base), *map(blk, seval), blk(filt), blk(pg_phiv), dt,
          bgeom)
    outs = pr.rest_parts_ref(*k4)
    out_rows.append(_row(
        "rest_parts_shard (K4's shard form)",
        "gcmiipy_tpu_torch/csrc/pgf_rest.cu",
        "gcmiipy_tpu/ops/pallas_stencil.py:605",
        m2d["counts"]["rest_parts_shard"], m2d["max_abs"]["k4"],
        cuda_ms(lambda: pr.rest_parts_shard(*k4), 50),
        cuda_ms(lambda: pr.rest_parts_ref(*k4), 10),
        _bytes((*k4[:12], *geo, *outs)),
        {torch.float32: count_ops(pr.rest_parts_ref, *k4)}, None,
        f"rest_parts_shard (rank 0's 2x2 block {len(rows)}x{len(cols)})",
        launch_ms=kernel_ms(lambda: pr.rest_parts_shard(*k4))))

    # the spectral-psum filter stage (no Pallas, no kernel of its own: not
    # a row of the kernels line) on the core of K3's stack of rank 0's
    # block: its matmuls alone (a mesh of one: no psum), against the plain
    # filter of the same rows at the full width (torch.fft in float64, the
    # work the mesh row's two ranks share) and the library's two matmuls
    CS, CwSw, nb = polar_filter.banded_pair_matrices(W, dtype=np.float64)
    mcc = polar_filter.banded_correction_mask_pair(geom.polar_mask, nb,
                                                   dtype=np.float64)
    hl, wl = H // 2, W // 2
    CS_l, CwSw_l, mcc_l = (torch.as_tensor(np.ascontiguousarray(a)).to(device)
                           for a in (CS[:wl], CwSw[:, :wl], mcc[:hl]))
    alone = RingMesh(ny=1, index=0, device=device)
    fcore = ss._spectral_psum_filter(CS_l, CwSw_l, mcc_l, alone)
    q = pr.pgf_parts_shard(*k3)[0][:, ss.EX:-ss.EX, ss.EX:-ss.EX].contiguous()
    q2 = q.reshape(-1, wl).double()
    mrow = mcc_l.expand(q.shape[0], *mcc_l.shape).reshape(-1, 2 * nb)
    lib_ms = cuda_ms(lambda: torch.matmul(torch.matmul(q2, CS_l) * mrow,
                                          CwSw_l), 50)
    band = pr.pgf_parts_ref(seval[0], seval[1], seval[3], geom)[0][:, :hl]
    band_geom = geom.take_rows(np.arange(hl))
    plain_ms = cuda_ms(lambda: polar_filter.arakawa_1977(
        band.double(), band_geom).to(band.dtype), 20)
    _, bound_by, text = _bound(
        _bytes((q, q, CS_l, CwSw_l, mcc_l)),
        {torch.float64: 2 * q2.shape[0] * wl * 2 * nb * 2})
    log("timing", "stage spectral_psum_filter (gcmiipy_tpu_torch/parallel/"
        "shard_step.py, replaces gcmiipy_tpu/parallel/shard_step.py:169; "
        "no kernel: not in the kernels line), rank 0's "
        f"{tuple(q.shape)} float32 core (float64 sums): "
        f"{m2d['parts']['psum filter']:.4f} host ms a call on the 2x2 mesh "
        f"with its all_reduce (phase mesh2d), its matmuls alone "
        f"{cuda_ms(lambda: fcore(q), 50):.4f} ms; plain (torch.fft float64 "
        f"of rank 0's mesh row, {tuple(band.shape)}) {plain_ms:.4f} ms; "
        f"library (the two torch.matmul) {lib_ms:.4f} ms; bound {text}, "
        f"by {bound_by}; launches {m2d['counts']['spectral_psum']} a rank; "
        f"max abs err against torch.fft's float64 filter "
        f"{m2d['psum_err']:.3e} (every rank's block)")

    # K5's shard form on rank 0's ring block, a corrector half
    state = random_state(geom, 5, device, torch.float32)
    rb = block_rows(H, RING, 0, ss.PHJ)
    half = MegaHalf(geom, dt, rows=rb)
    bb = [x[..., rb, :].contiguous() for x in state]
    bs = list(half(bb, bb))
    fc, hgeom = half.consts, half.geom
    k5 = (bb, bs, dt, hgeom, fc, False, False, banded_round(hgeom))
    stack = torch.cat(core25d.pgf_forces(bs[0], bs[1], bs[3], hgeom)[:2])
    out_rows.append(_row(
        "mega_half_shard (K5's shard form)",
        "gcmiipy_tpu_torch/csrc/mega_half.cu",
        "gcmiipy_tpu/ops/pallas_stencil.py:884",
        m2d["forms"]["k5 ring"]["launches"], m2d["max_abs"]["k5"],
        cuda_ms(lambda: half(bb, bs), 20),
        cuda_ms(lambda: mega_half_ref(*k5), 5),
        _bytes((*bb, *bs, *[getattr(hgeom, n) for n in GEOM_FIELDS],
                *_filter_buffers(fc), *mega_half_ref(*k5))),
        {torch.float32: count_ops(mega_half_ref, *k5,
                                  dtypes=(torch.float32,)),
         torch.float64: _filter_ops(fc, hgeom, 1)},
        cuda_ms(lambda: polar_filter.arakawa_1977(stack, hgeom), 20),
        f"mega_half_shard (rank 0's ring block, {len(rb)} rows)",
        launch_ms=kernel_ms(lambda: half(bb, bs))))

    # K6 on fused4's overlap strips of rank 0's band: one step's three calls
    hl = H // RING
    tj, strips = ss._strips(hl, 32, True)
    calls = []
    for lo, lh in strips:
        srows = np.arange(lo - ss.PHJ, lo + lh + ss.PHJ) % H
        step = MegaStep(geom, dt, rows=srows)
        calls.append((step, [x[..., srows, :].contiguous() for x in state]))
    bandeds = [banded_round(s.geom) for s, _ in calls]
    nbytes = sum(_bytes((*b, *[getattr(s.geom, n) for n in GEOM_FIELDS],
                         *_filter_buffers(s.consts),
                         *mega_step_ref(*b, dt, s.geom, s.consts,
                                        filter_ref=f)))
                 for (s, b), f in zip(calls, bandeds))
    ops = {torch.float32: sum(count_ops(mega_step_ref, *b, dt, s.geom,
                                        s.consts, filter_ref=f,
                                        dtypes=(torch.float32,))
                              for (s, b), f in zip(calls, bandeds)),
           torch.float64: sum(_filter_ops(s.consts, s.geom, 2)
                              for s, _ in calls)}
    stacks = [(torch.cat(core25d.pgf_forces(b[0], b[1], b[3], s.geom)[:2]),
               s.geom) for s, b in calls]
    out_rows.append(_row(
        "mega_step_shard on fused4's overlap strips (K6)",
        "gcmiipy_tpu_torch/csrc/mega_step.cu",
        "gcmiipy_tpu/parallel/shard_step.py:614",
        m2d["forms"]["fused4 overlap"]["launches"],
        m2d["max_abs"].get("k6_strips", 0.0),
        cuda_ms(lambda: [s(*b) for s, b in calls], 20),
        cuda_ms(lambda: [mega_step_ref(*b, dt, s.geom, s.consts,
                                       filter_ref=f)
                         for (s, b), f in zip(calls, bandeds)], 3),
        nbytes, ops,
        cuda_ms(lambda: [polar_filter.arakawa_1977(x, g)
                         for x, g in stacks for _ in range(2)], 20),
        f"mega_step_shard strips {[lh + 2 * ss.PHJ for _, lh in strips]} "
        f"rows (tj {tj}), a step's three calls",
        launch_ms=kernel_ms(lambda: [s(*b) for s, b in calls])))
    return out_rows


def timing_physics(device, launches, max_abs):
    """The row of K7's column-physics epilogue alone at the main path's
    shape, launched in place as K7 launches it (the wrapper's copies of u,
    v and t are not timed): reads p, t, the ground temperature and layer 0
    of u and v, writes t, the ground temperature and layer 0 of u and v.
    Its launches are those K7's C entry counted on the stream+physics main
    path (one a step)."""
    from gcmiipy_tpu_torch.ops.stream_steps import (
        column_physics_inplace, physics_epilogue_ref, physics_table)
    from gcmiipy_tpu_torch.step_profile import kernel_ms
    main_shape = (MAIN["layers"], MAIN["height"], MAIN["width"])
    geom, (p, u, v, t, gt), utc, ph = physics_inputs(main_shape, torch.float32,
                                                     device)
    args = (p, u, v, t, gt, utc, geom, MAIN["dt"], ph)
    table = physics_table(ph, MAIN["dt"], device)
    work = [x.clone() for x in (u, v, t)]
    gt_out = torch.empty_like(gt)

    def launch():
        column_physics_inplace(p, *work, gt, gt_out, utc, geom, table)

    nbytes = (_bytes((p, t, gt, u[0], v[0])) + _bytes((t, gt, u[0], v[0])))
    return _row(
        "column_physics (K7's epilogue)",
        "gcmiipy_tpu_torch/csrc/column_physics.cuh",
        "gcmiipy_tpu/ops/pallas_stream.py:314", launches["column_physics"],
        max_abs["physics"], cuda_ms(launch, 50),
        cuda_ms(lambda: physics_epilogue_ref(*args), 10), nbytes,
        {torch.float32: count_ops(physics_epilogue_ref, *args,
                                  dtypes=(torch.float32,))},
        None, "column_physics", launch_ms=kernel_ms(launch))


def timing_k345(launches, max_abs, geom, prog):
    """The rows of K3, K4, K5 and the FFT filter stage at the main path's
    shape, each on the inputs of a corrector half from the perturbed start:
    base the start, evaluated state the predictor's (10 distinct fields)."""
    from gcmiipy_tpu_torch.ops import polar_filter
    from gcmiipy_tpu_torch.ops.fft_filter import fft_filter, fft_filter_ref
    from gcmiipy_tpu_torch.ops.fused_parts import GEOM_FIELDS
    from gcmiipy_tpu_torch.ops.mega_half import MegaHalf, mega_half_ref
    from gcmiipy_tpu_torch.ops.mega_step import banded_round
    from gcmiipy_tpu_torch.ops.pgf_rest import (
        pgf_parts, pgf_parts_ref, rest_parts, rest_parts_ref)
    from gcmiipy_tpu_torch.step_profile import kernel_ms
    dt = MAIN["dt"]
    geo = [getattr(geom, n) for n in GEOM_FIELDS]
    half = MegaHalf(geom, dt)
    seval = half(prog, prog)
    rows = []

    # K3, one launch of the pgf tile (csrc/pgf_tile.cuh, stages 1-2 of K5,
    # K6 and K7 too): reads sp, su, st and the geometry, writes the stack
    # and pg_phiv.  Its launches are those the C entries of K3, K5, K6 and
    # K7 counted on the main paths (two a step each).
    k3_args = (seval[0], seval[1], seval[3], geom)
    outs = pgf_parts_ref(*k3_args)
    paths = ("mega4", "stream", "mega", "v2")
    tile_launches = sum(launches[f"pgf_tile {p}"] for p in paths)
    log("timing", "pgf tile launches on the main paths: " + ", ".join(
        f"{p} {launches[f'pgf_tile {p}']}" for p in paths)
        + f"; pgf_parts calls on the v2 path {launches['pgf_parts']}")
    rows.append(_row(
        "pgf_parts (the pgf tile, stages 1-2 of K3 and K5-K7)",
        "gcmiipy_tpu_torch/csrc/pgf_tile.cuh",
        "gcmiipy_tpu/ops/pallas_stencil.py:398", tile_launches,
        max_abs["k3"], cuda_ms(lambda: pgf_parts(*k3_args), 50),
        cuda_ms(lambda: pgf_parts_ref(*k3_args), 10),
        _bytes((*k3_args[:3], *geo, *outs)),
        {torch.float32: count_ops(pgf_parts_ref, *k3_args)}, None, "pgf_parts",
        launch_ms=kernel_ms(lambda: pgf_parts(*k3_args))))

    # K4, one launch of the rest tile (aflux in its prologue): the 10
    # fields, the filtered stack and pg_phiv in, 5 fields out
    stack, pg_phiv = outs
    filt = polar_filter.arakawa_1977(stack, geom)
    k4_args = (*prog, *seval, filt, pg_phiv, dt, geom)
    outs = rest_parts_ref(*k4_args)
    k4 = dict(max_abs=max_abs["k4"],
              ms=cuda_ms(lambda: rest_parts(*k4_args), 50),
              plain_ms=cuda_ms(lambda: rest_parts_ref(*k4_args), 10),
              nbytes=_bytes((*k4_args[:12], *geo, *outs)),
              ops={torch.float32: count_ops(rest_parts_ref, *k4_args)},
              library_ms=None,
              launch_ms=kernel_ms(lambda: rest_parts(*k4_args)))
    rows.append(_row(
        "rest_parts", "gcmiipy_tpu_torch/csrc/pgf_rest.cu",
        "gcmiipy_tpu/ops/pallas_stencil.py:492", launches["rest_parts"],
        tag="rest_parts", **k4))
    # the same launch as stages 4-5 of K5, K6 and K7 (csrc/stencil_tile.cuh,
    # tile_stencil<T, RestOut>): its launches those the C entries of K4-K7
    # counted on the main paths (two a step each)
    paths = ("mega4", "stream", "mega", "v2")
    stage_launches = sum(launches[f"rest_stencil {p}"] for p in paths)
    log("timing", "rest tile launches on the main paths: " + ", ".join(
        f"{p} {launches[f'rest_stencil {p}']}" for p in paths))
    rows.append(_row(
        "rest_stencil (the rest tile, stages 4-5 of K4-K7)",
        "gcmiipy_tpu_torch/csrc/stencil_tile.cuh",
        "gcmiipy_tpu/ops/pallas_stencil.py:1199", stage_launches,
        tag="rest_stencil", **k4))

    # K5: one corrector half; the float32 elementwise operations of the
    # plain version (the banded DFT, its factors built once) and the FFT
    # filter's float64 operations, one round
    fc = half.consts
    k5_args = (prog, seval, dt, geom, fc, False, False, banded_round(geom))
    filter_ops = _filter_ops(fc, geom, 1)
    ops = {torch.float32: count_ops(mega_half_ref, *k5_args,
                                    dtypes=(torch.float32,)),
           torch.float64: filter_ops}
    # the library yardstick of the filter stage: torch.fft rfft*mask*irfft
    # on the same 2L stacked rows, one round
    fft_ms = cuda_ms(lambda: polar_filter.arakawa_1977(stack, geom), 20)
    rows.append(_row(
        "mega_half", "gcmiipy_tpu_torch/csrc/mega_half.cu",
        "gcmiipy_tpu/ops/pallas_stencil.py:663", launches["mega_half"],
        max_abs["k5"], cuda_ms(lambda: half(prog, seval), 20),
        cuda_ms(lambda: mega_half_ref(*k5_args), 5),
        _bytes((*prog, *seval, *geo, *_filter_buffers(fc),
                *mega_half_ref(*k5_args))), ops, fft_ms, "mega_half"))

    # the FFT filter stage alone on the same stack (18x512x1024 float32),
    # in place on a copy: reads and writes each listed row once and reads
    # the mask, the twiddles and the latitude list
    work = stack.clone()
    lats = fc.lats.long()
    ms = cuda_ms(lambda: fft_filter(work, fc), 50)
    plain_ms = cuda_ms(lambda: fft_filter_ref(stack, fc), 5)
    nbytes = (2 * _bytes((stack[:, lats],))
              + _bytes((fc.mask, fc.twiddle, fc.lats)))
    launched = sum(launches[f"fft_filter {p}"]
                   for p in ("mega4", "stream", "mega"))
    log("timing", f"fft_filter launches on the main paths: mega4 "
                  f"{launches['fft_filter mega4']}, stream "
                  f"{launches['fft_filter stream']}, mega "
                  f"{launches['fft_filter mega']}; torch.fft rfft*mask*irfft "
                  f"of the same rows {fft_ms:.4f} ms")
    rows.append(_row(
        "fft_filter", "gcmiipy_tpu_torch/csrc/fft_filter.cuh",
        "gcmiipy_tpu/ops/pallas_stencil.py:806", launched, max_abs["fft"], ms,
        plain_ms, nbytes, {torch.float64: filter_ops}, fft_ms,
        f"fft_filter {tuple(stack.shape)} float32"))
    return rows


# phase graph: a run function's walk as one CUDA graph
# (gcmiipy_tpu_torch/model/run_graph.py) on the benchmark's grey
# configurations (gcmbench/configs): grey-modelii's 24x36 at 225 s, 16
# steps on the per-step 'mega4' fallback, and the flagship's 512x1024 at
# 30 s, 20 steps on 'stream', at 9 and at 40 layers; GRAPH_CALLS timed
# calls each of the eager walk and of the replay
GRAPH_RUNS = (("modelii", "gcm2-grey", 24, 36, 225.0, 16),
              ("flagship", "gcm2-grey", 512, 1024, 30.0, 20),
              ("flagship-l40", "gcm2-grey-l40", 512, 1024, 30.0, 20))
GRAPH_CALLS = 20


def _bench_config(name, height, width, dt):
    """gcmbench's configuration ``name`` as its harness builds it."""
    from gcmiipy_tpu_torch.model.config import ModelConfig
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "gcmbench", "configs", name + ".json")
    with open(path) as fh:
        model = dict(json.load(fh)["model"])
    model.pop("sigma")
    return ModelConfig(height=height, width=width, dt=dt, **model)


def phase_graph(device):
    """Each of GRAPH_RUNS through one run function: the first call eager,
    the second captures, every later one replays.  Each replay equals the
    eager walk (``run.walk``) on its state to the bit, from the start and
    chained on its own results, and a replay adds the eager call's
    launches to the ops' counters.  Then the host's wall ms a step of the
    eager walk and of a replay (GRAPH_CALLS synchronised calls each), the
    replay's device ms a step and the copy-in's and copy-out's device ms a
    call (CUDA events, the calls queued behind a sleeping kernel:
    :func:`device_ms`).  Returns a row a run."""
    from gcmiipy_tpu_torch.model import driver, run_graph
    leaves = run_graph.leaves
    rows = []
    for tag, name, H, W, dt, steps in GRAPH_RUNS:
        cfg = _bench_config(name, H, W, dt)
        geom = driver.gen_model_geometry(cfg, device)
        state = _deep_start(geom, cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run = driver.make_run_fn(geom, cfg, steps)

        def eager(s):
            return run.walk(s, int(s.step) if run.period else None)

        def same(what, out, ref):
            if not all(torch.equal(a, b) for a, b in zip(leaves(out),
                                                          leaves(ref))):
                fail("graph", f"{tag}: {what} differs from the eager walk")

        run(state)
        counters = run_graph.launch_counters()
        before = [c.launches for c in counters]
        ref = eager(state)
        torch.cuda.synchronize()
        eager_counts = [c.launches - n for c, n in zip(counters, before)]
        same("the capturing call", run(state), ref)
        if run.broken is not None or len(run.graphs) != 1:
            fail("graph", f"{tag}: no graph ({run.broken})")
        before = [c.launches for c in counters]
        calls = 3
        outs = [run(state)]
        for _ in range(calls - 1):
            outs.append(run(outs[-1][0]))
        counted = [(c.launches - n) / calls for c, n in zip(counters,
                                                           before)]
        if counted != eager_counts:
            fail("graph", f"{tag}: replays counted {counted}, the eager "
                          f"call {eager_counts}")
        same("a replay", outs[0], ref)
        for handed, out in zip(outs, outs[1:]):
            same("a chained replay", out, eager(handed[0]))
        launches = sum(eager_counts)

        def wall_ms(fn):
            fn(state)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(GRAPH_CALLS):
                fn(state)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t) / GRAPH_CALLS / steps

        eager_ms, replay_ms = wall_ms(eager), wall_ms(run)
        (captured,) = run.graphs.values()
        replay_device_ms = device_ms(captured.graph.replay,
                                     GRAPH_CALLS) / steps
        handed = leaves(state)
        copy_in_ms = device_ms(lambda: run_graph.copy_into(captured.inputs,
                                                           handed),
                               GRAPH_CALLS)
        copy_out_ms = device_ms(lambda: run_graph.copy_into(
            [torch.empty_like(x) for x in captured.outputs],
            captured.outputs), GRAPH_CALLS)
        nbytes = sum(x.numel() * x.element_size() for x in handed)
        log("graph", f"{tag} ({cfg.layers}x{H}x{W}, {steps} steps): equal "
                     f"to the bit; {launches} counted launches a call; host "
                     f"ms a step eager {eager_ms:.4f}, replay "
                     f"{replay_ms:.4f}; replay device ms a step "
                     f"{replay_device_ms:.4f}; copy-in {copy_in_ms:.4f} and "
                     f"copy-out {copy_out_ms:.4f} device ms a call "
                     f"({nbytes} bytes handed)")
        rows.append({"name": f"graph {tag}", "grid": [cfg.layers, H, W],
                     "steps": steps, "counted_launches": launches,
                     "eager_ms_per_step": eager_ms,
                     "replay_ms_per_step": replay_ms,
                     "replay_device_ms_per_step": replay_device_ms,
                     "copy_in_ms": copy_in_ms, "copy_out_ms": copy_out_ms,
                     "handed_bytes": nbytes})
        del run, captured, state, ref, outs
        torch.cuda.empty_cache()
    return rows


def main():
    card, kind = phase_device()
    device = torch.device("cuda", 0)
    if sys.argv[1:] == ["forms"]:
        # the column kernels' held and deep forms against each other
        print(card, flush=True)
        print(json.dumps({"forms": phase_forms(device)}), flush=True)
        return
    if sys.argv[1:] == ["convection"]:
        # the adaptive convection's kernel alone: build, check, time
        phase_build()
        print(card, flush=True)
        print(json.dumps({"kernels": phase_convection(device)}), flush=True)
        return
    if sys.argv[1:] == ["graph"]:
        # a run's walk as one CUDA graph: build, check, time
        phase_build()
        rows = phase_graph(device)
        print(card, flush=True)
        print(json.dumps({"graph": rows}), flush=True)
        return
    if sys.argv[1:] == ["radiation"]:
        # the four-band radiation's kernel: build, phase surface's counts,
        # check, time
        phase_build()
        _, column_launches = phase_surface(device)
        rows = phase_radiation(device, column_launches["four_band_column"])
        print(card, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    phase_build()
    max_abs = {"fft": phase_kernels_fft(device)}
    max_abs["k1"] = phase_kernels(device)
    max_abs["k6"] = phase_kernels_k6(device)
    max_abs["k7"] = phase_kernels_k7(device)
    max_abs.update(phase_kernels_k3k4(device))
    bits, deep_abs = phase_kernels_bits(device)
    max_abs["k1_column"] = bits["pgf_column"]
    max_abs["physics"], deep_abs["column_physics"] = phase_kernels_physics(
        device)
    max_abs["k5"] = phase_kernels_k5(device)
    if sys.argv[1:] == ["kernels"]:
        # the kernel phases and the deep column alone, with its rows
        deep_launches = phase_deep(device)
        rows = timing_deep(device, deep_launches, deep_abs)
        rows += phase_convection(device, None, deep_launches)
        print(card, flush=True)
        print(json.dumps({"kernels": rows}), flush=True)
        return
    launches, geom, start, max_abs["k2"], runs = phase_main(device)
    launches.update(phase_main_stream(device, geom, start))
    launches.update(phase_main_mega_v2(device, geom, start, runs))
    surface, column_launches = phase_surface(device)
    graph_rows = phase_graph(device)
    launches.update(phase_services(device))
    phase_sideband(device, card)
    phase_longrun(device, card)
    ring = phase_ring(device)
    m2d = phase_mesh2d(device)
    rows = phase_timing(device, launches, max_abs, geom, start, surface)
    rows += timing_shards(device, ring)
    rows += timing_mesh2d(device, m2d)
    # last: torch.profiler sessions opened before phases longrun to mesh2d
    # lose the device events of phase timing's (PERF.md), and the deep
    # column's and the convection's rows open such sessions
    deep_launches = phase_deep(device)
    rows += timing_deep(device, deep_launches, deep_abs)
    rows += phase_convection(device, column_launches["column_adjustment"],
                             deep_launches)
    rows += phase_radiation(device, column_launches["four_band_column"])
    log("done", f"all phases passed in {time.perf_counter() - T0:.1f}s")
    print(card, flush=True)
    print(json.dumps({"graph": graph_rows}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
