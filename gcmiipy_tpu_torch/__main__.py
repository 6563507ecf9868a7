"""Command-line entry point: ``python -m gcmiipy_tpu_torch run [options]``.

Port of ``gcmiipy_tpu/__main__.py:29-309``: every :class:`gcmiipy_tpu_torch.
model.config.ModelConfig` knob is a flag, and the run summary mirrors the
reference's STATS prints (u/v extrema and the total energy,
``no_limits_2_5d.py:85-91``).  ``--device`` picks the card (the default) or
the CPU.  ``--plot-dir`` writes the final fields and the energy trace as
PNGs (matplotlib, checked before the run starts).  Exit codes: 0 for a
clean run, 2 for a bad combination of flags or a missing matplotlib, 3 for
a run that blew up.

Examples:

    # the reference main(): 8x8x3, dt=1800 s
    python -m gcmiipy_tpu_torch run --height 8 --width 8 --layers 3 \
        --dt 1800 --steps 14400

    # a lat ring of 4 ranks on the card(s) of one host, with checkpoints
    torchrun --standalone --nproc-per-node 4 -m gcmiipy_tpu_torch run \
        --mesh-shape 4 --height 512 --width 1024 --layers 9 --dt 30 \
        --steps 20 --backend stream --guard --checkpoint-dir ckpt \
        --checkpoint-every 10 --metrics run.jsonl

    # a 2D (lat x lon) mesh of 2x2 ranks: K3's and K4's shard forms with
    # the spectral-psum polar filter
    torchrun --standalone --nproc-per-node 4 -m gcmiipy_tpu_torch run \
        --mesh-shape 2,2 --height 512 --width 1024 --layers 9 --dt 30 \
        --steps 20 --backend mega4 --guard
"""

import argparse
import os
import sys
import warnings

import numpy as np


def _add_run_args(ap):
    from gcmiipy_tpu_torch.model.config import ModelConfig

    ap.add_argument("--height", type=int, default=24)
    ap.add_argument("--width", type=int, default=36)
    ap.add_argument("--layers", type=int, default=9)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--giss-sige", action="store_true",
                    help="historical GCM-II SIGE vertical ladder + "
                         "PTOP=10 mb (needs --layers 9)")
    ap.add_argument("--ptop", type=float, default=0.0,
                    help="model-top pressure [Pa]")
    ap.add_argument("--physics", action="store_true",
                    help="grey-radiation column physics")
    ap.add_argument("--physics-every", type=int, default=1,
                    help="physics/drag cadence in steps (dt_eff = "
                         "physics_every*dt; even under --backend stream)")
    ap.add_argument("--seasonal", action="store_true",
                    help="drive solar declination from the model clock "
                         "(DAILY analog; default is the reference's "
                         "perpetual equinox)")
    ap.add_argument("--obliquity", type=float, default=23.44,
                    help="axial tilt [deg] for --seasonal")
    ap.add_argument("--year-days", type=float, default=365.0,
                    help="year length [days] for --seasonal")
    ap.add_argument("--convection", action="store_true",
                    help="dry convective adjustment (beyond-reference)")
    ap.add_argument("--evaporation", action="store_true",
                    help="bulk-aerodynamic surface evaporation "
                         "(beyond-reference; needs --physics and --gw0)")
    ap.add_argument("--gw0", type=float, default=0.0,
                    help="initial ground-water reservoir depth [m]")
    ap.add_argument("--coriolis", action="store_true")
    ap.add_argument("--q-limiter", action="store_true",
                    help="GCM-II ADVECQ +-0.5*QT horizontal q-flux clamp "
                         "(the reference core's TODO, dynamics.py:218)")
    ap.add_argument("--drag-tau", type=float, default=0.0,
                    help="surface Rayleigh-drag e-folding time [s]")
    ap.add_argument("--shapiro-every", type=int, default=0,
                    help="zonal Shapiro FILTER cadence in steps (0 off)")
    ap.add_argument("--shapiro-order", type=int, default=8)
    ap.add_argument("--shapiro-fields", default="p",
                    choices=["p", "t", "pt"],
                    help="GCM-II MFILTR selection: p, t, or both")
    ap.add_argument("--shapiro-slp", action="store_true", default=None,
                    help="reduce p to sea level before the Shapiro FILTER "
                         "(GCM-II MFILTR=1 semantics over topography; "
                         "default: auto — on over terrain, off flat)")
    ap.add_argument("--topography", default="flat",
                    choices=["flat", "hansen"],
                    help="surface terrain: Hansen 1983 topography "
                         "(resampled to the grid, barometric p init) or "
                         "the reference's flat surface")
    ap.add_argument("--sea-level-temp", type=float, default=288.0,
                    help="sea-level temperature [K] of the barometric "
                         "terrain-balanced initial pressure")
    ap.add_argument("--land-cover", default="none",
                    choices=["none", "hansen"],
                    help="couple the Hansen land-fraction map into "
                         "surface albedo and evaporation availability")
    ap.add_argument("--albedo-land", type=float, default=0.35,
                    help="land albedo for --land-cover hansen (--albedo "
                         "is the ocean/base value)")
    ap.add_argument("--precipitation", action="store_true",
                    help="large-scale condensation: rain supersaturation "
                         "into the ground-water bucket with latent "
                         "heating (GCM-II CONDSE analog; needs --physics)")
    ap.add_argument("--rh-crit", type=float, default=1.0,
                    help="relative-humidity threshold of the condensation "
                         "scheme")
    ap.add_argument("--t-lw", type=float, default=0.1,
                    help="grey longwave layer transmittance")
    ap.add_argument("--t-sw", type=float, default=0.9,
                    help="grey shortwave layer transmittance")
    ap.add_argument("--albedo", type=float, default=0.3)
    ap.add_argument("--radiation", default="grey",
                    choices=["grey", "4band"],
                    help="LW scheme: the reference's grey gas, or the "
                         "four-band MITgcm/aim absorptivities "
                         "(no_limits_2_5d.py:241-248)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "fused", "mega", "mega4", "stream"])
    ap.add_argument("--stream-steps", type=int, default=20,
                    help="steps per launch of the 'stream' backend "
                         "(even; guard/stats granularity)")
    ap.add_argument("--stream-pipeline", action="store_true",
                    help="the JAX kernel's paired-block schedule: K7 runs "
                         "unchanged, the physics between its calls")
    ap.add_argument("--stream-wide-native", action="store_true",
                    help="force the native streaming kernel on tall wide "
                         "grids (W > 2048, H > 64) instead of the "
                         "measured-faster v1 FFT fallback")
    ap.add_argument("--polar-filter", default="fft",
                    choices=["fft", "matmul", "dft"])
    ap.add_argument("--filter-precision", default="high",
                    choices=["highest", "high", "fwd_high", "default"],
                    help="precision of the mega backends' filter ('high' "
                         "and 'highest' both run it in float64; the bf16 "
                         "modes are not ported)")
    ap.add_argument("--filter-split-tau", type=float,
                    default=ModelConfig().filter_split_tau,
                    help="accepted for compatibility, no effect: the "
                         "port's filter has no split-precision tail")
    ap.add_argument("--guard", action="store_true",
                    help="device-side NaN/pressure blow-up guard")
    ap.add_argument("--guard-p-max", type=float, default=115000.0,
                    help="surface-pressure scream ceiling [Pa]")
    ap.add_argument("--guard-p-min", type=float, default=0.0)
    ap.add_argument("--guard-t-max", type=float, default=0.0,
                    help="CHECKT potential-temperature ceiling [K] (0 off)")
    ap.add_argument("--guard-t-min", type=float, default=0.0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--metrics", default=None,
                    help="write per-step StepStats as JSON lines here")
    ap.add_argument("--plot-dir", default=None,
                    help="write the final fields and the energy trace as "
                         "PNGs here (needs matplotlib)")
    ap.add_argument("--no-stats", action="store_true",
                    help="skip per-step diagnostics (fastest)")
    ap.add_argument("--mesh-shape", default=None, metavar="NY[,NX]",
                    help="decompose the run over a mesh of ranks (one "
                         "process each; torchrun or --coordinator): 'NY' = "
                         "lat ring over NY ranks; 'NY,NX' = 2D lat x lon "
                         "mesh of NY*NX ranks (the fused2d path)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="torch.distributed rendezvous address, rank 0 "
                         "listening (with --num-processes and "
                         "--process-id; the environment torchrun sets "
                         "also works)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="where to run: 'cuda' (default; a missing card is "
                         "an error) or 'cpu'")


def _mesh(args):
    """The mesh of ``--mesh-shape`` (a lat ring, or a 2D lat x lon mesh),
    or None when the ranks do not fill it."""
    from gcmiipy_tpu_torch.parallel import distributed, mesh as mesh_mod
    dims = [int(d) for d in args.mesh_shape.split(",")]
    ny, nx = dims[0], (dims[1] if len(dims) > 1 else 1)
    ranks = (distributed.dist.get_world_size()
             if distributed.is_multiprocess() else 1)
    if ny * nx != ranks:
        print(f"error: --mesh-shape {args.mesh_shape} needs {ny * nx} "
              f"ranks, have {ranks}", file=sys.stderr)
        return None
    return mesh_mod.make_mesh(device=args.device,
                              shape=(ny, nx) if nx > 1 else None)


def cmd_run(args):
    from gcmiipy_tpu_torch.model import driver
    from gcmiipy_tpu_torch.model.config import ModelConfig
    from gcmiipy_tpu_torch.parallel import distributed

    if args.plot_dir:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            print("error: --plot-dir needs matplotlib, which does not "
                  "import here", file=sys.stderr)
            return 2
    # join the process group before anything touches a device
    distributed.initialize(coordinator_address=args.coordinator,
                           num_processes=args.num_processes,
                           process_id=args.process_id, device=args.device)
    mesh = None
    if args.mesh_shape:
        mesh = _mesh(args)
        if mesh is None:
            return 2
    if args.metrics and args.no_stats:
        print("error: --metrics needs per-step stats; drop --no-stats",
              file=sys.stderr)
        return 2
    if args.shapiro_every > 0 and (args.shapiro_order <= 0
                                   or args.shapiro_order % 2):
        print(f"error: --shapiro-order must be a positive even integer "
              f"(got {args.shapiro_order})", file=sys.stderr)
        return 2

    config = ModelConfig(
        dt=args.dt, giss_sige=args.giss_sige, ptop=args.ptop,
        physics=args.physics, physics_every=args.physics_every,
        seasonal=args.seasonal, obliquity=args.obliquity,
        year_days=args.year_days,
        convection=args.convection,
        evaporation=args.evaporation, gw0=args.gw0,
        topography=args.topography, sea_level_temp=args.sea_level_temp,
        land_cover=args.land_cover, albedo_land=args.albedo_land,
        precipitation=args.precipitation, rh_crit=args.rh_crit,
        coriolis=args.coriolis, q_limiter=args.q_limiter,
        drag_tau=args.drag_tau,
        shapiro_every=args.shapiro_every, shapiro_order=args.shapiro_order,
        shapiro_fields=args.shapiro_fields, shapiro_slp=args.shapiro_slp,
        t_lw=args.t_lw, t_sw=args.t_sw, albedo=args.albedo,
        radiation=args.radiation,
        dtype=args.dtype, backend=args.backend,
        stream_steps=args.stream_steps,
        stream_pipeline=args.stream_pipeline,
        stream_wide_native=args.stream_wide_native,
        polar_filter=args.polar_filter,
        filter_precision=args.filter_precision,
        filter_split_tau=args.filter_split_tau, guard=args.guard,
        guard_p_max=args.guard_p_max, guard_p_min=args.guard_p_min,
        guard_t_max=args.guard_t_max, guard_t_min=args.guard_t_min,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        metrics_path=args.metrics, stats=not args.no_stats)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        p, u, v, t, q, ground, geom, stats = driver.run_model(
            args.height, args.width, args.layers, args.dt, args.steps,
            config=config, device=args.device, mesh=mesh)
    blown = [w for w in caught if "blew up" in str(w.message)]
    quiet = distributed.rank() != 0
    # everything else (backend fall-backs and the like) is shown, not
    # swallowed: the capture is there to see a blow-up
    effective_backend = args.backend
    for w in caught:
        if w in blown:
            continue
        msg = str(w.message)
        if not quiet:
            print(f"warning: {msg}", file=sys.stderr)
        if "'mega4'" in msg:
            effective_backend = "mega4"
    if not quiet:
        p, u, v = (x.detach().cpu().numpy() for x in (p, u, v))
        label = (effective_backend if effective_backend == args.backend
                 else f"{args.backend}->{effective_backend}")
        ring = ""
        if mesh is not None:
            ring = (f", {mesh.ny}x{mesh.nx} mesh" if mesh.nx > 1
                    else f", ring of {mesh.ny}")
        print(f"run: {args.steps} steps of {args.dt:g} s on "
              f"{args.layers}x{args.height}x{args.width} "
              f"({label}, {args.dtype}, {args.device}{ring})")
        print(f"  p  [{p.min():.1f}, {p.max():.1f}] Pa   "
              f"u [{u.min():.3g}, {u.max():.3g}]   "
              f"v [{v.min():.3g}, {v.max():.3g}] m/s   "
              f"finite: {all(np.isfinite(x).all() for x in (p, u, v))}")
        if stats is not None:
            te = stats.total_energy.detach().cpu().numpy()
            drift = float(te[-1] / te[0] - 1.0) if te[0] else float("nan")
            print(f"  total energy {te[0]:.6e} -> {te[-1]:.6e} J/m^2 "
                  f"(drift {drift:+.3e})")
        if args.plot_dir:
            from gcmiipy_tpu_torch.utils import plotting
            paths = [plotting.save_field_plot(
                f, os.path.join(args.plot_dir, f"final_{name}.png"),
                title=f"{name} after {args.steps} steps")
                for name, f in zip("puvtq", (p, u, v, t, q))]
            if stats is not None:
                paths.append(plotting.save_energy_plot(
                    stats, os.path.join(args.plot_dir, "energy.png")))
            print(f"  plots: {', '.join(paths)}")
    if blown:
        if not quiet:
            print(f"  BLOWN UP: {blown[0].message}", file=sys.stderr)
        return 3
    return 0


def cmd_info(args):
    import torch

    from gcmiipy_tpu_torch import __name__ as pkg
    print(f"{pkg}: the PyTorch / CUDA port of gcmiipy_tpu")
    print(f"  torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    for i in range(torch.cuda.device_count()):
        print(f"    cuda:{i} {torch.cuda.get_device_name(i)}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gcmiipy_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run_p = sub.add_parser("run", help="integrate the 2.5D model")
    _add_run_args(run_p)
    sub.add_parser("info", help="show torch and the cards")
    args = ap.parse_args(argv)
    return {"run": cmd_run, "info": cmd_info}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
