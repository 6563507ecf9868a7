import argparse, json, os, subprocess, sys, time  # noqa: E401
# ms/step of the PyTorch port's guarded loop on one NVIDIA GPU.
#
#     python3 bench_torch.py [--root DIR] [--configs mega4 mega4+physics/4 ...]
#         [--steps 20] [--windows 2]
#
# For each configuration it builds make_run_fn (the guard and the stats on)
# for --steps steps of the flagship grid, 9x512x1024 float32 at dt=30
# (chip_smoke.py's MAIN), runs it once to build and warm up, then times
# --windows runs of it from the reference's start between two CUDA events,
# the configurations in turn and then in reverse.  A configuration is a
# backend ('xla', 'fused', 'mega', 'mega4', 'stream'), optionally with the
# per-step physics ('+physics': grey radiation, convection, a one-day
# drag) and a cadence ('/N': physics_every=N).  --root imports
# gcmiipy_tpu_torch from another checkout, so that two trees are compared
# in one call on one card.  Prints the card's name and power limit, then
# one JSON line.  Imports nothing of JAX.

MAIN = dict(height=512, width=1024, layers=9, dt=30.0)
PHYSICS = dict(physics=True, convection=True, drag_tau=86400.0)


def config_of(name):
    """ModelConfig keyword arguments of a configuration name."""
    backend, _, rest = name.partition("+")
    kw = dict(MAIN, backend=backend, guard=True)
    if rest:
        physics, _, every = rest.partition("/")
        if physics != "physics":
            raise ValueError(f"unknown configuration {name!r}")
        kw.update(PHYSICS, physics_every=int(every or 1))
    return kw


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--configs", nargs="+",
                    default=["mega4", "mega4+physics", "mega4+physics/4",
                             "stream", "stream+physics"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--windows", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("bench_torch.py: no CUDA device")
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.model.config import ModelConfig
    from gcmiipy_tpu_torch.model.driver import gen_model_state, make_run_fn

    device = torch.device("cuda", 0)
    geom = geometry.gen_geometry(MAIN["height"], MAIN["width"], MAIN["layers"],
                                 sig_func=geometry.manabe_sig,
                                 dtype=torch.float32, device=device)
    runs, start = {}, None
    for name in args.configs:
        config = ModelConfig(**config_of(name))
        if start is None:
            start = gen_model_state(geom, config)
        runs[name] = make_run_fn(geom, config, args.steps)
        runs[name](start)
    torch.cuda.synchronize()
    ms = {name: [] for name in args.configs}
    for n in range(args.windows):
        for name in (args.configs if n % 2 == 0 else args.configs[::-1]):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            begin.record()
            runs[name](start)
            end.record()
            torch.cuda.synchronize()
            ms[name].append(begin.elapsed_time(end) / args.steps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    print(json.dumps({"root": os.path.abspath(args.root), "steps": args.steps,
                      "grid": [MAIN["layers"], MAIN["height"], MAIN["width"]],
                      "ms_per_step": ms,
                      "at": time.strftime("%Y-%m-%dT%H:%M:%S")}), flush=True)


if __name__ == "__main__":
    main()
