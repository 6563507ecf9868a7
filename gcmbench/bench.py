"""One run of one cell: set-up, the measured window, the check against the
reference, and the result.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``gcmbench/configs/<config>.json``: the model, its start
and the members' perturbations) and a traffic mix
(``gcmbench/traffic/<traffic>.json``: the grid, dt, the member horizon,
the output interval, how many intervals the check samples); its
comparison limits are in ``gcmbench/limits/<cell>.json`` and each
per-layer metric's reader in ``gcmbench/metrics/<metric>.py``, all found
by name.

The window is a closed loop of members: each a forecast of
``member_steps`` steps from one of the configuration's pool of starts
(``gcmbench/members.py``, in an order drawn from the seed), run as calls of
the program's run function (``gcmiipy_tpu_torch.model.driver.make_run_fn``)
of ``interval_steps`` steps each, every call followed by the host's read
of the guard flag and the interval's energy.  The window closes at the
first interval that ends ``--seconds`` after it opened (in a traced run,
once the trace has ended); the member then in flight runs to its end
outside the window.

The check follows the program interval by interval: for a sample of the
window's intervals, the float64 reference runs the interval from the
program's own state at its start, and the program's state and energy at
its end are compared with the reference's; the starts of member 0 and of
every sampled member are compared with the reference's own starts.
"""

import gc
import importlib.util
import itertools
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gcmbench import counts, members, trace as trace_mod
from gcmbench.reference import model as ref_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gcmiipy_tpu")
COMPARED = ("p", "u", "v", "t", "q", "gt", "gw")
GROUND = ("gt", "gw", "snow", "ice")
FIELDS = ("p", "u", "v", "t", "q") + GROUND
# how long a traced run traces, from member 1 on
TRACE_SECONDS = 1.0


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload, root=ROOT):
    """Everything a run of ``workload`` reads, by name: ``{cell, config,
    traffic, limits, end_to_end, per_layer}``; ``limits`` is None where the
    cell has no limits file."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = _json(os.path.join(root, "gcmbench", "traffic",
                                 cell["traffic"] + ".json"))
    limits_path = os.path.join(root, "gcmbench", "limits", workload + ".json")
    limits = _json(limits_path) if os.path.exists(limits_path) else None

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]
    return dict(cell=cell, config=config, traffic=traffic, limits=limits,
                end_to_end=mine(spec["end_to_end"]),
                per_layer=mine(spec["per_layer"]))


def quantity(name):
    """A metric's quantity: its name up to the first ``.``; what follows
    names the regime of the cells that report it (``sypd.hostbound``)."""
    return name.split(".")[0]


def metric_reader(name, root=ROOT):
    """``read(ctx)`` of ``gcmbench/metrics/<quantity>.py``."""
    name = quantity(name)
    path = os.path.join(root, "gcmbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gcmbench_metric_" + name.replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def log(msg):
    print(f"gcmbench: {msg}", file=sys.stderr, flush=True)


class Program:
    """The system under test, set up for one configuration and traffic:
    its geometry and base start on ``device``, and its run function over
    one output interval."""

    def __init__(self, config, traffic, pool, device):
        from gcmiipy_tpu_torch.model import driver
        from gcmiipy_tpu_torch.model import state as state_mod
        from gcmiipy_tpu_torch.model.config import ModelConfig
        model = dict(config["model"])
        ladder = model.pop("sigma")
        if ladder not in ref_model.SIGMA:
            raise ValueError(f"sigma {ladder!r}: the program's ladders "
                             f"here are {ref_model.SIGMA}")
        self.cfg = ModelConfig(height=traffic["height"],
                               width=traffic["width"], dt=traffic["dt"],
                               giss_sige=ladder == "giss", **model)
        self.traffic, self.config, self.device = traffic, config, device
        self.pool = pool
        self.geom = driver.gen_model_geometry(self.cfg, device)
        base = driver.gen_model_state(self.geom, self.cfg)
        if config["start"] == "moist":
            base = state_mod.moist_start(base, self.geom)
        self.base = base
        self.run = driver.make_run_fn(self.geom, self.cfg,
                                      traffic["interval_steps"])

    def start(self, index):
        """The start of pool member ``index``: the base start plus its
        perturbation, in fresh tensors."""
        b = self.base
        d = self.pool.delta(index)
        prog = b.prog._replace(
            p=b.prog.p.clone(), q=b.prog.q.clone(),
            t=b.prog.t + d["t"].to(b.prog.t.dtype),
            u=b.prog.u + d["u"].to(b.prog.u.dtype),
            v=b.prog.v + d["v"].to(b.prog.v.dtype))
        ground = type(b.ground)(*(x.clone() for x in b.ground))
        return type(b)(prog, ground, b.utc.clone(), b.step.clone())

    @staticmethod
    def read(out):
        """The host's read after a call: ``(state, ok, energy)``."""
        state, stats, guard = out
        vec = torch.stack([stats.total_energy[-1].double(),
                           guard.ok.double()]).cpu()
        return state, bool(vec[1] > 0.5), float(vec[0])


def program_fields(state):
    """A program state's fields."""
    return {f: getattr(state.ground if f in GROUND else state.prog, f)
            for f in FIELDS}


def reference_fields(s):
    """A reference state's fields."""
    return {f: getattr(s, f) for f in FIELDS}


class Sample:
    """The check's sample: a reservoir of ``size`` intervals of the window,
    drawn from the seed as each call begins, each kept with its member's
    pool index, its step, its input and output fields, energy and guard;
    with ``first``, the first ``size`` intervals (a traced run's, so that
    its trace, from member 1 on, holds none of the check's work).  The
    fields are kept in host memory, pinned and copied on a stream of the
    sample's own, so that the program's stream and peak memory carry no
    more of the check than a clone of the state a kept interval."""

    def __init__(self, like, size, seed, device, first=False):
        self.size, self.seen, self.first = size, 0, first
        self.pick = random.Random(seed)
        cuda = torch.device(device).type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None

        def host():
            return {f: torch.empty(x.shape, dtype=x.dtype, pin_memory=cuda)
                    for f, x in like.items()}
        self.fields = [dict(input=host(), output=host())
                       for _ in range(size)]
        self.kept = [None] * size

    def choose(self):
        """The slot of the interval about to run, or None."""
        if self.first and self.seen >= self.size:
            return None
        slot = (self.seen if self.seen < self.size
                else self.pick.randrange(self.seen + 1))
        self.seen += 1
        return slot if slot < self.size else None

    def copy(self, slot, which, fields):
        dst = self.fields[slot][which]
        if self.stream is None:
            for f, x in fields.items():
                dst[f].copy_(x)
            return
        src = {f: x.clone() for f, x in fields.items()}
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            for f, x in src.items():
                dst[f].copy_(x, non_blocking=True)
        for x in src.values():
            x.record_stream(self.stream)

    def intervals(self):
        """The kept intervals, each ``{index, step, input, output, energy,
        ok}``; call once the device is synchronized."""
        return [dict(k, input=self.fields[i]["input"],
                     output=self.fields[i]["output"])
                for i, k in enumerate(self.kept) if k is not None]


class Window:
    """What the window measured: interval times, steps, members, and the
    traced part."""

    def __init__(self):
        self.intervals = []
        self.steps = 0
        self.wall = 0.0
        self.attempted = 0
        self.failed = 0
        self.prof = None
        self.steps_traced = 0


def run_window(program, order, sample, seconds, trace=False):
    """The closed loop of members (module docstring), the members' pool
    indices taken from ``order``.  With ``trace``, ``torch.profiler``
    records the intervals from the start of member 1 until
    ``TRACE_SECONDS`` of wall time have passed, and the window closes once
    the trace has ended and the sample is full."""
    tr = program.traffic
    n_int = tr["member_steps"] // tr["interval_steps"]
    w = Window()
    tracing, trace_t0 = False, None
    t0 = time.perf_counter()
    t_prev, t_end, closed = t0, t0 + seconds, False
    member = 0
    while not closed:
        if trace and member == 1:
            w.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            w.prof.start()
            tracing, trace_t0 = True, time.perf_counter()
        w.attempted += 1
        index = next(order)
        with torch.profiler.record_function("member.start"):
            state = program.start(index)
        ok = True
        for k in range(n_int):
            step = k * tr["interval_steps"]
            slot = sample.choose()
            if slot is not None:
                sample.kept[slot] = None
                sample.copy(slot, "input", program_fields(state))
            with torch.profiler.record_function("interval.run"):
                out = program.run(state)
            with torch.profiler.record_function("interval.read"):
                state, ok, energy = program.read(out)
            now = time.perf_counter()
            if slot is not None:
                sample.copy(slot, "output", program_fields(state))
                sample.kept[slot] = dict(index=index, step=step,
                                         energy=energy, ok=ok)
            if tracing:
                w.steps_traced += tr["interval_steps"]
                if now - trace_t0 >= TRACE_SECONDS:
                    w.prof.stop()
                    tracing = False
            if not closed:
                w.intervals.append(now - t_prev)
                w.steps += tr["interval_steps"]
                traced = (trace and w.prof is not None and not tracing
                          and sample.seen >= sample.size)
                if now >= t_end or traced:
                    closed = True
                    w.wall = now - t0
            t_prev = now
            if not ok:
                break
        if not ok:
            w.failed += 1
        member += 1
    if tracing:
        w.prof.stop()
    return w


def perturbed_start(ref, base, pool, index):
    """The reference's own start of pool member ``index``: its start
    ``base`` plus the member's perturbation."""
    d = pool.delta(index)
    dt_ = base.t.dtype
    return base._replace(t=base.t + d["t"].to(dt_), u=base.u + d["u"].to(dt_),
                         v=base.v + d["v"].to(dt_))


def reference_interval(ref, fields, step, traffic, counter=None):
    """The reference's interval of ``interval_steps`` steps from step
    ``step`` of a member, from the state ``fields`` (a dict of the
    program's tensors, cast to the reference's type): ``(State, energy,
    bad)``."""
    like = ref.geom.sig
    get = {f: fields[f].to(device=like.device, dtype=like.dtype)
           for f in FIELDS}
    s = ref_model.State(**get)
    dt = traffic["dt"]
    for n in range(step, step + traffic["interval_steps"]):
        if counter is not None:
            with counter:
                s = ref.step(s, n, n * dt)
        else:
            s = ref.step(s, n, n * dt)
    return s, float(ref.energy(s)), ref.bad(s)


def field_gap(fields, ref_state):
    """The worst field's largest difference from the reference over the
    reference's largest magnitude of that field."""
    worst = 0.0
    for f in COMPARED:
        r = getattr(ref_state, f).double()
        x = fields[f].to(device=r.device, dtype=torch.float64)
        scale = max(float(r.abs().max()), 1e-30)
        worst = max(worst, _finite(float((x - r).abs().max()) / scale))
    return worst


def _finite(x):
    """A gap that is not a number (a NaN in the output) is infinite."""
    return x if math.isfinite(x) else math.inf


def interval_gaps(ref, kept, traffic, counter=None):
    """``state_gap`` and ``energy_gap`` of one kept interval: its output
    against the reference's interval from the same input; and whether the
    reference's guard tripped."""
    s, energy, bad = reference_interval(ref, kept["input"], kept["step"],
                                        traffic, counter)
    return ({"state_gap": field_gap(kept["output"], s),
             "energy_gap": _finite(abs(kept["energy"] - energy)
                                   / abs(energy))}, bad)


def check(sample, start, config, traffic, pool, failed, limits, device,
          count=False):
    """``(correct, checks, ops_per_step, notes)``: the sampled intervals'
    gaps against the float64 reference (the worst over the sample); the
    starts against the reference's own (``start_gap``): ``start``, the
    set-up's ``(index, fields)`` of member 0, and the input of every
    sampled interval that begins a member; all beside the limits; the
    ``failed`` members and the reference's guard (limit 0); with ``count``
    the reference step's operations, counted over the sample."""
    tr = traffic
    ref = ref_model.Reference(config["model"], tr["height"], tr["width"],
                              tr["dt"], dtype=torch.float64, device=device)
    base = ref.start(config["start"] == "moist")
    kept = sample.intervals()
    starts = [start] + [(k["index"], k["input"]) for k in kept
                        if k["step"] == 0]
    worst = {"state_gap": 0.0, "energy_gap": 0.0,
             "start_gap": max(field_gap(fields, perturbed_start(
                 ref, base, pool, index)) for index, fields in starts)}
    counter = counts.OpCounter() if count else None
    ref_bad = False
    t = time.perf_counter()
    for k in kept:
        g, bad = interval_gaps(ref, k, tr, counter)
        ref_bad = ref_bad or bad
        for name, v in g.items():
            worst[name] = max(worst[name], v)
    log(f"reference over {len(kept)} intervals and {len(starts)} starts: "
        f"{time.perf_counter() - t:.1f} s, most convection sweeps "
        f"{ref.sweeps.most}")
    ops_per_step = None
    if counter is not None and kept:
        ops_per_step = counter.ops / (len(kept) * tr["interval_steps"])
    notes = "" if limits is not None else "no limits file for this cell"
    checks = {k: {"value": v, "limit": None if limits is None else limits[k]}
              for k, v in worst.items()}
    checks["failed_members"] = {"value": failed, "limit": 0}
    checks["reference_tripped"] = {"value": int(ref_bad), "limit": 0}
    if not kept:
        notes += "; no interval to check"
    correct = (limits is not None and bool(kept)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return correct, checks, ops_per_step, notes


def log_intervals(intervals):
    """The interval times' spread within the run, and their course over
    it (the median of each tenth of the window)."""
    if len(intervals) < 10:
        return
    ms = [1e3 * x for x in intervals]
    q = statistics.quantiles(ms, n=20)
    log(f"interval ms over {len(ms)}: 5% {q[0]:.4f}, 25% {q[4]:.4f}, "
        f"median {q[9]:.4f}, 75% {q[14]:.4f}, 95% {q[18]:.4f}, "
        f"max {max(ms):.4f}")
    tenth = len(ms) // 10
    log("interval ms median by tenth of the window: " + ", ".join(
        f"{statistics.median(ms[i:i + tenth]):.2f}"
        for i in range(0, tenth * 10, tenth)))


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(loaded, seed, seconds, trace=False, device="cuda", t_start=None,
             fault=None):
    """One run: ``(result line's object, forbidden modules loaded)``.
    ``fault``: a broken path of :mod:`gcmbench.faults`, put in the place
    of the program's own."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = loaded["config"], loaded["traffic"]
    on_card = device != "cpu"
    pool = members.Pool(config["perturbation"], config["model"]["layers"],
                        traffic["height"], traffic["width"], device)
    program = Program(config, traffic, pool, device)
    if fault is not None:
        fault(program)
    order = members.order(seed, pool.size)
    first = next(order)
    order = itertools.chain([first], order)
    # set-up: one interval from the first member's start, which the check
    # holds to the reference's
    state = program.start(first)
    start = (first, {f: x.cpu() for f, x in program_fields(state).items()})
    program.read(program.run(state))
    del state
    sample = Sample(start[1], traffic["check_intervals"], seed, device,
                    first=trace)
    if trace and on_card:
        # the profiler's first start takes seconds: pay it in set-up
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # what set-up made lives to the end of the run: no full collection in
    # the window walks it
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    full = gc.get_stats()[2]["collections"]
    window = run_window(program, order, sample, seconds, trace)
    full = gc.get_stats()[2]["collections"] - full
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = forbidden_modules()
    log(f"window {window.wall:.3f} s, {window.steps} steps, "
        f"{len(window.intervals)} intervals, {window.attempted} members "
        f"({window.failed} failed); peak {peak} bytes; "
        f"{full} full collections")

    reduced = None
    if window.prof is not None:
        reduced = trace_mod.reduce(*trace_mod.events_of(window.prof))
        window.prof = None
    del program
    if on_card:
        torch.cuda.empty_cache()

    correct, checks, ops_per_step, notes = check(
        sample, start, config, traffic, pool, window.failed,
        loaded["limits"], device, count=trace)
    if notes:
        log(notes)
    found = sorted(set(found) | set(forbidden_modules()))
    dtype = config["model"]["dtype"]
    L, H, W = config["model"]["layers"], traffic["height"], traffic["width"]
    if trace:
        ctx = dict(trace=reduced, steps_traced=window.steps_traced,
                   ops_per_step=ops_per_step, dtype=dtype,
                   bytes_per_step=counts.state_bytes(L, H, W, dtype))
        metrics = {}
        for m in loaded["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ops_per_step:
            least, bound = counts.least_seconds(
                ops_per_step, ctx["bytes_per_step"], dtype)
            log(f"counted {ops_per_step:.6e} operations and "
                f"{ctx['bytes_per_step']} bytes a step: least "
                f"{least * 1e3:.6f} ms a step, bound by {bound}")
    else:
        years = window.steps * traffic["dt"] / (365.0 * 86400.0)
        values = {
            "sypd": years / (window.wall / 86400.0),
            "interval_ms_p95": 1e3 * float(np.percentile(window.intervals,
                                                         95)),
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[quantity(m["name"])],
                               "unit": m["unit"]}
                   for m in loaded["end_to_end"]}
        log_intervals(window.intervals)
    result = {"correct": bool(correct), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": loaded["cell"]["chips"],
                         "memory_peak_bytes": int(peak)}}
    if on_card:
        result["device"]["power_limit"] = power_limit()
        log(f"card {result['device']['power_limit']}; peaks "
            f"{counts.PEAK_OPS_PER_S} ops/s, {counts.PEAK_BYTES_PER_S} B/s")
    if trace and reduced:
        result["device"]["busy_s"] = reduced["busy_s"]
        result["device"]["window_s"] = reduced["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], v] for n, v in reduced["device_ops"]],
            "idle_gaps": [[n[:160], v] for n, v in reduced["idle_gaps"]]}
    result["checks"] = checks
    return result, found
