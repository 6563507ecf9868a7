"""The program's spans (``model.observability.span``) and what reads them.

* ``span`` is one shared no-op without a profiler, the profiler's own range
  with one;
* the run functions that the benchmark's cells reach give the span names
  and nesting of their design, with the kernels' CUDA sources run through
  the host emulation (``tests/torch_host_emulation.py``), so that the CPU
  runs the wrappers' card path and not the plain versions that stand in
  for the kernels here;
* ``gcm.physics.sun`` (the seasonal declination) fires once a physics call
  of the seasonal run (modelii-flagship's configuration) and never in the
  others;
* every host read of the device (``aten::_local_scalar_dense``) inside a run
  function's call lies inside a ``gcm.sync`` span, and grey-modelii's
  per-step loop makes none (the adaptive convection is one kernel launch);
* ``gcmbench/spans.py`` reads the program's totals once a run and empties
  them; the two readers by hand, and None without spans;
* ``step_profile``'s span table and its kernels without the copies;
* on the card (``gpu``): a traced run of each cell reads its span metrics
  (the replays of the run's walk as a CUDA graph, and the step counter's
  reads); the spans of an eager walk put nothing on the device's
  timeline, and the work put down to a span was launched inside it.
"""

import json
import os
import shutil
import subprocess
import sys
import types
import warnings

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gcmbench import bench, trace  # noqa: E402
from gcmbench import spans as gcmbench_spans  # noqa: E402
from gcmiipy_tpu_torch import step_profile  # noqa: E402
from gcmiipy_tpu_torch.model import driver, observability  # noqa: E402
from gcmiipy_tpu_torch.model import state as state_mod  # noqa: E402
from gcmiipy_tpu_torch.model.config import ModelConfig  # noqa: E402
from torch_host_emulation import kernels_on_cpu  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU

# gcmbench's gcm2-grey and gcm2-surface at a cut grid (3 layers)
GREY = dict(layers=3, physics=True, physics_every=1, convection=True,
            drag_tau=86400.0, backend="stream", stream_steps=20, guard=True,
            stats=True, guard_p_max=115000.0)
SURFACE = dict(layers=3, topography="hansen", land_cover="hansen",
               physics=True, physics_every=2, convection=True,
               radiation="4band", evaporation=True, gw0=0.05,
               precipitation=True, rh_crit=0.8, drag_tau=86400.0,
               shapiro_every=4, shapiro_fields="pt", shapiro_slp=True,
               backend="stream", stream_steps=20, guard=True, stats=True,
               guard_p_max=115000.0)
MODEL_II = dict(SURFACE, layers=9, giss_sige=True, ptop=1000.0,
                coriolis=True, seasonal=True, obliquity=23.44,
                year_days=365.0)
PHYSICS = ("gcm.physics.radiation", "gcm.physics.convection")
# (config, steps, moist start, start step): grey-modelii's per-step
# 'mega4' loop (24x36 is off K7's envelope), surface-flagship's 2-step K7
# calls with the extras between, the same behind an alignment head, and
# modelii-flagship's
RUNS = {
    "grey_per_step": (ModelConfig(height=24, width=36, dt=225.0, **GREY),
                      2, False, 0),
    "surface_stream": (ModelConfig(height=16, width=128, dt=30.0,
                                   **SURFACE), 4, True, 0),
    "surface_headed": (ModelConfig(height=16, width=128, dt=30.0,
                                   **SURFACE), 4, True, 1),
    # modelii-flagship's: the same calls, rotating, on Model II's 9 edges
    # under a seasonal sun
    "modelii_stream": (ModelConfig(height=16, width=128, dt=30.0,
                                   **MODEL_II), 4, True, 0),
}
NAMES = {
    "grey_per_step": {"gcm.dynamics", "gcm.extras", "gcm.physics",
                      *PHYSICS, "gcm.guard", "gcm.stats"},
    "surface_stream": {"gcm.dynamics", "gcm.extras", "gcm.shapiro",
                       "gcm.physics", *PHYSICS, "gcm.physics.evaporation",
                       "gcm.physics.condensation", "gcm.sync", "gcm.guard",
                       "gcm.stats"},
}
NAMES["surface_headed"] = NAMES["surface_stream"]
NAMES["modelii_stream"] = NAMES["surface_stream"] | {"gcm.physics.sun"}
# grey-flagship's traced launches a step: K7's 7, the loop's own and the
# graph's copies in and out (12.42 before the graph)
FLAGSHIP_LAUNCHES = 12.67
# the span each span lies directly inside (None: no program span)
PARENTS = {
    "gcm.dynamics": {None}, "gcm.extras": {None}, "gcm.guard": {None},
    "gcm.stats": {None}, "gcm.physics": {"gcm.extras"},
    "gcm.shapiro": {"gcm.extras"},
    "gcm.physics.sun": {"gcm.physics"},
    "gcm.physics.radiation": {"gcm.physics"},
    "gcm.physics.convection": {"gcm.physics"},
    "gcm.physics.evaporation": {"gcm.physics"},
    "gcm.physics.condensation": {"gcm.physics"},
    # the step counter and the head's guard
    "gcm.sync": {None},
}


def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    first = observability.span("gcm.dynamics")
    assert observability.span("gcm.sync") is first
    with first:
        with observability.span("gcm.stats"):
            torch.ones(3).sum()
    # nothing was recorded: a profiler started afterwards sees only its
    # own block
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(2)
    assert not any(e.name.startswith("gcm.") for e in prof.events())


def test_span_under_a_profiler_is_an_operator_range_and_is_totalled():
    observability.span_totals(reset=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            with observability.span("gcm.physics"):
                with observability.span("gcm.sync"):
                    bool(torch.ones(2).sum() > 0)
    spans = [e for e in prof.events() if e.name.startswith("gcm.")]
    assert sorted(e.name for e in spans) == ["gcm.physics"] * 2 + [
        "gcm.sync"] * 2
    # an operator's range, not a user annotation: the profiler copies no
    # annotation of it onto the device's timeline
    assert not any(e.is_user_annotation for e in spans)
    outer = [e for e in spans if e.name == "gcm.physics"]
    for inner in (e for e in spans if e.name == "gcm.sync"):
        assert any(o.time_range.start <= inner.time_range.start
                   and inner.time_range.end <= o.time_range.end
                   for o in outer)
    totals = observability.span_totals(reset=True)
    assert {n: t["count"] for n, t in totals.items()} == {
        "gcm.physics": 2, "gcm.sync": 2}
    assert totals["gcm.physics"]["host_s"] >= totals["gcm.sync"]["host_s"]
    assert totals["gcm.sync"]["host_s"] > 0
    assert set(totals["gcm.sync"]) == {"count", "host_s"}
    assert observability.span_totals() == {}
    # without the profiler nothing is added
    with observability.span("gcm.sync"):
        pass
    assert observability.span_totals() == {}


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """``{run: (profiler events, span totals)}`` of one warm call of each
    of :data:`RUNS`, the kernels' CUDA sources run by the host emulation."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host emulation")
    build_dir = str(tmp_path_factory.mktemp("spans_emulation"))
    torch.set_num_threads(1)
    out = {}
    for name, (config, steps, moist, start_step) in RUNS.items():
        geom = driver.gen_model_geometry(config, "cpu")
        state = driver.gen_model_state(geom, config)
        if moist:
            state = state_mod.moist_start(state, geom)
        state = state._replace(step=torch.tensor(start_step,
                                                 dtype=torch.int32))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            run = driver.make_run_fn(geom, config, steps,
                                     start_step=start_step)
        with kernels_on_cpu(build_dir):
            run(state)
            observability.span_totals(reset=True)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU]) as prof:
                run(state)
        out[name] = (list(prof.events()),
                     observability.span_totals(reset=True))
    return out


def _program(events):
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.name.startswith("gcm.")]


def _parent(span, spans):
    """The innermost other program span that holds ``span``."""
    s, e, _ = span
    holders = [x for x in spans if x is not span and x[0] <= s
               and e <= x[1]]
    return max(holders, key=lambda x: (x[0], -x[1]))[2] if holders else None


@pytest.mark.parametrize("run", sorted(RUNS))
def test_run_spans_have_the_designed_names_and_nesting(profiled, run):
    events, totals = profiled[run]
    spans = _program(events)
    assert {n for _, _, n in spans} == NAMES[run]
    for span in spans:
        assert _parent(span, spans) in PARENTS[span[2]], span
    counts = {n: sum(1 for x in spans if x[2] == n) for n in NAMES[run]}
    if run == "grey_per_step":
        # one dynamics call, extras, guard and stats a step
        for n in ("gcm.dynamics", "gcm.extras", "gcm.physics", "gcm.guard",
                  "gcm.stats"):
            assert counts[n] == 2, n
    if run in ("surface_stream", "modelii_stream"):
        # two K7 calls of 2 steps, the physics after each, the Shapiro
        # filter after the second; the guard's copy and check each call;
        # the one read of the step counter, the convection reading none
        assert counts["gcm.dynamics"] == 2 and counts["gcm.physics"] == 2
        assert counts["gcm.shapiro"] == 1 and counts["gcm.guard"] == 4
        assert counts["gcm.sync"] == 1
    # the program's totals count what the trace holds
    assert {n: t["count"] for n, t in totals.items()} == counts


@pytest.mark.parametrize("run", sorted(RUNS))
def test_the_sun_span_fires_once_a_physics_call_only_when_seasonal(profiled,
                                                                   run):
    """``gcm.physics.sun`` (the seasonal declination) fires once in each
    physics call of the seasonal run, inside it and before its
    radiation; and never where the sun stands at the equinox."""
    spans = _program(profiled[run][0])
    suns = [x for x in spans if x[2] == "gcm.physics.sun"]
    physics = [x for x in spans if x[2] == "gcm.physics"]
    if run != "modelii_stream":
        assert not suns
        return
    assert len(suns) == len(physics) == 2
    radiation = [x for x in spans if x[2] == "gcm.physics.radiation"]
    for call, sun, rad in zip(physics, suns, radiation):
        assert call[0] <= sun[0] and sun[1] <= call[1]
        assert sun[1] <= rad[0]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_every_host_read_lies_inside_a_sync_span(profiled, run):
    events = profiled[run][0]
    syncs = [x for x in _program(events) if x[2] == "gcm.sync"]
    reads = [e for e in events if e.name == "aten::_local_scalar_dense"]
    if run == "grey_per_step":
        # no step counter on the per-step path at physics_every 1, and the
        # convection's kernel reads nothing on the host
        assert not reads and not syncs
    else:
        assert reads
    for r in reads:
        assert any(s <= r.time_range.start and r.time_range.end <= e
                   for s, e, _ in syncs), r.time_range


# ---------------------------------------------------------------------------
# synthetic profiler events (step_profile's span table)

def _event(name, start_us, end_us, device=False, id=0, linked=0,
           annotation=False):
    return types.SimpleNamespace(
        name=name, key=name, device_type=CUDA if device else CPU, id=id,
        time_range=types.SimpleNamespace(start=start_us, end=end_us),
        linked_correlation_id=linked, is_user_annotation=annotation)


def _events():
    """Two intervals: a harness span and its device copy, aten ops, their
    runtime calls and the kernels they launched (same correlation id, one
    before the first span), and the program's spans on the host, with a
    device copy of one (no annotation mark: its name says what it is)."""
    ev = [_event("interval.run", 100, 2000, annotation=True),
          _event("interval.run", 120, 1990, device=True, annotation=True),
          _event("gcm.stats", 1710, 1990, device=True)]
    launches = [  # (op, op start, launch at, kernel start, kernel end)
        ("aten::mul", 150, 160, 170, 260), ("aten::add", 300, 310, 320, 380),
        ("aten::mul", 420, 430, 440, 700), ("aten::clamp", 800, 810, 900,
                                            950),
        ("aten::copy_", 1150, 1160, 1170, 1250),
        ("aten::mul", 1400, 1410, 1420, 1600), ("aten::sum", 1700, 1705,
                                                1710, 1990),
        ("aten::mul", 20, 25, 30, 90)]
    for n, (op, t_op, t_launch, k0, k1) in enumerate(launches):
        corr, ext = 1000 + n, 1 + n
        ev += [_event(op, t_op, t_launch + 5, id=ext),
               _event("cudaLaunchKernel", t_launch, t_launch + 4, id=corr,
                      linked=ext),
               _event(f"kernel_{op}", k0, k1, device=True, id=corr,
                      linked=ext)]
    ev += [_event(n, s, e, id=2000 + i) for i, (n, s, e) in enumerate([
        ("gcm.dynamics", 140, 290), ("gcm.physics", 400, 1000),
        ("gcm.physics.convection", 410, 780), ("gcm.sync", 700, 780),
        ("gcm.physics", 1390, 1690), ("gcm.stats", 1695, 1800)])]
    return ev


def _reader(name):
    return bench.metric_reader(name, ROOT)


def _totals(table):
    """A stand-in for ``span_totals`` that gives ``table`` once."""
    left = [table]

    def span_totals(reset=False):
        out = left[0]
        if reset:
            left[0] = {}
        return out
    return span_totals


def test_the_span_readers_by_hand_and_none_without_spans(monkeypatch):
    totals = {
        "gcm.sync": {"count": 30, "host_s": 0.003},
        "gcm.physics": {"count": 10, "host_s": 0.025},
        "gcm.guard": {"count": 10, "host_s": 0.001},
    }
    t = dict(busy_s=0.2, window_s=1.0, device_events=100, device_ops=[],
             idle_gaps=[])

    def ctx():
        return dict(trace=t, steps_traced=10, ops_per_step=None,
                    bytes_per_step=1.0, dtype="float32")
    names = ("host_syncs_per_step.hostbound",
             "physics_host_ms_per_step.hostbound")
    syncs, physics = (_reader(n) for n in names)
    monkeypatch.setattr(observability, "span_totals", _totals(totals))
    # both read the one table the first reading took
    one = ctx()
    assert syncs(one) == pytest.approx(3.0)
    assert physics(one) == pytest.approx(2.5)
    # a program with spans but no host read reads 0 syncs
    monkeypatch.setattr(observability, "span_totals", _totals({
        k: v for k, v in totals.items() if k != "gcm.sync"}))
    assert syncs(ctx()) == 0.0
    # no trace, no spans recorded, or a program without spans (the
    # parent's): nothing to read
    for read in (syncs, physics):
        assert read({}) is None
    monkeypatch.setattr(observability, "span_totals", _totals({}))
    for read in (syncs, physics):
        assert read(ctx()) is None
    monkeypatch.delattr(observability, "span_totals")
    for read in (syncs, physics):
        assert read(ctx()) is None


def test_per_step_logs_once_a_run(monkeypatch, capsys):
    monkeypatch.setattr(observability, "span_totals", _totals({
        "gcm.sync": {"count": 3, "host_s": 0.003},
        "gcm.guard": {"count": 3, "host_s": 0.006}}))
    ctx = dict(trace={"busy_s": 0.2}, steps_traced=3)
    assert gcmbench_spans.per_step(ctx) == {
        "gcm.sync": {"calls": 1.0, "host_ms": pytest.approx(1.0)},
        "gcm.guard": {"calls": 1.0, "host_ms": pytest.approx(2.0)}}
    gcmbench_spans.per_step(ctx)
    err = capsys.readouterr().err
    assert err.count("gcmbench: span gcm.sync: 1.0000 calls, host "
                     "1.000000 ms a step over 3 traced steps") == 1
    assert err.count("gcmbench: span gcm.guard: 1.0000 calls, host "
                     "2.000000 ms a step over 3 traced steps") == 1


def test_per_step_holds_only_what_was_profiled_since_the_last_reading():
    """Spans profiled before a reading do not reach the next one."""
    def profiled(calls):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(calls):
                with observability.span("gcm.sync"):
                    bool(torch.ones(2).sum() > 0)

    observability.span_totals(reset=True)
    profiled(5)
    first = gcmbench_spans.per_step(dict(trace={"busy_s": 1.0},
                                         steps_traced=1))
    assert first["gcm.sync"]["calls"] == 5.0
    assert observability.span_totals() == {}
    profiled(2)
    # unprofiled spans add nothing
    with observability.span("gcm.sync"):
        pass
    second = gcmbench_spans.per_step(dict(trace={"busy_s": 1.0},
                                          steps_traced=1))
    assert second["gcm.sync"]["calls"] == 2.0


# ---------------------------------------------------------------------------
# step_profile

def test_step_profile_spans_and_kernels_without_the_copies():
    events = _events()
    table = step_profile.span_table(events, 2)
    assert set(table) == {"gcm.dynamics", "gcm.physics",
                          "gcm.physics.convection", "gcm.sync", "gcm.stats"}
    # 400-1000 and 1390-1690 us; the mul launched at 430 (440-700), the
    # clamp at 810 (900-950), the mul at 1410 (1420-1600); over 2 steps
    assert table["gcm.physics"] == {"calls": 1.0,
                                    "host_ms": pytest.approx(0.45),
                                    "device_ms": pytest.approx(0.245)}
    assert table["gcm.physics.convection"]["device_ms"] == (
        pytest.approx(0.13))
    assert table["gcm.dynamics"]["device_ms"] == pytest.approx(0.045)
    # the sum launched at 1705 (1710-1990)
    assert table["gcm.stats"]["device_ms"] == pytest.approx(0.14)
    assert table["gcm.sync"] == {"calls": 0.5,
                                 "host_ms": pytest.approx(0.04),
                                 "device_ms": 0.0}
    kept = [e.name for e in events if step_profile._on_device(e)]
    assert len(kept) == 8 and all(n.startswith("kernel_") for n in kept)


# ---------------------------------------------------------------------------
# on the card

@pytest.mark.gpu
@pytest.mark.parametrize("cell,metrics", [
    ("grey-flagship", ["graph_replays_per_step"]),
    ("surface-flagship", ["host_syncs_per_step.hostbound",
                          "graph_replays_per_step.hostbound"]),
    ("grey-modelii", ["host_syncs_per_step.hostbound",
                      "graph_replays_per_step.hostbound"])])
def test_a_traced_run_reads_the_span_metrics(cell, metrics):
    """A traced run of each cell reads the span metrics it lists, and logs
    the spans they read.  The traced window replays each interval's walk
    as one CUDA graph (``model/run_graph.py``): one ``gcm.graph.replay`` an
    output interval, and no span of the walk itself, so that
    ``physics_host_ms_per_step`` has nothing to read.  The host reads are
    the step counter's alone: none in grey-modelii's per-step loop, one an
    output interval of 20 steps in surface-flagship.  grey-flagship's
    launches a step hold K7's 7, the loop's own and the copies in and out
    of the graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "gcmbench", "run.py"),
         "--workload", cell, "--seed", "3141592653", "--seconds", "50",
         "--trace", "1"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    interval = bench.load_cell(cell)["traffic"]["interval_steps"]
    for m in metrics:
        value = result["metrics"][m]["value"]
        if m.startswith("host_syncs"):
            assert (value == 0.0 if cell == "grey-modelii"
                    else 0 < value <= 0.06), (m, value)
        else:
            assert value == pytest.approx(1.0 / interval), (m, value)
    assert "gcmbench: span gcm.graph.replay:" in out.stderr
    for name in ("gcm.dynamics", "gcm.physics", "gcm.guard", "gcm.stats"):
        assert f"gcmbench: span {name}:" not in out.stderr
    assert not any(m.startswith("physics_host") for m in result["metrics"])
    assert ("gcmbench: span gcm.sync:" in out.stderr) == (
        cell == "surface-flagship")
    if cell == "grey-flagship":
        launches = result["metrics"]["launches_per_step"]["value"]
        assert abs(launches - FLAGSHIP_LAUNCHES) <= (
            0.02 * FLAGSHIP_LAUNCHES), launches


def _profile_on_card(config, steps, spans=True):
    """The profiler's events of one call of ``steps`` steps of ``config``
    on the card, the first of its run function (which walks the plan
    eagerly: a later call replays the walk as a CUDA graph), after another
    run function's warm call; with ``spans`` False the program's spans are
    switched off."""
    geom = driver.gen_model_geometry(config, "cuda")
    state = driver.gen_model_state(geom, config)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        warm = driver.make_run_fn(geom, config, steps)
        run = driver.make_run_fn(geom, config, steps)
    warm(state)
    torch.cuda.synchronize()
    saved = [(driver, driver.span)]
    if not spans:
        for m, _ in saved:
            m.span = lambda name: observability._NO_SPAN
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function("interval.run"):
                run(state)
                torch.cuda.synchronize()
    finally:
        for m, f in saved:
            m.span = f
    observability.span_totals(reset=True)
    return list(prof.events())


class _Events:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


@pytest.mark.gpu
@pytest.mark.parametrize("config,steps", [
    (ModelConfig(height=24, width=36, dt=225.0, **GREY), 16),
    (ModelConfig(height=64, width=128, dt=300.0, **GREY), 20)])
def test_spans_add_no_device_work_and_hold_what_they_launch(config, steps):
    """The per-step loop and K7 with its epilogue on the card: the spans
    put no event on the device's timeline (the trace's device events are
    those of the same call without spans), the device time of the spans
    that hold no other (dynamics, extras, guard, stats) sums to no more
    than the busy time, and each device event put down to a span starts
    after the span started."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    events = _profile_on_card(config, steps)
    bare = _profile_on_card(config, steps, spans=False)
    device, harness, host = trace.events_of(_Events(events))
    assert not any(n.startswith("gcm.") for _, _, n in device)
    assert (trace.reduce(device, harness, host)["device_events"]
            == trace.reduce(*trace.events_of(_Events(bare)))[
                "device_events"])
    busy_ms = 1e3 * trace.reduce(device, harness, host)["busy_s"]
    table = step_profile.span_table(events, 1)
    top = ("gcm.dynamics", "gcm.extras", "gcm.guard", "gcm.stats")
    assert table["gcm.dynamics"]["device_ms"] > 0
    assert table["gcm.guard"]["device_ms"] > 0
    assert sum(table[n]["device_ms"] for n in top if n in table) <= (
        busy_ms * (1 + 1e-9))
    cuda = torch.autograd.DeviceType.CUDA
    launches = {e.id: e.time_range.start for e in events
                if e.device_type != cuda and e.name.startswith("cu")}
    program = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type != cuda and e.name.startswith("gcm.")]
    attributed = 0
    for e in events:
        if e.device_type != cuda or e.id not in launches:
            continue
        for s0, e0 in program:
            if s0 <= launches[e.id] < e0:
                attributed += 1
                assert e.time_range.start >= s0, e.name
    assert attributed > 0
