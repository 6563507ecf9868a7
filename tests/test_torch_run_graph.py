"""PyTorch port: a run function's walk as one CUDA graph
(``gcmiipy_tpu_torch/model/run_graph.py``).

On the CPU, with a stand-in for the card's graph (its capture runs the
walk as a capture records it, its replay runs the walk again on the same
inputs into the same outputs):

* the rule: a CPU state and a mesh run eagerly; on a card the first call
  of a key runs eagerly, the second captures, every later one replays,
  and each call's result is the eager walk's on the state it is handed;
  the handed state is never written and a returned state stays intact;
* the key: one for grey-modelii's and surface-flagship's plans over a
  member's calls, a new one for another cadence phase, shape or dtype;
  the same for modelii-flagship's plan at every clock (the clock is an
  input of the walk);
* ``chunk_steps`` and ``head_steps`` survive the wrapper;
* the ops' ``.launches`` counters add one capture's count a replay, and a
  failed capture warns once and leaves the run eager;
* ``gcmbench/metrics/graph_replays_per_step.py`` reads the replays a step.

On the card (``gpu``): a replay equals the eager walk to the bit for the
benchmark's four configurations, through a guard trip too, and each of
them captures; with Model II's setup (rotation, Model II's edges, the
seasonal sun) replays at clocks days apart each equal the eager walk at
their own clock, so the sun follows the clock, not the capture's.
"""

import dataclasses
import json
import os
import sys
import warnings

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gcmbench.bench import metric_reader  # noqa: E402
from gcmiipy_tpu_torch.model import driver, observability  # noqa: E402
from gcmiipy_tpu_torch.model import run_graph  # noqa: E402
from gcmiipy_tpu_torch.model import state as state_mod  # noqa: E402
from gcmiipy_tpu_torch.model.config import ModelConfig  # noqa: E402
from gcmiipy_tpu_torch.ops import fft_filter, mega_step  # noqa: E402
from gcmiipy_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402

torch.set_num_threads(1)

leaves = run_graph.leaves


def bench_config(name, height, width, dt, **changes):
    """gcmbench's configuration ``name`` as the harness builds it, on a
    grid of ``height`` x ``width`` at ``dt``."""
    with open(os.path.join(ROOT, "gcmbench", "configs", name + ".json")) as fh:
        model = dict(json.load(fh)["model"])
    model.pop("sigma")
    model.update(changes)
    return ModelConfig(height=height, width=width, dt=dt, **model)


# grey-modelii's per-step 'mega4' loop (24x36 is off K7's envelope) and
# surface-flagship's 2-step K7 calls with the extras between, cut to 3
# layers, 4 steps, and a 16 x 128 grid for the stream
GREY = bench_config("gcm2-grey", 24, 36, 225.0, layers=3)
SURFACE = bench_config("gcm2-surface", 16, 128, 30.0, layers=3)
# modelii-flagship's: surface-flagship's plan, rotating, on Model II's 9
# edges under a seasonal sun
MODEL_II = bench_config("gcm2-modelii", 16, 128, 30.0, giss_sige=True)
RUNS = {"grey_per_step": (GREY, 4, False), "surface_stream": (SURFACE, 4,
                                                              True),
        "modelii_stream": (MODEL_II, 4, True)}


class StandIn:
    """The card's graph on the CPU: ``capture`` runs the walk and keeps its
    outputs; ``replay`` runs it again on the same inputs and writes the
    results into those outputs, leaving the launch counters as the capture
    counted them."""

    made = 0

    def __init__(self):
        StandIn.made += 1

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        counters = run_graph.launch_counters()
        counts = [c.launches for c in counters]
        new = self.fn()
        for c, n in zip(counters, counts):
            c.launches = n
        for dst, src in zip(leaves(self.out), leaves(new)):
            dst.copy_(src)


class NoGraph:
    def __init__(self):
        raise AssertionError("no capture expected")


@pytest.fixture
def card(monkeypatch):
    """Every state counts as a card's, and captures use :class:`StandIn`."""
    monkeypatch.setattr(run_graph, "on_card", lambda state: True)
    monkeypatch.setattr(run_graph, "Graph", StandIn)
    StandIn.made = 0


def _make(config, steps, moist=False, **kw):
    geom = driver.gen_model_geometry(config, "cpu")
    state = driver.gen_model_state(geom, config)
    if moist:
        state = state_mod.moist_start(state, geom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = driver.make_run_fn(geom, config, steps, **kw)
    return geom, state, run


def _perturbed(state, k):
    """``state`` with t moved by a smooth field of its own for each ``k``."""
    t = state.prog.t
    bump = 0.05 * k * torch.sin(torch.arange(
        t.numel(), dtype=t.dtype, device=t.device).reshape(t.shape)
        * 0.37 * (k + 1))
    return state._replace(prog=state.prog._replace(t=t + bump))


def _eager(run, state):
    """The eager walk of ``run`` on ``state``."""
    return run.walk(state, int(state.step) if run.period else None)


def _equal(out, ref):
    a, b = leaves(out), leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _clone(tree):
    return run_graph.rebuild(tree, iter([x.clone() for x in leaves(tree)]))


# ---------------------------------------------------------------------------
# the rule

def test_cpu_runs_stay_eager(monkeypatch):
    monkeypatch.setattr(run_graph, "Graph", NoGraph)
    _, state, run = _make(GREY, 2)
    assert isinstance(run, run_graph.GraphedRun) and run.capture
    for _ in range(3):
        out = run(state)
    _equal(out, _eager(run, state))
    assert run.graphs == {} and run.seen == set()


def test_mesh_runs_stay_eager(monkeypatch, card):
    monkeypatch.setattr(run_graph, "Graph", NoGraph)
    mesh = mesh_mod.make_mesh(device="cpu")
    config = dataclasses.replace(GREY, height=16, width=32)
    geom, state, run = _make(config, 2, mesh=mesh)
    state = mesh_mod.shard_state(state, mesh)
    assert not run.capture
    for _ in range(3):
        run(state)
    assert run.graphs == {} and run.seen == set()


@pytest.mark.parametrize("name", sorted(RUNS))
def test_second_call_captures_and_later_calls_replay(card, name):
    """Each call's result is the eager walk's on the state it is handed,
    bit for bit: eagerly on the first call, then through the capture and
    its replays; the handed states and the returned ones stay as they
    were, and no two results share memory."""
    config, steps, moist = RUNS[name]
    _, base, run = _make(config, steps, moist)
    states = [_perturbed(base, k) for k in range(4)]
    refs = [_eager(run, s) for s in states]
    kept = [_clone(s) for s in states]
    outs = []
    for k, s in enumerate(states):
        outs.append(run(s))
        assert StandIn.made == (0 if k == 0 else 1)
        assert len(run.graphs) == (0 if k == 0 else 1)
    outs.append(run(outs[-1][0]))
    refs.append(_eager(run, outs[-2][0]))
    for out, ref in zip(outs, refs):
        _equal(out, ref)
    for s, k in zip(states, kept):
        _equal(s, k)
    ptrs = [{x.data_ptr() for x in leaves(o)} for o in outs[1:]]
    for i in range(len(ptrs)):
        for j in range(i):
            assert not ptrs[i] & ptrs[j]
    graph_ptrs = {x.data_ptr() for c in run.graphs.values()
                  for x in c.outputs + c.inputs}
    assert not any(p & graph_ptrs for p in ptrs)


# ---------------------------------------------------------------------------
# the key

def test_modelii_plan_has_one_key():
    config = bench_config("gcm2-grey", 24, 36, 225.0)
    _, state, run = _make(config, 16)
    assert run.period == 0
    keys = {run.key(state._replace(step=torch.tensor(s, dtype=torch.int32)),
                    None) for s in range(0, 384, 16)}
    assert len(keys) == 1


def test_surface_plan_has_one_key_a_phase():
    """surface-flagship's plan (2-step K7 calls of a 20-step interval, the
    physics every 2 and the Shapiro filter every 4; the grid cut to 16 x
    128, which keeps the plan): one key over a member's 18 calls, another
    for a start off the Shapiro phase, a shape or a dtype."""
    config = bench_config("gcm2-surface", 16, 128, 30.0)
    geom, state, run = _make(config, 20, moist=True)
    assert run.chunk_steps == 2 and run.period == 4
    keys = {run.key(state, s) for s in range(0, 360, 20)}
    assert len(keys) == 1
    (key,) = keys
    assert run.key(state, 2) != key
    assert run.key(state, 4) == key
    wider = driver.gen_model_state(
        driver.gen_model_geometry(dataclasses.replace(config, width=256),
                                  "cpu"), config)
    assert run.key(wider, 0) != key
    double = run_graph.rebuild(state, iter([x.double() if x.is_floating_point()
                                            else x for x in leaves(state)]))
    assert run.key(double, 0) != key


def _at_clock(state, days):
    """``state`` with its clock ``days`` days after January 1."""
    return state._replace(utc=torch.full_like(state.utc, days * 86400.0))


def test_model_ii_key_is_the_same_at_every_clock():
    """The clock is an input of the walk, not part of its key: calls of
    modelii-flagship's plan days apart share one graph."""
    _, state, run = _make(MODEL_II, 20, moist=True)
    assert run.chunk_steps == 2 and run.period == 4
    keys = {run.key(_at_clock(state, days), 0) for days in (0, 45, 180)}
    assert len(keys) == 1


def test_surface_phases_capture_a_graph_each(card):
    """Calls that start at two phases of the Shapiro cadence capture a
    graph each, each on its own second call, and both replay the eager
    walk's result."""
    config, steps, moist = RUNS["surface_stream"]
    _, base, run = _make(config, steps, moist)
    at = [base._replace(step=torch.tensor(s, dtype=torch.int32))
          for s in (0, 2, 4, 6, 8, 10)]
    for k, s in enumerate(at):
        _equal(run(s), _eager(run, s))
        assert len(run.graphs) == min(2, max(0, k - 1))


def test_chunk_and_head_steps_survive_the_wrapper():
    _, _, run = _make(SURFACE, 20, True)
    assert isinstance(run, run_graph.GraphedRun) and run.chunk_steps == 2
    _, _, headed = _make(SURFACE, 20, True, start_step=1)
    assert headed.chunk_steps == 2 and headed.head_steps == 1


# ---------------------------------------------------------------------------
# the counters and the spans

def _toy_walk(state, step0):
    mega_step.mega_step.launches += 1
    fft_filter.fft_filter.launches += 2
    return (state[0] * 2.0, state[0].sum()), None


def test_counters_add_a_capture_per_replay_and_spans_mark_them(card):
    run = run_graph.GraphedRun(_toy_walk)
    state = (torch.arange(6.0),)
    before = (mega_step.mega_step.launches, fft_filter.fft_filter.launches)
    observability.span_totals(reset=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for k in range(5):
            out = run(state)
    totals = observability.span_totals(reset=True)
    assert (mega_step.mega_step.launches - before[0],
            fft_filter.fft_filter.launches - before[1]) == (5, 10)
    assert totals["gcm.graph.capture"]["count"] == 1
    assert totals["gcm.graph.replay"]["count"] == 4
    _equal(out, ((state[0] * 2.0, state[0].sum()), None))


class Failing:
    def capture(self, fn):
        fn()
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")


def test_a_failed_capture_warns_once_and_stays_eager(card, monkeypatch):
    monkeypatch.setattr(run_graph, "Graph", Failing)
    run = run_graph.GraphedRun(_toy_walk)
    state = (torch.arange(6.0),)
    before = mega_step.mega_step.launches
    run(state)
    with pytest.warns(RuntimeWarning, match="could not be captured"):
        run(state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for _ in range(3):
            run(state)
    assert run.broken.startswith("RuntimeError") and run.graphs == {}
    assert mega_step.mega_step.launches - before == 5


# ---------------------------------------------------------------------------
# the benchmark's reader

def test_graph_replays_per_step_reads_the_replay_spans():
    read = metric_reader("graph_replays_per_step.hostbound")
    assert read({"spans": {"gcm.graph.replay": {"calls": 0.0625,
                                                "host_ms": 0.01},
                           "gcm.sync": {"calls": 0.0, "host_ms": 0.0}}}
                ) == 0.0625
    assert read({"spans": {"gcm.dynamics": {"calls": 1.0,
                                            "host_ms": 0.3}}}) == 0.0
    assert read({"spans": {}}) is None
    assert read({}) is None


def test_graph_replays_per_step_over_the_programs_spans(card):
    run = run_graph.GraphedRun(_toy_walk)
    state = (torch.arange(6.0),)
    run(state)
    run(state)
    observability.span_totals(reset=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            run(state)
    read = metric_reader("graph_replays_per_step")
    assert read({"trace": {"busy_s": 1.0}, "steps_traced": 48}) == 3 / 48


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# the benchmark's configurations: grey-modelii's grid on the per-step
# 'mega4' fallback, and the flagship's cut to 64 x 256 (inside K7's
# envelope and the in-kernel physics' width) on 'stream'
CARD_RUNS = {
    "grey_modelii": (bench_config("gcm2-grey", 24, 36, 225.0), 16, False,
                     (0,)),
    "grey_stream": (bench_config("gcm2-grey", 64, 256, 30.0), 20, False,
                    (0,)),
    "grey_l40_stream": (bench_config("gcm2-grey-l40", 64, 256, 30.0), 20,
                        False, (0,)),
    "surface_stream": (bench_config("gcm2-surface", 64, 256, 30.0), 20,
                       True, (0, 2)),
}


def _card_run(name, device, **changes):
    config, steps, moist, phases = CARD_RUNS[name]
    config = dataclasses.replace(config, **changes)
    geom = driver.gen_model_geometry(config, device)
    state = driver.gen_model_state(geom, config)
    if moist:
        state = state_mod.moist_start(state, geom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = driver.make_run_fn(geom, config, steps)
    return geom, state, run, phases


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_RUNS))
def test_replay_equals_the_eager_walk_to_the_bit_on_gpu(cuda_device, name):
    """For each phase: an eager call, the capture, two replays (one from
    the previous result); each equal to the eager walk on its state to the
    bit, stats and guard included; the handed states unchanged; one graph
    a phase and no fall-back."""
    _, base, run, phases = _card_run(name, cuda_device)
    for phase in phases:
        states = [_perturbed(base, k)._replace(
            step=torch.tensor(phase, dtype=torch.int32, device=cuda_device))
            for k in range(3)]
        kept = [_clone(s) for s in states]
        outs = [run(s) for s in states]
        outs.append(run(outs[-1][0]))
        refs = [_eager(run, s) for s in states + [outs[-2][0]]]
        for out, ref in zip(outs, refs):
            _equal(out, ref)
        for s, k in zip(states, kept):
            _equal(s, k)
    assert run.broken is None and len(run.graphs) == len(phases)


def _trip_threshold(run, state, steps):
    """A ``guard_p_max`` between the largest surface pressure of the
    states before some step k > 0 and that of step k's: a guard at it
    trips inside the interval, not at its first step."""
    highest, s = float(state.prog.p.max()), state
    for k in range(steps):
        s = run.walk(s, None)[0]
        p = float(s.prog.p.max())
        if p > highest and k > 0:
            return 0.5 * (p + highest)
        highest = max(highest, p)
    return None


@pytest.mark.gpu
def test_the_replayed_sun_follows_the_clock_on_gpu(cuda_device):
    """modelii-flagship's configuration (rotation, Model II's edges, the
    seasonal sun) at 64 x 256: calls of one phase whose clocks lie days
    apart, the second capturing and the later ones replaying, each equal
    to the eager walk at its own clock to the bit; the sun moves the
    result, so a replay that kept the capture's declination would differ
    from the eager walk at its clock."""
    config = bench_config("gcm2-modelii", 64, 256, 30.0, giss_sige=True)
    geom = driver.gen_model_geometry(config, cuda_device)
    base = state_mod.moist_start(driver.gen_model_state(geom, config), geom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = driver.make_run_fn(geom, config, 20)
    days = (0, 30, 91, 172, 300)
    states = [_at_clock(base, d) for d in days]
    outs = [run(s) for s in states]
    assert run.broken is None and len(run.graphs) == 1
    refs = [_eager(run, s) for s in states]
    for out, ref in zip(outs, refs):
        _equal(out, ref)
    # the clock moved the sun: the replays at 91, 172 and 300 days differ
    # from the eager walk at the capture's clock (30 days) and from each
    # other
    t = [o[0].prog.t for o in outs]
    for k in (2, 3, 4):
        assert not torch.equal(t[k], refs[1][0].prog.t)
    assert not torch.equal(t[2], t[3]) and not torch.equal(t[3], t[4])


@pytest.mark.gpu
def test_a_trip_inside_a_replayed_interval_on_gpu(cuda_device):
    """A member whose surface pressure passes the guard's bound inside the
    interval: the replay's ``blown_step`` and frozen state are the eager
    walk's."""
    geom, base, _, _ = _card_run("grey_modelii", cuda_device)
    one = driver.make_run_fn(geom, CARD_RUNS["grey_modelii"][0], 1)
    state = _perturbed(base, 2)
    bound = _trip_threshold(one, state, 16)
    assert bound is not None
    _, _, run, _ = _card_run("grey_modelii", cuda_device, guard_p_max=bound)
    outs = [run(state) for _ in range(3)]
    ref = _eager(run, state)
    blown = int(ref[2].blown_step)
    assert 0 < blown < 16 and not bool(ref[2].ok)
    for out in outs:
        _equal(out, ref)
    assert len(run.graphs) == 1


@pytest.mark.gpu
def test_successive_outputs_stay_and_do_not_alias_on_gpu(cuda_device):
    _, state, run, _ = _card_run("grey_modelii", cuda_device)
    kept = _clone(state)
    outs = [run(state)]
    for _ in range(3):
        outs.append(run(outs[-1][0]))
    kept_outs = [_clone(o) for o in outs]
    for _ in range(2):
        run(outs[-1][0])
    _equal(state, kept)
    for o, k in zip(outs, kept_outs):
        _equal(o, k)
    ptrs = [{x.data_ptr() for x in leaves(o)} for o in outs]
    for i in range(len(ptrs)):
        for j in range(i):
            assert not ptrs[i] & ptrs[j]
