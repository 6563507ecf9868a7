"""A run function's walk as one CUDA graph, replayed on every later call.

:func:`driver._plan_run` walks a plan of units (the dynamics, the extras,
the guard's freeze, the stats) one launch at a time; on a card the host's
walk, not the card, sets the pace of a small grid.  The walk launches every
kernel on ``torch.cuda.current_stream``, allocates through PyTorch and
reads nothing back, so :class:`GraphedRun` captures it once in a
``torch.cuda.CUDAGraph`` and replays it as one launch:

* **when**: the handed state on a card, no mesh (the ring's guard, stats
  and halo run collectives, which stay eager), and a key seen before: the
  first call of each key runs eagerly and warms what the walk builds on
  its first call (the kernels' libraries, K7's scratch and tables), the
  second captures, every later one replays.  A run function called once
  never captures;
* **the key**: the handed state's shapes, dtypes and device, and, where
  the walk keys its cadences off the step counter, that step modulo the
  cadences' period (:attr:`driver.Cadence.period`).  The counter is read
  once a call, outside the graph (its ``gcm.sync`` span), as the eager
  walk reads it;
* **in and out**: the handed tensors are copied into the graph's own
  inputs, and its outputs copied into fresh tensors, so that the run never
  writes what it is handed and a state it returned stays intact through
  every later call;
* **counters**: the ops' ``.launches`` count at capture; each later replay
  adds what the capture counted, so that they count launches run;
* **spans**: ``gcm.graph.capture`` around a capture, ``gcm.graph.replay``
  around each replay; the walk's own spans fire only where it runs on the
  host (eagerly or under capture).

A replay runs the captured kernels in the captured order on one stream: its
results equal the eager walk's to the bit.  A capture that fails warns
once, and that run function stays eager.
"""

import sys
import types
import warnings

import torch

from gcmiipy_tpu_torch.model.observability import span


def leaves(tree):
    """The tensors of a nest of (named) tuples, in order; None holds
    none."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for part in tree for x in leaves(part)]


def rebuild(tree, tensors):
    """``tree`` with its tensors taken in order from the iterator
    ``tensors`` (the inverse of :func:`leaves`)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    parts = [rebuild(part, tensors) for part in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(
        parts)


def copy_into(dsts, srcs):
    """``dst.copy_(src)`` for each pair of one dtype, as few launches as a
    foreach copy makes: the 4-byte types (the fields, the clock, the step
    counter, the stats) copied as one group of their bits, each other type
    as a group of its own."""
    groups = {}
    for dst, src in zip(dsts, srcs):
        if dst.element_size() == 4:
            dst, src = dst.view(torch.int32), src.view(torch.int32)
        pair = groups.setdefault(dst.dtype, ([], []))
        pair[0].append(dst)
        pair[1].append(src)
    for group in groups.values():
        torch._foreach_copy_(*group)


def launch_counters():
    """The port's launch counters: each function of a loaded
    ``gcmiipy_tpu_torch`` module with an int ``launches``."""
    found = {}
    for name, module in list(sys.modules.items()):
        if module is None or not name.startswith("gcmiipy_tpu_torch."):
            continue
        for obj in vars(module).values():
            if (isinstance(obj, types.FunctionType)
                    and isinstance(getattr(obj, "launches", None), int)):
                found[id(obj)] = obj
    return list(found.values())


def on_card(state):
    """Whether the handed state lives on a CUDA device."""
    return leaves(state)[0].is_cuda


class CudaGraph:
    """The card's graph: ``capture(fn)`` records ``fn()`` and returns its
    outputs (the graph's own tensors), ``replay()`` runs it on the current
    stream."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn):
        with torch.cuda.graph(self.graph):
            return fn()

    def replay(self):
        self.graph.replay()


# the graph a capture makes (a stand-in for it runs the walk on the CPU)
Graph = CudaGraph


class _Captured:
    """One key's graph: its input tensors, its outputs and what the capture
    counted."""

    def __init__(self, graph, inputs, out, counted):
        self.graph, self.inputs, self.out = graph, inputs, out
        self.outputs = leaves(out)
        self.counted = counted

    def __call__(self, state, captured_now=False):
        """Replay on ``state``: copy in, replay, copy out.  ``captured_now``:
        the call that captured, whose inputs are in place and whose
        launches the capture counted."""
        if not captured_now:
            pairs = [(dst, src) for dst, src in zip(self.inputs,
                                                    leaves(state))
                     if dst is not src]
            copy_into([d for d, _ in pairs], [s for _, s in pairs])
        with span("gcm.graph.replay"):
            self.graph.replay()
        if not captured_now:
            for counter, n in self.counted:
                counter.launches += n
        fresh = [torch.empty_like(x) for x in self.outputs]
        copy_into(fresh, self.outputs)
        return rebuild(self.out, iter(fresh))


class GraphedRun:
    """``run(state)`` over ``walk(state, step0)``, the eager walk of a
    plan (module docstring).  ``period``: the cadences' period where the
    walk keys them off the step counter (``step0``, read here), else 0;
    ``capture``: False where the walk must stay eager (a mesh)."""

    def __init__(self, walk, period=0, capture=True):
        self.walk, self.period, self.capture = walk, period, capture
        self.seen = set()
        self.graphs = {}
        self.broken = None

    def key(self, state, step0):
        """The graph's key: the state's shapes, dtypes and device, and the
        cadence phase of ``step0``."""
        return (tuple((tuple(x.shape), x.dtype, x.device)
                      for x in leaves(state)),
                None if step0 is None else step0 % self.period)

    def __call__(self, state):
        step0 = None
        if self.period:
            with span("gcm.sync"):
                step0 = int(state.step)
        if not self.capture or self.broken is not None or not on_card(
                state):
            return self.walk(state, step0)
        key = self.key(state, step0)
        captured = self.graphs.get(key)
        if captured is not None:
            return captured(state)
        if key not in self.seen:
            self.seen.add(key)
            return self.walk(state, step0)
        captured = self._capture(state, step0)
        if captured is None:
            return self.walk(state, step0)
        self.graphs[key] = captured
        return captured(state, captured_now=True)

    def _capture(self, state, step0):
        """The walk of ``state`` captured on the graph's own copy of it, or
        None (with a warning, once) where the capture fails."""
        inputs = [x.clone() for x in leaves(state)]
        counters = launch_counters()
        before = [c.launches for c in counters]
        graph = Graph()
        try:
            with span("gcm.graph.capture"):
                out = graph.capture(lambda: self.walk(
                    rebuild(state, iter(inputs)), step0))
        except RuntimeError as err:
            for c, n in zip(counters, before):
                c.launches = n
            self.broken = f"{type(err).__name__}: {err}"
            warnings.warn(f"the run's walk could not be captured as a CUDA "
                          f"graph ({self.broken}); it stays eager",
                          RuntimeWarning, stacklevel=3)
            return None
        counted = [(c, c.launches - n) for c, n in zip(counters, before)
                   if c.launches != n]
        return _Captured(graph, inputs, out, counted)
