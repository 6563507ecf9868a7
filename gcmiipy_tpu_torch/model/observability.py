"""Tracing, the program's spans and the metrics log.

Port of ``gcmiipy_tpu/model/observability.py``:

* :func:`trace`: a ``torch.profiler`` context around a block that writes a
  Chrome trace (``trace.json``) into ``logdir``;
* :func:`span`: a named range of the program's own work (``gcm.*``) while
  a profiler records, and nothing otherwise; :func:`span_totals` reads
  what the spans recorded;
* :class:`MetricsLogger`: appends step metrics as JSON lines.
"""

import contextlib
import json
import os
import tempfile
import time

import torch

_NO_SPAN = contextlib.nullcontext()
# a range on the profiler's clock with the scope of an operator, not of a
# user annotation: the profiler copies annotations onto the device's
# timeline, where they would read as device work
_RANGE = torch._C._profiler._RecordFunctionFast
# name -> [count, host seconds]
_TOTALS = {}


class _Span:
    """One recorded span: the profiler's range and the host's time."""

    __slots__ = ("name", "range", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.range = _RANGE(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        totals = _TOTALS.setdefault(self.name, [0, 0.0])
        totals[0] += 1
        totals[1] += time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        return False


def span(name):
    """``with span("gcm.physics"):`` around a block of the program's work.
    While a profiler records on this thread it is a range on the
    profiler's clock (which names the host's work in the trace and links
    the kernels launched inside it), and it adds to :func:`span_totals`;
    otherwise it is one shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return _Span(name)
    return _NO_SPAN


def span_totals(reset=False):
    """``{name: {count, host_s}}`` of the spans recorded under a profiler
    since the last reset: how many, and the host's seconds inside them.
    ``reset`` empties the totals once read, so that the next reading holds
    only what is profiled after it."""
    out = {name: {"count": count, "host_s": host}
           for name, (count, host) in _TOTALS.items()}
    if reset:
        _TOTALS.clear()
    return out


@contextlib.contextmanager
def trace(logdir=None):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    when there is one) and write ``<logdir>/trace.json``; yields the
    profiler."""
    logdir = logdir or os.path.join(tempfile.gettempdir(),
                                    "gcmiipy_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLogger:
    """JSON-lines metrics sink (the reference's STATS defaultdict, kept)."""

    def __init__(self, path=None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.history = []

    def log(self, step, **metrics):
        rec = {"step": int(step), "time": time.time(), **{
            k: float(v) for k, v in metrics.items()}}
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
