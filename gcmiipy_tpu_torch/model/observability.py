"""Tracing, step timing and the metrics log.

Port of ``gcmiipy_tpu/model/observability.py``:

* :func:`trace`: a ``torch.profiler`` context around a block that writes a
  Chrome trace (``trace.json``) into ``logdir``;
* :class:`MetricsLogger`: appends step metrics as JSON lines;
* :func:`throughput`: grid-point updates per second;
* :class:`StepTimer`: time per step with warm-up discarded, timed with CUDA
  events on a card (read once, at :attr:`StepTimer.mean`) and with the
  host's clock otherwise.
"""

import contextlib
import json
import os
import tempfile
import time

import torch


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


def throughput(points, seconds):
    """Grid-point updates per second."""
    return points / seconds if seconds > 0 else float("inf")


class StepTimer:
    """Seconds per step with the first ``skip`` steps discarded: ``with
    timer:`` around each step.  With a CUDA ``device`` each step is timed
    by a pair of CUDA events on the current stream, so no step waits for
    the card; :attr:`times` synchronises once and reads them."""

    def __init__(self, skip=1, device=None):
        self.skip = skip
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._times, self._events = [], []
        self._t0 = None

    def __enter__(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.skip > 0:
            self.skip -= 1
        elif self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((self._t0, end))
        else:
            self._times.append(time.perf_counter() - self._t0)
        return False

    @property
    def times(self):
        if self._events:
            torch.cuda.synchronize()
            self._times += [a.elapsed_time(b) / 1e3 for a, b in self._events]
            self._events = []
        return self._times

    @property
    def mean(self):
        times = self.times
        return sum(times) / len(times) if times else float("nan")
