"""Reduce a ``torch.profiler`` trace of part of the window to what the
per-layer metrics and the breakdown read.

The traced window runs from the start of the harness's first span to the
end of its last (``SPANS``, recorded with ``record_function`` around the
calls into the program).  Within it: the device's busy time (the union of
its kernels, copies and sets), their count, the device operations by total
time, and the idle gaps, each named by the harness span and the innermost
host operation that were running when it began.
"""

import torch

SPANS = ("member.start", "interval.run", "interval.read")
TOP = 10


def events_of(prof):
    """``(device, spans, host_ops)`` from a finished profiler: lists of
    ``(start_s, end_s, name)`` on the profiler's one clock.  The device
    side's copies of the harness's spans are left out."""
    device, spans, host = [], [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        item = (e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
        if e.name in SPANS:
            if e.device_type != cuda:
                spans.append(item)
        elif e.device_type == cuda:
            device.append(item)
        else:
            host.append(item)
    return device, spans, host


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label(t, spans, host):
    """What the host was doing at ``t``: the harness span and the
    innermost host operation that cover it."""
    span = next((n for s, e, n in spans if s <= t < e), "outside")
    inner = None
    for s, e, n in host:
        if s <= t < e and (inner is None or s >= inner[0]):
            inner = (s, n)
    return span if inner is None else f"{span}/{inner[1]}"


def reduce(device, spans, host):
    """``{busy_s, window_s, device_events, device_ops, idle_gaps}`` of the
    window the spans cover, or None where there are no spans or no device
    activity in it."""
    if not spans:
        return None
    t0 = min(s for s, _, _ in spans)
    t1 = max(e for _, e, _ in spans)
    inside = [(max(s, t0), min(e, t1), n) for s, e, n in device
              if e > t0 and s < t1]
    if not inside:
        return None
    busy = _union([(s, e) for s, e, _ in inside])
    by_name = {}
    for s, e, n in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps, edge = [], t0
    for s, e in busy:
        if s > edge:
            gaps.append((s - edge, edge))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((t1 - edge, edge))
    gaps.sort(reverse=True)
    return {
        "busy_s": sum(e - s for s, e in busy),
        "window_s": t1 - t0,
        "device_events": len(inside),
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:TOP],
        "idle_gaps": [[_label(at, spans, host), length]
                      for length, at in gaps[:TOP]],
    }
