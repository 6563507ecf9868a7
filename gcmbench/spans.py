"""The program's own spans over a traced run, for the per-layer readers.

While the profiler records, the program marks its work with spans
(``gcm.dynamics``, ``gcm.physics.convection``, ``gcm.sync``, ...) and adds
up each one's count and host seconds
(``gcmiipy_tpu_torch.model.observability.span_totals``).  In a run the
traced window is the only profiled part that runs the program (set-up's
warm profile runs none of it), and the first reading here takes the totals
and empties them, so the table holds the window's spans alone.  A program
without spans gives nothing here, and its readers return None."""

import sys


def per_step(ctx):
    """``{name: {calls, host_ms}}`` a traced step, or ``{}``; read once a
    ``ctx`` and kept in it, and logged to standard error then, one line a
    span."""
    if "spans" in ctx:
        return ctx["spans"]
    steps = ctx.get("steps_traced")
    if not ctx.get("trace") or not steps:
        return {}
    try:
        from gcmiipy_tpu_torch.model.observability import span_totals
    except ImportError:
        return {}
    table = {n: {"calls": v["count"] / steps,
                 "host_ms": 1e3 * v["host_s"] / steps}
             for n, v in sorted(span_totals(reset=True).items())}
    ctx["spans"] = table
    for n, v in table.items():
        print(f"gcmbench: span {n}: {v['calls']:.4f} calls, host "
              f"{v['host_ms']:.6f} ms a step over {steps} traced steps",
              file=sys.stderr, flush=True)
    return table
