"""The whole step's share of the card's peak: the operations of the steps
run in the traced window (counted over the benchmark's reference step,
``gcmbench/counts.py``) over the configuration type's peak times the
window's wall time, in percent."""

from gcmbench import counts


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps_traced")
    ops = ctx.get("ops_per_step")
    if not trace or not steps or not ops:
        return None
    peak = counts.PEAK_OPS_PER_S[ctx["dtype"]]
    return 100.0 * ops * steps / (peak * trace["window_s"])
