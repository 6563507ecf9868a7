"""The kernels' share of their roofline: the least time of the steps run in
the traced window (the larger of their operations at the type's peak and
their state bytes at the bandwidth, ``gcmbench/counts.py``) over the
device's busy time in the same window, in percent."""

from gcmbench import counts


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps_traced")
    ops, nbytes = ctx.get("ops_per_step"), ctx.get("bytes_per_step")
    if not trace or not steps or not ops or not nbytes or not trace["busy_s"]:
        return None
    least, _ = counts.least_seconds(ops * steps, nbytes * steps, ctx["dtype"])
    return 100.0 * least / trace["busy_s"]
