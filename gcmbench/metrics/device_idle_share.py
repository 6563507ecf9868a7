"""The device's idle share of the traced window: 1 - busy / wall, both from
the same trace, in percent."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
