"""Device kernels, copies and sets in the traced window per model step run
in it: what the driver loop (``model/driver.py``) launches a step."""


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps_traced")
    if not trace or not steps:
        return None
    return trace["device_events"] / steps
