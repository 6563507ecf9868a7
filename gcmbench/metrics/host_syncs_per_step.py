"""The program's device-to-host reads per model step run in the traced
window: its ``gcm.sync`` spans (one around each read of the driver loop,
``model/driver.py``, and of the adaptive convection's stop test), counted
by the program.  Each read drains the device's queue; a CUDA graph of the
step needs none."""

from gcmbench import spans


def read(ctx):
    table = spans.per_step(ctx)
    if not table:
        return None
    return table.get("gcm.sync", {}).get("calls", 0.0)
