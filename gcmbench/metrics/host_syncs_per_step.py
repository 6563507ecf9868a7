"""The program's device-to-host reads per model step run in the traced
window: its ``gcm.sync`` spans, counted by the program, one around each
read a run function makes: the step counter, read once a call where a
cadence outlasts a unit of the run's plan (``model/run_graph.py``), and the
guard of a run's alignment head (``model/driver.py``).  Each read drains
the device's queue."""

from gcmbench import spans


def read(ctx):
    table = spans.per_step(ctx)
    if not table:
        return None
    return table.get("gcm.sync", {}).get("calls", 0.0)
