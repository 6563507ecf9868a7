"""The program's replays of a captured run per model step run in the traced
window: its ``gcm.graph.replay`` spans (one around each replay of a run
function's walk as a CUDA graph, ``model/run_graph.py``).  One replay an
output interval reads 1 / ``interval_steps``; 0.0 means the walk ran
eagerly (the program's spans are there, but none of that name)."""

from gcmbench import spans


def read(ctx):
    table = spans.per_step(ctx)
    if not table:
        return None
    return table.get("gcm.graph.replay", {}).get("calls", 0.0)
