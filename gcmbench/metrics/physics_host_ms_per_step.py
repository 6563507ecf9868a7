"""The host's ms per model step run in the traced window inside the
program's plain physics (its ``gcm.physics`` spans: the drag, the
radiation, the convection, the evaporation and the condensation between
the dynamics calls).  No cell reports it: on a card the traced window
replays each call's walk as one CUDA graph, in which no ``gcm.physics``
span fires.  The reader stays for the span tests that read it by hand."""

from gcmbench import spans


def read(ctx):
    physics = spans.per_step(ctx).get("gcm.physics")
    return None if physics is None else physics["host_ms"]
