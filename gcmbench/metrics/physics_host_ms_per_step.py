"""The host's ms per model step run in the traced window inside the
program's plain physics (its ``gcm.physics`` spans: the drag, the
radiation, the convection, the evaporation and the condensation between
the dynamics calls)."""

from gcmbench import spans


def read(ctx):
    physics = spans.per_step(ctx).get("gcm.physics")
    return None if physics is None else physics["host_ms"]
