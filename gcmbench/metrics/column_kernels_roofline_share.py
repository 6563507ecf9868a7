"""The share of their roofline that the kernels whose work a column's depth
sets reach together: the pgf tile, the rest tile and K7's column-physics
epilogue (``gcmiipy_tpu_torch/csrc/pgf_tile.cuh``, ``stencil_tile.cuh``,
``column_physics.cuh``, in their held and their deep forms), matched by the
names the trace prints.  The least time of the steps run in the traced
window at the bandwidth (their state bytes, ``gcmbench/counts.py``) over
those kernels' summed device time, in percent: how near the L-scaled
kernels come, together, to moving the step's state once.  None where the
trace holds none of them."""

from gcmbench import counts

KERNELS = ("pgf_tile", "tile_stencil", "column_physics")


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps_traced")
    nbytes = ctx.get("bytes_per_step")
    if not trace or not steps or not nbytes:
        return None
    busy = sum(s for name, s in trace["device_ops"]
               if any(k in name for k in KERNELS))
    if not busy:
        return None
    return 100.0 * steps * nbytes / counts.PEAK_BYTES_PER_S / busy
