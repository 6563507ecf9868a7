"""The lat-ring steps: K6 and K7 in their shard forms on each rank's band.

Port of ``gcmiipy_tpu/parallel/shard_step.py``: ``make_shard_step_fused4``
(:553-707) in its ``overlap=False`` form, ``make_shard_stream_ring``
(:708-843) and ``shard_prognostics`` (:844, in
:mod:`gcmiipy_tpu_torch.parallel.mesh`).  Each returns a function on the
rank's own band of rows, the fields ``(p, u, v, t, q)`` with Hl rows.

Each step exchanges a halo of rows with the ring neighbours
(:func:`halo.exchange_axis`, the fields packed into one buffer of planes)
and runs the kernel on the block of Hl + 2*halo rows with the block's own
row tables, built once per shard on the host, as the JAX package's
``strip_tables`` and ``rows`` build them (``dx_j``, ``dx_h``, ``lat``,
``heightmap``, the polar mask and its listed rows; the wall from the
global row H-1).  The kernels wrap rows modulo the block's height; that
spoils only halo rows, and the core rows come out as the whole globe's.
"""

import torch

from gcmiipy_tpu_torch.ops import mega_step, stream_steps
from gcmiipy_tpu_torch.parallel import halo
from gcmiipy_tpu_torch.parallel.mesh import block_rows

PHJ = 8  # a Matsuno step's row reach (JAX pallas_stencil.PHJ)


def _shard_rows(mesh, geom):
    if geom.height % mesh.ny:
        raise ValueError("height must divide the lat mesh axis")
    return geom.height // mesh.ny


def make_shard_step_fused4(mesh, geom, dt, coriolis=False, q_limiter=False):
    """One Matsuno step a call on the rank's band: one PHJ-row exchange and
    one call of K6's shard form (:func:`mega_step.mega_step_shard`) on the
    (Hl + 2*PHJ)-row block.  ``geom``: the global geometry."""
    hl = _shard_rows(mesh, geom)
    if hl < PHJ:
        raise ValueError(f"shard rows {hl} < padded-state halo {PHJ}")
    step = mega_step.MegaStep(
        geom.to(device=mesh.device), dt, coriolis=coriolis,
        q_limiter=q_limiter,
        rows=block_rows(geom.height, mesh.ny, mesh.index, PHJ))
    L = geom.layers

    def run(p, u, v, t, q):
        block = halo.exchange_axis(stream_steps.pack_state(p, u, v, t, q),
                                   PHJ, mesh)
        out = step(*stream_steps.unpack_state(block, L))
        return tuple(halo.trim(x, PHJ).contiguous() for x in out)

    return run


def make_shard_stream_ring(mesh, geom, dt, steps_per_launch=2,
                           coriolis=False, q_limiter=False):
    """K = ``steps_per_launch`` Matsuno steps a call on the rank's band: one
    K*PHJ-row exchange and one call of K7's shard form
    (:func:`stream_steps.stream_steps_shard`) on the (Hl + 2*K*PHJ)-row
    block, whose outer rows go stale step by step while the core stays
    exact (recompute on the halo, in time).  K must be even (the buffer's
    ping-pong) and K*PHJ at most Hl (a one-hop exchange).  Returns
    ``advance(p, u, v, t, q)``; ``advance.chunk_steps`` is K."""
    K = steps_per_launch
    if K < 2 or K % 2:
        raise ValueError(f"steps_per_launch must be even >= 2, got {K}")
    hl = _shard_rows(mesh, geom)
    D = K * PHJ
    if D > hl:
        raise ValueError(
            f"ring halo K*PHJ = {D} exceeds shard rows {hl} (one-hop "
            f"exchange); lower steps_per_launch to <= {hl // PHJ}")
    multi = stream_steps.StreamSteps(
        geom.to(device=mesh.device), dt, coriolis=coriolis,
        q_limiter=q_limiter,
        rows=block_rows(geom.height, mesh.ny, mesh.index, D))
    L = geom.layers

    def advance(p, u, v, t, q):
        packed = halo.exchange_axis(stream_steps.pack_state(p, u, v, t, q),
                                    D, mesh)
        S = torch.stack([packed, torch.empty_like(packed)])
        multi(S, None, K)
        return tuple(halo.trim(x, D).contiguous()
                     for x in stream_steps.unpack_state(S[0], L))

    advance.chunk_steps = K
    return advance
