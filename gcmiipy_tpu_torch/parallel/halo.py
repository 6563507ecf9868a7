"""Halo exchange along the latitude ring.

Port of ``gcmiipy_tpu/parallel/halo.py`` (``exchange_axis`` :21-40,
``trim`` :110).  Periodicity is the ring itself: the rows a shard receives
from its neighbours are the rows a periodic roll would reach across its
edges.  The JAX package's ``ppermute`` pair becomes one batch of
point-to-point operations (``dist.batch_isend_irecv``); a ring of one rank
wraps its own rows, as a one-device ``ppermute`` does.
"""

import torch

from gcmiipy_tpu_torch.parallel import distributed


def exchange_axis(x, halo, mesh, axis=-2):
    """``x`` padded with ``halo`` rows from the ring neighbours along
    ``axis``: the leading pad is the previous shard's trailing rows, the
    trailing pad the next shard's leading rows.  Returns a new tensor of
    ``size + 2*halo`` rows."""
    size = x.shape[axis]
    if halo > size:
        raise ValueError(f"halo {halo} exceeds local extent {size}")
    if halo == 0:
        return x
    lead = x.narrow(axis, 0, halo)
    trail = x.narrow(axis, size - halo, halo)
    if mesh.ny == 1:
        return torch.cat([trail, x, lead], dim=axis)
    prev = (mesh.index - 1) % mesh.ny
    nxt = (mesh.index + 1) % mesh.ny
    shape = tuple(lead.shape)
    # my trailing rows go forward (tag 0) and become the next shard's
    # leading pad; my leading rows go back (tag 1)
    from_prev, from_next = distributed.send_recv(
        [(trail, nxt, 0), (lead, prev, 1)],
        [(shape, prev, 0), (shape, nxt, 1)], mesh.group)
    return torch.cat([from_prev, x, from_next], dim=axis)


def trim(x, halo, axis=-2):
    """Remove ``halo`` rows of padding at both ends of ``axis``."""
    return x.narrow(axis, halo, x.shape[axis] - 2 * halo)
