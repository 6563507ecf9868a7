"""Halo exchange along the rings of a mesh.

Port of ``gcmiipy_tpu/parallel/halo.py`` (``exchange_axis`` :21-40,
``exchange_2d`` :41-46, ``trim`` :110).  Periodicity is the ring itself:
the cells a shard receives from its neighbours are the cells a periodic
roll would reach across its edges.  The JAX package's ``ppermute`` pair
becomes one batch of point-to-point operations (``dist.batch_isend_irecv``)
over the ring's process group (the mesh column for latitude, the mesh row
for longitude); a ring of one rank wraps its own cells, as a one-device
``ppermute`` does.  JAX's ``exchange_pad_aligned`` (:49-109), a TPU layout
device that embeds the exchange into an (8, 128) zero pad, is not carried
over: the 2D path runs its kernels on the exchanged block itself.
"""

import torch

from gcmiipy_tpu_torch.parallel import distributed


def exchange_axis(x, halo, mesh, axis=-2):
    """``x`` padded with ``halo`` cells from the ring neighbours along
    ``axis`` (-2: the latitude ring, -1: the longitude ring): the leading
    pad is the previous shard's trailing cells, the trailing pad the next
    shard's leading cells.  Returns a new tensor of ``size + 2*halo``
    cells along ``axis``."""
    if halo == 0:
        return x
    return finish_exchange(start_exchange(x, halo, mesh, axis))


def start_exchange(x, halo, mesh, axis=-2):
    """The first half of :func:`exchange_axis`: cuts the edge cells and,
    where they travel through host memory (gloo's point-to-point on the
    card), copies them to the host now, so that kernels launched before
    :func:`finish_exchange` do not hold the copies back."""
    size = x.shape[axis]
    if halo > size:
        raise ValueError(f"halo {halo} exceeds local extent {size}")
    n, index, group = mesh.ring(axis)
    lead = x.narrow(axis, 0, halo)
    trail = x.narrow(axis, size - halo, halo)
    if n > 1:
        lead, trail = (distributed.stage(c, group) for c in (lead, trail))
    return x, axis, n, index, group, lead, trail


def finish_exchange(pending):
    """The exchange that :func:`start_exchange` began: the padded tensor."""
    x, axis, n, index, group, lead, trail = pending
    if n == 1:
        return torch.cat([trail, x, lead], dim=axis)
    prev, nxt = (index - 1) % n, (index + 1) % n
    shape = tuple(lead.shape)
    # my trailing cells go forward (tag 0) and become the next shard's
    # leading pad; my leading cells go back (tag 1)
    from_prev, from_next = distributed.send_recv(
        [(trail, nxt, 0), (lead, prev, 1)],
        [(shape, prev, 0), (shape, nxt, 1)], group, device=x.device)
    return torch.cat([from_prev, x, from_next], dim=axis)


def exchange_2d(x, halo, mesh):
    """``x`` padded by ``halo`` cells on both spatial axes: along y, then
    along x on the y-padded block, so that the corners come from the
    diagonal neighbours."""
    return exchange_axis(exchange_axis(x, halo, mesh, -2), halo, mesh, -1)


def trim(x, halo, axes=(-2,)):
    """Remove ``halo`` cells of padding at both ends of each of ``axes``
    (rows by default; ``(-2, -1)`` for a 2D block)."""
    for axis in axes:
        x = x.narrow(axis, halo, x.shape[axis] - 2 * halo)
    return x
