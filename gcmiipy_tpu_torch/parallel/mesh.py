"""The mesh of ranks: a latitude ring, or a 2D (lat x lon) mesh.

Port of ``gcmiipy_tpu/parallel/mesh.py``.  The JAX package shards global
arrays over a device mesh (``state_specs`` :53-70 for the ('y','x') mesh,
``ring_state_specs`` :73-109 for the lat ring); here each rank is one
process that holds its own block of the grid and knows its neighbours.
On a (ny, nx) mesh rank r sits at ``(r // nx, r % nx)`` (JAX
``make_mesh``'s device order) and holds rows ``[y*Hl, (y+1)*Hl)`` and
columns ``[x*Wl, (x+1)*Wl)``, ``Hl = H // ny``, ``Wl = W // nx``: p and the
ground fields cut ``('y','x')``, the layered fields ``(None,'y','x')``.
A lat ring is the mesh with ``nx = 1``: full longitude rows on each rank.

The mesh is the process group, its shape, the rank's place on it, the
process subgroups of its mesh row (the x ring: the lon halo and the
spectral psum) and of its mesh column (the y ring), and the rank's
device.  ``torch.distributed.device_mesh.DeviceMesh`` is not used: it
binds one card to each rank by its local rank, and the mesh also runs
with its ranks sharing one card (under gloo) or on the CPU.
"""

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from gcmiipy_tpu_torch.device import resolve_device
from gcmiipy_tpu_torch.model.state import (
    GroundVars, ModelState, PrognosticVars)


def best_mesh_shape(n_devices):
    """Split n devices into a near-square (y, x) grid, x >= y (JAX
    ``best_mesh_shape``)."""
    y = int(np.floor(np.sqrt(n_devices)))
    while n_devices % y != 0:
        y -= 1
    return (y, n_devices // y)


@dataclasses.dataclass(frozen=True)
class RingMesh:
    """A mesh as one rank sees it: ``ny`` x ``nx`` blocks, this rank's
    block at (``index``, ``x_index``), the process ``group`` of all its
    ranks (None: the default group, or no group for a mesh of one), the
    subgroups ``row_group`` (the ranks of this rank's mesh row, ``nx`` of
    them) and ``col_group`` (its mesh column, ``ny``; the whole group on a
    lat ring) and the rank's ``device``.  ``shape`` is ``{'y': ny}`` on a
    lat ring and ``{'y': ny, 'x': nx}`` on a 2D mesh, as JAX's
    ``mesh.shape``."""
    ny: int
    index: int
    device: torch.device
    group: object = None
    nx: int = 1
    x_index: int = 0
    row_group: object = None
    col_group: object = None

    @property
    def shape(self):
        return {"y": self.ny, "x": self.nx} if self.nx > 1 else {"y": self.ny}

    def ring(self, axis):
        """``(n, index, group)`` of the ring along ``axis`` (-2: latitude,
        the mesh column; -1: longitude, the mesh row)."""
        if axis in (-1, 1):
            return self.nx, self.x_index, self.row_group
        return self.ny, self.index, (self.col_group if self.nx > 1
                                     else self.group)


def make_mesh(device="cuda", group=None, shape=None):
    """This rank's :class:`RingMesh` over the ranks of ``group`` (the
    default group; a mesh of one without a process group), in ``shape``
    ``(ny, nx)`` (default: a lat ring of all of them).  ``device``: the
    rank's device; a bare ``'cuda'`` picks the card of the rank's local
    index modulo the cards, so ranks that outnumber the cards share them.

    A 2D mesh (``nx > 1``) creates its row and column subgroups with
    ``dist.new_group``: every rank of the default group must call
    ``make_mesh`` with the same arguments, in the same order as its other
    group creations, members of ``group`` or not (gloo hangs otherwise); a
    rank outside ``group`` gets None."""
    multi = dist.is_available() and dist.is_initialized()
    device = resolve_device(device)
    if not multi:
        if shape is not None and tuple(shape) != (1, 1):
            raise ValueError(f"a mesh of shape {tuple(shape)} needs "
                             "torch.distributed ranks; none are initialised")
        return RingMesh(ny=1, index=0, device=device)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    ny, nx = (len(ranks), 1) if shape is None else map(int, shape)
    if ny * nx != len(ranks):
        raise ValueError(f"mesh shape ({ny}, {nx}) needs {ny * nx} ranks, "
                         f"the group has {len(ranks)}")
    rows = cols = None
    if nx > 1:
        rows = [dist.new_group([ranks[y * nx + x] for x in range(nx)])
                for y in range(ny)]
        if ny > 1:
            cols = [dist.new_group([ranks[y * nx + x] for y in range(ny)])
                    for x in range(nx)]
    me = dist.get_rank(group) if group is not None else dist.get_rank()
    if me < 0:
        return None
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", me))
        device = torch.device("cuda", local % torch.cuda.device_count())
    y, x = divmod(me, nx)
    return RingMesh(ny=ny, index=y, device=device, group=group, nx=nx,
                    x_index=x, row_group=rows[y] if rows else None,
                    col_group=cols[x] if cols else None)


def band_rows(height, ny, index):
    """Global rows of shard ``index``'s core: ``[s*Hl, (s+1)*Hl)`` (the
    row cut of JAX ``ring_state_specs``)."""
    if height % ny:
        raise ValueError("height must divide the lat mesh axis")
    hl = height // ny
    return np.arange(index * hl, (index + 1) * hl)


def block_rows(height, ny, index, halo):
    """Global rows of shard ``index``'s block: its core with ``halo`` rows
    above and below, wrapped around the globe (the rows that a halo
    exchange of depth ``halo`` brings in)."""
    core = band_rows(height, ny, index)
    return np.arange(core[0] - halo, core[-1] + 1 + halo) % height


def band_cols(width, nx, x_index):
    """Global columns of shard ``x_index``'s core along the lon axis:
    ``[x*Wl, (x+1)*Wl)`` (JAX ``state_specs``' 'x' cut)."""
    if width % nx:
        raise ValueError("width must divide the lon mesh axis")
    return band_rows(width, nx, x_index)


def block_cols(width, nx, x_index, halo):
    """Global columns of shard ``x_index``'s block: its core with ``halo``
    columns on each side, wrapped around the globe."""
    core = band_cols(width, nx, x_index)
    return np.arange(core[0] - halo, core[-1] + 1 + halo) % width


def _cut(x, mesh):
    """This rank's core block of a full field (``('y','x')`` on the last
    two axes), contiguous on the mesh's device."""
    rows = band_rows(x.shape[-2], mesh.ny, mesh.index)
    cols = band_cols(x.shape[-1], mesh.nx, mesh.x_index)
    return x.to(mesh.device)[..., rows[0]:rows[-1] + 1,
                             cols[0]:cols[-1] + 1].contiguous()


def shard_prognostics(prog, mesh):
    """This rank's block of a full ``PrognosticVars`` on the mesh's device
    (JAX ``shard_prognostics``)."""
    return PrognosticVars(*(_cut(x, mesh) for x in prog))


def shard_state(state, mesh):
    """This rank's block of a full ``ModelState``: the block of every
    field (JAX ``state_specs``), the clock and the step counter, on the
    mesh's device."""
    return ModelState(
        shard_prognostics(state.prog, mesh),
        GroundVars(*(_cut(x, mesh) for x in state.ground)),
        state.utc.to(mesh.device), state.step.to(mesh.device))


def gather_field(x, mesh):
    """The full field on every rank from the ranks' blocks: ``all_gather``
    along x over the mesh row, then along y over the mesh column, on the
    rank's device."""
    from gcmiipy_tpu_torch.parallel import distributed
    if mesh.nx > 1:
        x = distributed.all_gather_rows(x, mesh.row_group, dim=-1)
    if mesh.ny > 1:
        x = distributed.all_gather_rows(x, mesh.ring(-2)[2], dim=-2)
    return x


def gather_state(state, mesh):
    """The full ``ModelState`` on every rank from the ranks' blocks."""
    if mesh.ny * mesh.nx == 1:
        return state

    def full(x):
        return gather_field(x, mesh)

    return ModelState(PrognosticVars(*map(full, state.prog)),
                      GroundVars(*map(full, state.ground)),
                      state.utc, state.step)
