"""The latitude-ring mesh: one 'y' axis over the ranks of a process group.

Port of ``gcmiipy_tpu/parallel/mesh.py``.  The JAX package shards global
arrays over a device mesh (``ring_state_specs``, ``geom_specs``
:73-109: fields cut by latitude rows, full longitude rows on each device);
here each rank is one process that holds its own band of rows and knows
its ring neighbours.  Shard s holds rows ``[s*Hl, (s+1)*Hl)``,
``Hl = H // ny``.

The mesh is the process group, its size, the rank's place on the ring
and the rank's device.  ``torch.distributed.device_mesh.DeviceMesh`` is
not used: it binds one card to each rank by its local rank, and the ring
also runs with its ranks sharing one card (under gloo) or on the CPU.
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
    """A lat-ring mesh as one rank sees it: ``ny`` shards, this rank's
    shard ``index`` on the ring, the process ``group`` (None: the default
    group, or no group for a ring of one) and the rank's ``device``.
    ``shape`` is ``{'y': ny}``, as JAX's ``mesh.shape``; a 2D mesh (``nx``
    > 1), which the port does not run yet, has an 'x' axis too."""
    ny: int
    index: int
    device: torch.device
    group: object = None
    nx: int = 1

    @property
    def shape(self):
        return {"y": self.ny, "x": self.nx} if self.nx > 1 else {"y": self.ny}


def make_mesh(device="cuda", group=None):
    """This rank's :class:`RingMesh` over the ranks of ``group`` (the
    default group; a ring of one without a process group).  ``device``:
    the rank's device; a bare ``'cuda'`` picks the card of the rank's local
    index modulo the cards, so ranks that outnumber the cards share
    them."""
    multi = dist.is_available() and dist.is_initialized()
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank(group) if multi else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if not multi:
        return RingMesh(ny=1, index=0, device=device)
    return RingMesh(ny=dist.get_world_size(group),
                    index=dist.get_rank(group), device=device, group=group)


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


def _rows(x, rows):
    return x[..., rows[0]:rows[-1] + 1, :].contiguous()


def shard_prognostics(prog, mesh):
    """This rank's rows of a full ``PrognosticVars`` on the mesh's device
    (JAX ``shard_prognostics``)."""
    rows = band_rows(prog.p.shape[-2], mesh.ny, mesh.index)
    return PrognosticVars(*(_rows(x.to(mesh.device), rows) for x in prog))


def shard_state(state, mesh):
    """This rank's band of a full ``ModelState``: the rows of every field,
    the clock and the step counter, on the mesh's device."""
    rows = band_rows(state.prog.p.shape[-2], mesh.ny, mesh.index)
    return ModelState(
        shard_prognostics(state.prog, mesh),
        GroundVars(*(_rows(x.to(mesh.device), rows) for x in state.ground)),
        state.utc.to(mesh.device), state.step.to(mesh.device))


def gather_state(state, mesh):
    """The full ``ModelState`` on every rank from the ranks' bands
    (``all_gather`` over the ring, on the rank's device)."""
    from gcmiipy_tpu_torch.parallel import distributed
    if mesh.ny == 1:
        return state

    def full(x):
        return distributed.all_gather_rows(x, mesh.group)

    return ModelState(PrognosticVars(*map(full, state.prog)),
                      GroundVars(*map(full, state.ground)),
                      state.utc, state.step)
