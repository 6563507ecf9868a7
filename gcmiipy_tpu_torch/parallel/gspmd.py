"""The JAX package's GSPMD entry points, on the port's mesh of ranks.

Port of ``gcmiipy_tpu/parallel/gspmd.py:22-42``.  There XLA's GSPMD
partitions the plain core over the mesh and inserts the collectives.
PyTorch has no GSPMD: the same operator runs as the explicit-halo plain
core with the spectral-psum filter (JAX's own any-grid form of it,
:func:`gcmiipy_tpu_torch.parallel.shard_step.make_shard_step_2d`), which
is what ``make_run_fn(mesh=)`` runs for backend 'xla'.  These functions
are there so that callers of the JAX API find their counterpart.
"""

import dataclasses

from gcmiipy_tpu_torch.model import driver as driver_mod
from gcmiipy_tpu_torch.parallel import mesh as mesh_mod


def make_sharded_run_fn(geom, config, timesteps, mesh):
    """``run(state) -> (state, stats)`` over ``timesteps`` steps of the
    plain core on ``mesh`` (JAX ``make_sharded_run_fn``): ``state`` is the
    rank's block (:func:`shard_state`), ``geom`` the global geometry.  As
    in JAX, the run has no guard; ``stats`` is None with
    ``config.stats`` off."""
    config = dataclasses.replace(config, backend="xla", guard=False)
    return driver_mod.make_run_fn(geom, config, timesteps, mesh=mesh)


def shard_state(state, mesh):
    """This rank's block of a full ``ModelState`` (JAX ``shard_state``)."""
    return mesh_mod.shard_state(state, mesh)
