"""The ensemble axis: independent members spread over ranks.

Port of ``gcmiipy_tpu/parallel/ensemble.py``.  The JAX package gives every
state leaf a leading member axis sharded over an ``'e'`` mesh axis and runs
``jax.vmap`` of the single-model scan; on a mesh that also has 'y'/'x'
axes each member's state is cut over them as well (``ensemble_shardings``).
Here the ranks of a process group form the mesh:

* a pure ``'e'`` mesh (:func:`make_ensemble_mesh` without ``shape``): rank
  r runs its own members (a contiguous share of them, as JAX's ``P('e')``
  cut gives device r) through
  :func:`gcmiipy_tpu_torch.model.driver.make_run_fn`, one after another;
* an ``('e', 'y', 'x')`` mesh (``shape=(ne, ny, nx)``): the ranks split into
  ``ne`` member groups of ``ny * nx`` consecutive ranks (JAX's device order
  for ``reshape(ne, ny, nx)``), each a spatial mesh
  (:func:`gcmiipy_tpu_torch.parallel.mesh.make_mesh`) that runs its members
  one after another through ``make_run_fn(mesh=)``: the same shard steps as
  ``run_model(mesh=)``.

The members never talk to each other: the states are gathered at the end,
the blocks over the spatial mesh and then the members over the 'e' axis,
so that every rank receives them all.  Without a process group one device
runs all the members in a loop.
"""

import dataclasses

import torch
import torch.distributed as dist

from gcmiipy_tpu_torch.model import driver as driver_mod
from gcmiipy_tpu_torch.model.state import (
    GroundVars, ModelState, PrognosticVars)
from gcmiipy_tpu_torch.parallel import distributed, mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class EnsembleMesh:
    """An ensemble mesh as one rank sees it: ``n`` member groups along
    'e', this rank's group ``index``, the rank's ``device``, the process
    ``group`` of its 'e' axis (the ranks that hold the same block of every
    member group; None: the default group, or no group on one device) and
    the ``spatial`` mesh of its member group (None on a pure 'e' mesh)."""
    n: int
    index: int
    device: torch.device
    group: object = None
    spatial: object = None

    @property
    def shape(self):
        if self.spatial is None:
            return {"e": self.n}
        return {"e": self.n, "y": self.spatial.ny, "x": self.spatial.nx}


def make_ensemble_mesh(device="cuda", group=None, shape=None):
    """This rank's :class:`EnsembleMesh` over the ranks of ``group`` (the
    default group; one device without a process group): a pure 'e' mesh
    of all of them (JAX ``make_ensemble_mesh``), or with ``shape = (ne, ny,
    nx)`` an ('e', 'y', 'x') mesh of ``ne`` member groups, each an
    ``(ny, nx)`` spatial mesh.

    The spatial form creates process groups (the member groups, the 'e'
    axes and each member group's row and column subgroups): every rank of
    the default group must call it with the same arguments, in the same
    order as its other group creations (gloo hangs otherwise); a rank
    outside ``group`` gets None."""
    # the ranks as a lat ring (no groups made): the rank's place and device
    ring = mesh_mod.make_mesh(device=device, group=group)
    if shape is None:
        return EnsembleMesh(n=ring.ny, index=ring.index, device=ring.device,
                            group=ring.group)
    ne, ny, nx = map(int, shape)
    if not (dist.is_available() and dist.is_initialized()):
        if (ne, ny, nx) != (1, 1, 1):
            raise ValueError(f"an ensemble mesh of shape {(ne, ny, nx)} "
                             "needs torch.distributed ranks; none are "
                             "initialised")
        return EnsembleMesh(n=1, index=0, device=ring.device)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(dist.get_world_size())))
    size = ny * nx
    if ne * size != len(ranks):
        raise ValueError(f"ensemble mesh shape {(ne, ny, nx)} needs "
                         f"{ne * size} ranks, the group has {len(ranks)}")
    if ring is not None:
        device = ring.device
    members = [dist.new_group(ranks[e * size:(e + 1) * size])
               for e in range(ne)]
    axes = [dist.new_group([ranks[e * size + s] for e in range(ne)])
            for s in range(size)]
    spatial = None
    for member_group in members:  # every rank enters every group's mesh
        m = mesh_mod.make_mesh(device=device, group=member_group,
                               shape=(ny, nx))
        spatial = m if m is not None else spatial
    if ring is None:
        return None
    e, s = divmod(ring.index, size)
    return EnsembleMesh(n=ne, index=e, device=device, group=axes[s],
                        spatial=spatial)


def stack_states(states):
    """Stack per-member ``ModelState`` s into one ensemble state, every leaf
    with a leading member axis (JAX ``stack_states``)."""
    def stack(*xs):
        return torch.stack(xs)

    return ModelState(PrognosticVars(*map(stack, *(s.prog for s in states))),
                      GroundVars(*map(stack, *(s.ground for s in states))),
                      stack(*(s.utc for s in states)),
                      stack(*(s.step for s in states)))


def _member(states, k, device):
    return ModelState(PrognosticVars(*(x[k].to(device) for x in states.prog)),
                      GroundVars(*(x[k].to(device) for x in states.ground)),
                      states.utc[k].to(device), states.step[k].to(device))


def make_ensemble_run_fn(geom, config, timesteps, mesh):
    """``run(stacked_states) -> (states, stats)`` (JAX
    ``make_ensemble_run_fn``): every member of the stacked state (each leaf
    with a leading member axis, :func:`stack_states`) advanced
    ``timesteps`` steps as :func:`driver.make_run_fn` runs it, member group
    r of ``mesh`` running members ``[r*m, (r+1)*m)``, ``m = members / n``,
    on its spatial mesh where it has one.  Returns the stacked states and
    the stats per member per step (a ``StepStats`` of (members, timesteps)
    tensors; None with ``config.stats`` off), gathered on every rank.  As
    in JAX the run has no guard."""
    config = dataclasses.replace(config, guard=False)
    spatial = mesh.spatial
    run_one = driver_mod.make_run_fn(geom.to(device=mesh.device), config,
                                     timesteps, mesh=spatial)

    def gather(x):
        return distributed.all_gather_rows(x.contiguous(), mesh.group, dim=0)

    def run(states):
        members = states.step.shape[0]
        if members % mesh.n:
            raise ValueError(f"{members} members do not divide over "
                             f"{mesh.n} member groups")
        m = members // mesh.n
        outs, stats = [], []
        for k in range(mesh.index * m, (mesh.index + 1) * m):
            member = _member(states, k, mesh.device)
            if spatial is None:
                state, st = run_one(member)
            else:
                state, st = run_one(mesh_mod.shard_state(member, spatial))
                state = mesh_mod.gather_state(state, spatial)
            outs.append(state)
            stats.append(st)
        out = stack_states(outs)
        out = ModelState(PrognosticVars(*map(gather, out.prog)),
                         GroundVars(*map(gather, out.ground)),
                         gather(out.utc), gather(out.step))
        if not config.stats:
            return out, None
        per_member = driver_mod.StepStats(*(
            gather(torch.stack(col)) for col in zip(*stats)))
        return out, per_member

    return run
