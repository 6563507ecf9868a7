"""The ensemble axis: independent members spread over ranks.

Port of ``gcmiipy_tpu/parallel/ensemble.py:1-75``.  The JAX package gives
every state leaf a leading member axis sharded over an ``'e'`` mesh axis
and runs ``jax.vmap`` of the single-model scan.  Here a pure ``'e'`` mesh
is the ranks of a process group: rank r runs its own members (a
contiguous share of them, as JAX's ``P('e')`` cut gives device r) through
:func:`gcmiipy_tpu_torch.model.driver.make_run_fn`, one after another, and
the members' states and stats are gathered so that every rank receives
them all.  Members never talk to each other: the one collective is the
gather at the end.  Without a process group one device runs all the
members in a loop.

An ensemble over a mesh that also has 'y'/'x' axes (JAX
``ensemble_shardings`` with spatial axes) is not ported: it raises
``NotImplementedError``.
"""

import dataclasses

import torch

from gcmiipy_tpu_torch.model import driver as driver_mod
from gcmiipy_tpu_torch.model.state import (
    GroundVars, ModelState, PrognosticVars)
from gcmiipy_tpu_torch.parallel import distributed, mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class EnsembleMesh:
    """A pure ``'e'`` mesh as one rank sees it: ``n`` ranks, this rank's
    ``index``, the process ``group`` (None: the default group, or no group
    for an ensemble on one device) and the rank's ``device``."""
    n: int
    index: int
    device: torch.device
    group: object = None

    @property
    def shape(self):
        return {"e": self.n}


def make_ensemble_mesh(device="cuda", group=None):
    """This rank's :class:`EnsembleMesh` over the ranks of ``group`` (JAX
    ``make_ensemble_mesh``; the devices are the ranks')."""
    ring = mesh_mod.make_mesh(device=device, group=group)
    return EnsembleMesh(n=ring.ny, index=ring.index, device=ring.device,
                        group=ring.group)


def stack_states(states):
    """Stack per-member ``ModelState`` s into one ensemble state, every leaf
    with a leading member axis (JAX ``stack_states``)."""
    def stack(*xs):
        return torch.stack(xs)

    return ModelState(PrognosticVars(*map(stack, *(s.prog for s in states))),
                      GroundVars(*map(stack, *(s.ground for s in states))),
                      stack(*(s.utc for s in states)),
                      stack(*(s.step for s in states)))


def _member(states, k):
    return ModelState(PrognosticVars(*(x[k] for x in states.prog)),
                      GroundVars(*(x[k] for x in states.ground)),
                      states.utc[k], states.step[k])


def make_ensemble_run_fn(geom, config, timesteps, mesh):
    """``run(stacked_states) -> (states, stats)`` (JAX
    ``make_ensemble_run_fn``): every member of the stacked state (each leaf
    with a leading member axis, :func:`stack_states`) advanced
    ``timesteps`` steps as :func:`driver.make_run_fn` runs it, rank r of
    ``mesh`` running members ``[r*m, (r+1)*m)``, ``m = members / n``.
    Returns the stacked states and the stats per member per step (a
    ``StepStats`` of (members, timesteps) tensors; None with
    ``config.stats`` off), gathered on every rank.  As in JAX the run has
    no guard."""
    if not isinstance(mesh, EnsembleMesh):
        raise NotImplementedError(
            "an ensemble over a mesh with 'y'/'x' axes (JAX "
            "ensemble.ensemble_shardings with spatial axes) is not ported; "
            "use make_ensemble_mesh for a pure 'e' mesh")
    config = dataclasses.replace(config, guard=False)
    run_one = driver_mod.make_run_fn(geom.to(device=mesh.device), config,
                                     timesteps)

    def gather(x):
        return distributed.all_gather_rows(x.contiguous(), mesh.group, dim=0)

    def run(states):
        members = states.step.shape[0]
        if members % mesh.n:
            raise ValueError(f"{members} members do not divide over "
                             f"{mesh.n} ranks")
        m = members // mesh.n
        outs, stats = [], []
        for k in range(mesh.index * m, (mesh.index + 1) * m):
            member = _member(states, k)
            state, st = run_one(ModelState(
                *(type(f)(*(x.to(mesh.device) for x in f))
                  if isinstance(f, tuple) else f.to(mesh.device)
                  for f in member)))
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
