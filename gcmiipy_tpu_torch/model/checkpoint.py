"""Checkpoint and resume of the model state, as ``.npz`` files.

Port of ``gcmiipy_tpu/model/checkpoint.py:19-106`` in its npz form: a
checkpoint is ``<dir>/step_{step:010d}.npz`` holding ``p u v t q gt gw snow
ice utc step``, the JAX package's keys, so that a checkpoint written by
either package restores in the other.  The JAX package's orbax form is not
ported (the card's machine has no orbax).

Under a mesh the ranks' bands are gathered into the full state, rank 0
writes, and all ranks meet at a barrier before returning, so that a
restore on any rank sees the finished file.
"""

import os

import numpy as np
import torch

from gcmiipy_tpu_torch.device import resolve_device
from gcmiipy_tpu_torch.model.state import (
    GroundVars, ModelState, PrognosticVars)
from gcmiipy_tpu_torch.parallel import distributed


def checkpoint_path(path, step):
    return os.path.join(path, f"step_{step:010d}.npz")


def save_checkpoint(path, state, step, mesh=None):
    """Write ``state`` at ``step`` under the directory ``path``.  With
    ``mesh``, ``state`` is the rank's band; every rank must call."""
    path = os.path.abspath(path)
    host = distributed.fully_replicated_host_copy(state, mesh)
    if distributed.rank() == 0:
        os.makedirs(path, exist_ok=True)
        flat = {**host.prog._asdict(), **host.ground._asdict(),
                "utc": host.utc, "step": host.step}
        np.savez(checkpoint_path(path, step),
                 **{k: v.numpy() for k, v in flat.items()})
    distributed.barrier(mesh.group if mesh is not None else None)


def latest_step(path):
    """The newest checkpointed step under ``path``, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(name[5:].removesuffix(".npz")) for name in os.listdir(path)
             if name.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(path, step=None, device="cuda"):
    """``(ModelState, step)`` from the checkpoint of ``step`` (the newest
    when None), on ``device``.  The step counter is the file name's."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    npz = checkpoint_path(path, step)
    if not os.path.exists(npz):
        raise FileNotFoundError(
            f"{npz} does not exist (the port reads the npz form only; the "
            "JAX package's orbax checkpoints are not ported)")
    device = resolve_device(device)
    with np.load(npz) as data:
        def t(k):
            return torch.as_tensor(np.array(data[k])).to(device)

        state = ModelState(
            PrognosticVars(*map(t, PrognosticVars._fields)),
            GroundVars(*map(t, GroundVars._fields)), t("utc"),
            torch.tensor(step, dtype=torch.int32, device=device))
    return state, step
