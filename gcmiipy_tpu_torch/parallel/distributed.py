"""Multi-process execution over ``torch.distributed``.

Port of ``gcmiipy_tpu/parallel/distributed.py:24-104``.  The JAX package
initialises ``jax.distributed`` and lets a mesh over ``jax.devices()`` span
the hosts; here each process is one rank of a process group and holds one
latitude band (:mod:`gcmiipy_tpu_torch.parallel.mesh`).

* :func:`initialize` joins the group: a ``tcp://`` coordinator, or the
  environment that ``torchrun`` sets; a no-op for a single-process run.
  The backend is NCCL when every rank of a node has a card of its own,
  gloo when ranks share a card or run on the CPU (NCCL refuses two ranks
  on one card).  The choice is logged.
* :func:`is_multiprocess`, :func:`barrier`.
* :func:`all_reduce`, :func:`all_gather_rows` and :func:`send_recv`: the
  collectives the meshes use, on the rank's tensors, in the default group
  or a subgroup (a 2D mesh's row or column).  Under gloo a CUDA tensor
  goes through a pinned host buffer for the operations that gloo's CUDA
  support does not take (:data:`GLOO_CUDA_OPS`).
* :func:`fully_replicated_host_copy` gathers a band state into the full
  state on the host of every process (the checkpoint's gather).
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

LOG = logging.getLogger("gcmiipy_tpu_torch")
# The operations that gloo takes on CUDA tensors directly; the others are
# staged through pinned host memory.  Measured on the card's machine
# (torch 2.11, cu128) with ``python -m gcmiipy_tpu_torch.parallel.gloo_probe``:
# all_reduce (in the default group and in a subgroup), all_gather and
# broadcast gave the right values; point-to-point (batch_isend_irecv) on
# CUDA tensors lost the connection to its peer.
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_reduce_subgroup", "all_gather",
                           "broadcast"})
TIMEOUT_S = 600  # how long a collective may wait for its peers


def choose_backend(device, local_ranks):
    """``'nccl'`` when ``device`` is CUDA and the node has a card for each
    of its ``local_ranks`` ranks, else ``'gloo'``."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available() \
            and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device="cuda"):
    """Join the process group (idempotent).  Returns True for a
    multi-process run, False for a single process.

    ``coordinator_address`` ``host:port`` (rank 0 listens there),
    ``num_processes`` and ``process_id`` fall back to what ``torchrun``
    sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with
    neither, the run is single-process and nothing happens.  ``device``:
    where the ranks run, which chooses the backend (:func:`choose_backend`,
    with ``LOCAL_WORLD_SIZE`` ranks on this node, else all of them)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs num_processes and "
                         "process_id (or WORLD_SIZE and RANK)")
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = choose_backend(device, local)
    LOG.warning("rank %d of %d: backend %s (%d rank(s) on this node, %d "
                "card(s))", process_id, num_processes, backend, local,
                torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return num_processes > 1


def is_multiprocess():
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def rank():
    """This process's rank, 0 for a single process."""
    return dist.get_rank() if is_multiprocess() else 0


def barrier(group=None):
    """Cross-process sync point (no-op single-process)."""
    if is_multiprocess():
        dist.barrier(group=group)


def _alone(group):
    """True without a process group, or in a group of one rank."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_world_size(group) == 1


def _staged(x, group, op):
    """True when ``x`` must go through host memory for ``op`` on
    ``group``: a CUDA tensor under gloo, for an op gloo does not take on
    the card (``all_reduce`` in a subgroup is ``all_reduce_subgroup``)."""
    if op == "all_reduce" and group is not None:
        op = "all_reduce_subgroup"
    return (x.is_cuda and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def _host(x):
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
    return buf.copy_(x)


def all_reduce(x, op, group=None):
    """``x`` reduced in place over ``group`` with ``op`` (a
    ``dist.ReduceOp``); returns it."""
    if _alone(group):
        return x
    if not _staged(x, group, "all_reduce"):
        dist.all_reduce(x, op=op, group=group)
        return x
    h = _host(x)
    dist.all_reduce(h, op=op, group=group)
    return x.copy_(h)


def all_gather_rows(x, group=None, dim=-2):
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order."""
    if _alone(group):
        return x
    staged = _staged(x, group, "all_gather")
    src = _host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def stage(x, group=None):
    """``x`` as :func:`send_recv` will send it over ``group``: a pinned
    host copy made now where the point-to-point goes through host memory,
    else ``x`` itself."""
    return _host(x) if _staged(x, group, "p2p") else x


def send_recv(sends, recvs, group=None, device=None):
    """Point-to-point in one batch: ``sends`` [(tensor, peer, tag)] and
    ``recvs`` [(shape, peer, tag)] with peers as group ranks; returns the
    received tensors on ``device`` (default: ``sends[0]``'s) in
    ``sends[0]``'s dtype.  Sends may already be staged on the host
    (:func:`stage`)."""
    like = sends[0][0]
    device = like.device if device is None else torch.device(device)
    staged = (device.type == "cuda" and "p2p" not in GLOO_CUDA_OPS
              and dist.get_backend(group) == "gloo")

    def peer(r):
        return dist.get_global_rank(group, r) if group is not None else r

    ops, out = [], []
    for x, r, tag in sends:
        ops.append(dist.P2POp(dist.isend, _host(x) if staged and x.is_cuda
                              else x.contiguous(), peer(r), group, tag))
    for shape, r, tag in recvs:
        buf = torch.empty(shape, dtype=like.dtype,
                          device="cpu" if staged else device,
                          pin_memory=staged)
        out.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer(r), group, tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(device) for b in out] if staged else out


def fully_replicated_host_copy(state, mesh=None):
    """The full state on the host (CPU tensors) of every process: each
    row-sharded field gathered over the ring (:func:`mesh.gather_state`),
    or a plain copy without a mesh (JAX: ``process_allgather``, then
    ``device_get``)."""
    from gcmiipy_tpu_torch.parallel.mesh import gather_state
    if mesh is not None:
        state = gather_state(state, mesh)
    return type(state)(*(
        type(x)(*(t.detach().cpu() for t in x)) if isinstance(x, tuple)
        else x.detach().cpu() for x in state))
