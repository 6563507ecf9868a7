"""Ranks of a gloo mesh on the CPU, for the port's tests.

A :class:`RankPool` spawns ``world`` processes once (one pool per test
module), each a rank of one gloo process group on ``127.0.0.1``, with a
second group of ranks 0 and 1 for two-rank meshes.  ``pool.run(task, n,
shape=None, **kwargs)`` runs one of :data:`TASKS` on the first ``n``
ranks, each on its own block of a mesh of ``n`` (``mesh.make_mesh`` on the
CPU): a lat ring, or the 2D (ny, nx) ``shape``, and returns their results
in rank order.  Every rank builds the 2D meshes of :data:`SHAPES` at
start, in one order, since their row and column groups need every rank.  Every call has a deadline: on expiry
the ranks are killed and the call raises, so a hung collective cannot eat
the test run's clock.

This module imports the port and nothing of JAX: the ranks never load it.
Inputs and results are numpy arrays and plain values.
"""

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback

import numpy as np

DEADLINE_S = 300
INIT_TIMEOUT_S = 120
FIELDS = "puvtq"
# the 2D meshes a pool of 4 builds: (ranks, (ny, nx))
SHAPES = ((4, (2, 2)), (4, (1, 4)), (2, (1, 2)))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- the tasks

def _geom(geom_d):
    from gcmiipy_tpu_torch.convert import geom_from_jax_numpy
    return geom_from_jax_numpy(geom_d, device="cpu")


def _band(fields, mesh):
    """This rank's block of each full numpy field, as a tensor."""
    import torch

    from gcmiipy_tpu_torch.parallel.mesh import band_cols, band_rows
    rows = band_rows(fields[0].shape[-2], mesh.ny, mesh.index)
    cols = band_cols(fields[0].shape[-1], mesh.nx, mesh.x_index)
    return tuple(torch.as_tensor(np.ascontiguousarray(
        x[..., rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1])) for x in fields)


def _gathered(band, mesh):
    from gcmiipy_tpu_torch.parallel.mesh import gather_field
    return tuple(gather_field(x, mesh).numpy() for x in band)


def task_halo(mesh, x, halo):
    """The rank's band of ``x`` padded by the exchange."""
    from gcmiipy_tpu_torch.parallel import halo as halo_mod
    (band,) = _band((x,), mesh)
    return halo_mod.exchange_axis(band, halo, mesh).numpy()


def task_halo2d(mesh, x, halo):
    """The rank's block of ``x`` padded by the 2D exchange, and trimmed
    back."""
    from gcmiipy_tpu_torch.parallel import halo as halo_mod
    (block,) = _band((x,), mesh)
    padded = halo_mod.exchange_2d(block, halo, mesh)
    back = halo_mod.trim(padded, halo, (-2, -1))
    return padded.numpy(), bool((back == block).all())


def task_psum_filter(mesh, q, geom_d):
    """The spectral-psum filter of the rank's block of ``q``; the gathered
    field."""
    from gcmiipy_tpu_torch.parallel import shard_step
    (block,) = _band((q,), mesh)
    filt = shard_step.spectral_psum_filter(mesh, _geom(geom_d))
    return _gathered((filt(block),), mesh)[0]


def task_step(mesh, form, fields, geom_d, dt, steps, **kw):
    """``steps`` steps of ``shard_step.<form>(mesh, geom, dt, **kw)``;
    the gathered fields and the warnings."""
    import warnings

    from gcmiipy_tpu_torch.parallel import shard_step
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step = getattr(shard_step, form)(mesh, _geom(geom_d), dt, **kw)
    band = _band(fields, mesh)
    for _ in range(steps):
        band = step(*band)
    return _gathered(band, mesh), [str(w.message) for w in caught]


def task_fused4(mesh, fields, geom_d, dt, steps):
    """``steps`` steps of the fused4 ring; the gathered fields."""
    from gcmiipy_tpu_torch.parallel import shard_step
    step = shard_step.make_shard_step_fused4(mesh, _geom(geom_d), dt)
    band = _band(fields, mesh)
    for _ in range(steps):
        band = step(*band)
    return _gathered(band, mesh)


def task_stream_ring(mesh, fields, geom_d, dt, K, calls):
    """``calls`` calls of the stream ring of K steps; the gathered
    fields."""
    from gcmiipy_tpu_torch.parallel import shard_step
    adv = shard_step.make_shard_stream_ring(mesh, _geom(geom_d), dt,
                                            steps_per_launch=K)
    band = _band(fields, mesh)
    for _ in range(calls):
        band = adv(*band)
    return _gathered(band, mesh)


def _state_out(out):
    p, u, v, t, q, ground, geom, stats = out
    res = {k: x.numpy() for k, x in zip(FIELDS, (p, u, v, t, q))}
    res.update({k: x.numpy() for k, x in ground._asdict().items()})
    if stats is not None:
        res["stats"] = {k: x.numpy() for k, x in stats._asdict().items()}
    return res


def task_run_model(mesh, height, width, layers, dt, steps, config):
    """``run_model(..., mesh=)`` with ``ModelConfig(**config)``: the full
    fields, ground and stats this rank received, and the warnings."""
    import warnings

    from gcmiipy_tpu_torch.model import driver
    from gcmiipy_tpu_torch.model.config import ModelConfig
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = driver.run_model(height, width, layers, dt, steps,
                               config=ModelConfig(**config), mesh=mesh)
    res = _state_out(out)
    res["warnings"] = [str(w.message) for w in caught]
    return res


def task_resume(mesh, height, width, layers, dt, steps, config, path):
    """The ring resumed from the checkpoint under ``path``: restored, cut
    into bands and run with ``make_run_fn(start_step=)``; the gathered
    state."""
    from gcmiipy_tpu_torch.model import checkpoint, driver
    from gcmiipy_tpu_torch.model.config import ModelConfig
    from gcmiipy_tpu_torch.parallel import mesh as mesh_mod
    cfg = driver.normalize_config(ModelConfig(
        height=height, width=width, layers=layers, dt=dt, **config))
    geom = driver.gen_model_geometry(cfg, "cpu")
    state, step = checkpoint.restore_checkpoint(path, device="cpu")
    run = driver.make_run_fn(geom, cfg, steps, mesh=mesh, start_step=step)
    out = run(mesh_mod.shard_state(state, mesh))
    full = mesh_mod.gather_state(out[0], mesh)
    res = {k: x.numpy() for k, x in zip(FIELDS, full.prog)}
    res["gt"] = full.ground.gt.numpy()
    res["step"] = int(full.step)
    return res


def task_run_from(mesh, state_d, height, width, layers, dt, steps, config):
    """``make_run_fn(..., mesh=)`` from the full state ``state_d`` (numpy,
    the JAX ``ModelState``'s fields) on the geometry ``run_model`` builds
    for ``ModelConfig(**config)``; the gathered state."""
    from gcmiipy_tpu_torch.convert import state_from_jax_numpy
    from gcmiipy_tpu_torch.model import driver
    from gcmiipy_tpu_torch.model.config import ModelConfig
    from gcmiipy_tpu_torch.parallel import mesh as mesh_mod
    cfg = driver.normalize_config(ModelConfig(
        height=height, width=width, layers=layers, dt=dt, **config))
    geom = driver.gen_model_geometry(cfg, "cpu")
    band = mesh_mod.shard_state(state_from_jax_numpy(state_d, "cpu"), mesh)
    out = driver.make_run_fn(geom, cfg, steps, mesh=mesh)(band)
    full = mesh_mod.gather_state(out[0], mesh)
    res = {k: x.numpy() for k, x in zip(FIELDS, full.prog)}
    res.update({k: x.numpy() for k, x in full.ground._asdict().items()})
    res["stats"] = {k: x.numpy() for k, x in out[1]._asdict().items()}
    return res


def task_sharded_run(mesh, state_d, height, width, layers, dt, steps,
                     config):
    """``gspmd.make_sharded_run_fn`` from the full state ``state_d``; the
    gathered fields."""
    from gcmiipy_tpu_torch.convert import state_from_jax_numpy
    from gcmiipy_tpu_torch.model import driver
    from gcmiipy_tpu_torch.model.config import ModelConfig
    from gcmiipy_tpu_torch.parallel import gspmd, mesh as mesh_mod
    cfg = driver.normalize_config(ModelConfig(
        height=height, width=width, layers=layers, dt=dt, **config))
    geom = driver.gen_model_geometry(cfg, "cpu")
    run = gspmd.make_sharded_run_fn(geom, cfg, steps, mesh)
    out = run(gspmd.shard_state(state_from_jax_numpy(state_d, "cpu"), mesh))
    full = mesh_mod.gather_state(out[0], mesh)
    return {k: x.numpy() for k, x in zip(FIELDS, full.prog)}


def task_ensemble(mesh, states_d, height, width, layers, dt, steps, config,
                  eshape=None):
    """``ensemble.make_ensemble_run_fn`` on an 'e' mesh of this task's
    ranks (an ('e', 'y', 'x') mesh of shape ``eshape``, which every rank of
    the pool must build), from the members ``states_d``; the gathered
    members' fields and total energies."""
    from gcmiipy_tpu_torch.convert import state_from_jax_numpy
    from gcmiipy_tpu_torch.model import driver
    from gcmiipy_tpu_torch.model.config import ModelConfig
    from gcmiipy_tpu_torch.parallel import ensemble
    cfg = driver.normalize_config(ModelConfig(
        height=height, width=width, layers=layers, dt=dt, **config))
    geom = driver.gen_model_geometry(cfg, "cpu")
    emesh = ensemble.make_ensemble_mesh(device="cpu", group=mesh.group,
                                        shape=eshape)
    run = ensemble.make_ensemble_run_fn(geom, cfg, steps, emesh)
    out, stats = run(ensemble.stack_states(
        [state_from_jax_numpy(d, "cpu") for d in states_d]))
    res = {k: x.numpy() for k, x in zip(FIELDS, out.prog)}
    res["total_energy"] = stats.total_energy.numpy()
    return res


def task_cli(mesh, argv):
    """``python -m gcmiipy_tpu_torch`` in-process on this rank: its exit
    code."""
    from gcmiipy_tpu_torch.__main__ import main
    return main(list(argv))


TASKS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("task_")}


# ----------------------------------------------------------------- the pool

def _serve(rank, world, port, tasks, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    groups = {world: None}
    if world > 2:
        groups[2] = dist.new_group([0, 1])
    from gcmiipy_tpu_torch.parallel.mesh import make_mesh
    # every rank builds every 2D mesh, members or not, in one order
    meshes = {(n, shape): make_mesh(device="cpu", group=groups[n],
                                    shape=shape)
              for n, shape in SHAPES if n in groups}
    while True:
        item = tasks.get()
        if item is None:
            break
        name, n, shape, kwargs = item
        try:
            out = None
            if rank < n:
                mesh = (make_mesh(device="cpu", group=groups[n])
                        if shape is None or shape[1] == 1
                        else meshes[n, tuple(shape)])
                out = TASKS[name](mesh, **kwargs)
            results.put((rank, None, out))
        except Exception:  # noqa: BLE001 - sent to the test, which fails
            results.put((rank, traceback.format_exc(), None))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks on the CPU, started once; see the module's
    docstring."""

    def __init__(self, world=4):
        ctx = mp.get_context("spawn")
        self.world = world
        port = free_port()
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve,
                                  args=(r, world, port, self.tasks[r],
                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.broken = None

    def run(self, task, n=None, shape=None, deadline_s=DEADLINE_S,
            **kwargs):
        """``task`` on the first ``n`` ranks (all by default), on a lat
        ring or the 2D mesh ``shape`` (one of :data:`SHAPES`); their
        results in rank order.  Raises on a rank's error, and kills the
        pool on a missed deadline."""
        if self.broken:
            raise RuntimeError(f"the rank pool is down: {self.broken}")
        n = self.world if n is None else n
        for q in self.tasks:
            q.put((task, n, shape, kwargs))
        end = time.monotonic() + deadline_s
        got = {}
        while len(got) < self.world:
            try:
                rank, err, out = self.results.get(
                    timeout=max(0.1, end - time.monotonic()))
            except queue.Empty:
                self.broken = f"{task} missed its {deadline_s} s deadline"
                self.close(kill=True)
                raise TimeoutError(self.broken) from None
            got[rank] = (err, out)
            if err is not None:
                self.broken = f"rank {rank} failed in {task}"
                self.close(kill=True)
                raise RuntimeError(f"rank {rank} failed in {task}:\n{err}")
        return [got[r][1] for r in range(n)]

    def close(self, kill=False, deadline_s=30):
        for p, q in zip(self.procs, self.tasks):
            if kill:
                p.kill()
            elif p.is_alive():
                q.put(None)
        end = time.monotonic() + deadline_s
        for p in self.procs:
            p.join(max(0.1, end - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
