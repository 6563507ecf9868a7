"""The port's latitude ring (gcmiipy_tpu_torch.parallel) on the CPU.

Two and four gloo ranks (tests/torch_ring_ranks.py, one pool for the
module, every call with its deadline) step their bands with K6's and K7's
shard forms; the wrappers run their plain versions on CPU tensors.  The
inputs come from a numpy seed and the JAX reference is computed here, in
the test process, at float64: the rings against JAX's single-device core
with the exact DFT filter, ``run_model(mesh=)`` against the port's
single-device run and JAX's ``run_model`` (the bounds of JAX
tests/test_parallel.py: 1e-9).
"""

import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gcmiipy_tpu.dynamics import core25d as jcore25d
from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.ops import polar_filter as jpolar_filter
from gcmiipy_tpu.parallel import mesh as jmesh
from gcmiipy_tpu_torch.model import checkpoint, driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.parallel import halo, mesh as mesh_mod, shard_step
from torch_port_helpers import (
    FIELDS, geom_dict, port_geom, random_state, state_dict)
from torch_ring_ranks import RankPool

torch.set_num_threads(1)
BOUND = 1e-9


@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(4)
    yield ranks
    ranks.close()


def _jgeom(height, width, layers=2):
    return jgeometry.gen_geometry(height, width, layers,
                                  sig_func=jgeometry.manabe_sig)


def _jax_core(jgeom, fields, dt, steps):
    """``steps`` steps of JAX's single-device core with the exact DFT
    filter (JAX tests/test_parallel.py's reference)."""
    mats = jpolar_filter.build_dft_matrices(jgeom.width, dtype=np.float64)

    def filt(q, g):
        return jpolar_filter.arakawa_1977_dft(q, g, mats,
                                              precision="highest")

    step = jax.jit(lambda *s: jcore25d.matsuno_timestep(
        *s, dt, jgeom, filter_fn=filt))
    s = tuple(jnp.asarray(x) for x in fields)
    for _ in range(steps):
        s = step(*s)
    return [np.asarray(x) for x in s]


def _close(got, ref, bound=BOUND, names=FIELDS):
    for name, a, b in zip(names, got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=bound,
                                   atol=bound, err_msg=f"field {name}")


def test_best_mesh_shape_matches_jax():
    for n in range(1, 13):
        assert mesh_mod.best_mesh_shape(n) == jmesh.best_mesh_shape(n)


@pytest.mark.parametrize("ny", [2, 4, 8])
def test_row_cut_is_jax_ring_sharding(ny):
    """Shard s holds rows [s*Hl, (s+1)*Hl): the rows JAX's
    ring_state_specs give device s."""
    H, W = 64, 16
    sharding = NamedSharding(Mesh(np.array(jax.devices()[:ny]), ("y",)),
                             P("y", None))
    for s, dev in enumerate(sharding.mesh.devices):
        rows = sharding.devices_indices_map((H, W))[dev][0]
        np.testing.assert_array_equal(mesh_mod.band_rows(H, ny, s),
                                      np.arange(H)[rows])
    np.testing.assert_array_equal(mesh_mod.block_rows(H, ny, 0, 3),
                                  np.r_[61:64, 0:H // ny + 3])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("depth", [1, 8])
def test_halo_exchange_equals_roll(pool, n, depth):
    x = np.random.default_rng(n + depth).standard_normal((3, 32, 8))
    blocks = pool.run("halo", n=n, x=x, halo=depth)
    for s, block in enumerate(blocks):
        rows = mesh_mod.block_rows(32, n, s, depth)
        np.testing.assert_array_equal(block, x[:, rows])


def test_ring_of_one_wraps_its_own_rows():
    mesh = mesh_mod.make_mesh(device="cpu")
    x = torch.arange(40.0).reshape(5, 8)
    block = halo.exchange_axis(x, 2, mesh)
    np.testing.assert_array_equal(block.numpy(),
                                  x.numpy()[np.arange(-2, 7) % 5])
    np.testing.assert_array_equal(halo.trim(block, 2).numpy(), x.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_fused4_ring_matches_jax_core(pool, n):
    """One PHJ-row exchange and K6's shard form a step == JAX's
    single-device core with the DFT filter; the polar wall holds."""
    jgeom = _jgeom(64, 128)
    fields = random_state(jgeom, seed=31)
    got = pool.run("fused4", n=n, fields=fields, geom_d=geom_dict(jgeom),
                   dt=300.0, steps=3)[0]
    _close(got, _jax_core(jgeom, fields, 300.0, 3))
    np.testing.assert_allclose(got[2][:, -1, :], 0.0, atol=1e-14)


@pytest.mark.parametrize("n", [2, 4])
def test_stream_ring_matches_jax_core(pool, n):
    """One 2*PHJ-row exchange and K7's shard form per 2 steps == JAX's
    single-device core with the DFT filter; the polar wall holds."""
    jgeom = _jgeom(64, 128)
    fields = random_state(jgeom, seed=32)
    got = pool.run("stream_ring", n=n, fields=fields,
                   geom_d=geom_dict(jgeom), dt=300.0, K=2, calls=2)[0]
    _close(got, _jax_core(jgeom, fields, 300.0, 4))
    np.testing.assert_allclose(got[2][:, -1, :], 0.0, atol=1e-14)


def test_halo_depth_and_odd_k_raise():
    geom = port_geom(_jgeom(128, 128))
    mesh = mesh_mod.RingMesh(ny=8, index=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="halo"):
        shard_step.make_shard_stream_ring(mesh, geom, 100.0,
                                          steps_per_launch=4)
    with pytest.raises(ValueError, match="even"):
        shard_step.make_shard_stream_ring(mesh, geom, 100.0,
                                          steps_per_launch=3)
    small = mesh_mod.RingMesh(ny=32, index=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="shard rows"):
        shard_step.make_shard_step_fused4(small, geom, 100.0)


def _both(height, steps, cfg, n, pool, width=128):
    """(ring results of every rank, the port's single-device run, JAX's
    run_model) for the same run."""
    ring = pool.run("run_model", n=n, height=height, width=width, layers=2,
                    dt=300.0, steps=steps, config=cfg)
    one = driver.run_model(height, width, 2, 300.0, steps, device="cpu",
                           config=ModelConfig(**cfg))
    ref = jdriver.run_model(height, width, 2, 300.0, steps,
                            config=JModelConfig(**cfg))
    return ring, one, ref


@pytest.mark.parametrize("backend", ["stream", "mega4"])
def test_run_model_mesh_matches_single_device_and_jax(pool, backend):
    """Guarded, with stats: every rank receives the full fields, equal to
    the port's single-device run and to JAX's run_model (fields and
    total_energy)."""
    cfg = dict(backend=backend, stream_steps=2, dtype="float64", guard=True,
               stats=True)
    ring, one, ref = _both(64, 5, cfg, 4, pool)
    for res in ring:
        got = [res[k] for k in FIELDS]
        _close(got, one[:5])
        _close(got, ref[:5])
        for k in ("ke", "ate", "geo", "total_energy"):
            np.testing.assert_allclose(res["stats"][k],
                                       np.asarray(getattr(ref[7], k)),
                                       rtol=BOUND, err_msg=k)
            np.testing.assert_allclose(res["stats"][k],
                                       getattr(one[7], k).numpy(),
                                       rtol=BOUND, err_msg=k)
        for k in ("u_max", "u_min", "v_max", "v_min"):
            np.testing.assert_array_equal(res["stats"][k],
                                          getattr(one[7], k).numpy())
    assert len(ring[0]["stats"]["ke"]) == len(ref[7].ke)


@pytest.mark.parametrize("backend", ["fused", "mega"])
def test_fused_family_on_a_mesh_runs_the_fused4_ring(pool, backend):
    """'fused' and 'mega' on a mesh run the fused4 ring, K6's shard form, as
    the JAX package's make_dynamics_step(mesh=) does: equal to the 'mega4'
    ring to the bit."""
    cfg = dict(dtype="float64", guard=True)
    got = pool.run("run_model", n=2, height=64, width=128, layers=2,
                   dt=300.0, steps=3, config=dict(cfg, backend=backend))[0]
    ref = pool.run("run_model", n=2, height=64, width=128, layers=2,
                   dt=300.0, steps=3, config=dict(cfg, backend="mega4"))[0]
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_mesh_run_guarded_checkpointed(pool, tmp_path):
    """A guarded, stats-on, checkpointed mega4 ring run (JAX
    test_mesh_run_model_guarded_checkpointed): checkpoints at steps 2 and
    4, the last of which holds the run's fields; equal to the plain
    single-device core."""
    cfg = dict(backend="mega4", dtype="float64", guard=True, stats=True,
               checkpoint_dir=str(tmp_path), checkpoint_every=2)
    ring = pool.run("run_model", n=4, height=64, width=128, layers=2,
                    dt=300.0, steps=4, config=cfg)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002.npz",
                                            "step_0000000004.npz"]
    one = driver.run_model(64, 128, 2, 300.0, 4, device="cpu",
                           config=ModelConfig(backend="xla",
                                              polar_filter="dft",
                                              dtype="float64", guard=True))
    _close([ring[0][k] for k in FIELDS], one[:5])
    restored, step = checkpoint.restore_checkpoint(str(tmp_path),
                                                   device="cpu")
    assert step == 4
    for k, x in zip(FIELDS, restored.prog):
        np.testing.assert_array_equal(x.numpy(), ring[0][k])
    assert len(ring[0]["stats"]["total_energy"]) == 4


def test_stream_ring_physics_matches_single_device(pool):
    """Extras between ring calls (JAX test_stream_ring_run_model_physics):
    the ring equals the single-device stream run and JAX's."""
    cfg = dict(backend="stream", stream_steps=2, physics=True,
               physics_every=2, drag_tau=86400.0, dtype="float64",
               stats=False)
    ring, one, ref = _both(128, 4, cfg, 4, pool)
    got = [ring[0][k] for k in FIELDS]
    _close(got, one[:5])
    _close(got, ref[:5])
    np.testing.assert_allclose(ring[0]["gt"], np.asarray(ref[5].gt),
                               rtol=BOUND)


def test_stream_ring_cadence_survives_halo_clamp(pool):
    """4 shards of 64 rows cap K at 4; physics_every=10 must clamp K to 2
    (the largest even divisor of the cadence), not 4, and match the
    single-device runs (JAX test_stream_ring_cadence_survives_halo_clamp)."""
    cfg = dict(backend="stream", stream_steps=10, physics=True,
               physics_every=10, drag_tau=86400.0, dtype="float64",
               stats=False)
    ring, one, ref = _both(256, 10, cfg, 4, pool)
    got = [ring[0][k] for k in FIELDS]
    _close(got, one[:5])
    _close(got, ref[:5])
    np.testing.assert_allclose(ring[0]["gt"], one[5].gt.numpy(), rtol=BOUND)


def test_stream_ring_short_run_falls_back_to_mega4_ring(pool):
    """A one-step stream ring run takes the 'mega4' ring with JAX's
    warning."""
    cfg = dict(backend="stream", dtype="float64", stats=False)
    ring = pool.run("run_model", n=2, height=64, width=128, layers=2,
                    dt=300.0, steps=1, config=cfg)
    assert any("falls back to the 'mega4' ring" in w
               for w in ring[0]["warnings"])
    one = driver.run_model(64, 128, 2, 300.0, 1, device="cpu",
                           config=ModelConfig(backend="mega4",
                                              dtype="float64"))
    _close([ring[0][k] for k in FIELDS], one[:5])


def test_blown_ring_run_names_the_step(pool):
    """At dt=1800 the 64-row grid breaks its CFL limit and the surface
    pressure passes guard_p_max inside the first 4-step stream ring call;
    the run replays the call on the 'mega4' ring and names the exact step,
    the single-device run's."""
    cfg = dict(backend="stream", stream_steps=4, dtype="float64",
               guard=True)
    ring = pool.run("run_model", n=2, height=64, width=128, layers=2,
                    dt=1800.0, steps=8, config=cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        driver.run_model(64, 128, 2, 1800.0, 8, device="cpu",
                         config=ModelConfig(**cfg))
    blew = [str(w.message) for w in caught if "blew up" in str(w.message)]
    ring_blew = [w for w in ring[0]["warnings"] if "blew up" in w]
    assert blew and ring_blew == blew
    assert "at step 2 (exact" in blew[0]


def test_ring_checkpoint_resumes_off_alignment(pool, tmp_path):
    """A cadenced stream ring run checkpointed at step 6 (K = 4, so off
    the launch size) resumes with its alignment head on the ring and
    equals the straight 12-step single-device run."""
    cfg = dict(backend="stream", stream_steps=4, physics=True,
               physics_every=4, drag_tau=86400.0, dtype="float64",
               stats=False)
    pool.run("run_model", n=2, height=64, width=128, layers=2, dt=300.0,
             steps=6, config=dict(cfg, checkpoint_dir=str(tmp_path),
                                  checkpoint_every=6))
    res = pool.run("resume", n=2, height=64, width=128, layers=2, dt=300.0,
                   steps=6, config=cfg, path=str(tmp_path))[0]
    assert res["step"] == 12
    full = driver.run_model(64, 128, 2, 300.0, 12, device="cpu",
                            config=ModelConfig(**cfg))
    _close([res[k] for k in FIELDS], full[:5], bound=1e-10)
    np.testing.assert_allclose(res["gt"], full[5].gt.numpy(), rtol=1e-10)


@pytest.mark.parametrize("backend", ["stream", "mega4"])
def test_ring_surface_configuration_matches_jax(pool, backend):
    """Config S (the Hansen terrain and land cover, four-band radiation,
    the water cycle, drag and the Shapiro filter of p and t) on a ring of
    4 from the cooled start: the extras run on each band padded by one
    row (the evaporation's wind averages v with the row above), the
    filter on complete rows; equal to JAX's single-device run at 1e-9,
    ground water included."""
    from torch_port_helpers import CONFIG_S, cooled_start, hansen_jgeom
    H, W, L, dt, steps = 64, 128, 3, 30.0, 8
    jcfg = JModelConfig(height=H, width=W, layers=L, dt=dt,
                        **dict(CONFIG_S, backend="mega4"))
    jgeom = hansen_jgeom(H, W, L)
    # winds of a few m/s, so that the evaporation's wind, which averages v
    # with the row above, is not its gust floor alone
    rng = np.random.default_rng(7)
    jstart = cooled_start(jgeom, jcfg)
    jstart = jstart._replace(prog=jstart.prog._replace(**{
        k: jnp.asarray(3.0 * rng.standard_normal((L, H, W))) for k in "uv"}))
    start = state_dict(jstart)
    got = pool.run("run_from", n=4, state_d=start, height=H, width=W,
                   layers=L, dt=dt, steps=steps,
                   config=dict(CONFIG_S, backend=backend))[0]
    # (JAX's run function takes its state's buffers: the numpy copy first)
    ref, stats = jdriver.make_run_fn(jgeom, jcfg, steps)(jstart)
    names = list(FIELDS) + ["gt", "gw"]
    _close([got[k] for k in names],
           list(ref.prog) + [ref.ground.gt, ref.ground.gw], names=names)
    # the kinetic energy averages v with the row above, as the evaporation;
    # the stream ring keeps one stats entry a call of K = 2 steps
    every = 2 if backend == "stream" else 1
    for k in ("ke", "total_energy", "v_max", "v_min"):
        np.testing.assert_allclose(
            got["stats"][k], np.asarray(getattr(stats, k))[every - 1::every],
            rtol=BOUND, err_msg=k)
    assert float(np.abs(got["gw"] - start["gw"]).max()) > 0


def test_cli_runs_a_ring(pool, tmp_path):
    """``python -m gcmiipy_tpu_torch run --mesh-shape 4`` on four ranks:
    exit code 0 everywhere, one metrics line a step from rank 0."""
    metrics = tmp_path / "m.jsonl"
    rcs = pool.run("cli", argv=[
        "run", "--mesh-shape", "4", "--height", "64", "--width", "128",
        "--layers", "2", "--dt", "300", "--steps", "3", "--backend",
        "mega4", "--guard", "--dtype", "float64", "--device", "cpu",
        "--metrics", str(metrics)])
    assert rcs == [0, 0, 0, 0]
    assert len(metrics.read_text().splitlines()) == 3


def test_ring_code_imports_no_jax():
    """The ranks' helper and the parallel modules import nothing of JAX
    (tests/test_torch_driver.py holds the whole package to it)."""
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(os.path.dirname(here), "gcmiipy_tpu_torch")
    paths = [os.path.join(here, "torch_ring_ranks.py")] + [
        os.path.join(pkg, "parallel", n)
        for n in sorted(os.listdir(os.path.join(pkg, "parallel")))
        if n.endswith(".py")]
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gcmiipy_tpu)\b", re.M)
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shard_kernels_on_gpu_match_plain_and_whole_globe(cuda_device,
                                                          dtype):
    """K6's and K7's shard forms on each block of a ring of 4 on the card:
    against their plain versions, and their core rows against the kernel
    on the whole globe to the bit."""
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.model.state import random_prognostics
    from gcmiipy_tpu_torch.ops import mega_step as ms, stream_steps as ss
    geom = geometry.gen_geometry(128, 256, 3, sig_func=geometry.manabe_sig,
                                 dtype=dtype, device=cuda_device)
    state = random_prognostics(geom, 9, dtype)
    whole = ms.MegaStep(geom, 300.0)(*state)
    packed = ss.pack_state(*state)
    S = torch.stack([packed, torch.zeros_like(packed)])
    whole7 = ss.StreamSteps(geom, 300.0)(S.clone(), torch.zeros(
        (), dtype=dtype, device=cuda_device), 4)
    bound = 1e-4 if dtype == torch.float32 else 1e-10
    for s in range(4):
        rows = mesh_mod.block_rows(128, 4, s, 8)
        step = ms.MegaStep(geom, 300.0, rows=rows)
        block = [x[..., rows, :].contiguous() for x in state]
        out = step(*block)
        ref = ms.mega_step_ref(*block, 300.0, step.geom, step.consts)
        for a, b, w in zip(out, ref, whole):
            assert float((a - b).abs().max() / b.abs().max()) <= bound
            assert torch.equal(a[..., 8:40, :], w[..., s * 32:(s + 1) * 32, :])
        rows = mesh_mod.block_rows(128, 4, s, 32)
        multi = ss.StreamSteps(geom, 300.0, rows=rows)
        blk = S[:, :, rows].contiguous()
        out = multi(blk.clone(), None, 4)
        ref = ss.stream_steps_ref(blk.clone(), torch.zeros(
            (), dtype=dtype, device=cuda_device), 4, 300.0, multi.geom,
            multi.consts)
        assert float((out[0] - ref[0]).abs().max()
                     / ref[0].abs().max()) <= bound
        assert torch.equal(out[0][:, 32:64], whole7[0][:, s * 32:(s + 1) * 32])
