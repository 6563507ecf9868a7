"""The port's 2D (lat x lon) decomposition and the ring's last forms, on the
CPU.

Four gloo ranks (tests/torch_ring_ranks.py, one pool for the module,
every call with its deadline) step their blocks of a (2, 2), (1, 4) or
(4, 1) mesh; the wrappers run their plain versions on CPU tensors.  The
inputs come from a numpy seed and the JAX reference is computed here, in
the test process, at float64: the 2D steps against JAX's single-device
core at 16x32x3 (JAX tests/test_shard2d.py: 1e-9 for 5 steps), K5's ring
and fused4's overlap form as JAX tests/test_parallel.py holds them,
``run_model(mesh=)`` against JAX's ``run_model``, and the ensemble on a
pure 'e' mesh and on an ('e', 'y', 'x') mesh against JAX's
``make_ensemble_run_fn``.
"""

import os
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
from gcmiipy_tpu.ops import pallas_stencil as jps
from gcmiipy_tpu.ops import polar_filter as jpolar_filter
from gcmiipy_tpu_torch.model import checkpoint, driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.ops import pgf_rest, polar_filter
from gcmiipy_tpu_torch.parallel import mesh as mesh_mod, shard_step
from torch_port_helpers import (
    FIELDS, geom_dict, port_geom, random_state, state_dict)
from torch_ring_ranks import RankPool

torch.set_num_threads(1)
BOUND = 1e-9
SHAPES = [(2, 2), (1, 4), (4, 1)]


@pytest.fixture(scope="module")
def pool():
    ranks = RankPool(4)
    yield ranks
    ranks.close()


def _jgeom(height=16, width=32, layers=3, hill=False):
    hm = None
    if hill:
        hm = np.zeros((height, width))
        hm[height // 4:height // 2 + 1, width // 8:width // 3] = 1500.0
    return jgeometry.gen_geometry(height, width, layers,
                                  sig_func=jgeometry.manabe_sig,
                                  heightmap=hm)


def _jax_core(jgeom, fields, dt, steps, q_limiter=False, dft=False):
    """``steps`` steps of JAX's single-device core (its FFT filter, or the
    exact DFT filter with ``dft``)."""
    filt = None
    if dft:
        mats = jpolar_filter.build_dft_matrices(jgeom.width, dtype=np.float64)

        def filt(q, g):
            return jpolar_filter.arakawa_1977_dft(q, g, mats,
                                                  precision="highest")

    step = jax.jit(lambda *s: jcore25d.matsuno_timestep(
        *s, dt, jgeom, filter_fn=filt, q_limiter=q_limiter))
    s = tuple(jnp.asarray(x) for x in fields)
    for _ in range(steps):
        s = step(*s)
    return [np.asarray(x) for x in s]


def _close(got, ref, bound=BOUND, names=FIELDS):
    for name, a, b in zip(names, got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=bound,
                                   atol=bound, err_msg=f"field {name}")


def _limited_state(jgeom, seed):
    """A random state with strong winds and a sharp q spike, which make the
    q flux clamp bind (JAX test_fused2d_q_limiter's recipe)."""
    p, u, v, t, q = random_state(jgeom, seed)
    u = np.random.default_rng(seed).uniform(-60, 60, u.shape)
    q = q.copy()
    q[0, 4, 7] *= 50
    return p, u, v, t, q


# ---------------------------------------------------------------- the cuts

@pytest.mark.parametrize("shape", SHAPES)
def test_block_cut_is_jax_state_specs(shape):
    """Rank r of a (ny, nx) mesh holds, at (r // nx, r % nx), the block JAX's
    state_specs give device r of make_mesh's mesh; gather_state's order
    (along x, then along y) puts the blocks back."""
    ny, nx = shape
    H, W, L = 16, 32, 3
    devs = np.array(jax.devices()[:ny * nx]).reshape(shape)
    jmesh = Mesh(devs, ("y", "x"))
    full = np.arange(L * H * W, dtype=np.float64).reshape(L, H, W)
    idx = NamedSharding(jmesh, P(None, "y", "x")).devices_indices_map(
        full.shape)
    surf = NamedSharding(jmesh, P("y", "x")).devices_indices_map((H, W))
    for r, dev in enumerate(devs.reshape(-1)):
        mesh = mesh_mod.RingMesh(ny=ny, index=r // nx, nx=nx, x_index=r % nx,
                                 device=torch.device("cpu"))
        prog = mesh_mod.shard_prognostics(
            mesh_mod.PrognosticVars(torch.as_tensor(full[0]),
                                    *[torch.as_tensor(full)] * 4), mesh)
        np.testing.assert_array_equal(prog.u.numpy(), full[idx[dev]])
        np.testing.assert_array_equal(prog.p.numpy(), full[0][surf[dev]])
        rows = mesh_mod.band_rows(H, ny, r // nx)
        cols = mesh_mod.band_cols(W, nx, r % nx)
        np.testing.assert_array_equal(full[0][np.ix_(rows, cols)],
                                      prog.p.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("depth", [1, 3])
def test_halo_2d_equals_roll_on_both_axes(pool, shape, depth):
    """exchange_2d pads each block with the cells a periodic roll reaches on
    both axes, the corners from the diagonal neighbours; trim cuts the
    core back out."""
    ny, nx = shape
    x = np.random.default_rng(depth).standard_normal((2, 16, 32))
    blocks = pool.run("halo2d", shape=shape, x=x, halo=depth)
    for r, (block, back) in enumerate(blocks):
        rows = mesh_mod.block_rows(16, ny, r // nx, depth)
        cols = mesh_mod.block_cols(32, nx, r % nx, depth)
        np.testing.assert_array_equal(block, x[:, rows][:, :, cols])
        assert back


# ------------------------------------------------------------ the filter

@pytest.mark.parametrize("n,shape", [(2, (1, 2)), (4, (2, 2)), (4, (1, 4))])
def test_spectral_psum_filter_matches_single_device(pool, n, shape):
    """The per-rank partial DFT, one psum over the mesh row and the inverse
    slice give the single-device filter: the port's arakawa_1977_dft and
    JAX's arakawa_1977 at 1e-12 of the field's scale."""
    jgeom = _jgeom()
    q = np.random.default_rng(5).standard_normal((4, 16, 32))
    got = pool.run("psum_filter", n=n, shape=shape, q=q,
                   geom_d=geom_dict(jgeom))[0]
    geom = port_geom(jgeom)
    mats = polar_filter.build_dft_matrices(32, dtype=np.float64)
    one = polar_filter.arakawa_1977_dft(torch.as_tensor(q), geom, mats)
    ref = np.asarray(jpolar_filter.arakawa_1977(jnp.asarray(q), jgeom))
    scale = np.abs(ref).max()
    assert np.abs(got - one.numpy()).max() <= 1e-12 * scale
    assert np.abs(got - ref).max() <= 1e-12 * scale


# ------------------------------------------------------ K3 and K4 on a block

@pytest.mark.parametrize("block", [(0, 0), (1, 1)])
def test_k3_k4_plain_on_a_block_match_jax_padded_kernels(block):
    """K3's and K4's plain versions on one rank's block of a 2x2 mesh (its
    core and a halo of EX = 3, the block's take_block geometry) against
    JAX's make_pgf_kernel_padded / make_rest_kernel_padded(local_height=,
    local_width=, geom_as_args=True, interpret=True) on the same block in
    JAX's (PHJ, PHX) padded layout: the cores at 1e-10."""
    H, W, L, dt = 16, 32, 3, 300.0
    hl, wl = H // 2, W // 2
    y, x = block
    jgeom = _jgeom(H, W, L, hill=True)
    base = random_state(jgeom, 11)
    seval = random_state(jgeom, 12)
    rng = np.random.default_rng(13)
    spu, pgfu, pg_phiv = (rng.standard_normal((L, H, W)) for _ in range(3))
    hj, hx = jps.PHJ, jps.PHX

    def jpad(a):
        ap = np.pad(a, [(0, 0)] * (a.ndim - 2) + [(hj, hj), (hx, hx)],
                    mode="wrap")
        return jnp.asarray(ap[..., y * hl:y * hl + hl + 2 * hj,
                              x * wl:x * wl + wl + 2 * hx])

    def jcore(a):
        return jnp.asarray(a[..., y * hl:(y + 1) * hl, x * wl:(x + 1) * wl])

    def rows(a):
        ap = np.pad(np.asarray(a).reshape(H, 1), ((hj, hj), (0, 0)),
                    mode="wrap")
        return jnp.asarray(ap[y * hl:y * hl + hl + 2 * hj])

    tables = (rows(jgeom.dx_j), rows(jgeom.dx_h), rows(jgeom.lat),
              jpad(np.asarray(jgeom.heightmap)))
    kw = dict(dtype=jnp.float64, interpret=True, local_height=hl,
              local_width=wl, geom_as_args=True)
    pgfk = jps.make_pgf_kernel_padded(jgeom, **kw)
    restk = jps.make_rest_kernel_padded(jgeom, dt, coriolis=True,
                                        q_limiter=True, **kw)
    jstack, jpgv = pgfk(jpad(seval[0]), jpad(seval[1]), jpad(seval[3]),
                        tables)
    jout = restk(*map(jpad, base), *map(jpad, seval), jpad(spu),
                 jcore(np.concatenate([spu, pgfu])), jcore(pg_phiv), tables)

    ex = shard_step.EX
    brows = mesh_mod.block_rows(H, 2, y, ex)
    bcols = mesh_mod.block_cols(W, 2, x, ex)
    bgeom = port_geom(jgeom).take_block(brows, bcols)

    def blk(a):
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(a)[..., brows, :][..., bcols]))

    def core(t):
        return t[..., ex:ex + hl, ex:ex + wl].numpy()

    stack, pgv = pgf_rest.pgf_parts_shard(blk(seval[0]), blk(seval[1]),
                                          blk(seval[3]), bgeom)
    _close([core(stack), core(pgv)], [jstack, jpgv], 1e-10,
           ["stack", "pg_phiv"])
    out = pgf_rest.rest_parts_shard(
        *map(blk, base), *map(blk, seval),
        torch.cat([blk(spu), blk(pgfu)]), blk(pg_phiv), dt, bgeom,
        coriolis=True, q_limiter=True)
    _close([core(o) for o in out],
           [np.asarray(o)[..., hj:hj + hl, hx:hx + wl] for o in jout], 1e-10)


# ------------------------------------------------------------- the 2D steps

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("form", ["make_shard_step_2d",
                                     "make_shard_step_fused2d"])
@pytest.mark.parametrize("q_limiter", [False, True])
def test_2d_steps_match_jax_core(pool, shape, form, q_limiter):
    """The plain-core and the fused2d 2D decompositions == JAX's
    single-device core at 1e-9 for 5 steps (JAX test_shard_step_2d_
    matches_core, test_fused2d_matches_core, test_fused2d_q_limiter), from
    a random start; the polar wall holds."""
    jgeom = _jgeom()
    fields = (_limited_state(jgeom, 21) if q_limiter
              else random_state(jgeom, 21))
    got, _ = pool.run("step", shape=shape, form=form, fields=fields,
                      geom_d=geom_dict(jgeom), dt=300.0, steps=5,
                      q_limiter=q_limiter)[0]
    _close(got, _jax_core(jgeom, fields, 300.0, 5, q_limiter=q_limiter))
    np.testing.assert_allclose(got[2][:, -1, :], 0.0, atol=1e-14)
    if q_limiter:
        free = _jax_core(jgeom, fields, 300.0, 5)
        assert not np.allclose(got[4], free[4], rtol=0, atol=1e-15)


def test_circulant_shard_step_matches_jax_core(pool):
    """make_shard_step (the rows' slices of the circulant stack after a
    gather along the mesh row) == JAX's core at 1e-9 for 5 steps (JAX
    test_shard_step_matches_single_device)."""
    jgeom = _jgeom()
    fields = random_state(jgeom, 22)
    got, _ = pool.run("step", shape=(2, 2), form="make_shard_step",
                      fields=fields, geom_d=geom_dict(jgeom), dt=300.0,
                      steps=5)[0]
    _close(got, _jax_core(jgeom, fields, 300.0, 5))


def test_shard_steps_refuse_what_jax_refuses():
    """Extents below the halo, a grid the mesh does not divide and the
    circulant stack above 2 GiB raise, as in JAX; the ring-only forms
    refuse a 2D mesh."""
    cpu = torch.device("cpu")
    mesh = mesh_mod.RingMesh(ny=2, index=0, nx=4, x_index=0, device=cpu)
    for height in (4, 9):
        geom = port_geom(jgeometry.gen_geometry(height, 32, 2))
        with pytest.raises(ValueError):
            shard_step.make_shard_step(mesh, geom, 300.0)
    with pytest.raises(ValueError, match="shard extents"):
        shard_step.make_shard_step_fused2d(
            mesh, port_geom(jgeometry.gen_geometry(4, 32, 2)), 300.0)
    wide = port_geom(jgeometry.gen_geometry(1024, 2048, 1))
    with pytest.raises(ValueError, match="GiB"):
        shard_step.make_shard_step(mesh, wide, 300.0)
    geom = port_geom(_jgeom(64, 128, 2))
    for form in (shard_step.make_shard_step_fused,
                    shard_step.make_shard_step_fused4):
        with pytest.raises(ValueError, match="latitude only"):
            form(mesh, geom, 300.0)


# ----------------------------------------------------- the ring's last forms

@pytest.mark.parametrize("n", [2, 4])
def test_k5_ring_matches_jax_dft_core(pool, n):
    """make_shard_step_fused (a PHJ-row exchange and K5's shard form a half
    step) == JAX's single-device core with the exact DFT filter at 1e-10
    (JAX test_shard_step_fused_matches_single_device); the wall holds."""
    jgeom = _jgeom(64, 128, 2)
    fields = random_state(jgeom, 23)
    got, _ = pool.run("step", n=n, form="make_shard_step_fused",
                      fields=fields, geom_d=geom_dict(jgeom), dt=300.0,
                      steps=2)[0]
    _close(got, _jax_core(jgeom, fields, 300.0, 2, dft=True), 1e-10)
    np.testing.assert_allclose(got[2][:, -1, :], 0.0, atol=1e-14)


@pytest.mark.parametrize("n", [2, 4])
def test_fused4_overlap_equals_one_kernel_ring(pool, n):
    """overlap=True (the interior strip launched before the exchange, the
    two edge strips after it, each K6's shard form on its own rows) == the
    one-kernel ring at 1e-12 (JAX test_shard_step_fused4_overlap)."""
    jgeom = _jgeom(48 * n, 128, 2)
    fields = random_state(jgeom, 24)
    kw = dict(n=n, form="make_shard_step_fused4", fields=fields,
              geom_d=geom_dict(jgeom), dt=300.0, steps=2)
    ov, caught = pool.run("step", overlap=True, **kw)[0]
    one, _ = pool.run("step", **kw)[0]
    assert not caught
    _close(ov, one, 1e-12)


def test_fused4_overlap_small_shard_warns_and_runs_one_kernel(pool):
    """Shards below 3 * tile_j rows fall back to the one-kernel form with
    JAX's warning (JAX test_shard_step_fused4_overlap_fallback_small_
    shard)."""
    jgeom = _jgeom(32, 128, 2)
    fields = random_state(jgeom, 25)
    kw = dict(n=2, form="make_shard_step_fused4", fields=fields,
              geom_d=geom_dict(jgeom), dt=300.0, steps=1)
    ov, caught = pool.run("step", overlap=True, tile_j=16, **kw)[0]
    assert any("overlap" in w for w in caught)
    one, _ = pool.run("step", tile_j=16, **kw)[0]
    _close(ov, one, 1e-12)


# ----------------------------------------------------------- run_model(mesh=)

@pytest.fixture(scope="module")
def jax_run_16x32():
    """JAX's single-device run_model(16, 32, 3, 900, 4) in float64."""
    return jdriver.run_model(16, 32, 3, 900.0, 4,
                             config=JModelConfig(dtype="float64"))


@pytest.mark.parametrize("backend", ["mega4", "xla", "stream"])
def test_run_model_2d_mesh_matches_jax(pool, jax_run_16x32, backend):
    """run_model on a 2x2 mesh, guarded, with stats: every rank receives
    the full fields, equal to JAX's single-device run at 1e-9 and its
    energies at 1e-12 (JAX test_run_model_2d_mesh); 'stream' warns and runs
    the per-step fused2d path (JAX test_stream_2d_mesh_falls_back)."""
    ref = jax_run_16x32
    cfg = dict(backend=backend, dtype="float64", guard=True)
    ring = pool.run("run_model", shape=(2, 2), height=16, width=32,
                    layers=3, dt=900.0, steps=4, config=cfg)
    for res in ring:
        _close([res[k] for k in FIELDS], ref[:5])
        np.testing.assert_allclose(res["stats"]["total_energy"],
                                   np.asarray(ref[7].total_energy),
                                   rtol=1e-12)
        for k in ("u_max", "u_min", "v_max", "v_min"):
            np.testing.assert_allclose(res["stats"][k],
                                       np.asarray(getattr(ref[7], k)),
                                       rtol=BOUND, atol=1e-12, err_msg=k)
    latitude_only = any("latitude only" in w for w in ring[0]["warnings"])
    assert latitude_only == (backend == "stream")


@pytest.mark.parametrize("backend", ["fused", "mega"])
def test_fused_family_on_a_2d_mesh_runs_fused2d(pool, backend):
    """'fused' and 'mega' on a 2D mesh run fused2d, as JAX's
    make_dynamics_step(mesh=) does: equal to 'mega4' on the mesh to the
    bit."""
    cfg = dict(dtype="float64", guard=True)
    kw = dict(shape=(2, 2), height=16, width=32, layers=3, dt=900.0,
              steps=2)
    got = pool.run("run_model", config=dict(cfg, backend=backend), **kw)[0]
    ref = pool.run("run_model", config=dict(cfg, backend="mega4"), **kw)[0]
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_xla_on_a_ring_and_the_sharded_run_fn_match_jax(pool):
    """'xla' on a lat ring of 4 (the plain core with the spectral-psum
    filter over rows of one rank) and gspmd.make_sharded_run_fn on a 2x2
    mesh (JAX test_mesh_run_model_xla_backend, test_gspmd_matches_single_
    device) == JAX's single-device run at 1e-10."""
    cfg = dict(backend="xla", dtype="float64", stats=False)
    ring = pool.run("run_model", height=32, width=64, layers=2, dt=300.0,
                    steps=3, config=cfg)[0]
    ref = jdriver.run_model(32, 64, 2, 300.0, 3,
                            config=JModelConfig(**cfg))
    _close([ring[k] for k in FIELDS], ref[:5], 1e-10)
    jcfg = JModelConfig(height=16, width=32, layers=3, dt=300.0,
                        dtype="float64", polar_filter="matmul")
    jgeom = jgeometry.gen_geometry(16, 32, 3,
                                   sig_func=jcfg.sig_func).astype(np.float64)
    jstate = jdriver.gen_model_state(jgeom, jcfg)
    start = state_dict(jstate)
    got = pool.run("sharded_run", shape=(2, 2), state_d=start, height=16,
                   width=32, layers=3, dt=300.0, steps=5,
                   config=dict(dtype="float64", polar_filter="matmul"))[0]
    jref, _ = jdriver.make_run_fn(jgeom, jcfg, 5)(jstate)
    _close([got[k] for k in FIELDS], jref.prog, 1e-10)


def test_config_s_on_a_2d_mesh_matches_jax(pool):
    """Config S (the Hansen terrain and land cover, four-band radiation,
    the water cycle, drag and the Shapiro filter of p and t) on a 2x2 mesh
    from the cooled start with winds of a few m/s: the Shapiro filter on
    whole rows gathered over the mesh row, the extras on the block padded
    by one cell (the evaporation's wind averages u with the column to the
    left and v with the row above); equal to JAX's single-device run at
    1e-9, ground water included, and the energies."""
    from torch_port_helpers import CONFIG_S, cooled_start, hansen_jgeom
    H, W, L, dt, steps = 64, 128, 3, 30.0, 8
    jcfg = JModelConfig(height=H, width=W, layers=L, dt=dt,
                        **dict(CONFIG_S, backend="xla"))
    jgeom = hansen_jgeom(H, W, L)
    rng = np.random.default_rng(8)
    jstart = cooled_start(jgeom, jcfg)
    jstart = jstart._replace(prog=jstart.prog._replace(**{
        k: jnp.asarray(3.0 * rng.standard_normal((L, H, W))) for k in "uv"}))
    start = state_dict(jstart)
    got = pool.run("run_from", shape=(2, 2), state_d=start, height=H,
                   width=W, layers=L, dt=dt, steps=steps,
                   config=dict(CONFIG_S, backend="mega4"))[0]
    ref, stats = jdriver.make_run_fn(jgeom, jcfg, steps)(jstart)
    names = list(FIELDS) + ["gt", "gw"]
    _close([got[k] for k in names],
           list(ref.prog) + [ref.ground.gt, ref.ground.gw], names=names)
    for k in ("ke", "total_energy", "u_max", "v_min"):
        np.testing.assert_allclose(got["stats"][k],
                                   np.asarray(getattr(stats, k)),
                                   rtol=BOUND, err_msg=k)
    assert float(np.abs(got["gw"] - start["gw"]).max()) > 0


def test_checkpointed_2d_run_resumes(pool, tmp_path):
    """A guarded mega4 run on a 2x2 mesh with checkpoints at steps 2 and 4
    (the blocks gathered, rank 0 writes): the last holds its fields; the
    step-2 checkpoint cut into blocks and run 2 steps on the mesh equals
    them, and the single-device plain core."""
    cfg = dict(backend="mega4", dtype="float64", guard=True)
    ring = pool.run("run_model", shape=(2, 2), height=16, width=32,
                    layers=3, dt=900.0, steps=4,
                    config=dict(cfg, checkpoint_dir=str(tmp_path),
                                checkpoint_every=2))
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002.npz",
                                            "step_0000000004.npz"]
    last, step = checkpoint.restore_checkpoint(str(tmp_path), device="cpu")
    assert step == 4
    for k, x in zip(FIELDS, last.prog):
        np.testing.assert_array_equal(x.numpy(), ring[0][k])
    os.remove(os.path.join(tmp_path, "step_0000000004.npz"))
    res = pool.run("resume", shape=(2, 2), height=16, width=32, layers=3,
                   dt=900.0, steps=2, config=cfg, path=str(tmp_path))[0]
    assert res["step"] == 4
    _close([res[k] for k in FIELDS], [ring[0][k] for k in FIELDS], 1e-12)
    one = driver.run_model(16, 32, 3, 900.0, 4, device="cpu",
                           config=ModelConfig(backend="xla",
                                              polar_filter="dft",
                                              dtype="float64"))
    _close([res[k] for k in FIELDS], one[:5])


def test_cli_runs_a_2d_mesh(pool, tmp_path):
    """``python -m gcmiipy_tpu_torch run --mesh-shape 2,2`` on four ranks:
    exit code 0 everywhere, one metrics line a step from rank 0."""
    metrics = tmp_path / "m.jsonl"
    rcs = pool.run("cli", argv=[
        "run", "--mesh-shape", "2,2", "--height", "16", "--width", "32",
        "--layers", "3", "--dt", "900", "--steps", "3", "--backend",
        "mega4", "--guard", "--dtype", "float64", "--device", "cpu",
        "--metrics", str(metrics)])
    assert rcs == [0, 0, 0, 0]
    assert len(metrics.read_text().splitlines()) == 3


def test_cli_mesh_needs_its_ranks(capsys):
    """--mesh-shape 2,2 in a single process: exit 2 naming the ranks it
    needs."""
    from gcmiipy_tpu_torch.__main__ import main
    rc = main(["run", "--mesh-shape", "2,2", "--height", "16", "--width",
               "32", "--layers", "3", "--steps", "1", "--device", "cpu"])
    assert rc == 2
    assert "needs 4 ranks" in capsys.readouterr().err


def test_new_modules_import_no_jax():
    """The 2D path's modules import nothing of JAX."""
    import re
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(os.path.dirname(here), "gcmiipy_tpu_torch")
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gcmiipy_tpu)\b", re.M)
    for rel in ("parallel/gspmd.py", "parallel/shard_step.py",
                "parallel/mesh.py", "parallel/halo.py", "ops/pgf_rest.py",
                "ops/mega_half.py", "grid/geometry.py"):
        with open(os.path.join(pkg, rel)) as f:
            assert not pattern.search(f.read()), rel


@pytest.mark.parametrize("form", ["make_shard_step_2d",
                                     "make_shard_step_fused2d"])
def test_2d_steps_on_a_mesh_of_one_equal_the_core(form):
    """On a mesh of one rank (no process group) the 2D steps wrap their own
    block on both axes: equal to the port's single-device core with the DFT
    filter at 1e-12, without a warning."""
    jgeom = _jgeom()
    geom = port_geom(jgeom)
    fields = [torch.as_tensor(x) for x in random_state(jgeom, 26)]
    mats = polar_filter.build_dft_matrices(32, dtype=np.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = getattr(shard_step, form)(mesh_mod.make_mesh(device="cpu"),
                                            geom, 300.0)
    from gcmiipy_tpu_torch.dynamics import core25d
    got = ref = fields
    for _ in range(3):
        got = step(*got)
        ref = core25d.matsuno_timestep(
            *ref, 300.0, geom,
            filter_fn=lambda q, g: polar_filter.arakawa_1977_dft(q, g, mats))
    _close([x.numpy() for x in got], [x.numpy() for x in ref], 1e-12)


# ------------------------------------------------------------- the ensemble

@pytest.mark.parametrize("n", [1, 2, 4])
def test_ensemble_matches_jax_ensemble(pool, n):
    """Four members with different v seeds (JAX test_ensemble_members_
    match_single_runs) over an 'e' mesh of n ranks, each running its
    members one after another: every rank receives all four, equal to
    JAX's make_ensemble_run_fn on its virtual 4-device 'e' mesh at 1e-10,
    stats per member per step."""
    from gcmiipy_tpu.parallel import ensemble as jensemble
    jcfg = JModelConfig(height=8, width=8, layers=3, dt=900.0,
                        dtype="float64")
    jgeom = jgeometry.gen_geometry(8, 8, 3, sig_func=jgeometry.manabe_sig)
    base = jdriver.gen_model_state(jgeom, jcfg)
    members = [base._replace(prog=base.prog._replace(
        v=base.prog.v.at[0, 0, 0].set(0.05 * (k + 1)))) for k in range(4)]
    starts = [state_dict(m) for m in members]
    jmesh = jensemble.make_ensemble_mesh(4)
    stacked = jax.device_put(jensemble.stack_states(members),
                             jensemble.ensemble_shardings(jmesh))
    ref, rstats = jensemble.make_ensemble_run_fn(jgeom, jcfg, 3,
                                                 jmesh)(stacked)
    kw = dict(states_d=starts, height=8, width=8, layers=3, dt=900.0,
              steps=3, config=dict(dtype="float64"))
    if n == 1:  # one device, no process group: the members in a loop
        from torch_ring_ranks import task_ensemble
        results = [task_ensemble(mesh_mod.make_mesh(device="cpu"), **kw)]
    else:
        results = pool.run("ensemble", n=n, **kw)
    for res in results:
        _close([res[k] for k in FIELDS], ref.prog, 1e-10)
        assert res["total_energy"].shape == (4, 3)
        np.testing.assert_allclose(res["total_energy"],
                                   np.asarray(rstats.total_energy),
                                   rtol=1e-10)


ESHAPES = [(2, 2, 1), (2, 1, 2)]


def _ensemble_members(cfg_kw, n=2, H=16, W=32, L=3):
    """``n`` members of one JAX start, each with the random fields of its
    own seed; (JAX geometry, members)."""
    jcfg = JModelConfig(height=H, width=W, layers=L, dt=900.0,
                        dtype="float64", **cfg_kw)
    jgeom = jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)
    base = jdriver.gen_model_state(jgeom, jcfg)
    members = [base._replace(prog=base.prog._replace(**{
        k: jnp.asarray(x) for k, x in zip(FIELDS, random_state(jgeom, k))}))
        for k in range(n)]
    return jcfg, jgeom, members


@pytest.mark.parametrize("backend", ["mega4", "xla"])
@pytest.mark.parametrize("eshape", ESHAPES)
def test_spatial_ensemble_matches_jax_ensemble(pool, eshape, backend):
    """Two members on an ('e', 'y', 'x') mesh of 4 ranks, each member's
    group of ny*nx ranks running it on its spatial mesh (the fused4 ring or
    fused2d on 'mega4', the plain core with the spectral-psum filter on
    'xla'), equal on every rank to JAX's make_ensemble_run_fn on the same
    hand-built mesh of its virtual devices at 1e-9, the stats per member
    per step.  Both sides filter with the DFT: JAX's CPU FFT fails on this
    mesh (its fft thunk refuses the sharded layout)."""
    from gcmiipy_tpu.parallel import ensemble as jensemble
    jcfg, jgeom, members = _ensemble_members(dict(polar_filter="dft"))
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(eshape),
                 ("e", "y", "x"))
    stacked = jax.device_put(jensemble.stack_states(members),
                             jensemble.ensemble_shardings(jmesh))
    ref, rstats = jensemble.make_ensemble_run_fn(jgeom, jcfg, 3,
                                                 jmesh)(stacked)
    results = pool.run("ensemble", eshape=eshape,
                       states_d=[state_dict(m) for m in members], height=16,
                       width=32, layers=3, dt=900.0, steps=3,
                       config=dict(dtype="float64", polar_filter="dft",
                                   backend=backend))
    for res in results:
        _close([res[k] for k in FIELDS], ref.prog)
        assert res["total_energy"].shape == (2, 3)
        np.testing.assert_allclose(res["total_energy"],
                                   np.asarray(rstats.total_energy),
                                   rtol=BOUND)


@pytest.mark.parametrize("backend", ["mega4", "xla"])
@pytest.mark.parametrize("eshape", ESHAPES)
def test_spatial_ensemble_fft_matches_single_device_members(pool, eshape,
                                                            backend):
    """With the FFT filter (the port's default) the spatial ensemble equals
    the port's own single-device run of each member at 1e-9."""
    jcfg, jgeom, members = _ensemble_members({})
    starts = [state_dict(m) for m in members]
    cfg = dict(dtype="float64", backend=backend)
    results = pool.run("ensemble", eshape=eshape, states_d=starts,
                       height=16, width=32, layers=3, dt=900.0, steps=3,
                       config=cfg)
    pcfg = driver.normalize_config(ModelConfig(
        height=16, width=32, layers=3, dt=900.0, **cfg))
    geom = driver.gen_model_geometry(pcfg, "cpu")
    run = driver.make_run_fn(geom, pcfg, 3)
    from gcmiipy_tpu_torch.convert import state_from_jax_numpy
    for k, start in enumerate(starts):
        one = run(state_from_jax_numpy(start, "cpu"))[0]
        for res in results:
            _close([res[f][k] for f in FIELDS], [x.numpy() for x in one.prog])


def test_ensemble_mesh_shape_and_errors():
    """Without a process group an ensemble mesh of shape (1, 1, 1) is one
    device and any other shape is refused; the pure 'e' mesh's shape is
    JAX's."""
    from gcmiipy_tpu_torch.parallel import ensemble
    one = ensemble.make_ensemble_mesh(device="cpu", shape=(1, 1, 1))
    assert one.n == 1 and one.spatial is None
    assert ensemble.make_ensemble_mesh(device="cpu").shape == {"e": 1}
    with pytest.raises(ValueError, match="ranks"):
        ensemble.make_ensemble_mesh(device="cpu", shape=(2, 2, 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_2d_shard_kernels_on_gpu_match_whole_globe(cuda_device, dtype):
    """On the card, K3's and K4's shard forms on each block of a 2x2 mesh
    and K5's on each block of a ring of 4: their cores equal the kernels
    on the whole globe to the bit."""
    from gcmiipy_tpu_torch.grid import geometry
    from gcmiipy_tpu_torch.model.state import random_prognostics
    from gcmiipy_tpu_torch.ops.mega_half import MegaHalf
    H, W, L = 128, 256, 3
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=dtype, device=cuda_device)
    base = random_prognostics(geom, 9, dtype)
    seval = random_prognostics(geom, 10, dtype)
    wstack, wpgv = pgf_rest.pgf_parts(seval[0], seval[1], seval[3], geom)
    filt = polar_filter.arakawa_1977(wstack, geom)
    wout = pgf_rest.rest_parts(*base, *seval, filt, wpgv, 300.0, geom,
                               coriolis=True)
    whole = MegaHalf(geom, 300.0)(base, seval)
    ex, hl, wl = shard_step.EX, H // 2, W // 2
    for r in range(4):
        y, x = divmod(r, 2)
        rows = mesh_mod.block_rows(H, 2, y, ex)
        cols = mesh_mod.block_cols(W, 2, x, ex)
        bgeom = geom.take_block(rows, cols)

        def blk(a):
            return a[..., rows, :][..., cols].contiguous()

        core = (Ellipsis, slice(ex, ex + hl), slice(ex, ex + wl))
        ref = (Ellipsis, slice(y * hl, (y + 1) * hl),
               slice(x * wl, (x + 1) * wl))
        out = pgf_rest.pgf_parts_shard(blk(seval[0]), blk(seval[1]),
                                       blk(seval[3]), bgeom)
        for a, w in zip(out, (wstack, wpgv)):
            assert torch.equal(a[core], w[ref])
        out = pgf_rest.rest_parts_shard(*map(blk, base), *map(blk, seval),
                                        blk(filt), blk(wpgv), 300.0, bgeom,
                                        coriolis=True)
        for a, w in zip(out, wout):
            assert torch.equal(a[core], w[ref])
        rows = mesh_mod.block_rows(H, 4, r, 8)
        half = MegaHalf(geom, 300.0, rows=rows)
        out = half([v[..., rows, :].contiguous() for v in base],
                   [v[..., rows, :].contiguous() for v in seval])
        for a, w in zip(out, whole):
            assert torch.equal(a[..., 8:40, :], w[..., r * 32:(r + 1) * 32, :])
