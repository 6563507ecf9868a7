"""PyTorch port: the Hansen terrain and land cover (``grid/topography.py``),
the square geometry and the barometric surface pressure
(``grid/geometry.py``), the terrain-balanced start, the land-cover albedo,
the geometry and state crossing from JAX, and a terrain run on 'stream'
with K7's in-kernel physics (Config T), against the JAX package at float64
on the CPU.  Bounds: rtol 1e-12 for each module (the same operations in
the same order), 1e-10 of each field's scale for whole runs
(tests/test_parity.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.grid import topography as jtopography
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.model.state import GroundVars as JGroundVars
from gcmiipy_tpu_torch.grid import geometry, topography
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import GroundVars

from torch_port_helpers import (
    FIELDS, assert_close, assert_states_close, geom_dict, hansen_jgeom,
    port_geom, port_state, random_state, state_dict)

torch.set_num_threads(1)
RTOL = 1e-12   # one module against its JAX function
RUN = 1e-10    # a whole run, of each field's scale


def test_hansen_tables_equal_jax():
    np.testing.assert_array_equal(topography.TOPOGRAPHY_M,
                                  jtopography.TOPOGRAPHY_M)
    np.testing.assert_array_equal(topography.LAND_COVER,
                                  jtopography.LAND_COVER)
    np.testing.assert_array_equal(topography.calc_topography(),
                                  jtopography.calc_topography())
    np.testing.assert_array_equal(topography.calc_land_cover(),
                                  jtopography.calc_land_cover())
    assert topography.TOPOGRAPHY_M.shape == (topography.height,
                                             topography.width) == (24, 36)


@pytest.mark.parametrize("shape", [(24, 36), (16, 128), (7, 50)])
@pytest.mark.parametrize("table", ["TOPOGRAPHY_M", "LAND_COVER"])
def test_resample_map_matches_jax(shape, table):
    """rtol 1e-12; at the native 24x36 the identity."""
    out = topography.resample_map(getattr(topography, table), *shape)
    ref = jtopography.resample_map(getattr(jtopography, table), *shape)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=0)
    assert out.shape == shape
    if shape == (24, 36):
        np.testing.assert_array_equal(out, getattr(topography, table))


def test_pressure_from_heightmap_matches_jax():
    """rtol 1e-12, over the Hansen map at 16x128 (sea level to 4500 m)."""
    hm = jtopography.resample_map(jtopography.TOPOGRAPHY_M, 16, 128)
    for t0 in (288.0, 250.0):
        out = geometry.pressure_from_heightmap(torch.as_tensor(hm), 1e5, t0)
        ref = jgeometry.pressure_from_heightmap(hm, 1e5, t0)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=0)
    assert float(out.max()) == 1e5 and float(out.min()) < 0.7e5


def test_gen_square_geometry_matches_jax():
    """rtol 1e-12 on every array of the Cartesian geometry."""
    out = geometry.gen_square_geometry(6, 10, 4, 1.5e4, 2e4,
                                       sig_func=geometry.manabe_sig,
                                       ptop=500.0, device="cpu")
    ref = geom_dict(jgeometry.gen_square_geometry(
        6, 10, 4, 1.5e4, 2e4, sig_func=jgeometry.manabe_sig, ptop=500.0))
    for f in dataclasses.fields(out):
        a = getattr(out, f.name)
        if isinstance(a, int):
            assert a == ref[f.name], f.name
        else:
            np.testing.assert_allclose(a.numpy(), ref[f.name], rtol=RTOL,
                                       atol=0, err_msg=f.name)


def test_hansen_geom_and_wet_state_cross_over_to_the_bit():
    """``convert``: a JAX Geom with the Hansen heightmap and land fraction
    and a state with nonzero ground water arrive unchanged."""
    jg = hansen_jgeom(24, 36, 9, giss_sige=True)
    tg = port_geom(jg)
    for name, a in geom_dict(jg).items():
        b = getattr(tg, name)
        if isinstance(b, int):
            assert a == b, name
        else:
            assert b.dtype == torch.float64, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert float(tg.heightmap.max()) == 4500.0
    assert 0 < float(tg.land_fraction.mean()) < 1
    cfg = JModelConfig(height=24, width=36, layers=9, gw0=0.05,
                       topography="hansen", dtype="float64")
    js = jdriver.gen_model_state(jg, cfg)
    rng = np.random.default_rng(3)
    js = js._replace(ground=JGroundVars(
        *(jnp.asarray(rng.uniform(0.01, 0.1, (24, 36))) for _ in range(4))))
    ts = port_state(js)
    for name, a in state_dict(js).items():
        b = getattr(ts.prog, name, None)
        b = getattr(ts.ground, name, b) if b is None else b
        b = {"utc": ts.utc, "step": ts.step}.get(name, b)
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert float(ts.ground.gw.min()) > 0


@pytest.mark.parametrize("gw0", [0.0, 0.05])
def test_gen_model_state_over_terrain_matches_jax(gw0):
    """The surface pressure balanced against the heightmap, gw seeded with
    gw0: rtol 1e-12."""
    jg = hansen_jgeom(24, 36, 9, giss_sige=True)
    kw = dict(topography="hansen", sea_level_temp=270.0, gw0=gw0,
              dtype="float64")
    out = driver.gen_model_state(port_geom(jg), ModelConfig(**kw))
    ref = jdriver.gen_model_state(jg, JModelConfig(**kw))
    assert_close(out.prog, ref.prog, RTOL, 0, FIELDS)
    assert_close(out.ground, ref.ground, RTOL, 0, GroundVars._fields)
    assert float(out.ground.gw.min()) == gw0
    assert float(out.prog.p.min()) < 0.6e5   # over the 4500 m cell


@pytest.mark.parametrize("radiation", ["grey", "4band"])
def test_land_cover_albedo_matches_jax(radiation):
    """solar_timestep with the land-fraction albedo blend: rtol 1e-12."""
    from gcmiipy_tpu.model.state import GroundVars as JG
    jg = hansen_jgeom(16, 32, 3)
    p, u, v, t, q = random_state(jg, 4)
    gt = 270.0 + 30.0 * np.random.default_rng(4).random((16, 32))
    kw = dict(physics=True, land_cover="hansen", albedo_land=0.5,
              radiation=radiation, dtype="float64")
    tg = port_geom(jg)
    zeros = np.zeros_like(gt)
    out = driver.solar_timestep(
        torch.as_tensor(t), torch.as_tensor(p),
        GroundVars(*(torch.as_tensor(x) for x in (gt, zeros, zeros, zeros))),
        1800.0, torch.tensor(4.0e4, dtype=torch.float64), tg,
        ModelConfig(**kw), q=torch.as_tensor(q))
    ref = jdriver.solar_timestep(
        jnp.asarray(t), jnp.asarray(p),
        JG(*(jnp.asarray(x) for x in (gt, zeros, zeros, zeros))),
        1800.0, jnp.asarray(4.0e4), jg, JModelConfig(**kw),
        q=jnp.asarray(q))
    assert_close((out[0], out[1].gt), (ref[0], ref[1].gt), RTOL, 0,
                 ("t", "gt"))
    # the land's albedo changes the ground's budget by day
    flat = driver.solar_timestep(
        torch.as_tensor(t), torch.as_tensor(p), out[1]._replace(
            gt=torch.as_tensor(gt)), 1800.0,
        torch.tensor(4.0e4, dtype=torch.float64), tg,
        ModelConfig(**dict(kw, land_cover="none")), q=torch.as_tensor(q))
    assert not torch.equal(flat[1].gt, out[1].gt)


def test_terrain_stream_inkernel_physics_matches_jax():
    """Config T: Hansen terrain, grey physics at physics_every=1 on 'stream'
    (K7's in-kernel epilogue over the terrain; its plain version here) for
    8 steps against JAX's 'stream' in interpret mode, within 1e-10 of each
    field's scale; the launch size stays 4 (no promotion to 2)."""
    kw = dict(backend="stream", stream_steps=4, topography="hansen",
              physics=True, convection=True, drag_tau=86400.0,
              dtype="float64", height=16, width=128, layers=3, dt=300.0)
    jg = hansen_jgeom(16, 128, 3, land_cover="none")
    jstate = jdriver.gen_model_state(jg, jdriver.normalize_config(
        JModelConfig(**kw)))
    state = port_state(jstate)
    run = driver.make_run_fn(port_geom(jg), ModelConfig(**kw), 8)
    out = run(state)
    ref = jdriver.make_run_fn(jg, JModelConfig(**kw), 8)(jstate)
    assert run.chunk_steps == 4
    assert driver._inkernel_physics(driver.normalize_config(
        ModelConfig(**kw)), port_geom(jg))
    assert_states_close(out[0], ref[0], RUN)
    assert_close(out[1], ref[1], RUN, RUN, out[1]._fields)
    assert float(out[0].prog.p.min()) < 0.7e5   # it ran over the terrain


@pytest.mark.parametrize("field,value,match", [
    ("topography", "alps", "topography"), ("land_cover", "forest",
                                           "land_cover"),
    ("radiation", "3band", "radiation"), ("evaporation", True, "physics"),
    ("precipitation", True, "physics")])
def test_validate_config_raises_as_jax(field, value, match):
    cfg = {field: value}
    with pytest.raises(ValueError, match=match):
        jdriver.validate_config(JModelConfig(**cfg))
    with pytest.raises(ValueError, match=match):
        driver.run_model(8, 8, 3, 900.0, 1, device="cpu",
                         config=ModelConfig(**cfg))


@pytest.mark.parametrize("topo,slp", [("flat", None), ("hansen", None),
                                      ("hansen", False), ("flat", True)])
def test_normalize_config_matches_jax(topo, slp):
    kw = dict(topography=topo, shapiro_slp=slp, shapiro_every=2)
    out = driver.normalize_config(ModelConfig(**kw))
    ref = jdriver.normalize_config(JModelConfig(**kw))
    assert out.shapiro_slp is ref.shapiro_slp
    assert out.shapiro_slp is (topo == "hansen" if slp is None else slp)


def test_model_geometry_over_terrain_is_jax_s_and_contiguous():
    """``gen_model_geometry`` with the Hansen maps: every array JAX's
    ``run_model`` builds, in its shape, to rtol 1e-12, and contiguous (the
    kernels take contiguous tensors only; a resampled map comes in Fortran
    order)."""
    cfg = ModelConfig(height=16, width=128, layers=3, topography="hansen",
                      land_cover="hansen", dtype="float64")
    geom = driver.gen_model_geometry(cfg, "cpu")
    ref = geom_dict(hansen_jgeom(16, 128, 3))
    for f in dataclasses.fields(geom):
        a = getattr(geom, f.name)
        if isinstance(a, int):
            assert a == ref[f.name], f.name
            continue
        assert a.is_contiguous() and tuple(a.shape) == ref[f.name].shape, \
            f.name
        np.testing.assert_allclose(a.numpy(), ref[f.name], rtol=RTOL,
                                   atol=0, err_msg=f.name)
