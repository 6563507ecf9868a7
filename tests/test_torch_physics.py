"""PyTorch port: the grey-radiation physics, the convective adjustment and
``model/driver.py``'s cadenced extras, against the JAX package and the numpy
oracle of the reference (``gcmiipy_tpu/oracle/numpy_radiation.py``) at
float64 on the CPU.  Bounds: 1e-11 for the column functions (their sums
run in another order), 3e-13 of the field's scale for the ladder form
against ``basic_grey_radiation`` (the bound recorded for the JAX pair),
1e-10 for whole runs (tests/test_parity.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.model.state import GroundVars as JGroundVars
from gcmiipy_tpu.model.state import PrognosticVars as JPrognosticVars
from gcmiipy_tpu.oracle import numpy_radiation as rad_np
from gcmiipy_tpu.physics import convection as jconvection
from gcmiipy_tpu.physics import radiation as jradiation
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import GroundVars, PrognosticVars
from gcmiipy_tpu_torch.physics import convection, radiation

from torch_port_helpers import (
    FIELDS, as_jax, as_torch, assert_close, port_geom, random_state)

torch.set_num_threads(1)


def _jgeom(L=9, H=6, W=8):
    return jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)


def _column(jg, seed=0):
    """Random but physical float64 (p, tp, tt, gt): the recipe of
    tests/test_radiation.py:_random_column."""
    rng = np.random.default_rng(seed)
    L, H, W = jg.layers, jg.height, jg.width
    p = 1e5 * (1 + 0.02 * rng.standard_normal((H, W)))
    tp = p * np.asarray(jg.sig) + float(jg.ptop)
    tt = 260.0 + 60.0 * rng.random((L, H, W))
    gt = 270.0 + 50.0 * rng.random((H, W))
    return p, tp, tt, gt


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


@pytest.mark.parametrize("decl", [0.0, 0.3, -0.2])
def test_daily_average_irradiance_matches_jax(decl):
    lat = np.linspace(-1.2, 1.2, 11)
    out = radiation.daily_average_irradiance(_t(lat), decl)
    ref = jradiation.daily_average_irradiance(jnp.asarray(lat), decl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-13,
                               atol=1e-10)


def test_solar_declination_matches_jax_and_oracle():
    utc = np.array([0.0, 3.7e5, 86400.0 * 172, 86400.0 * 355.5])
    for obl, year in ((23.44, 365.0), (40.0, 360.0)):
        out = radiation.solar_declination(_t(utc), obl, year)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jradiation.solar_declination(
                jnp.asarray(utc), obl, year)), rtol=1e-14, atol=1e-15)
        np.testing.assert_allclose(
            out.numpy(), rad_np.solar_declination_np(utc, obl, year),
            rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("time,decl", [(0.0, 0.0), (5 * 3600.0, 0.0),
                                       (7.3e4, 0.35)])
def test_zenith_angle_matches_jax_and_oracle(time, decl):
    jg = _jgeom(3, 8, 12)
    tg = port_geom(jg)
    out = radiation.zenith_angle(tg.long, tg.lat, _t(time), declination=decl)
    ref = jradiation.zenith_angle(jnp.asarray(jg.long), jnp.asarray(jg.lat),
                                  jnp.asarray(time), jg, declination=decl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(
        out.numpy(), rad_np.zenith_angle_np(jg.long, jg.lat, time, jg,
                                            declination=decl),
        rtol=1e-14, atol=1e-15)
    hour = _t(time / (-86400.0) * 2 * math.pi)
    raw = radiation.solar_zenith_angle(tg.lat, tg.long + hour, decl)
    np.testing.assert_allclose(
        raw.numpy(), rad_np.solar_zenith_angle_np(
            np.asarray(jg.lat), np.asarray(jg.long) + hour.item(), decl),
        rtol=1e-14, atol=1e-15)


def test_zenith_angle_takes_jax_positional_form():
    """zenith_angle(longs, lats, time, geom) in JAX's positional form: the
    unused geom in the fourth place, equal to the keyword call and to JAX."""
    jg = _jgeom(3, 8, 12)
    tg = port_geom(jg)
    out = radiation.zenith_angle(tg.long, tg.lat, _t(3600.0), tg)
    kw = radiation.zenith_angle(tg.long, tg.lat, _t(3600.0), declination=0.0)
    ref = jradiation.zenith_angle(jnp.asarray(jg.long), jnp.asarray(jg.lat),
                                  jnp.asarray(3600.0), jg)
    np.testing.assert_array_equal(out.numpy(), kw.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-14,
                               atol=1e-15)


def test_basic_grey_transmittances_match_jax():
    jg = _jgeom()
    out = radiation.basic_grey_transmittances(0.1, 0.9, port_geom(jg))
    ref = jradiation.basic_grey_transmittances(0.1, 0.9, jg)
    assert_close(out, ref, 1e-15, 0.0, ("lw", "sw"))


@pytest.mark.parametrize("utc,decl", [(5 * 3600.0, 0.0), (0.0, 0.0),
                                      (4.1e4, -0.3)])
def test_basic_grey_radiation_matches_jax_and_oracle(utc, decl):
    jg = _jgeom()
    p, tp, tt, gt = _column(jg, seed=1)
    out = radiation.basic_grey_radiation(_t(p), _t(tp), _t(tt), _t(gt), 0.1,
                                         0.9, 0.3, _t(utc), port_geom(jg),
                                         declination=decl)
    g = JGroundVars(jnp.asarray(gt), *[jnp.zeros_like(jnp.asarray(gt))] * 3)
    ref = jradiation.basic_grey_radiation(
        jnp.asarray(p), jnp.asarray(tp), jnp.asarray(tt), g, 0.1, 0.9, 0.3,
        jnp.asarray(utc), jg, declination=decl)
    assert_close(out, ref, 1e-11, 1e-16, ("dTdt", "dt_ground"))
    oracle = rad_np.basic_grey_radiation_np(p, tp, tt, gt, 0.1, 0.9, 0.3,
                                            utc, jg, declination=decl)
    assert_close(out, oracle, 1e-11, 1e-16, ("dTdt", "dt_ground"))


@pytest.mark.parametrize("L", [3, 9])
def test_ladder_matches_basic_grey_radiation(L):
    """The ladder form (K7's epilogue) against the scanned form at 3e-13,
    and against the JAX ladder."""
    jg = _jgeom(L)
    tg = port_geom(jg)
    p, tp, tt, gt = _column(jg, seed=2)
    utc = 2.2e4
    sza = radiation.zenith_angle(tg.long, tg.lat, _t(utc))
    dsig = [float(x) for x in np.asarray(jg.dsig).ravel()]
    out = radiation.basic_grey_radiation_ladder(_t(p), _t(tt), _t(gt), 0.1,
                                                0.9, 0.3, sza, dsig)
    ref = radiation.basic_grey_radiation(_t(p), _t(tp), _t(tt), _t(gt), 0.1,
                                         0.9, 0.3, _t(utc), tg)
    jref = jradiation.basic_grey_radiation_ladder(
        jnp.asarray(p), jnp.asarray(tt), jnp.asarray(gt), 0.1, 0.9, 0.3,
        jnp.asarray(sza.numpy()), dsig)
    for a, b, c in zip(out, ref, jref):
        a, b, c = a.numpy(), b.numpy(), np.asarray(c)
        assert np.abs(a - b).max() <= 3e-13 * np.abs(b).max()
        assert np.abs(a - c).max() <= 3e-13 * np.abs(c).max()


def _unstable_column(seed, L=9, H=4, W=5):
    jg = _jgeom(L, H, W)
    rng = np.random.default_rng(seed)
    p = 1e5 * (1 + 0.01 * rng.standard_normal((H, W)))
    tp = p * np.asarray(jg.sig) + float(jg.ptop)
    dp = p * np.asarray(jg.dsig)
    # a warm, noisy lower column: many superadiabatic pairs
    tt = 280.0 + 8.0 * rng.standard_normal((L, H, W))
    tt[:3] += np.array([40.0, 20.0, 8.0])[:, None, None]
    return tt, tp, dp


@pytest.mark.parametrize("adaptive,sweeps", [(True, None), (False, 4),
                                             (False, None)])
def test_convective_adjustment_matches_jax_and_conserves_enthalpy(adaptive,
                                                                   sweeps):
    tt, tp, dp = _unstable_column(3)
    out = convection.convective_adjustment(_t(tt), _t(tp), _t(dp),
                                           sweeps=sweeps, adaptive=adaptive)
    ref = jconvection.convective_adjustment(
        jnp.asarray(tt), jnp.asarray(tp), jnp.asarray(dp), sweeps=sweeps,
        adaptive=adaptive)
    assert not np.array_equal(out.numpy(), tt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=0.0)
    np.testing.assert_allclose((out.numpy() * dp).sum(0),
                               (tt * dp).sum(0), rtol=1e-13)


def test_adaptive_convection_reaches_the_fixed_sweep_point():
    """The adaptive form stops at the first sweep that changed nothing; a
    sweep over a converged field is the identity, so 2L fixed sweeps give
    the same field."""
    tt, tp, dp = _unstable_column(4)
    a = convection.convective_adjustment(_t(tt), _t(tp), _t(dp))
    b = convection.convective_adjustment(_t(tt), _t(tp), _t(dp),
                                         adaptive=False)
    assert torch.equal(a, b)


def _physics_state(jg, seed):
    p, u, v, t, q = random_state(jg, seed)
    rng = np.random.default_rng(seed + 100)
    gt = 290.0 + 20.0 * rng.random(p.shape)
    zeros = np.zeros_like(gt)
    return (p, u, v, t, q), (gt, zeros, zeros + 0.01, zeros)


@pytest.mark.parametrize("cfg", [
    dict(physics=True),
    dict(physics=True, convection=True, seasonal=True, drag_tau=86400.0),
    dict(drag_tau=3600.0, physics_every=3),
])
def test_physics_extras_match_jax(cfg):
    jg = _jgeom(3, 16, 128)
    prog, ground = _physics_state(jg, 5)
    utc = 3.3e4
    port = driver.physics_extras(
        PrognosticVars(*as_torch(prog)), GroundVars(*as_torch(ground)),
        _t(utc), port_geom(jg), ModelConfig(dtype="float64", **cfg), 900.0)
    ref = jdriver.physics_extras(
        JPrognosticVars(*as_jax(prog)), JGroundVars(*as_jax(ground)),
        jnp.asarray(utc), jg, JModelConfig(dtype="float64", **cfg), 900.0)
    assert_close(port[0], ref[0], 1e-12, 1e-12, FIELDS)
    assert_close(port[1], ref[1], 1e-13, 0.0, port[1]._fields)


@pytest.mark.parametrize("step_next,granularity", [(4, 1), (5, 1), (8, 4),
                                                   (6, 4)])
def test_apply_cadenced_extras_matches_jax(step_next, granularity):
    """physics_every=4: due when a multiple of 4 falls in the window
    (step_next - granularity, step_next], keyed on the step counter
    tensor the runs carry."""
    jg = _jgeom(3, 16, 128)
    prog, ground = _physics_state(jg, 6)
    cfg = dict(physics=True, physics_every=4, drag_tau=86400.0,
               dtype="float64")
    utc = 1.2e4
    ref = jdriver.apply_cadenced_extras(
        JPrognosticVars(*as_jax(prog)), JGroundVars(*as_jax(ground)),
        jnp.asarray(utc), jnp.asarray(step_next, jnp.int32), jg,
        JModelConfig(**cfg), granularity=granularity)
    port = driver.apply_cadenced_extras(
        PrognosticVars(*as_torch(prog)), GroundVars(*as_torch(ground)),
        _t(utc), torch.tensor(step_next, dtype=torch.int32), port_geom(jg),
        ModelConfig(**cfg), granularity=granularity)
    assert_close(port[0], ref[0], 1e-12, 1e-12, FIELDS)
    assert_close(port[1], ref[1], 1e-13, 0.0, port[1]._fields)
    due = step_next % 4 < granularity
    assert np.array_equal(np.asarray(ref[1].gt), ground[0]) != due


def test_solar_timestep_matches_the_oracle():
    jg = _jgeom(5, 8, 12)
    prog, ground = _physics_state(jg, 8)
    cfg = ModelConfig(physics=True, dtype="float64")
    t_n, g = driver.solar_timestep(
        _t(prog[3]), _t(prog[0]), GroundVars(*as_torch(ground)), 600.0,
        _t(1800.0), port_geom(jg), cfg)
    ref = rad_np.solar_timestep_np(prog[3], prog[0], ground[0], 600.0,
                                   1800.0, cfg.t_lw, cfg.t_sw, cfg.albedo, jg)
    assert_close((t_n, g.gt), ref, 1e-11, 1e-11, ("t", "gt"))


@pytest.mark.parametrize("backend,steps,cfg", [
    ("xla", 6, dict(physics=True, drag_tau=86400.0)),
    ("xla", 5, dict(physics=True, convection=True, seasonal=True,
                    physics_every=2)),
    ("mega4", 4, dict(physics=True, drag_tau=86400.0, convection=True)),
    ("mega4", 3, dict(drag_tau=7200.0, physics_every=2)),
])
def test_run_model_with_physics_matches_jax(backend, steps, cfg):
    args = (16, 128, 3, 900.0, steps)
    kw = dict(backend=backend, dtype="float64", **cfg)
    port = driver.run_model(*args, config=ModelConfig(**kw), device="cpu")
    ref = jdriver.run_model(*args, config=JModelConfig(**kw))
    assert_close(port[:5], ref[:5], 1e-10, 1e-10, FIELDS)
    assert_close(port[5], ref[5], 1e-12, 1e-12, port[5]._fields)
    assert_close(port[7], ref[7], 1e-10, 1e-10, port[7]._fields)
    moved = not np.array_equal(port[5].gt.numpy(), np.full((16, 128), 360.0))
    assert moved == cfg.get("physics", False)


def test_physics_run_matches_the_reference_oracle():
    """Five physics steps of the port on the plain core against the numpy
    oracle composed as the reference's full_timestep would (dynamics, then
    radiation at the step's starting clock): tests/test_radiation.py's
    end-to-end check, on the port."""
    from gcmiipy_tpu.oracle import numpy_ref
    from gcmiipy_tpu_torch.model.state import ModelState

    jg = jgeometry.gen_geometry(8, 12, 5, sig_func=jgeometry.manabe_sig)
    tg = port_geom(jg)
    cfg = ModelConfig(dt=600.0, physics=True, dtype="float64", stats=False)
    prog, ground = _physics_state(jg, 9)
    state = ModelState(PrognosticVars(*as_torch(prog)),
                       GroundVars(*as_torch(ground)), _t(0.0),
                       torch.tensor(0, dtype=torch.int32))
    filter_fn = driver.make_filter_fn(cfg, tg)
    for _ in range(5):
        state = driver.full_timestep(state, tg, cfg, filter_fn)
    o, gt = prog, ground[0]
    for i in range(5):
        o = numpy_ref.matsuno_timestep_np(*o, 600.0, jg)
        t_i, gt = rad_np.solar_timestep_np(o[3], o[0], gt, 600.0, i * 600.0,
                                           cfg.t_lw, cfg.t_sw, cfg.albedo, jg)
        o = (o[0], o[1], o[2], t_i, o[4])
    assert_close(state.prog, o, 1e-9, 1e-9, FIELDS)
    assert_close((state.ground.gt,), (gt,), 1e-10, 0.0, ("gt",))
    assert int(state.step) == 5 and float(state.utc) == 3000.0


def test_radiation_4band_is_not_ported():
    """radiation='4band' runs through run_model (the per-module and
    whole-run checks against JAX are in tests/test_torch_moist.py): finite,
    and its ground and air tendencies differ from the grey scheme's.  A
    cadence below 1 still raises."""
    runs = [driver.run_model(8, 8, 3, 1800.0, 2, device="cpu",
                             config=ModelConfig(physics=True, radiation=r,
                                                dtype="float64"))
            for r in ("4band", "grey")]
    assert all(torch.isfinite(x).all() for x in runs[0][:5])
    assert not torch.equal(runs[0][3], runs[1][3])
    assert not torch.equal(runs[0][5].gt, runs[1][5].gt)
    with pytest.raises(ValueError, match="physics_every"):
        driver.run_model(8, 8, 3, 1800.0, 1, device="cpu", config=ModelConfig(
            physics=True, physics_every=0))
