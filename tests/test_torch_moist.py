"""PyTorch port: the water cycle and the four-band radiation — evaporation
(``physics/evaporation.py``), condensation (``physics/condensation.py``),
``radiation.four_band_*``, ``ozone``, ``isa`` and
``humidity.vmr_from_mmr`` — against the JAX package at float64 on the CPU,
their conservation properties, and whole runs of the surface configuration
(Config S) from a cooled, supersaturated start on 'xla', 'mega4' and
'stream'.  Bounds: rtol 1e-12 for each module (the same operations in the
same order; sums over bands and layers in another order), 1e-12 for the
water budget, 1e-10 of each field's scale for whole runs
(tests/test_parity.py)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu import constants
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.physics import condensation as jcondensation
from gcmiipy_tpu.physics import evaporation as jevaporation
from gcmiipy_tpu.physics import humidity as jhumidity
from gcmiipy_tpu.physics import isa as jisa
from gcmiipy_tpu.physics import ozone as jozone
from gcmiipy_tpu.physics import radiation as jradiation
from gcmiipy_tpu.model.state import GroundVars as JGroundVars
from gcmiipy_tpu_torch.diagnostics import global_water
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import moist_start
from gcmiipy_tpu_torch.physics import (
    condensation, evaporation, humidity, isa, ozone, radiation)

from torch_port_helpers import (
    CONFIG_S, as_jax, as_torch, assert_close, assert_states_close,
    cooled_start, hansen_jgeom, port_geom, port_state)

torch.set_num_threads(1)
RTOL = 1e-12   # one module against its JAX function
RUN = 1e-10    # a whole run, of each field's scale


def _surface(seed, L=4, H=6, W=8, land=True):
    """A moist float64 column state on a Hansen grid: the JAX Geom, p, q, u,
    v, tt (true temperature), gt, gw, with some cells drier than the ground
    and some ground nearly dry."""
    rng = np.random.default_rng(seed)
    jg = hansen_jgeom(H, W, L, land_cover="hansen" if land else "none")
    p = 1e5 * (1 + 0.02 * rng.standard_normal((H, W)))
    tp = p[None] * np.asarray(jg.sig) + float(jg.ptop)
    tt = 270.0 + 25.0 * rng.random((L, H, W))
    ws = np.asarray(jhumidity.w_s_at(jnp.asarray(tp), jnp.asarray(tt)))
    q = ws * rng.uniform(0.3, 1.1, (L, H, W))
    u = 5.0 * rng.standard_normal((L, H, W))
    v = 5.0 * rng.standard_normal((L, H, W))
    gt = 275.0 + 20.0 * rng.random((H, W))
    gw = rng.choice([1e-7, 0.02, 0.3], (H, W)) * rng.random((H, W))
    return jg, p, q, u, v, tt, gt, gw


@pytest.mark.parametrize("land", [False, True])
def test_bulk_evaporation_matches_jax(land):
    """rtol 1e-12, with and without the land-fraction split."""
    jg, *args = _surface(1)
    lf = np.asarray(jg.land_fraction)
    out = evaporation.bulk_evaporation(
        *as_torch(args), port_geom(jg),
        land_fraction=torch.as_tensor(lf) if land else None)
    ref = jevaporation.bulk_evaporation(
        *as_jax(args), jg, land_fraction=jnp.asarray(lf) if land else None)
    out, ref = (out, ref) if land else ((out,), (ref,))
    assert_close(out, ref, RTOL, 0)
    assert float(out[0].max()) > 0


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("land", [False, True])
def test_evaporation_step_matches_jax_and_never_overdraws(land, capped):
    """rtol 1e-12; the step takes at most the water the ground holds, down
    to 0 (to rounding) where a 10-day step at full soil wetness (a field capacity of
    1e-6 m) would take more, and closes each column's water budget."""
    jg, p, q, u, v, tt, gt, gw = _surface(2)
    dt, kw = (10 * 86400.0, dict(gw_cap=1e-6)) if capped else (3600.0, {})
    lf = np.asarray(jg.land_fraction)
    out = evaporation.evaporation_step(
        *as_torch((p, q, u, v, tt, gt, gw)), dt, port_geom(jg),
        land_fraction=torch.as_tensor(lf) if land else None, **kw)
    ref = jevaporation.evaporation_step(
        *as_jax((p, q, u, v, tt, gt, gw)), dt, jg,
        land_fraction=jnp.asarray(lf) if land else None, **kw)
    assert_close(out, ref, RTOL, 0, ("q", "gt", "gw"))
    q_n, gt_n, gw_n = (x.numpy() for x in out)
    # the cap leaves gw - (gw rho / dt) / rho dt: 0 to the rounding of gw
    emptied = np.abs(gw_n) <= 1e-15 * gw.max()
    assert ((gw_n >= 0) | emptied).all() and (gw_n <= gw).all()
    assert (gw_n[~emptied] > 0).all() and emptied.any() == capped
    if not land:
        dsig0 = float(np.asarray(jg.dsig).reshape(-1)[0])
        gained = (q_n[0] - q[0]) * p * dsig0 / constants.G
        lost = (gw - gw_n) * evaporation.RHO_WATER
        np.testing.assert_allclose(gained, lost, rtol=1e-10, atol=1e-12)


def test_reference_evaporation_signature_raises():
    with pytest.raises(NotImplementedError, match="evaporation.py:5-9"):
        evaporation.evaporation(None, None, None, None, None)


def _supersaturated(seed=5, L=4, H=6, W=8):
    rng = np.random.default_rng(seed)
    jg = hansen_jgeom(H, W, L, topography="flat", land_cover="none")
    p = 1e5 * (1 + 0.01 * rng.standard_normal((H, W)))
    tp = p[None] * np.asarray(jg.sig)
    tt = 280.0 + 10.0 * rng.standard_normal((L, H, W))
    ws = np.asarray(jhumidity.w_s_at(jnp.asarray(tp), jnp.asarray(tt)))
    q = ws * rng.uniform(0.5, 1.8, size=ws.shape)
    t = tt * (constants.P0 / tp) ** constants.kappa
    gw = np.full((H, W), 0.01)
    return jg, p, tp, tt, t, q, gw


@pytest.mark.parametrize("rh_crit", [1.0, 0.8])
def test_saturation_adjustment_matches_jax(rh_crit):
    """rtol 1e-12."""
    jg, p, tp, tt, t, q, gw = _supersaturated()
    out = condensation.saturation_adjustment(*as_torch((tt, q, tp)),
                                             rh_crit=rh_crit)
    ref = jcondensation.saturation_adjustment(*as_jax((tt, q, tp)),
                                              rh_crit=rh_crit)
    assert_close(out, ref, RTOL, 1e-300, ("tt", "q", "dq"))
    assert condensation.N_NEWTON == jcondensation.N_NEWTON == 2


@pytest.mark.parametrize("rh_crit", [1.0, 0.8])
def test_condensation_step_matches_jax_and_closes_the_budget(rh_crit):
    """rtol 1e-12 against JAX; each column's water (atmosphere and bucket)
    closes to 1e-12 and cp dT = L dq cell by cell (the tolerance of
    tests/test_surface.py: the potential-temperature round trip leaves
    about 3e-11 K)."""
    jg, p, tp, tt, t, q, gw = _supersaturated()
    out = condensation.condensation_step(*as_torch((p, t, q, gw)),
                                         port_geom(jg), rh_crit=rh_crit)
    ref = jcondensation.condensation_step(*as_jax((p, t, q, gw)), jg,
                                          rh_crit=rh_crit)
    assert_close(out, ref, RTOL, 0, ("t", "q", "gw"))
    t_n, q_n, gw_n = (x.numpy() for x in out)
    dsig = np.asarray(jg.dsig)

    def col(qq):
        return np.sum(qq * p * dsig, axis=0) / constants.G
    np.testing.assert_allclose(col(q_n) + gw_n * condensation.RHO_WATER,
                               col(q) + gw * condensation.RHO_WATER,
                               rtol=1e-12)
    assert (gw_n - gw).max() > 0   # it rained
    tt_n = t_n / (constants.P0 / tp) ** constants.kappa
    np.testing.assert_allclose(constants.Cp * (tt_n - tt),
                               constants.lhv_water_0c * (q - q_n),
                               rtol=1e-7, atol=1e-8)


def _radiation_column(seed=0, L=9, H=6, W=8):
    rng = np.random.default_rng(seed)
    jg = hansen_jgeom(H, W, L, topography="flat", land_cover="none")
    p = 1e5 * (1 + 0.02 * rng.standard_normal((H, W)))
    tp = p * np.asarray(jg.sig) + float(jg.ptop)
    tt = 200.0 + 130.0 * rng.random((L, H, W))    # past the fits' range
    q = 10 ** rng.uniform(-6, -1.3, (L, H, W))   # the strong band opaque
    gt = 140.0 + 230.0 * rng.random((H, W))
    return jg, p, tp, tt, q, gt


def test_four_band_fractions_matches_jax():
    """rtol 1e-12 over 100-400 K (the fit variable clamped beyond
    [150, 350] K); the four bands sum to 1."""
    tt = np.linspace(100.0, 400.0, 301)
    out = radiation.four_band_fractions(torch.as_tensor(tt))
    ref = jradiation.four_band_fractions(jnp.asarray(tt))
    assert_close((out,), (ref,), RTOL, 1e-15)
    np.testing.assert_allclose(out.sum(0).numpy(), 1.0, rtol=1e-14)
    np.testing.assert_array_equal(radiation._BAND_POLYS,
                                  jradiation._BAND_POLYS)


def test_four_band_transmittances_matches_jax():
    """rtol 1e-12; the strong water-vapour band underflows to 0 where the
    air is wet, as in JAX."""
    jg, p, tp, tt, q, gt = _radiation_column()
    out = radiation.four_band_transmittances(torch.as_tensor(p),
                                             torch.as_tensor(q),
                                             port_geom(jg))
    ref = jradiation.four_band_transmittances(jnp.asarray(p),
                                              jnp.asarray(q), jg)
    assert out.shape == (4, 9, 6, 8)
    assert_close((out,), (ref,), RTOL, 0)
    assert float(out[0].min()) < 1e-30


@pytest.mark.parametrize("decl", [0.0, 0.3])
def test_four_band_radiation_matches_jax(decl):
    """rtol 1e-12 for dTdt and dt_ground (atol 1e-12 of dTdt's scale: sums
    over the bands and layers in another order), finite in opaque bands."""
    jg, p, tp, tt, q, gt = _radiation_column()
    albedo = 0.3 + 0.2 * np.asarray(jg.lat) ** 2
    utc = 3.3e4
    zeros = np.zeros_like(gt)
    out = radiation.four_band_radiation(
        *as_torch((p, tp, tt, q, gt)), 0.9, torch.as_tensor(albedo),
        torch.tensor(utc, dtype=torch.float64), port_geom(jg),
        declination=decl)
    ref = jradiation.four_band_radiation(
        *as_jax((p, tp, tt, q)), JGroundVars(*as_jax((gt, zeros, zeros,
                                                      zeros))),
        0.9, jnp.asarray(albedo), jnp.asarray(utc), jg, declination=decl)
    scale = float(np.abs(np.asarray(ref[0])).max())
    assert_close(out, ref, RTOL, 1e-12 * scale, ("dTdt", "dt_ground"))
    assert all(torch.isfinite(x).all() for x in out)


def test_mmr_from_vmr_and_vmr_from_mmr_match_jax():
    x = np.linspace(1e-6, 1e-2, 17)
    for port, ref in ((humidity.vmr_from_mmr, jhumidity.vmr_from_mmr),
                      (radiation.mmr_from_vmr, jradiation.mmr_from_vmr)):
        out = port(torch.as_tensor(x), constants.M_water, constants.Md)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(ref(jnp.asarray(x), constants.M_water,
                                        constants.Md)), rtol=RTOL, atol=0)
    for name in ("ABLWIN", "ABLCO2", "ABLWV1", "ABLWV2",
                 "FOUR_BAND_EDGES_CM"):
        assert getattr(radiation, name) == getattr(jradiation, name), name


@pytest.mark.parametrize("module", ["ozone", "isa"])
def test_profile_tables_match_jax(module):
    """ozone_at / temp_at: rtol 1e-12 inside the tables, their end values
    beyond them (np.interp's rule)."""
    port, ref, xp = {
        "ozone": (ozone.ozone_at, jozone.ozone_at, ozone.O_PRESSURE_PA),
        "isa": (isa.temp_at, jisa.temp_at, isa.ISA_PRESSURES_PA)}[module]
    rng = np.random.default_rng(7)
    p = np.concatenate([rng.uniform(0.0, 1.2e5, 500), xp, [0.0, 5e5]])
    out = port(torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref(jnp.asarray(p))),
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(out, np.interp(p, xp, port.__globals__[
        "O_VALUE" if module == "ozone" else "ISA_TEMPERATURES_K"]),
        rtol=RTOL, atol=0)


def _cooled_runs(steps, **cfg):
    """(port, JAX) ``make_run_fn`` results from JAX's cooled start at the
    config's grid, and the start's ground water."""
    jg = hansen_jgeom(cfg["height"], cfg["width"], cfg["layers"],
                      topography=cfg.get("topography", "flat"),
                      land_cover=cfg.get("land_cover", "none"),
                      giss_sige=cfg.get("giss_sige", False))
    jstate = cooled_start(jg, JModelConfig(**cfg))
    state = port_state(jstate)
    gw_start = state.ground.gw.clone()
    out = driver.make_run_fn(port_geom(jg), ModelConfig(**cfg), steps)(state)
    ref = jdriver.make_run_fn(jg, JModelConfig(**cfg), steps)(jstate)
    return out, ref, gw_start


@pytest.mark.parametrize("backend", ["xla", "mega4"])
def test_surface_config_matches_jax(backend):
    """Config S (Hansen terrain and land cover, four-band radiation,
    convection, evaporation, precipitation, the Shapiro filter of p and t
    every 4 steps, the physics every 2) at 24x36x9 on the GISS ladder, 8
    steps from the cooled start: within 1e-10 of each field's scale, gt
    and gw included; rain fell."""
    cfg = dict(CONFIG_S, backend=backend, giss_sige=True, height=24,
               width=36, layers=9, dt=900.0)
    out, ref, gw_start = _cooled_runs(8, **cfg)
    assert_states_close(out[0], ref[0], RUN)
    assert_close(out[1], ref[1], RUN, RUN, out[1]._fields)
    assert bool((out[0].ground.gw > gw_start).any())
    assert int(out[0].step) == 8


def test_surface_config_on_stream_matches_jax():
    """Config S's settings on 'stream' at 16x128x3 with stream_steps=4, the
    physics every 4 and the Shapiro filter every 2 (K = 2, the gcd): the
    between-call extras write back p, t and q (evaporation and rain) and
    match JAX's 'stream' within 1e-10 of each field's scale."""
    cfg = dict(CONFIG_S, backend="stream", stream_steps=4, physics_every=4,
               shapiro_every=2, height=16, width=128, layers=3, dt=300.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out, ref, gw_start = _cooled_runs(8, **cfg)
    assert_states_close(out[0], ref[0], RUN)
    assert_close(out[1], ref[1], RUN, RUN, out[1]._fields)
    assert out[1].total_energy.shape == (4,)   # one entry a K = 2 call
    assert bool((out[0].ground.gw > gw_start).any())


def test_water_is_conserved_without_land_cover():
    """Config S without the land cover (the ocean draws on ``gw`` too) on
    flat ground, 8 steps on 'mega4' from the cooled start: the global
    water, atmosphere plus ground, changes by less than 1e-5 relative, the
    bound of tests/test_surface.py (the evaporation and rain exchange
    closes to 1e-12 a step; what is left is the q advection's residual
    under the trapezoid areas), while rain and evaporation move ``gw``."""
    cfg = dict(CONFIG_S, land_cover="none", topography="flat",
               backend="mega4", giss_sige=True, height=24, width=36,
               layers=9, dt=900.0)
    jg = hansen_jgeom(24, 36, 9, topography="flat", land_cover="none",
                      giss_sige=True)
    state = port_state(cooled_start(jg, JModelConfig(**cfg)))
    tg = port_geom(jg)
    before = global_water(state, tg)
    out = driver.make_run_fn(tg, ModelConfig(**cfg), 8)(state)[0]
    after = global_water(out, tg)
    assert abs(float(after / before) - 1) < 1e-5
    assert float((out.ground.gw - state.ground.gw).abs().max()) > 1e-4


@pytest.mark.parametrize("land_cover", ["hansen", "none"])
def test_moist_start_rains_over_the_terrain(land_cover):
    """``state.moist_start`` over the Hansen terrain (Config S, and Config W
    without the land cover), 20 steps on 'stream' at 16x128x3, dt=30: the
    guard stays clean, rain falls in every cell, and the global water
    changes by less than 1e-5 (the bound of tests/test_surface.py)."""
    cfg = ModelConfig(**dict(CONFIG_S, land_cover=land_cover),
                      backend="stream", height=16, width=128, layers=3,
                      dt=30.0, guard=True)
    geom = driver.gen_model_geometry(cfg, "cpu")
    start = moist_start(driver.gen_model_state(geom, cfg), geom)
    state, _, guard = driver.make_run_fn(geom, cfg, 20)(start)
    assert bool(guard.ok)
    assert bool((state.ground.gw > start.ground.gw).all())
    change = float(global_water(state, geom) / global_water(start, geom))
    assert abs(change - 1) < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_surface_config_on_gpu_matches_the_cpu(cuda_device):
    """Config S's settings at float64 on 'stream' (K7 calls of 2 steps) and
    'mega4' (K6) on the card, 8 steps at 16x128x3 from
    ``state.moist_start``: the two equal each
    other to the bit and the CPU's plain versions within 1e-10 of each
    field's scale."""
    kw = dict(CONFIG_S, stream_steps=4, height=16, width=128, layers=3,
              dt=300.0)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        for backend in ("stream", "mega4"):
            cfg = ModelConfig(**kw, backend=backend)
            geom = driver.gen_model_geometry(cfg, device)
            start = moist_start(driver.gen_model_state(geom, cfg), geom)
            out[backend, device.type] = driver.make_run_fn(geom, cfg, 8)(
                start)[0]
    for a, b in zip(out["stream", "cuda"].prog, out["mega4", "cuda"].prog):
        assert torch.equal(a, b)
    for backend in ("stream", "mega4"):
        gpu, cpu = out[backend, "cuda"], out[backend, "cpu"]
        for a, b in zip(tuple(gpu.prog) + tuple(gpu.ground),
                        tuple(cpu.prog) + tuple(cpu.ground)):
            err = (a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)
            assert float(err) <= RUN, backend
