"""PyTorch port: the cloudy grey radiation schemes (``grey_solar``,
``grey_radiation`` and their parts, reference grey_solar.py:85-355),
against the JAX package at float64 on the CPU.

Inputs are the random but physical columns of JAX's
tests/test_radiation.py (clouds, day and night, cold and warm layers),
on a 9-layer column set (6x8, the Manabe sigma levels) and on 3x8x16.
Bound: ``REL`` = 1e-12 of each output's scale, index by index, for every
output (``dt_ground``, ``dt_air``, the TOA upwelling, the new potential
temperature and the downwelling levels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu import constants
from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model.state import GroundVars as JGroundVars
from gcmiipy_tpu.physics import radiation as jradiation
from gcmiipy_tpu_torch.model.state import GroundVars
from gcmiipy_tpu_torch.physics import radiation

from torch_port_helpers import port_geom

torch.set_num_threads(1)
REL = 1e-12
GRIDS = {"9x6x8": (6, 8, 9, jgeometry.manabe_sig),
         "3x8x16": (8, 16, 3, None)}


def _jgeom(grid):
    H, W, L, sig_func = GRIDS[grid]
    if sig_func is None:
        return jgeometry.gen_geometry(H, W, L)
    return jgeometry.gen_geometry(H, W, L, sig_func=sig_func)


def _column(jg, seed):
    """(p, tt, t, q, gt) as numpy float64: JAX's _random_column recipe."""
    rng = np.random.default_rng(seed)
    L, H, W = jg.layers, jg.height, jg.width
    p = 1e5 * (1 + 0.02 * rng.standard_normal((H, W)))
    tp = p[None] * np.asarray(jg.sig) + float(jg.ptop)
    tt = 260.0 + 60.0 * rng.random((L, H, W))
    t = tt * (constants.P0 / tp) ** constants.kappa
    q = 10.0 ** rng.uniform(-5, -2, (L, H, W))
    gt = 270.0 + 50.0 * rng.random((H, W))
    return p, tt, t, q, gt


def _close(got, ref, what):
    for k, (a, b) in enumerate(zip(got, ref)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, (what, k)
        assert np.isfinite(a).all(), (what, k)
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        assert err <= REL * scale, (what, k, err, scale)


def _ground(gt, mod):
    zero = np.zeros_like(gt)
    if mod is radiation:
        return GroundVars(*(torch.as_tensor(x) for x in (gt, zero, zero, zero)))
    return JGroundVars(*(jnp.asarray(x) for x in (gt, zero, zero, zero)))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_hansen_cloud_thickness_and_absorbance_match_jax(grid):
    """The cloud thickness on the columns' layer pressures and true
    temperatures (25 K colder, so that some layers are below 258 K), and
    the absorbance of the shortwave gases."""
    jg = _jgeom(grid)
    p, tt, t, q, gt = _column(jg, 1)
    tp = p[None] * np.asarray(jg.sig) + float(jg.ptop)
    rho = tp / (constants.Rd * tt)
    got = [radiation.hansen_cloud_thickness(torch.as_tensor(tp),
                                            torch.as_tensor(tt - 25.0))]
    ref = [jradiation.hansen_cloud_thickness(jnp.asarray(tp),
                                             jnp.asarray(tt - 25.0))]
    assert (ref[0] == 1.0 / 3.0).any() and (ref[0] > 1.0 / 3.0).any()
    for gasses in ([], [(q, 0.125), (radiation.co2_mmr, 1.0)]):
        got.append(radiation.compute_absorbance(
            [(torch.as_tensor(g) if isinstance(g, np.ndarray) else g, w)
             for g, w in gasses], torch.as_tensor(rho),
            torch.as_tensor(100.0 * tt)))
        ref.append(jradiation.compute_absorbance(
            [(jnp.asarray(g), w) for g, w in gasses], jnp.asarray(rho),
            jnp.asarray(100.0 * tt)))
    np.testing.assert_array_equal(got[1].numpy(), 0.0)
    _close(got[:1] + got[2:], ref[:1] + ref[2:], grid)


def test_constants_match_jax():
    for name in ("co2_mmr", "h2o_weight", "co2_weight",
                 "co2_sw_weight", "ozone_weight"):
        assert getattr(radiation, name) == getattr(jradiation, name), name


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("c", [0.0, 0.4])
def test_grey_solar_matches_jax(grid, c):
    """grey_solar's new potential temperature and its L+1 downwelling
    levels, level by level (the reversed sweep's output order)."""
    jg = _jgeom(grid)
    g = port_geom(jg)
    p, tt, t, q, gt = _column(jg, 2)
    t_n, dw = radiation.grey_solar(*(torch.as_tensor(x) for x in (p, q, t)),
                                   c, torch.as_tensor(gt), 0.0, 600.0, g)
    jt_n, jdw = jradiation.grey_solar(*(jnp.asarray(x) for x in (p, q, t)),
                                      c, jnp.asarray(gt), 0.0, 600.0, jg)
    assert dw.shape == (jg.layers + 1, jg.height, jg.width)
    _close((t_n, dw), (jt_n, jdw), grid)
    if c == 0.0:  # clear sky: the SW flux only falls going down
        assert (torch.diff(dw, dim=0) >= -1e-9).all()


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("c", [0.0, 0.3, 1.0])
def test_grey_radiation_matches_jax(grid, c):
    """grey_radiation's dt_ground, dt_air and TOA upwelling."""
    jg = _jgeom(grid)
    g = port_geom(jg)
    p, tt, t, q, gt = _column(jg, 3)
    got = radiation.grey_radiation(
        *(torch.as_tensor(x) for x in (p, q, tt)), c, _ground(gt, radiation),
        None, 600.0, g)
    ref = jradiation.grey_radiation(
        *(jnp.asarray(x) for x in (p, q, tt)), c, _ground(gt, jradiation),
        None, 600.0, jg)
    _close(got, ref, grid)
    assert (got[2] > 0).all()


@pytest.mark.parametrize("c", [0.0, 0.7])
def test_sw_cloud_sweep_matches_jax(c):
    """The shortwave sweep alone: the level below each layer, the absorbed
    per layer and the reflected total."""
    rng = np.random.default_rng(4)
    L, shape = 9, (5, 7)
    top = 300.0 + rng.random(shape)
    trans, t_cloud, albedo = (rng.random((L,) + shape) for _ in range(3))
    got = radiation._sw_cloud_sweep(
        *(torch.as_tensor(x) for x in (top, trans, t_cloud, albedo)), c)
    ref = jradiation._sw_cloud_sweep(
        *(jnp.asarray(x) for x in (top, trans, t_cloud, albedo)), c)
    _close(got, ref, "sweep")


def test_basic_3_gas_absorbance_matches_jax():
    jg = _jgeom("9x6x8")
    p, tt, t, q, gt = _column(jg, 5)
    tp = p[None] * np.asarray(jg.sig) + float(jg.ptop)
    rho = tp / (constants.Rd * tt)
    got = radiation.basic_3_gas_absorbance(
        *(torch.as_tensor(x) for x in (p, tp, tt, rho, q)), port_geom(jg))
    ref = jradiation.basic_3_gas_absorbance(
        *(jnp.asarray(x) for x in (p, tp, tt, rho, q)), jg)
    np.testing.assert_array_equal(got[1].numpy(), 0.0)
    _close(got[:1], ref[:1], "basic_3_gas")


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grey_radiation_budget_closes(grid):
    """Column energy conservation on the port alone: the air's and the
    ground's heating equal the net flux in at the boundaries (the incoming
    SW minus the cloud-reflected SW, the ground's SW albedo leak and the
    TOA LW escape), as JAX's test_grey_radiation_budget_closes checks."""
    jg = _jgeom(grid)
    g = port_geom(jg)
    p, tt, t, q, gt = (torch.as_tensor(x) for x in _column(jg, 4))
    c = 0.3
    dtg, dta, toa = radiation.grey_radiation(
        p, q, tt, c, _ground(gt.numpy(), radiation), None, 600.0, g)
    # the shortwave sweep's reflected total and ground flux, from the same
    # inputs
    tp = p * g.sig + g.ptop
    rho = tp / (constants.Rd * tt)
    depth = p * g.dsig / (rho * constants.G)
    sw_abs = radiation.compute_absorbance(
        [(q, radiation.h2o_weight), (radiation.co2_mmr,
                                     radiation.co2_sw_weight)], rho, depth)
    albedo = (1 - torch.exp(-radiation.hansen_cloud_thickness(tp, tt))) * 0.7
    irradiance = 2 * 41840.0 / 60.0 * 0.5 * 0.5
    levels, _, reflected = radiation._sw_cloud_sweep(
        torch.full_like(p, irradiance), torch.pow(10.0, -sw_abs),
        torch.pow(10.0, -(sw_abs * 1.66)), albedo, c)
    air_heat = torch.sum(constants.Cp * rho * depth * dta, dim=0)
    ground_heat = constants.Cg * 0.1 * dtg
    net_in = irradiance - reflected - 0.1 * levels[0] - toa
    np.testing.assert_allclose((air_heat + ground_heat).numpy(),
                               net_in.numpy(), rtol=1e-10, atol=1e-8)

