"""PyTorch port: geometry, initial state, stencils and the polar filter
against the JAX package, at float64 on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import state as jstate
from gcmiipy_tpu.ops import limiters as jlimiters
from gcmiipy_tpu.ops import polar_filter as jpolar
from gcmiipy_tpu.ops import stencil as jstencil
from gcmiipy_tpu.physics import humidity as jhumidity
from gcmiipy_tpu.physics import thermo as jthermo
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model import state
from gcmiipy_tpu_torch.ops import limiters, polar_filter, stencil
from gcmiipy_tpu_torch.physics import humidity, thermo

from torch_port_helpers import as_jax, as_torch, port_geom, random_state

torch.set_num_threads(1)

GRIDS = {
    "giss_24x36x9": dict(height=24, width=36, layers=9,
                         sige_table=jgeometry.GISS_SIGE, ptop=1000.0),
    "manabe_16x128x3": dict(height=16, width=128, layers=3,
                            sig_func="manabe"),
}


def _geoms(name):
    kw = dict(GRIDS[name])
    if kw.pop("sig_func", None) == "manabe":
        jg = jgeometry.gen_geometry(**kw, sig_func=jgeometry.manabe_sig)
        tg = geometry.gen_geometry(**kw, sig_func=geometry.manabe_sig,
                                   device="cpu")
    else:
        jg = jgeometry.gen_geometry(**kw)
        tg = geometry.gen_geometry(**kw, device="cpu")
    return jg, tg


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_geometry_matches_jax(grid):
    jg, tg = _geoms(grid)
    for f in dataclasses.fields(jg):
        a, b = getattr(tg, f.name), getattr(jg, f.name)
        if f.metadata.get("static"):
            assert a == b, f.name
            continue
        assert a.dtype == torch.float64 and a.device.type == "cpu"
        assert tuple(a.shape) == np.shape(b), f.name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=f.name)


def test_geometry_float32_cast_matches_jax_astype():
    jg = jgeometry.gen_geometry(16, 128, 3).astype(np.float32)
    tg = geometry.gen_geometry(16, 128, 3, dtype=torch.float32, device="cpu")
    for name in ("dx_j", "polar_mask", "sig", "dy", "area"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_initial_conditions_match_jax(grid):
    jg, tg = _geoms(grid)
    jprog, jground = jstate.gen_initial_conditions(jg, dtype=jnp.float64)
    tprog, tground = state.gen_initial_conditions(tg, dtype=torch.float64)
    for name, a, b in zip(tprog._fields + tground._fields,
                          tprog + tground, jprog + jground):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_sigma_ladder_validation():
    with pytest.raises(ValueError):
        geometry.gen_geometry(4, 8, 3, sige_table=jgeometry.GISS_SIGE,
                              device="cpu")
    np.testing.assert_array_equal(geometry.GISS_SIGE, jgeometry.GISS_SIGE)


@pytest.mark.parametrize("name", ["ip", "im", "ipj", "imj", "ijp", "ijm",
                                  "kp", "km", "kph", "kmh", "iph", "imh",
                                  "jph", "jmh"])
def test_stencil_ops_match_jax(name):
    x = np.random.default_rng(1).standard_normal((3, 5, 7))
    np.testing.assert_array_equal(
        getattr(stencil, name)(torch.as_tensor(x)).numpy(),
        np.asarray(getattr(jstencil, name)(jnp.asarray(x))))


def test_gradients_and_limiter_match_jax():
    rng = np.random.default_rng(2)
    q, f = rng.standard_normal((2, 3, 5, 7))
    np.testing.assert_allclose(
        stencil.gradi(torch.as_tensor(q), 3.0).numpy(),
        np.asarray(jstencil.gradi(jnp.asarray(q), 3.0)), rtol=1e-15)
    np.testing.assert_allclose(
        stencil.gradj(torch.as_tensor(q), 3.0).numpy(),
        np.asarray(jstencil.gradj(jnp.asarray(q), 3.0)), rtol=1e-15)
    np.testing.assert_array_equal(
        limiters.gcm2_limit_flux(torch.as_tensor(f), torch.as_tensor(q)).numpy(),
        np.asarray(jlimiters.gcm2_limit_flux(jnp.asarray(f), jnp.asarray(q))))


@pytest.mark.parametrize("width", [36, 37, 128])
def test_polar_filter_matches_jax(width):
    jg = jgeometry.gen_geometry(12, width, 3)
    tg = port_geom(jg)
    x = np.random.default_rng(width).standard_normal((3, 12, width))
    np.testing.assert_allclose(
        polar_filter.arakawa_1977(torch.as_tensor(x), tg).numpy(),
        np.asarray(jpolar.arakawa_1977(jnp.asarray(x), jg)),
        rtol=1e-12, atol=1e-12)


def test_thermo_humidity_match_jax():
    jg = jgeometry.gen_geometry(8, 8, 3)
    p, _, _, t, q = random_state(jg, seed=4)
    tp = p[None] * np.asarray(jg.sig)
    tt = np.asarray(jthermo.to_true_temp(jnp.asarray(t), jnp.asarray(tp)))
    pairs = [
        (thermo.to_true_temp, jthermo.to_true_temp, (t, tp)),
        (thermo.to_potential_temp, jthermo.to_potential_temp, (tt, tp)),
        (thermo.to_density, jthermo.to_density, (tt, tp)),
        (thermo.exbyk, jthermo.exbyk, (tp,)),
        (thermo.thbar, jthermo.thbar, (t, np.roll(t, 1, axis=0))),
        (humidity.w_s_at, jhumidity.w_s_at, (tp, tt)),
        (humidity.rh_to_mmr, jhumidity.rh_to_mmr, (0.5 + 0 * tt, tp, tt)),
        (humidity.mmr_to_rh, jhumidity.mmr_to_rh, (q, tp, tt)),
    ]
    for fn, jfn, args in pairs:
        np.testing.assert_allclose(fn(*as_torch(args)).numpy(),
                                   np.asarray(jfn(*as_jax(args))),
                                   rtol=1e-12, err_msg=fn.__name__)


def test_geom_to_casts_every_tensor():
    tg = geometry.gen_geometry(8, 8, 3, device="cpu").to(dtype=torch.float32)
    for f in dataclasses.fields(tg):
        if f.name not in geometry.STATIC_FIELDS:
            assert getattr(tg, f.name).dtype == torch.float32, f.name
