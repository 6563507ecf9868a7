"""Shared inputs for the PyTorch port's parity tests.

Inputs are made with numpy from a seed and handed to both packages: the JAX
package as jnp arrays, the port as CPU tensors, always at float64.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from gcmiipy_tpu import constants
from gcmiipy_tpu_torch.convert import geom_from_jax_numpy, state_from_jax_numpy

FIELDS = "puvtq"
# The kernels against the float64 banded DFT on the stacked forces and the
# fields after them: above its own rounding on the cancelling polar rows,
# which reached 2.46e-11 of a field's scale at 3x512x1024 and 5e-11 at
# width 2048 on the card, and far below a float32 result's 3.6e-8
# (chip_smoke.py's BANDED_REL64)
BANDED_REL64 = 1e-10


def geom_dict(jgeom):
    """The JAX Geom's fields as ints and numpy arrays."""
    return {f.name: getattr(jgeom, f.name) if f.metadata.get("static")
            else np.asarray(getattr(jgeom, f.name))
            for f in dataclasses.fields(jgeom)}


def port_geom(jgeom):
    """The port's CPU Geom carrying exactly the JAX Geom's arrays."""
    return geom_from_jax_numpy(geom_dict(jgeom), device="cpu")


def state_dict(jstate):
    """A JAX ModelState as ``{field: numpy array}``."""
    return {**{k: np.asarray(v) for k, v in jstate.prog._asdict().items()},
            **{k: np.asarray(v) for k, v in jstate.ground._asdict().items()},
            "utc": np.asarray(jstate.utc), "step": np.asarray(jstate.step)}


def port_state(jstate):
    return state_from_jax_numpy(state_dict(jstate), device="cpu")


def random_state(jgeom, seed=0):
    """(p, u, v, t, q) as float64 numpy arrays: the recipe of
    tests/test_pallas_fused.py:_initial."""
    rng = np.random.default_rng(seed)
    L, H, W = jgeom.layers, jgeom.height, jgeom.width
    p = 1e5 * (1 + 1e-3 * rng.standard_normal((H, W)))
    u = 0.5 * rng.standard_normal((L, H, W))
    v = 0.5 * rng.standard_normal((L, H, W))
    tp = p[None] * np.asarray(jgeom.sig) + float(jgeom.ptop)
    t = ((300 + 5 * rng.standard_normal((L, H, W)))
         * (constants.P0 / tp) ** constants.kappa)
    q = 1e-5 * (1 + 0.1 * rng.random((L, H, W)))
    return p, u, v, t, q


def as_jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def as_torch(arrays):
    return tuple(torch.as_tensor(np.array(a)) for a in arrays)


def assert_close(port, ref, rtol, atol, names=None):
    """Each port tensor against its JAX/numpy reference."""
    assert len(port) == len(ref)
    for n, (a, b) in enumerate(zip(port, ref)):
        name = names[n] if names else str(n)
        np.testing.assert_allclose(
            np.asarray(a.detach().cpu() if torch.is_tensor(a) else a),
            np.asarray(b), rtol=rtol, atol=atol, err_msg=f"field {name}")


# The surface configuration (Config S of chip_smoke.py's phase 'surface'):
# Hansen terrain and land cover, four-band radiation, convection, the water
# cycle, a one-day drag and the Shapiro filter of p and t, with the physics
# every 2nd step
CONFIG_S = dict(topography="hansen", land_cover="hansen", physics=True,
                convection=True, radiation="4band", evaporation=True,
                gw0=0.05, precipitation=True, rh_crit=0.8,
                drag_tau=86400.0, shapiro_every=4, shapiro_fields="pt",
                physics_every=2, dtype="float64")


def hansen_jgeom(height, width, layers, topography="hansen",
                 land_cover="hansen", giss_sige=False):
    """The JAX Geom that the JAX ``run_model`` builds for these settings, at
    float64."""
    from gcmiipy_tpu.grid import geometry as jgeometry
    from gcmiipy_tpu.grid import topography as jtopography
    maps = dict(
        heightmap=(jtopography.resample_map(jtopography.TOPOGRAPHY_M, height,
                                            width)
                   if topography == "hansen" else None),
        land_fraction=(jtopography.resample_map(jtopography.LAND_COVER,
                                                height, width)
                       if land_cover == "hansen" else None))
    if giss_sige:
        g = jgeometry.gen_geometry(height, width, layers,
                                   sige_table=jgeometry.GISS_SIGE,
                                   ptop=1000.0, **maps)
    else:
        g = jgeometry.gen_geometry(height, width, layers,
                                   sig_func=jgeometry.manabe_sig, **maps)
    return g.astype(np.float64)


def cooled_start(jgeom, jconfig):
    """The JAX ``gen_model_state`` start cooled to 280 K (air and ground)
    with q = 1.2 w_s, so that rain must fall (the recipe of
    tests/test_surface.py:test_precipitation_run_closes_water_cycle; the
    reference's 360 K start is a steam bath where no cell reaches
    ``rh_crit``)."""
    from gcmiipy_tpu.model import driver as jdriver
    from gcmiipy_tpu.physics import humidity as jhumidity
    s = jdriver.gen_model_state(jgeom, jdriver.normalize_config(jconfig))
    tp = (np.asarray(s.prog.p)[None] * np.asarray(jgeom.sig)
          + float(jgeom.ptop))
    tt = np.full_like(tp, 280.0)
    t = tt * (constants.P0 / tp) ** constants.kappa
    q = 1.2 * np.asarray(jhumidity.w_s_at(jnp.asarray(tp), jnp.asarray(tt)))
    return s._replace(
        prog=s.prog._replace(t=jnp.asarray(t), q=jnp.asarray(q)),
        ground=s.ground._replace(gt=jnp.full_like(s.ground.gt, 280.0)))


def assert_states_close(port, ref, bound):
    """Port ModelState against a JAX one: each prognostic and gt, gw within
    ``bound`` of the JAX field's scale (max |a - b| / max |b|)."""
    pairs = list(zip(port.prog, ref.prog)) + [
        (port.ground.gt, ref.ground.gt), (port.ground.gw, ref.ground.gw)]
    for name, (a, b) in zip(list(FIELDS) + ["gt", "gw"], pairs):
        a, b = a.detach().cpu().numpy(), np.asarray(b)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= bound, (name, err)
