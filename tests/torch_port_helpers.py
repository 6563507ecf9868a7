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
