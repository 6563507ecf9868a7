"""Carry the JAX package's geometry and state across to the port.

The JAX ``Geom`` and ``ModelState`` are handed over as plain numpy arrays
(``{field name: array}``), so this module needs nothing of JAX.  The tests
use it to feed both packages identical inputs.
"""

import numpy as np
import torch

from gcmiipy_tpu_torch.device import resolve_device
from gcmiipy_tpu_torch.grid.geometry import STATIC_FIELDS, Geom
from gcmiipy_tpu_torch.model.state import (
    GroundVars, ModelState, PrognosticVars)


def _tensor(x, device, dtype=None):
    t = torch.as_tensor(np.array(x, order="C")).to(device)
    return t if dtype is None else t.to(dtype)


def geom_from_jax_numpy(d, device="cuda", dtype=None):
    """Port ``Geom`` from the JAX ``Geom``'s fields as numpy arrays
    (``height``/``width``/``layers`` as ints).  ``dtype`` casts every array;
    None keeps the arrays' own dtype."""
    device = resolve_device(device)
    return Geom(**{k: int(d[k]) for k in STATIC_FIELDS}, **{
        k: _tensor(v, device, dtype) for k, v in d.items()
        if k not in STATIC_FIELDS})


def state_from_jax_numpy(d, device="cuda"):
    """Port ``ModelState`` from the JAX ``ModelState``'s fields as numpy
    arrays: keys ``p u v t q`` (prognostics), ``gt gw snow ice`` (ground),
    ``utc`` and ``step``."""
    device = resolve_device(device)
    prog = PrognosticVars(*(_tensor(d[k], device)
                            for k in PrognosticVars._fields))
    ground = GroundVars(*(_tensor(d[k], device) for k in GroundVars._fields))
    return ModelState(prog, ground, _tensor(d["utc"], device),
                      _tensor(d["step"], device, torch.int32))
