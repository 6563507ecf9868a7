"""Run diagnostics: total variation, the Courant number, the safe division,
the blow-up guard's NaN sweep and the global water.

Port of ``gcmiipy_tpu/diagnostics.py`` (the unit-aware helpers of reference
constants.py:105-121 and the reference's NaN sweep, no_limits_2_5d.py:213).
Every result is a tensor on its inputs' device, 0-dim for the reductions,
so that a guarded run needs no host sync per step.  :func:`global_water` is
the budget that the water cycle (evaporation and condensation) conserves.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.physics.condensation import RHO_WATER


def get_total_variation(q):
    """Sum of |q_{i+1} - q_i| along the leading axis (reference constants.py:105-108)."""
    diff = q - torch.roll(q, -1, dims=0)
    return torch.sum(torch.abs(diff))


def courant_number(p, u, dx, dt):
    """(max u + sqrt(mean(p) g)) dt / dx (reference constants.py:111-112), a
    0-dim tensor.  For shallow water ``p`` is the height field, so
    sqrt(p g) is the gravity-wave speed."""
    return (torch.max(u) + torch.sqrt(torch.mean(p) * constants.G)) * dt / dx


def safe_div(a, b):
    """a/b with 0 where b == 0 (reference constants.py:115-117); the inner
    select keeps b = 0 out of the division."""
    nz = b != 0
    return torch.where(nz, a / torch.where(nz, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def potential_temp_to_temp(p, t):
    """Potential -> true temperature (reference constants.py:120-121)."""
    return t / (constants.P0 / p) ** constants.kappa


def any_nan(*tensors):
    """0-dim bool tensor: True if any tensor contains a NaN."""
    out = torch.isnan(tensors[0]).any()
    for x in tensors[1:]:
        out = out | torch.isnan(x).any()
    return out


def global_water(state, geom):
    """The water of the whole grid [kg], atmosphere and ground, summed in
    float64: ``sum q dp area / g + sum gw rho_water area`` with the layer
    mass ``dp = p dsig``."""
    p = state.prog.p.double()
    area = geom.area.double()
    atm = torch.sum(state.prog.q.double() * p * geom.dsig.double() * area)
    ground = torch.sum(state.ground.gw.double() * area) * RHO_WATER
    return atm / constants.G + ground
