"""Run diagnostics: the blow-up guard's NaN sweep and the global water.

Port of ``gcmiipy_tpu/diagnostics.py:any_nan``: the reference's NaN sweep
(reference no_limits_2_5d.py:213), kept on the device as a bool tensor so a
guarded run needs no host sync per step.  :func:`global_water` is the
budget that the water cycle (evaporation and condensation) conserves.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.physics.condensation import RHO_WATER


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
