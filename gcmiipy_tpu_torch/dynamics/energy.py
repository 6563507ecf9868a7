"""Energy diagnostics for the 2.5D core.

Port of ``gcmiipy_tpu/dynamics/energy.py:calc_energy`` (reference
no_limits_2_5d.py:35-60): kinetic + available-thermal + geopotential energy,
each column-integrated over true air mass.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops.stencil import imh, jmh
from gcmiipy_tpu_torch.physics import thermo


def calc_energy(p, u, v, t, q, geom):
    """Return (ke, ate, geo, total) in Joules as 0-dim tensors."""
    dt_ = t.dtype
    sig, dsig = geom.sig.to(dt_), geom.dsig.to(dt_)
    ptop, area = geom.ptop.to(dt_), geom.area.to(dt_)

    mag2 = imh(u) ** 2 + jmh(v) ** 2

    tp = p * sig + ptop
    tt = thermo.to_true_temp(t, tp)
    rho = tp / (constants.Rd * tt)
    dp = p * dsig
    depth = dp / (rho * constants.G)

    airmass = rho * depth * area
    total_depth = torch.cumsum(depth, dim=0)
    geo = torch.sum(total_depth * airmass * constants.G)
    ke = torch.sum(mag2 * 0.5 * airmass)
    ate = torch.sum(tt * constants.Cp * airmass)
    return ke, ate, geo, ke + ate + geo
