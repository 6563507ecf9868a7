"""Large-scale condensation and precipitation (a GCM-II CONDSE analog).

Port of ``gcmiipy_tpu/physics/condensation.py``.  For each cell with
``q > rh_crit * w_s(T, p)`` an enthalpy-conserving saturation adjustment
condenses the excess:

    dq = (q - rh_crit w_s) / (1 + rh_crit L^2 w_s / (Cp Rv T^2))
    T += (L / Cp) dq ,   q -= dq

(the Newton step of ``q - rh_crit w_s(T + L dq / Cp) = 0`` with the
Clausius-Clapeyron slope), twice.  The condensate falls at once into the
ground-water bucket, ``gw += sum_k dq_k dp_k / (g rho_water)``, so the
column total ``sum_k q dp_k / g + gw rho_water`` is conserved to rounding.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.physics import humidity

RHO_WATER = 1000.0   # [kg/m^3], the constant evaporation uses

N_NEWTON = 2


def saturation_adjustment(tt, q, tp, rh_crit=1.0):
    """Condense supersaturation at fixed pressure; returns ``(tt_n, q_n,
    dq)``: ``tt`` true temperature [K], ``q`` mixing ratio, ``tp`` layer
    pressure [Pa], all broadcastable; ``dq >= 0`` the condensed water per
    unit mass."""
    lv = constants.lhv_water_0c
    cp = constants.Cp
    tt_n, q_n = tt, q
    for _ in range(N_NEWTON):
        ws = rh_crit * humidity.w_s_at(tp, tt_n)
        excess = q_n - ws
        slope = lv * ws / (constants.Rv * tt_n * tt_n)
        dq = torch.clamp(excess, min=0.0) / (1.0 + lv / cp * slope)
        q_n = q_n - dq
        tt_n = tt_n + lv / cp * dq
    return tt_n, q_n, q - q_n


def condensation_step(p, t, q, gw, geom, rh_crit=1.0):
    """One large-scale condensation step: ``p`` (H,W) surface pressure less
    ptop, ``t`` (L,H,W) potential temperature, ``q`` mixing ratio, ``gw``
    (H,W) ground water [m].  Returns ``(t_n, q_n, gw_n)``; conserves each
    column's enthalpy and its water, atmosphere and bucket."""
    sig = geom.sig.to(t.dtype)
    dsig = geom.dsig.to(t.dtype)
    ptop = geom.ptop.to(t.dtype)
    tp = p * sig + ptop
    exner_inv = (constants.P0 / tp) ** constants.kappa
    tt = t / exner_inv
    tt_n, q_n, dq = saturation_adjustment(tt, q, tp, rh_crit=rh_crit)
    precip = torch.sum(dq * p * dsig, dim=0) / constants.G   # [kg/m^2]
    gw_n = gw + precip / RHO_WATER
    return tt_n * exner_inv, q_n, gw_n
