"""Surface evaporation: bulk-aerodynamic latent flux into the lowest layer.

Port of ``gcmiipy_tpu/physics/evaporation.py``.  The reference declares
this component with an empty body (reference ``evaporation.py:5-9``); the
JAX package implements the standard bulk equation its docstring names:

    E = beta * rho_1 * C_E * |U_1| * (w_s(T_g, p_s) - q_1)    [kg m^-2 s^-1]

with ``beta = min(gw / gw_field_capacity, 1)`` the soil-wetness factor,
``rho_1``/``q_1``/``|U_1|`` the lowest layer's density, specific humidity
and wind speed (with a gustiness floor), and ``w_s`` the Buck saturation
mixing ratio at the ground temperature.  The lowest layer gains
``E g / dp_1``, the ground water loses ``E / rho_water`` and the ground
cools by ``L_v E / (C_g d_g)``, so the three reservoirs close.  Dew (a
negative deficit) is clipped to zero.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.physics import humidity

RHO_WATER = 1000.0       # [kg/m^3]
GROUND_SLAB = 0.1        # [m] slab depth of the ground heat reservoir
DEFAULT_CE = 1.3e-3      # bulk transfer coefficient (neutral, ~10 m)
DEFAULT_GUST = 1.0       # [m/s] gustiness floor for |U_1|
DEFAULT_GW_CAP = 0.15    # [m] field capacity for the beta factor


def bulk_evaporation(p, q, u, v, tt, gt, gw, geom, c_e=DEFAULT_CE,
                     gust=DEFAULT_GUST, gw_cap=DEFAULT_GW_CAP,
                     land_fraction=None):
    """Evaporative mass flux [kg m^-2 s^-1]: ``p`` (H,W); ``q, u, v, tt``
    (L,H,W), of which the lowest layer k=0 is used; ``gt, gw`` (H,W).

    With ``land_fraction=None`` the total flux with the soil beta applied
    everywhere.  With a land-fraction map, ``(E_total, E_land)``: the
    ocean share evaporates at beta = 1 and only ``E_land`` draws on
    ``gw``."""
    sig0 = geom.sig.to(p.dtype).reshape(-1)[0]
    ptop = geom.ptop.to(p.dtype)
    tp1 = p * sig0 + ptop
    rho1 = tp1 / (constants.Rd * tt[0])
    # C-grid u at i+1/2, v at j+1/2: averaged back to the centres for |U|
    uc = 0.5 * (u[0] + torch.roll(u[0], 1, dims=-1))
    vc = 0.5 * (v[0] + torch.roll(v[0], 1, dims=-2))
    wind = torch.sqrt(uc * uc + vc * vc + gust * gust)
    deficit = humidity.w_s_at(tp1, gt) - q[0]
    base = torch.clamp(rho1 * c_e * wind * deficit, min=0.0)
    beta = torch.clamp(gw / gw_cap, 0.0, 1.0)
    if land_fraction is None:
        return beta * base
    f = land_fraction.to(p.dtype)
    e_land = f * beta * base
    return e_land + (1.0 - f) * base, e_land


def evaporation_step(p, q, u, v, tt, gt, gw, dt, geom, c_e=DEFAULT_CE,
                     gust=DEFAULT_GUST, gw_cap=DEFAULT_GW_CAP,
                     land_fraction=None):
    """One evaporation step; returns ``(q_n, gt_n, gw_n)``.  The land flux
    is limited so that a step never takes more water than the ground holds
    (``E dt <= gw rho_water``); with a ``land_fraction`` map only the land
    share draws on ``gw`` (the ocean is an unlimited reservoir)."""
    if land_fraction is None:
        E = bulk_evaporation(p, q, u, v, tt, gt, gw, geom, c_e=c_e,
                             gust=gust, gw_cap=gw_cap)
        E = torch.minimum(E, gw * RHO_WATER / dt)
        e_land = E
    else:
        E, e_land = bulk_evaporation(p, q, u, v, tt, gt, gw, geom, c_e=c_e,
                                     gust=gust, gw_cap=gw_cap,
                                     land_fraction=land_fraction)
        clipped = torch.minimum(e_land, gw * RHO_WATER / dt)
        E = E - (e_land - clipped)
        e_land = clipped
    dsig0 = geom.dsig.to(p.dtype).reshape(-1)[0]
    dp1 = p * dsig0
    q_n = torch.cat([(q[0] + E * constants.G / dp1 * dt)[None], q[1:]])
    gw_n = gw - e_land / RHO_WATER * dt
    lv = constants.lhv_water_0c
    gt_n = gt - lv * E / (constants.Cg * GROUND_SLAB) * dt
    return q_n, gt_n, gw_n


def evaporation(tt, gt, gw, wind_speed, rh):
    """The reference's declared but empty entry point (``evaporation.py:5-9``),
    kept for its name: its signature carries no pressure or geometry, so it
    raises and names the working functions."""
    raise NotImplementedError(
        "unimplemented in the reference (evaporation.py:5-9); use "
        "bulk_evaporation()/evaporation_step(), which take the pressure and "
        "the geometry")
