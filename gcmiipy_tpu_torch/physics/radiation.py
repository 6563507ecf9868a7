"""Grey-gas radiation column physics.

Port of the grey scheme of ``gcmiipy_tpu/physics/radiation.py`` (reference
``grey_solar.py``): the zenith angle and the solar clock, and the basic grey
atmosphere of Atmospheric Dynamics section 2.7 (reference
``grey_solar.py:358-563``) in its two forms: :func:`basic_grey_radiation`
(per-layer tensors, the vertical scans written as loops over the L layers)
and :func:`basic_grey_radiation_ladder` (the same math with every layer's
transmittances as Python floats, the form K7's column-physics epilogue,
``csrc/column_physics.cuh``, computes).  The four-band scheme is not
ported.  SI units throughout.
"""

import math

import torch

from gcmiipy_tpu_torch import constants


def _sin(x):
    return torch.sin(x) if torch.is_tensor(x) else math.sin(x)


def _cos(x):
    return torch.cos(x) if torch.is_tensor(x) else math.cos(x)


def daily_average_irradiance(lat, declination):
    """Manabe 1964 daily-mean insolation [W/m^2] (reference
    grey_solar.py:32-36); ``lat``/``declination`` in radians."""
    lat = torch.as_tensor(lat)
    declination = torch.as_tensor(declination, dtype=lat.dtype)
    dH = torch.arccos(-torch.tan(lat) * torch.tan(declination))
    manabe64_Sc = 2 * 41840.0 / 60.0  # J/m^2/min -> W/m^2
    return manabe64_Sc / math.pi * (
        dH * torch.sin(lat) * torch.sin(declination)
        + torch.cos(lat) * torch.cos(declination) * torch.sin(dH))


def solar_declination(utc, obliquity_deg=23.44, year_days=365.0):
    """Solar declination [rad] from the model clock ``utc`` [s] (the daily
    analog; utc = 0 is January 1 00:00):
    ``-obliquity * cos(2 pi (d + 10) / year_days)``."""
    d = utc / 86400.0
    return (-math.radians(obliquity_deg)
            * _cos(2 * math.pi * (d + 10.0) / year_days))


def solar_zenith_angle(latitude, hour_angle, declination):
    """cos(solar zenith angle) (reference grey_solar.py:40-46), radians.
    ``declination`` may be a Python float (0 for the perpetual equinox)."""
    return (torch.sin(latitude) * _sin(declination)
            + torch.cos(latitude) * _cos(declination) * torch.cos(hour_angle))


def zenith_angle(longs, lats, time, declination=0.0):
    """Clamped cos(zenith) over the grid at the clock ``time`` [s]
    (reference grey_solar.py:49-65): ``longs`` (I,), ``lats`` (J,1) in
    radians, ``time`` a 0-dim tensor."""
    hour_angle = time / (-24.0 * 3600.0) * 2 * math.pi  # sun moves west
    point_angle = longs + hour_angle
    sza = solar_zenith_angle(lats, point_angle, declination)
    return torch.clamp(sza, min=0.0)


def basic_grey_transmittances(t_lw, t_sw, geom):
    """Per-layer transmittances ``t ** dsig`` (reference
    grey_solar.py:323-333), (L,1,1) in the geometry's dtype."""
    return t_lw ** geom.dsig, t_sw ** geom.dsig


def ladder_constants(t_lw, t_sw, dsig_vals):
    """The ladder form's per-layer Python floats: ``lw_t``, ``sw_t`` (the
    transmittances ``t ** dsig``), ``cum_sw_top[k]`` (product of ``sw_t[k:]``)
    and ``clw_b_div[k]`` (product of ``lw_t[:k]``).  K7's epilogue receives
    the same doubles."""
    L = len(dsig_vals)
    lw_t = [float(t_lw) ** float(d) for d in dsig_vals]
    sw_t = [float(t_sw) ** float(d) for d in dsig_vals]
    cum_sw_top = [0.0] * L
    acc = 1.0
    for k in range(L - 1, -1, -1):
        acc *= sw_t[k]
        cum_sw_top[k] = acc
    clw_b_div = [0.0] * L
    acc = 1.0
    for k in range(L):
        clw_b_div[k] = acc
        acc *= lw_t[k]
    return lw_t, sw_t, cum_sw_top, clw_b_div


def basic_grey_radiation_ladder(p, tt, gt, t_lw, t_sw, albedo, sza,
                                dsig_vals):
    """:func:`basic_grey_radiation`'s core with each layer's transmittances
    and their cumulative products as Python floats (JAX
    ``basic_grey_radiation_ladder``): ``p`` (H,W), ``tt`` (L,H,W) true
    temperature, ``gt`` ground temperature, ``sza`` the clamped cos-zenith
    field, ``dsig_vals`` the layers' sigma thicknesses as floats.  Returns
    ``(dTdt (L,H,W), dt_ground (H,W))``, equal to :func:`basic_grey_radiation`
    up to the summation order."""
    L = len(dsig_vals)
    lw_t, sw_t, cum_sw_top, clw_b_div = ladder_constants(t_lw, t_sw,
                                                         dsig_vals)
    sb = constants.sb_constant
    emission = [(1.0 - lw_t[k]) * sb * tt[k] ** 4 for k in range(L)]

    B = emission[0] * clw_b_div[0]
    for k in range(1, L):
        B = B + emission[k] * clw_b_div[k]
    Sc = constants.solar_constant * sza
    S = (1.0 - albedo) * Sc * cum_sw_top[0]
    U_s = sb * gt ** 4
    dt_ground = (B + S - U_s) / constants.Cg / 0.1

    # downwelling LW absorption, top -> bottom
    LWA_a = [None] * L
    d = torch.zeros_like(p)
    for k in range(L - 1, -1, -1):
        LWA_a[k] = d * (1.0 - lw_t[k])
        d = d * lw_t[k] + emission[k]
    # upwelling from layer emission only, bottom -> top
    LWA_b = [None] * L
    d = torch.zeros_like(p)
    for k in range(L):
        LWA_b[k] = d * (1.0 - lw_t[k])
        d = d * lw_t[k] + emission[k]

    dTdt = []
    for k in range(L):
        U_n = clw_b_div[k] * (1.0 - lw_t[k]) * U_s
        S_n = (1.0 - sw_t[k]) * cum_sw_top[k] / sw_t[k] * Sc
        dTdt.append((U_n + S_n - 2.0 * emission[k] + LWA_a[k] + LWA_b[k])
                    * (constants.G / (constants.Cp * float(dsig_vals[k])))
                    / p)
    return torch.stack(dTdt), dt_ground


def basic_grey_radiation(p, tp, tt, gt, t_lw, t_sw, albedo, utc, geom,
                         declination=0.0):
    """Basic grey atmosphere, Atmospheric Dynamics section 2.7 (reference
    grey_solar.py:358-563), the radiation the model driver runs.  ``p``
    (H,W), ``tp``/``tt`` (L,H,W) layer pressure and true temperature,
    ``gt`` (H,W) ground temperature, ``utc`` the clock [s],
    ``declination`` [rad] (0 is the reference's perpetual equinox).
    ``tp`` is unused, as in the reference.  Returns (dTdt [K/s] per layer,
    dt_ground [K/s])."""
    del tp
    dtype = tt.dtype
    dsig = geom.dsig.to(dtype)
    lw_t, sw_t = basic_grey_transmittances(t_lw, t_sw, geom)
    lw_t, sw_t = lw_t.to(dtype), sw_t.to(dtype)
    L = tt.shape[0]

    # 1) emission reaching the surface (eq. 2.25, grey_solar.py:374-386)
    emission = (1 - lw_t) * constants.sb_constant * tt ** 4
    cum_sw_top = torch.flip(torch.cumprod(torch.flip(sw_t, (0,)), dim=0),
                            (0,))
    cum_lw_bottom = torch.cumprod(lw_t, dim=0)
    clw_b_div = cum_lw_bottom / lw_t
    B = torch.sum(emission * clw_b_div, dim=0)

    # 2) solar received (eq. 2.26, grey_solar.py:390-394)
    sza = zenith_angle(geom.long.to(dtype), geom.lat.to(dtype), utc,
                       declination=declination)
    Sc = constants.solar_constant * sza
    S = (1 - albedo) * Sc * cum_sw_top[0]

    # 3) surface emission (eq. 2.27, grey_solar.py:398-399)
    U_s = constants.sb_constant * gt ** 4
    dt_ground = (B + S - U_s) / constants.Cg / 0.1

    # downwelling LW absorption per layer, top -> bottom
    # (grey_solar.py:480-492)
    zero = torch.zeros_like(Sc)
    LWA_a = [None] * L
    previous = zero
    for k in range(L - 1, -1, -1):
        LWA_a[k] = previous * (1 - lw_t[k])
        previous = previous * lw_t[k] + emission[k]
    # upwelling absorption from layer emission only; the ground enters
    # through U_n (grey_solar.py:513-518)
    LWA_b = [None] * L
    previous = zero
    for k in range(L):
        LWA_b[k] = previous * (1 - lw_t[k])
        previous = previous * lw_t[k] + emission[k]
    LWA_a, LWA_b = torch.stack(LWA_a), torch.stack(LWA_b)

    U_n = clw_b_div * U_s * (1 - lw_t)                   # eq. 2.30
    S_n = (1 - sw_t) * cum_sw_top / sw_t * Sc            # eq. 2.31
    B_n = emission                                       # eq. 2.32
    dTdt = (U_n + S_n - 2 * B_n + LWA_a + LWA_b) * (     # eq. 2.34
        constants.G / (constants.Cp * p * dsig))
    return dTdt, dt_ground
