"""Grey-gas radiation column physics.

Port of ``gcmiipy_tpu/physics/radiation.py`` (reference ``grey_solar.py``):
the zenith angle and the solar clock; the cloudy grey schemes with ozone,
CO2 and H2O absorbers, Hansen 1983 cloud optical thickness and a slab ground
(:func:`grey_solar`, the shortwave alone, and :func:`grey_radiation`, the
shortwave and longwave sweeps, reference ``grey_solar.py:106-320``), whose
vertical ``lax.scan`` sweeps are loops over the L layers here; the basic
grey atmosphere of Atmospheric Dynamics section 2.7 (reference
``grey_solar.py:358-563``) in its two forms: :func:`basic_grey_radiation`
(per-layer tensors, the vertical scans written as loops over the L layers)
and :func:`basic_grey_radiation_ladder` (the same math with every layer's
transmittances as Python floats, the form K7's column-physics epilogue,
``csrc/column_physics.cuh``, computes); and the four-band longwave
scheme with the grey shortwave (:func:`four_band_radiation`,
``ModelConfig.radiation='4band'``).  SI units throughout.
"""

import math

import numpy as np
import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.physics import ozone as ozone_mod
from gcmiipy_tpu_torch.physics import thermo


def mmr_from_vmr(vmr, mmg, mma):
    """Mass from volumetric mixing ratio (reference grey_solar.py:21-26)."""
    return vmr * mmg / mma


# 300 ppm CO2 as mass mixing ratio (reference grey_solar.py:29)
co2_mmr = mmr_from_vmr(300 / 1e6, constants.M_CO2, constants.Md)

# Grey absorption cross-sections [m^2/kg] (reference grey_solar.py:76-83);
# the reference's ozone_weight = 0.01 in the units of h2o_weight is a plain
# 0.01 m^2/kg (grey_solar.py:82)
h2o_weight = 0.125
co2_weight = 1.0
co2_sw_weight = co2_weight
ozone_weight = 0.01

# Four-band longwave absorptivities per dp = 1e5 Pa, from MITgcm/aim, which
# the reference records for a multi-band scheme (no_limits_2_5d.py:241-248;
# the water-vapour terms per dq = 1 g/kg)
ABLWIN = 0.7   # window band
ABLCO2 = 4.0   # CO2 band
ABLWV1 = 0.7   # weak water-vapour band
ABLWV2 = 50.0  # strong water-vapour band

# Spectral edges of the four bands [cm^-1]: the H2O rotation band (strong),
# the 15 um CO2 band, the atmospheric window and the H2O vibration-rotation
# band (weak)
FOUR_BAND_EDGES_CM = (0.0, 600.0, 800.0, 1200.0)
_C2_CM_K = 1.438777  # hc/k [cm K]
_LW_DIFFUSIVITY = 1.66  # Elsasser diffuse-path factor (grey_solar.py:145)


def _planck_cumfrac(x, terms=60):
    """Fraction of blackbody emission at dimensionless frequency < x
    (x = c2 nu / T): 1 - (15/pi^4) sum_n e^{-nx} (x^3/n + 3x^2/n^2 + 6x/n^3
    + 6/n^4).  NumPy, host-side (it fits the band polynomials)."""
    x = np.asarray(x, np.float64)
    acc = np.zeros_like(x)
    for n in range(1, terms + 1):
        acc += np.exp(-n * x) * (x ** 3 / n + 3 * x ** 2 / n ** 2
                                 + 6 * x / n ** 3 + 6 / n ** 4)
    return 1.0 - acc * 15.0 / math.pi ** 4


def _fit_band_fraction_polys(deg=6, t_lo=150.0, t_hi=350.0):
    """Degree-``deg`` polynomial fits, in (T - 250) / 100, of the Planck
    fraction emitted in each of the three bounded bands (the open top band
    is 1 - their sum), highest power first; the fit's residual stays below
    2e-4 over [150, 350] K."""
    T = np.linspace(t_lo, t_hi, 201)
    fr_below = [_planck_cumfrac(_C2_CM_K * edge / T)
                for edge in FOUR_BAND_EDGES_CM[1:]]          # 600/800/1200
    bands = [fr_below[0], fr_below[1] - fr_below[0],
             fr_below[2] - fr_below[1]]
    s = (T - 250.0) / 100.0
    return np.stack([np.polyfit(s, b, deg) for b in bands])  # (3, deg+1)


_BAND_POLYS = _fit_band_fraction_polys()


def four_band_fractions(tt):
    """Planck emission fraction per longwave band at the temperature ``tt``
    [K], stacked (4, ...) as (H2O rotation, CO2, window, H2O vibration);
    they sum to 1 (the open band is the complement).  The fit variable is
    clamped to the fits' [150, 350] K, so that out-of-range temperatures
    cannot extrapolate into negative fractions."""
    s = torch.clamp((tt - 250.0) / 100.0, -1.0, 1.0)
    fs = []
    for coeffs in _BAND_POLYS:   # Horner's rule, highest power first
        y = torch.zeros_like(s)
        for c in coeffs:
            y = y * s + float(c)
        fs.append(y)
    f4 = 1.0 - (fs[0] + fs[1] + fs[2])
    return torch.stack([fs[0], fs[1], fs[2], f4])


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


def zenith_angle(longs, lats, time, geom=None, declination=0.0):
    """Clamped cos(zenith) over the grid at the clock ``time`` [s]
    (reference grey_solar.py:49-65): ``longs`` (I,), ``lats`` (J,1) in
    radians, ``time`` a 0-dim tensor or a float.  ``geom`` is unused, as in
    JAX's signature."""
    del geom
    hour_angle = time / (-24.0 * 3600.0) * 2 * math.pi  # sun moves west
    point_angle = longs + hour_angle
    sza = solar_zenith_angle(lats, point_angle, declination)
    return torch.clamp(sza, min=0.0)


def compute_absorbance(gasses, rho, path_length):
    """Beer-Lambert absorbance sum over (mixing ratio, cross-section) pairs
    (reference grey_solar.py:85-91)."""
    absorbance = torch.zeros_like(rho)
    for gas, coefficient in gasses:
        absorbance = absorbance + gas * rho * path_length * coefficient
    return absorbance


def hansen_cloud_thickness(tp, tt):
    """Cloud optical thickness, Hansen 1983 eq. 21 (reference
    grey_solar.py:94-101), in the reference's order: cold layers (<258 K)
    get 1/3, then negatives clamp to 0."""
    thickness = (tp - 100.0e2) * 0.0133 / 100.0   # per hPa -> per Pa
    thickness = torch.where(tt < 258.0, torch.full_like(thickness, 1.0 / 3.0),
                            thickness)
    return torch.where(thickness < 0, torch.zeros_like(thickness), thickness)


def _sw_cloud_sweep(downwelling_top, transmittance, t_cloud, cloud_albedo, c):
    """Downward SW sweep with partial cloud (reference grey_solar.py:157-171),
    from the top layer (L-1) down to 0.  Returns (the downwelling below
    each layer, stacked so that index k is layer k's, as JAX's reversed
    scan stacks them; the absorbed per layer; the reflected total)."""
    L = transmittance.shape[0]
    down, absorbed = [None] * L, [None] * L
    previous = downwelling_top
    reflected_total = torch.zeros_like(downwelling_top)
    for k in range(L - 1, -1, -1):
        absorbed_nc = (1 - c) * (previous * (1 - transmittance[k]))
        reflected = c * cloud_albedo[k] * previous
        absorbed_c = c * (1 - cloud_albedo[k]) * previous * (1 - t_cloud[k])
        total_absorbed = absorbed_nc + absorbed_c
        previous = previous - total_absorbed - reflected
        reflected_total = reflected_total + reflected
        down[k], absorbed[k] = previous, total_absorbed
    return torch.stack(down), torch.stack(absorbed), reflected_total


def grey_solar(p, q, t, c, gt, utc, dt, geom):
    """SW-only grey sweep (reference grey_solar.py:106-184); returns
    (t_next, the downwelling at the L+1 levels, bottom to top)."""
    sig, dsig = geom.sig.to(t.dtype), geom.dsig.to(t.dtype)
    ptop = geom.ptop.to(t.dtype)

    tp = p * sig + ptop
    tt = thermo.to_true_temp(t, tp)
    rho = tp / (constants.Rd * tt)
    dp = p * dsig
    oc = ozone_mod.ozone_at(tp)

    depth = dp / (rho * constants.G)
    gasses = [(oc, ozone_weight), (q, h2o_weight)]
    absorbance = compute_absorbance(gasses, rho, depth)
    transmittance = torch.pow(10.0, -absorbance)
    # Manabe diffuse path factor (grey_solar.py:145)
    t_cloud = torch.pow(10.0, -(absorbance * 1.66))

    cloud_thickness = hansen_cloud_thickness(tp, tt)
    cloud_albedo = (1 - torch.exp(-cloud_thickness)) * 0.7

    top = torch.full(p.shape, constants.solar_constant * 0.25,
                     dtype=t.dtype, device=t.device)
    down_levels, absorbed, _ = _sw_cloud_sweep(
        top, transmittance, t_cloud, cloud_albedo, c)
    downwelling = torch.cat([down_levels, top[None]], dim=0)

    dT = absorbed / constants.Cp / rho / depth * dt
    t_n = thermo.to_potential_temp(tt + dT, tp)
    return t_n, downwelling


def _lw_sweep(previous, emittance, eps_clear, eps_cloud, c, layers):
    """One longwave sweep over ``layers`` in order: each absorbs its part of
    the flux coming in and adds its emission.  Returns (the flux leaving
    the last layer, the flux below/above each layer by layer index, the
    absorbed per layer by layer index)."""
    L = emittance.shape[0]
    out, absorbed = [None] * L, [None] * L
    for k in layers:
        total_absorbtion = (c * eps_cloud[k] + (1 - c) * eps_clear[k]) * previous
        previous = previous - total_absorbtion + emittance[k]
        out[k], absorbed[k] = previous, total_absorbtion
    return previous, torch.stack(out), torch.stack(absorbed)


def grey_radiation(p, q, tt, c, g, utc, dt, geom):
    """Full SW+LW grey radiation with clouds (reference
    grey_solar.py:192-320); returns (dt_ground, dt_air, the TOA thermal
    upwelling)."""
    sig, dsig = geom.sig.to(tt.dtype), geom.dsig.to(tt.dtype)
    ptop = geom.ptop.to(tt.dtype)

    tp = p * sig + ptop
    rho = tp / (constants.Rd * tt)
    dp = p * dsig
    depth = dp / (rho * constants.G)

    # Manabe64 solar constant halved twice (reference grey_solar.py:207-209)
    irradiance = 2 * 41840.0 / 60.0 * 0.5 * 0.5

    sw_gasses = [(q, h2o_weight), (co2_mmr, co2_sw_weight)]
    sw_absorbance = compute_absorbance(sw_gasses, rho, depth)
    sw_transmittance = torch.pow(10.0, -sw_absorbance)
    sw_t_cloud = torch.pow(10.0, -(sw_absorbance * 1.66))

    lw_gasses = [(q, h2o_weight), (co2_mmr, co2_weight)]
    lw_absorbance = compute_absorbance(lw_gasses, rho, depth)

    cloud_thickness = hansen_cloud_thickness(tp, tt)
    sw_cloud_albedo = (1 - torch.exp(-cloud_thickness)) * 0.7
    lw_cloud_absorbance = cloud_thickness / math.log(10.0) + lw_absorbance

    lw_emissivity = 1 - torch.pow(10.0, -lw_absorbance)
    lw_cloud_emissivity = 1 - torch.pow(10.0, -lw_cloud_absorbance)

    emittance = (constants.sb_constant * tt ** 4
                 * ((1 - c) * lw_emissivity + c * lw_cloud_emissivity))
    ground_emittance = constants.sb_constant * g.gt ** 4

    # downwelling sweeps, top -> bottom: SW with clouds, LW with emission
    top_sw = torch.full(p.shape, irradiance, dtype=tt.dtype, device=tt.device)
    sw_levels, absorbed_sw, _ = _sw_cloud_sweep(
        top_sw, sw_transmittance, sw_t_cloud, sw_cloud_albedo, c)
    L = tt.shape[0]
    _, lw_down_levels, lw_absorbed_dw = _lw_sweep(
        torch.zeros_like(top_sw), emittance, lw_emissivity,
        lw_cloud_emissivity, c, range(L - 1, -1, -1))

    # ground budget (reference grey_solar.py:290-293)
    ground_albedo = 0.1
    ground_absorbtion = ((1 - ground_albedo) * sw_levels[0]
                         + lw_down_levels[0])

    # upwelling LW sweep, bottom -> top, from the ground's emittance
    toa_up, _, lw_absorbed_uw = _lw_sweep(
        ground_emittance, emittance, lw_emissivity, lw_cloud_emissivity, c,
        range(L))
    absorbed = absorbed_sw + lw_absorbed_dw + lw_absorbed_uw

    dt_ground = (ground_absorbtion - ground_emittance) / constants.Cg / 0.1
    dt_air = (absorbed - 2 * emittance) / (constants.Cp * rho * depth)
    return dt_ground, dt_air, toa_up


def basic_grey_transmittances(t_lw, t_sw, geom):
    """Per-layer transmittances ``t ** dsig`` (reference
    grey_solar.py:323-333), (L,1,1) in the geometry's dtype."""
    return t_lw ** geom.dsig, t_sw ** geom.dsig


def basic_3_gas_absorbance(p, tp, tt, rho, q, geom):
    """LW (H2O+CO2) and SW (empty) grey absorbances
    (reference grey_solar.py:336-355)."""
    dp = p * geom.dsig.to(q.dtype)
    depth = dp / (rho * constants.G)
    sw_absorbance = compute_absorbance([], rho, depth)
    lw_absorbance = compute_absorbance(
        [(q, h2o_weight), (co2_mmr, co2_weight)], rho, depth)
    return lw_absorbance, sw_absorbance


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


def four_band_transmittances(p, q, geom, dtype=None):
    """Per-layer longwave transmittance of each of the 4 bands, stacked
    (4, L, ...): ``exp(-1.66 eps_b)`` with the aim layer absorptivities
    ``eps = AB * dp / 1e5``, the water-vapour bands also scaled by q in
    g/kg (no_limits_2_5d.py:241-248)."""
    dtype = dtype or q.dtype
    dsig = geom.dsig.to(dtype)
    dp_norm = p * dsig / 1.0e5          # (L, ...) layer mass per 1e5 Pa
    q_gkg = q * 1000.0
    ones = torch.ones_like(q)
    eps = torch.stack([
        ABLWV2 * q_gkg * dp_norm,       # H2O rotation (strong)
        ABLCO2 * ones * dp_norm,        # CO2 15 um (well mixed)
        ABLWIN * ones * dp_norm,        # window
        ABLWV1 * q_gkg * dp_norm,       # H2O vibration (weak)
    ])
    return torch.exp(-_LW_DIFFUSIVITY * eps)


def four_band_radiation(p, tp, tt, q, gt, t_sw, albedo, utc, geom,
                        declination=0.0):
    """Four-band longwave and grey shortwave column radiation: the ladders
    of :func:`basic_grey_radiation` with the grey longwave transmittance
    ``t_lw ** dsig`` replaced by four bands (:func:`four_band_transmittances`)
    and the layers' and the ground's emission split across them by the
    Planck fraction at the emitting temperature (:func:`four_band_fractions`).
    The shortwave path and the ground's slab budget are the grey scheme's.
    ``p`` (H,W), ``tp``/``tt``/``q`` (L,H,W), ``gt`` (H,W) ground
    temperature; ``tp`` is unused.  Returns (dTdt [K/s] per layer,
    dt_ground [K/s])."""
    del tp
    dtype = tt.dtype
    dsig = geom.dsig.to(dtype)
    sw_t = t_sw ** dsig                        # (L,1,1)
    L = tt.shape[0]

    # per-band longwave ladders
    t_b = four_band_transmittances(p, q, geom, dtype)        # (4, L, ...)
    f_b = four_band_fractions(tt)                            # (4, L, ...)
    emission = f_b * (1 - t_b) * constants.sb_constant * tt ** 4

    # transmission from layer k down to the ground in each band: the
    # exclusive product over the layers below k.  The grey scheme's
    # cumprod / t is 0/0 in an opaque band, where exp(-1.66 eps) underflows
    # to 0 at the strong water-vapour band's absorptivity
    cum_b_bottom = torch.cumprod(t_b, dim=1)
    c_div = torch.cat([torch.ones_like(t_b[:, :1]), cum_b_bottom[:, :-1]],
                      dim=1)
    B = torch.sum(emission * c_div, dim=(0, 1))              # at the ground

    # the grey shortwave sweep (basic_grey_radiation's)
    cum_sw_top = torch.flip(torch.cumprod(torch.flip(
        sw_t.expand(tt.shape), (0,)), dim=0), (0,))
    sza = zenith_angle(geom.long.to(dtype), geom.lat.to(dtype), utc,
                       declination=declination)
    Sc = constants.solar_constant * sza
    S = (1 - albedo) * Sc * cum_sw_top[0]
    U_s = constants.sb_constant * gt ** 4
    dt_ground = (B + S - U_s) / constants.Cg / 0.1

    # downwelling absorption per band, top -> bottom
    LWA_a = [None] * L
    previous = torch.zeros_like(emission[:, 0])
    for k in range(L - 1, -1, -1):
        LWA_a[k] = previous * (1 - t_b[:, k])
        previous = previous * t_b[:, k] + emission[:, k]
    # upwelling from the layers' emission only, bottom -> top; the ground
    # enters through U_n (grey_solar.py:513-518)
    LWA_b = [None] * L
    previous = torch.zeros_like(emission[:, 0])
    for k in range(L):
        LWA_b[k] = previous * (1 - t_b[:, k])
        previous = previous * t_b[:, k] + emission[:, k]
    LWA_a = torch.stack(LWA_a, dim=1).sum(0)                 # (L, ...)
    LWA_b = torch.stack(LWA_b, dim=1).sum(0)

    # the ground's emission absorbed in layer k, per band: split by the
    # Planck fraction at the ground temperature
    fg = four_band_fractions(gt)                             # (4, ...)
    U_n = (fg[:, None] * U_s * c_div * (1 - t_b)).sum(0)
    S_n = (1 - sw_t) * cum_sw_top / sw_t * Sc
    B_n = emission.sum(0)
    dTdt = (U_n + S_n - 2 * B_n + LWA_a + LWA_b) * (
        constants.G / (constants.Cp * p * dsig))
    return dTdt, dt_ground
