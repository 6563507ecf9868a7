"""The benchmark's plain reference of a GCM-II run: geometry, initial state,
the Matsuno step of the 2.5D sigma core with the Arakawa-Lamb polar filter,
the column physics, the zonal Shapiro filter, the energy diagnostics and
the blow-up guard.  With the configuration's ``coriolis``, ``sigma:
"giss"`` and ``seasonal`` it runs GCM-II as Hansen et al. 1983 (MWR 111,
609-662) publish it: a rotating Earth, Model II's 9 sigma edges and a
seasonal sun.

Plain PyTorch on plain SI tensors, written once and frozen: it imports
nothing of the program under test, and every table it needs (the sigma
ladders, the damping mask, the band-fraction fits, the Hansen maps) it
builds itself.  A feature that is off runs none of its operations.  It
runs in any floating type (float64 for the reference; the FFT runs in
float32 at least, since cuFFT has no bfloat16).

Equations (layout ``[k, j, i]``: sigma layer from the ground up, latitude
from the north, longitude; ``p`` is ``[j, i]``; u at i+1/2, v at j+1/2, a
positive v southward):

* the core: GISS Model II's flux-form C-grid sigma dynamics as in
  gcmiipy's ``dynamics.py``: mass fluxes, sigma-dot from the column
  convergence, momentum advection, the GISS ``Cp thbar (p^k_dn - p^k_up)``
  geopotential ladder, the pressure-gradient force, flux-form advection
  of t and q; the Matsuno forward-backward step; the zonal mass flux and
  the zonal pressure force filtered by the Arakawa-Lamb mask in each half
  step; v = 0 on the southern wall row; with ``coriolis``, the Coriolis
  terms of ``dynamics.py:82-95`` in the momentum tendencies that the step
  subtracts: f = 2 Omega sin(lat) at u's row times minus the meridional
  mass flux averaged to u, and f at v's half row times the zonal mass flux
  averaged to v;
* the physics, at its cadence after the step: implicit Rayleigh drag of
  the lowest layer's winds; the basic grey atmosphere of Atmospheric
  Dynamics section 2.7 or its four-band longwave variant, under a sun at
  the perpetual equinox or, with ``seasonal``, at the declination of the
  model's day of the year; the Manabe-Strickler convective adjustment
  (pairwise, bottom up, until a sweep changes nothing, at most 2L sweeps);
  bulk evaporation into the lowest layer; the two-Newton-step saturation
  adjustment that rains into the ground bucket;
* the 8th-order zonal Shapiro filter of p (reduced to sea level over
  terrain) and t at its cadence, before the physics.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from . import hansen

# physical constants [SI]
RD, CP, G, P0 = 287.0, 1004.0, 9.8, 100000.0
KAPPA = RD / CP
RADIUS = 6.3781e6
R_GAS, MD, RV = 8.3145, 28.97e-3, 461.0
CG, SB, SOLAR = 1.13e6, 5.67e-8, 1360.8
LV = 2.50e6
RHO_WATER = 1000.0
EPS = RD / RV
GROUND_SLAB = 0.1
CRITICAL_LAPSE = 0.0065
CE, GUST, GW_CAP = 1.3e-3, 1.0, 0.15
BANDS = dict(wv2=50.0, co2=4.0, win=0.7, wv1=0.7)  # absorptivity per 1e5 Pa
BAND_EDGES_CM = (600.0, 800.0, 1200.0)
C2_CM_K = 1.438777
DIFFUSIVITY = 1.66
OMEGA = 2 * math.pi / 86400.0  # the Earth's rotation [rad/s], gcmiipy's
# Model II's 9-layer sigma edges, from the ground up (Hansen et al. 1983)
GISS_SIGE = (1.0, .948665, .866530, .728953, .554415, .390144, .251540,
             .143737, .061602, 0.0)

# the configuration keys this reference reads, and those that choose only
# how the program computes (its backend and launch size, its type, whether
# it guards and keeps stats); and those of the seasonal sun, which it
# needs where ``seasonal`` is on and reads nowhere else
KEYS = ("layers", "sigma", "ptop", "topography", "land_cover",
        "sea_level_temp", "physics", "physics_every", "radiation", "t_lw",
        "t_sw", "albedo", "albedo_land", "convection", "drag_tau",
        "evaporation", "gw0", "precipitation", "rh_crit", "shapiro_every",
        "shapiro_order", "shapiro_fields", "shapiro_slp", "guard_p_max",
        "guard_p_min", "coriolis", "seasonal", "q_limiter")
PROGRAM_ONLY = ("backend", "stream_steps", "dtype", "guard", "stats",
                "polar_filter")
SEASONAL = ("obliquity", "year_days")
SIGMA = ("manabe", "giss")


class State(NamedTuple):
    p: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    q: torch.Tensor
    gt: torch.Tensor
    gw: torch.Tensor
    snow: torch.Tensor
    ice: torch.Tensor


def check_model(model):
    """Raise ``ValueError`` on a key this reference does not know, a key it
    needs and is not given, or a feature it does not have."""
    unknown = set(model) - set(KEYS) - set(PROGRAM_ONLY) - set(SEASONAL)
    missing = set(KEYS) - set(model)
    if model.get("seasonal"):
        missing |= set(SEASONAL) - set(model)
    if unknown or missing:
        raise ValueError(f"model keys: unknown {sorted(unknown)}, "
                         f"missing {sorted(missing)}")
    if model["sigma"] not in SIGMA:
        raise ValueError(f"sigma {model['sigma']!r}: the reference builds "
                         f"the ladders {SIGMA}")
    if model["sigma"] == "giss" and model["layers"] != len(GISS_SIGE) - 1:
        raise ValueError(f"sigma 'giss' has {len(GISS_SIGE) - 1} layers, "
                         f"not {model['layers']}")
    if model["q_limiter"]:
        raise ValueError("q_limiter is not in the reference")
    if model["radiation"] not in ("grey", "4band"):
        raise ValueError(f"radiation {model['radiation']!r}")


# --- periodic C-grid shifts ------------------------------------------------

def ip(x):
    return torch.roll(x, -1, -1)


def im(x):
    return torch.roll(x, 1, -1)


def jp(x):
    return torch.roll(x, -1, -2)


def jm(x):
    return torch.roll(x, 1, -2)


def kp(x):
    return torch.roll(x, -1, -3)


def km(x):
    return torch.roll(x, 1, -3)


def iph(x):
    return (x + ip(x)) * 0.5


def imh(x):
    return (x + im(x)) * 0.5


def jph(x):
    return (x + jp(x)) * 0.5


def jmh(x):
    return (x + jm(x)) * 0.5


def kph(x):
    return (x + kp(x)) * 0.5


def kmh(x):
    return (x + km(x)) * 0.5


# --- geometry --------------------------------------------------------------

def manabe_edges(layers):
    """Manabe's sigma edges, sigma^2 (3 - 2 sigma) on an even ladder, from
    the ground (1) up to the top (0)."""
    s = 1 - np.arange(layers + 1) / layers
    return s ** 2 * (3 - 2 * s)


class Geometry:
    """The lat-lon C-grid of ``height`` x ``width`` cells with the sigma
    layers between the edges ``sige`` (from 1 at the ground to 0 at the
    top), and the Coriolis parameter at u's rows and v's half rows; built
    in float64 numpy and held as tensors of ``dtype`` on ``device``."""

    def __init__(self, height, width, sige, ptop, heightmap, land,
                 dtype, device):
        sige = np.asarray(sige, np.float64)
        self.height, self.width, self.layers = height, width, len(sige) - 1
        sigt, sigb = sige[1:], sige[:-1]
        col = (-1, 1, 1)
        circ = 2 * math.pi * RADIUS
        dlat, dlon = 180.0 / height, 360.0 / width
        lat = 90.0 - (np.arange(height) + 0.5) * dlat
        lat_h = 90.0 - (np.arange(height) + 1.0) * dlat
        lon = -180.0 + (np.arange(width) + 0.5) * dlon
        dx_j = np.cos(np.deg2rad(lat)) * circ / width
        dx_h = np.cos(np.deg2rad(lat_h)) * circ / width
        dy = circ / 2 / height
        area = (np.roll(dx_h, 1) + dx_h) * dy * 0.5
        n = np.arange(1, width // 2 + 1)
        damp = 1.0 - np.maximum(
            1.0 - (1.0 / np.sin(np.pi * n / width))[None]
            / (dy / dx_j)[:, None], 0.0)
        mask = np.concatenate([np.ones((height, 1)), damp], axis=1)
        arrays = dict(
            sig=((sigb + sigt) / 2).reshape(col),
            dsig=(sigb - sigt).reshape(col),
            sigt=sigt.reshape(col), sigb=sigb.reshape(col),
            lat=np.deg2rad(lat).reshape(-1, 1), long=np.deg2rad(lon),
            f_row=(2 * OMEGA * np.sin(np.deg2rad(lat))).reshape(-1, 1),
            f_half=(2 * OMEGA * np.sin(np.deg2rad(lat_h))).reshape(-1, 1),
            dx_j=dx_j.reshape(1, -1, 1), dx_h=dx_h.reshape(1, -1, 1),
            dy=np.float64(dy), area=area.reshape(-1, 1), ptop=np.float64(ptop),
            heightmap=heightmap, land=land, mask=mask)
        for name, value in arrays.items():
            setattr(self, name, torch.as_tensor(
                np.array(value, np.float64)).to(dtype=dtype, device=device))


def make_geometry(model, height, width, dtype, device):
    """The geometry of ``model`` (a configuration's ``model`` dict) on the
    ``height`` x ``width`` grid: its sigma ladder, Manabe's or Model II's
    edges, under its ``ptop``, and the Hansen elevation and land fraction
    resampled to the grid where the configuration asks for them."""
    heightmap = (hansen.resample(hansen.TOPOGRAPHY_M, height, width)
                 if model["topography"] == "hansen"
                 else np.zeros((height, width)))
    land = (hansen.resample(hansen.LAND_COVER, height, width)
            if model["land_cover"] == "hansen"
            else np.zeros((height, width)))
    sige = (GISS_SIGE if model["sigma"] == "giss"
            else manabe_edges(model["layers"]))
    return Geometry(height, width, sige, model["ptop"], heightmap, land,
                    dtype, device)


# --- thermodynamics and humidity -------------------------------------------

def exner_inv(tp):
    """(P0 / p)^kappa: true -> potential temperature factor."""
    return (P0 / tp) ** KAPPA


def saturation_vapor_pressure(tt):
    """Buck's equation [Pa]."""
    c = tt - 273.15
    return 611.21 * torch.exp((18.678 - c / 234.5) * (c / (257.14 + c)))


def w_s(tp, tt):
    """Saturation mixing ratio."""
    e_s = saturation_vapor_pressure(tt)
    return EPS * e_s / (tp - e_s)


def manabe_rh(sig):
    return 0.77 * (sig - 0.02) / (1 - 0.02)


# --- initial state ---------------------------------------------------------

def initial_state(model, geom, moist):
    """GCM-II's start as gcmiipy's ``run_model`` sets it: 1e5 Pa at sea
    level (barometric over terrain at ``sea_level_temp``), a 360 K
    isothermal atmosphere at the Manabe relative humidity (3e-6 floor), the
    ground at 360 K, u = 0, v = 0.1 m/s at the first point, the ground
    water at ``gw0``.  ``moist``: cooled to 280 K, air and ground, with the
    lowest layer at 1.2 times saturation, so that rain falls from the first
    physics step."""
    sig, ptop = geom.sig, geom.ptop
    dt_ = sig.dtype
    shape2 = (geom.height, geom.width)
    shape3 = (geom.layers,) + shape2
    ps = P0 * torch.exp(-G * MD * geom.heightmap / (R_GAS
                                                    * model["sea_level_temp"]))
    p = ps - ptop
    tp = p * sig + ptop
    tt = torch.full(shape3, 360.0, dtype=dt_, device=sig.device)
    e = manabe_rh(sig) * saturation_vapor_pressure(tt)
    w = e * EPS / (tp - e)
    q = torch.clamp(w / (w + 1), min=3.0e-6)
    gt = torch.full(shape2, 360.0, dtype=dt_, device=sig.device)
    if moist:
        tt = torch.full(shape3, 280.0, dtype=dt_, device=sig.device)
        rh = manabe_rh(sig).expand(shape3).clone()
        rh[0] = 1.2
        q = torch.clamp(rh * w_s(tp, tt), min=3.0e-6)
        gt = torch.full(shape2, 280.0, dtype=dt_, device=sig.device)
    v = torch.zeros(shape3, dtype=dt_, device=sig.device)
    v[0, 0, 0] = 0.1
    zero2 = torch.zeros(shape2, dtype=dt_, device=sig.device)
    return State(p, torch.zeros_like(v), v, tt * exner_inv(tp), q, gt,
                 torch.full_like(zero2, model["gw0"]), zero2,
                 zero2.clone())


# --- dynamics --------------------------------------------------------------

def polar_filter(x, geom):
    """Arakawa & Lamb (1977): zonal wavenumbers damped by the mask."""
    work = x if x.dtype in (torch.float32, torch.float64) else x.float()
    f = torch.fft.rfft(work, dim=-1) * geom.mask.to(work.dtype)
    return torch.fft.irfft(f, n=geom.width, dim=-1).to(x.dtype)


def aflux(pu, pv, geom):
    """Column convergence (the surface-pressure tendency) and sigma-dot at
    the layer bottoms, zero at the ground."""
    conv = ((pu - im(pu)) / geom.dx_j + (pv - jm(pv)) / geom.dy) * geom.dsig
    pit = conv.sum(0)
    above = torch.flip(torch.cumsum(torch.flip(conv, (0,)), 0), (0,))
    sd = above - pit * geom.sigb
    sd = torch.cat([torch.zeros_like(sd[:1]), sd[1:]])
    return pit, sd


def advec_sig(sd, x, geom):
    flux = kmh(x) * sd
    return -(flux - kp(flux)) / geom.dsig


def advec_momentum(u, v, pu, pv, geom, coriolis):
    """The momentum tendencies (dut, dvt) that the step subtracts: the
    momentum-flux terms and, with ``coriolis``, f times the other wind's
    mass flux averaged to the point (gcmiipy's ``dynamics.py:82-95``)."""
    puum = imh(u) * imh(pu)
    puvp = iph(pv) * jph(u)
    pvvm = jmh(v) * jmh(pv)
    pvup = iph(v) * jph(pu)
    dut = (puum - ip(puum)) / geom.dx_j + (jm(puvp) - puvp) / geom.dy
    dvt = (pvvm - jp(pvvm)) / geom.dy + (im(pvup) - pvup) / geom.dx_h
    if coriolis:
        dut = dut - geom.f_row * iph(jmh(pv))
        dvt = dvt + geom.f_half * imh(jph(pu))
    return dut, dvt


def pressure_gradient(p, t, geom):
    """(pgfu + phiu, pgfv + phiv): the pressure-gradient and geopotential
    forces from the GISS geopotential ladder."""
    sig, ptop = geom.sig, geom.ptop
    tp = p * sig + ptop
    pk = (tp / P0) ** KAPPA
    rho = tp / (RD * t * pk)
    s1 = sig * p / rho * geom.dsig
    stp = CP * kph(t) * (pk - kp(pk))
    base = (s1 - geom.sigt * stp).sum(0) + geom.heightmap * G
    phi = torch.cumsum(torch.cat([base[None], stp[:-1]]), 0)
    sp = sig * p
    phiu = iph(p) * ((ip(phi) - phi) / geom.dx_j)
    phiv = jph(p) * ((jp(phi) - phi) / geom.dy)
    pgfu = iph(sp) / iph(rho) * ((ip(p) - p) / geom.dx_j)
    pgfv = jph(sp) / jph(rho) * ((jp(p) - p) / geom.dy)
    return pgfu + phiu, pgfv + phiv


def advec_scalar(pu, pv, x, geom):
    fx, fy = pu * iph(x), pv * jph(x)
    return (fx - im(fx)) / geom.dx_j + (fy - jm(fy)) / geom.dy


def half_step(base, at, dt, geom, coriolis):
    """Advance ``base`` = (p, u, v, t, q) by ``dt`` with the tendencies of
    ``at``."""
    p, u, v, t, q = base
    sp, su, sv, st, sq = at
    spu = polar_filter(su * iph(sp), geom)
    spv = sv * jph(sp)
    pit, sd = aflux(spu, spv, geom)
    p_n = p - pit * dt
    dut, dvt = advec_momentum(su, sv, spu, spv, geom, coriolis)
    force_u, force_v = pressure_gradient(sp, st, geom)
    force_u = polar_filter(force_u, geom)
    dus = advec_sig(iph(sd), su, geom)
    dvs = advec_sig(jph(sd), sv, geom)
    u_n = (u * iph(p) - (dut + dus + force_u) * dt) / iph(p_n)
    v_n = (v * jph(p) - (dvt + dvs + force_v) * dt) / jph(p_n)
    v_n[:, -1, :] = 0.0
    t_n = (t * p - (advec_scalar(spu, spv, st, geom)
                    + advec_sig(sd, st, geom)) * dt) / p_n
    q_n = (q * p - (advec_scalar(spu, spv, sq, geom)
                    + advec_sig(sd, sq, geom)) * dt) / p_n
    return p_n, u_n, v_n, t_n, q_n


def matsuno(prog, dt, geom, coriolis):
    predicted = half_step(prog, prog, dt, geom, coriolis)
    return half_step(prog, predicted, dt, geom, coriolis)


# --- column physics --------------------------------------------------------

def declination(model, utc):
    """The sun's declination [rad] at the clock ``utc`` [s] (0 is January
    1, 00:00): -obliquity cos(2 pi (d + 10) / year_days), d the day."""
    d = utc / 86400.0
    return -math.radians(model["obliquity"]) * math.cos(
        2 * math.pi * (d + 10.0) / model["year_days"])


def zenith(geom, utc, model):
    """Clamped cos(zenith) at the clock ``utc`` [s]: at the perpetual
    equinox, or with ``seasonal`` sin(lat) sin(dec) + cos(lat) cos(dec)
    cos(lon + hour) at the declination of the day."""
    hour = utc / (-24.0 * 3600.0) * 2 * math.pi
    if not model["seasonal"]:
        return torch.clamp(torch.cos(geom.lat) * torch.cos(geom.long + hour),
                           min=0.0)
    dec = declination(model, utc)
    return torch.clamp(
        torch.sin(geom.lat) * math.sin(dec) + torch.cos(geom.lat)
        * math.cos(dec) * torch.cos(geom.long + hour), min=0.0)


def _ladders(emission, trans):
    """Longwave absorbed per layer from the layers' own emission: the
    downward sweep (top to bottom) and the upward one (bottom to top)."""
    L = emission.shape[0]
    down, up = [None] * L, [None] * L
    flux = torch.zeros_like(emission[0])
    for k in range(L - 1, -1, -1):
        down[k] = flux * (1 - trans[k])
        flux = flux * trans[k] + emission[k]
    flux = torch.zeros_like(emission[0])
    for k in range(L):
        up[k] = flux * (1 - trans[k])
        flux = flux * trans[k] + emission[k]
    return torch.stack(down), torch.stack(up)


def grey_radiation(p, tt, gt, albedo, utc, model, geom):
    """Basic grey atmosphere: (dT/dt per layer, dT_ground/dt) [K/s]."""
    lw_t = model["t_lw"] ** geom.dsig
    sw_t = model["t_sw"] ** geom.dsig
    emission = (1 - lw_t) * SB * tt ** 4
    cum_sw_top = torch.flip(torch.cumprod(torch.flip(sw_t, (0,)), 0), (0,))
    below = torch.cumprod(lw_t, 0) / lw_t
    sc = SOLAR * zenith(geom, utc, model)
    u_s = SB * gt ** 4
    dt_ground = ((emission * below).sum(0)
                 + (1 - albedo) * sc * cum_sw_top[0] - u_s) / CG / 0.1
    down, up = _ladders(emission, lw_t)
    dtdt = (below * u_s * (1 - lw_t) + (1 - sw_t) * cum_sw_top / sw_t * sc
            - 2 * emission + down + up) * (G / (CP * p * geom.dsig))
    return dtdt, dt_ground


_BAND_FITS = {}


def band_fractions(tt):
    """Planck emission fraction in each of the four longwave bands (H2O
    rotation, CO2, window, H2O vibration) at ``tt``: degree-6 fits in
    (T - 250) / 100 over 150-350 K of the Planck integral, clamped to that
    range; the open top band is the complement."""
    if not _BAND_FITS:
        T = np.linspace(150.0, 350.0, 201)

        def below(edge):
            x = C2_CM_K * edge / T
            acc = np.zeros_like(x)
            for n in range(1, 61):
                acc += np.exp(-n * x) * (x ** 3 / n + 3 * x ** 2 / n ** 2
                                         + 6 * x / n ** 3 + 6 / n ** 4)
            return 1.0 - acc * 15.0 / math.pi ** 4
        b = [below(e) for e in BAND_EDGES_CM]
        s = (T - 250.0) / 100.0
        _BAND_FITS["polys"] = [np.polyfit(s, f, 6)
                               for f in (b[0], b[1] - b[0], b[2] - b[1])]
    s = torch.clamp((tt - 250.0) / 100.0, -1.0, 1.0)
    fs = []
    for coeffs in _BAND_FITS["polys"]:
        y = torch.zeros_like(s)
        for c in coeffs:
            y = y * s + float(c)
        fs.append(y)
    return torch.stack(fs + [1.0 - (fs[0] + fs[1] + fs[2])])


def four_band_radiation(p, tt, q, gt, albedo, utc, model, geom):
    """Four-band longwave (MITgcm aim absorptivities, the water-vapour
    bands scaled by q in g/kg) with the grey shortwave."""
    sw_t = model["t_sw"] ** geom.dsig
    dp = p * geom.dsig / 1.0e5
    qg = q * 1000.0
    one = torch.ones_like(q)
    eps = torch.stack([BANDS["wv2"] * qg * dp, BANDS["co2"] * one * dp,
                       BANDS["win"] * one * dp, BANDS["wv1"] * qg * dp])
    trans = torch.exp(-DIFFUSIVITY * eps)
    emission = band_fractions(tt) * (1 - trans) * SB * tt ** 4
    below = torch.cat([torch.ones_like(trans[:, :1]),
                       torch.cumprod(trans, 1)[:, :-1]], 1)
    cum_sw_top = torch.flip(torch.cumprod(torch.flip(
        sw_t.expand(tt.shape), (0,)), 0), (0,))
    sc = SOLAR * zenith(geom, utc, model)
    u_s = SB * gt ** 4
    dt_ground = ((emission * below).sum((0, 1))
                 + (1 - albedo) * sc * cum_sw_top[0] - u_s) / CG / 0.1
    down, up = [], []
    for b in range(4):
        d, u = _ladders(emission[b], trans[b])
        down.append(d)
        up.append(u)
    u_n = (band_fractions(gt)[:, None] * u_s * below * (1 - trans)).sum(0)
    dtdt = (u_n + (1 - sw_t) * cum_sw_top / sw_t * sc - 2 * emission.sum(0)
            + torch.stack(down).sum(0) + torch.stack(up).sum(0)) * (
        G / (CP * p * geom.dsig))
    return dtdt, dt_ground


class Sweeps:
    """The most sweeps the convective adjustment needed in one call."""

    def __init__(self):
        self.most = 0


def convect(tt, tp, dp, sweeps):
    """Manabe-Strickler adjustment toward the 6.5 K/km lapse rate,
    conserving each column's enthalpy: bottom-up sweeps over the layer
    pairs until one changes no column (read on the host), at most 2L."""
    L = tt.shape[0]
    layers = list(tt)
    log_ratio = [torch.log(tp[k] / tp[k + 1]) for k in range(L - 1)]
    inv_mass = [1.0 / (dp[k] + dp[k + 1]) for k in range(L - 1)]
    ran = 0
    for _ in range(2 * L):
        ran += 1
        touched = torch.zeros((), dtype=torch.bool, device=tt.device)
        for k in range(L - 1):
            lo, hi = layers[k], layers[k + 1]
            lift = CRITICAL_LAPSE * RD * (0.5 * (lo + hi)) / G * log_ratio[k]
            unstable = hi < lo - lift
            lo_n = ((dp[k] * lo + dp[k + 1] * hi + dp[k + 1] * lift)
                    * inv_mass[k])
            layers[k] = torch.where(unstable, lo_n, lo)
            layers[k + 1] = torch.where(unstable, lo_n - lift, hi)
            touched = touched | unstable.any()
        if not bool(touched):
            break
    sweeps.most = max(sweeps.most, ran)
    return torch.stack(layers)


def evaporate(p, q, u, v, tt, gt, gw, dt, land, geom):
    """Bulk-aerodynamic evaporation into the lowest layer: the ocean at
    beta = 1, the land at min(gw / 0.15 m, 1), limited to the water the
    ground holds; the ground cools by the latent heat."""
    tp1 = p * geom.sig[0] + geom.ptop
    rho1 = tp1 / (RD * tt[0])
    uc = 0.5 * (u[0] + im(u[0]))
    vc = 0.5 * (v[0] + jm(v[0]))
    wind = torch.sqrt(uc * uc + vc * vc + GUST * GUST)
    flux = torch.clamp(rho1 * CE * wind * (w_s(tp1, gt) - q[0]), min=0.0)
    beta = torch.clamp(gw / GW_CAP, 0.0, 1.0)
    if land is None:
        e_land = torch.minimum(beta * flux, gw * RHO_WATER / dt)
        total = e_land
    else:
        e_land = land * beta * flux
        clipped = torch.minimum(e_land, gw * RHO_WATER / dt)
        total = e_land + (1.0 - land) * flux - (e_land - clipped)
        e_land = clipped
    q0 = q[0] + total * G / (p * geom.dsig[0]) * dt
    return (torch.cat([q0[None], q[1:]]),
            gt - LV * total / (CG * GROUND_SLAB) * dt,
            gw - e_land / RHO_WATER * dt)


def condense(p, t, q, gw, rh_crit, geom):
    """Saturation adjustment above ``rh_crit`` (two Newton steps of the
    Clausius-Clapeyron linearisation); the condensate rains into the
    ground bucket."""
    tp = p * geom.sig + geom.ptop
    ex = exner_inv(tp)
    tt, qn = t / ex, q
    for _ in range(2):
        ws = rh_crit * w_s(tp, tt)
        slope = LV * ws / (RV * tt * tt)
        dq = torch.clamp(qn - ws, min=0.0) / (1.0 + LV / CP * slope)
        qn = qn - dq
        tt = tt + LV / CP * dq
    rain = ((q - qn) * p * geom.dsig).sum(0) / G
    return tt * ex, qn, gw + rain / RHO_WATER


def shapiro(x, order):
    """Order-n zonal Shapiro filter: x - (-1)^(n/2) F^(n/2) x, with F the
    periodic second difference over 4."""
    d = x
    for _ in range(order // 2):
        d = (ip(d) - 2 * d + im(d)) * 0.25
    return x - (-1.0 if (order // 2) % 2 else 1.0) * d


# --- the run ---------------------------------------------------------------

class Reference:
    """One configuration on one grid: ``step(state, n, utc)`` advances a
    state from step ``n`` (whose clock is ``utc``) by one step of ``dt``,
    with the Shapiro filter and the physics on their cadences."""

    def __init__(self, model, height, width, dt, dtype=torch.float64,
                 device="cpu"):
        check_model(model)
        self.model, self.dt = model, float(dt)
        self.geom = make_geometry(model, height, width, dtype, device)
        self.sweeps = Sweeps()

    def start(self, moist):
        return initial_state(self.model, self.geom, moist)

    def step(self, s, n, utc):
        m, geom = self.model, self.geom
        p, u, v, t, q = matsuno(s[:5], self.dt, geom, m["coriolis"])
        s = State(p, u, v, t, q, *s[5:])
        if m["shapiro_every"] > 0 and (n + 1) % m["shapiro_every"] == 0:
            s = self._shapiro(s)
        pe = m["physics_every"]
        if (m["physics"] or m["drag_tau"] > 0) and (n + 1) % pe == 0:
            s = self._physics(s, utc, pe * self.dt)
        return s

    def _shapiro(self, s):
        m, geom = self.model, self.geom
        p, t = s.p, s.t
        if "p" in m["shapiro_fields"]:
            if m["shapiro_slp"]:
                tt0 = t[0] / exner_inv(p * geom.sig[0] + geom.ptop)
                f = torch.exp(G * geom.heightmap / (RD * tt0))
                p = shapiro((p + geom.ptop) * f, m["shapiro_order"]) / f \
                    - geom.ptop
            else:
                p = shapiro(p, m["shapiro_order"])
        if "t" in m["shapiro_fields"]:
            t = shapiro(t, m["shapiro_order"])
        return s._replace(p=p, t=t)

    def _physics(self, s, utc, dt):
        m, geom = self.model, self.geom
        p, u, v, t, q, gt, gw = s[:7]
        if m["drag_tau"] > 0:
            f = 1.0 / (1.0 + dt / m["drag_tau"])
            u = torch.cat([u[:1] * f, u[1:]])
            v = torch.cat([v[:1] * f, v[1:]])
        if not m["physics"]:
            return s._replace(u=u, v=v)
        land = geom.land if m["land_cover"] != "none" else None
        albedo = m["albedo"]
        if land is not None:
            albedo = m["albedo"] * (1.0 - land) + m["albedo_land"] * land
        tp = p * geom.sig + geom.ptop
        ex = exner_inv(tp)
        tt = t / ex
        if m["radiation"] == "4band":
            dtdt, dtg = four_band_radiation(p, tt, q, gt, albedo, utc, m,
                                            geom)
        else:
            dtdt, dtg = grey_radiation(p, tt, gt, albedo, utc, m, geom)
        gt = gt + dtg * dt
        tt = tt + dtdt * dt
        if m["convection"]:
            tt = convect(tt, tp, p * geom.dsig, self.sweeps)
        t = tt * ex
        if m["evaporation"]:
            q, gt, gw = evaporate(p, q, u, v, t / ex, gt, gw, dt, land, geom)
        if m["precipitation"]:
            t, q, gw = condense(p, t, q, gw, m["rh_crit"], geom)
        return State(p, u, v, t, q, gt, gw, s.snow, s.ice)

    def energy(self, s):
        """Kinetic + thermal + geopotential energy of the air [J]."""
        geom = self.geom
        tp = s.p * geom.sig + geom.ptop
        tt = s.t / exner_inv(tp)
        rho = tp / (RD * tt)
        depth = s.p * geom.dsig / (rho * G)
        mass = rho * depth * geom.area
        ke = ((imh(s.u) ** 2 + jmh(s.v) ** 2) * 0.5 * mass).sum()
        ate = (tt * CP * mass).sum()
        geo = (torch.cumsum(depth, 0) * mass * G).sum()
        return ke + ate + geo

    def bad(self, s):
        """The guard: a NaN anywhere, or the surface pressure out of
        (guard_p_min, guard_p_max]."""
        m = self.model
        nan = any(bool(torch.isnan(x).any()) for x in s[:5])
        return (nan or bool((s.p > m["guard_p_max"]).any())
                or bool((s.p <= m["guard_p_min"]).any()))
