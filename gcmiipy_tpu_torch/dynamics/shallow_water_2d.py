"""2D shallow-water cores: C-grid, A-grid, with temperature, and GCM-form.

Port of ``gcmiipy_tpu/dynamics/shallow_water_2d.py``, the twin of four
reference modules:

* ``matsuno_c_grid.py``: Matsuno 1966 shallow water on the C-grid, the
  reference's 2D-SW benchmark configuration (64x64, dx=300 km, dt=300 s,
  SURVEY.md section 6);
* ``matsuno.py``: the earlier A-grid variant (the reference notes its
  checkerboard modes, ``matsuno.py:19-21``);
* ``matsumo_temp.py``: C-grid shallow water with potential temperature and
  explicit viscosity damping;
* ``no_limits_2d.py``: the 2D GCM-II-form core (p, u, v, T, q with PGF).

Arrays are [j, i]; u at i+1/2, v at j+1/2 (reference ``coordinates.py:7-27``).
"""

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.dynamics.viscosity import incompressible_viscosity_2d
from gcmiipy_tpu_torch.ops.stencil import (
    gradi, gradj, ijm, ijp, imh, imj, imjp, iph, ipj, jmh, jph,
)
from gcmiipy_tpu_torch.physics import thermo


# ---------------------------------------------------------------------------
# C-grid Matsuno shallow water (reference matsuno_c_grid.py)
# ---------------------------------------------------------------------------

def advection_of_velocity_u(u, v, dx):
    """Self-advection of u on the C-grid (reference matsuno_c_grid.py:15-51)."""
    u_ipj = (ipj(u) + u) / 2
    u_imj = (imj(u) + u) / 2
    # interpolate v to the u point (names relative to U, not P)
    v_ijm = (imj(v) + v) / 2
    v_ijp = (imjp(v) + ijp(v)) / 2

    du_ipj = ipj(u) - u
    du_imj = u - imj(u)
    du_ijp = ijp(u) - u
    du_ijm = u - ijm(u)

    return (u_ipj * du_ipj + u_imj * du_imj
            + v_ijp * du_ijp + v_ijm * du_ijm) / dx


def advection_of_velocity_v(u, v, dx):
    """Self-advection of v on the C-grid (reference matsuno_c_grid.py:54-80)."""
    v_ijp = (ijp(v) + v) / 2
    v_ijm = (ijm(v) + v) / 2
    u_ipj = (u + ijm(u)) / 2
    u_imj = (imj(u) + imjp(u)) / 2

    dv_ipj = ipj(v) - v
    dv_imj = v - imj(v)
    dv_ijp = ijp(v) - v
    dv_ijm = v - ijm(v)

    return (u_ipj * dv_ipj + u_imj * dv_imj
            + v_ijp * dv_ijp + v_ijm * dv_ijm) / dx


def geopotential_gradient_u(p, dx):
    """(reference matsuno_c_grid.py:97-100)"""
    return (ipj(p) - p) / dx * constants.G


def geopotential_gradient_v(p, dx):
    """(reference matsuno_c_grid.py:103-106)"""
    return (ijp(p) - p) / dx * constants.G


def advection_of_geopotential(u, v, p, dx):
    """Continuity: divergence of the height flux (reference matsuno_c_grid.py:109-118)."""
    up_imj = (imj(p) + p) / 2 * imj(u)
    up_ipj = (ipj(p) + p) / 2 * u
    vp_ijm = (ijm(p) + p) / 2 * ijm(v)
    vp_ijp = (ijp(p) + p) / 2 * v
    return (up_ipj - up_imj) / dx + (vp_ijp - vp_ijm) / dx


def matsuno_scheme_c_grid(u, v, p, dx, dt):
    """Full Matsuno FB step (reference matsuno_c_grid.py:125-142)."""
    u_star = u - dt * (advection_of_velocity_u(u, v, dx)
                       + geopotential_gradient_u(p, dx))
    v_star = v - dt * (advection_of_velocity_v(u, v, dx)
                       + geopotential_gradient_v(p, dx))
    p_star = p - dt * advection_of_geopotential(u, v, p, dx)

    u_next = u - dt * (advection_of_velocity_u(u_star, v_star, dx)
                       + geopotential_gradient_u(p_star, dx))
    v_next = v - dt * (advection_of_velocity_v(u_star, v_star, dx)
                       + geopotential_gradient_v(p_star, dx))
    p_next = p - dt * advection_of_geopotential(u_star, v_star, p_star, dx)
    return u_next, v_next, p_next


# ---------------------------------------------------------------------------
# A-grid Matsuno shallow water (reference matsuno.py)
# ---------------------------------------------------------------------------

def a_grid_advection_u(u, v, dx):
    """A-grid u self-advection (reference matsuno.py:27-40).

    Faithful to the reference, including its v-at-jm interpolation that
    averages u instead of v (``matsuno.py:34``) — this module is the
    documented checkerboard-prone experiment, kept as-is for parity.
    """
    u_ipj = (ipj(u) + u) / 2
    u_imj = (imj(u) + u) / 2
    du_ipj = ipj(u) - u
    du_imj = u - imj(u)
    v_ijp = (ijp(v) + v) / 2
    v_ijm = (ijm(u) + v) / 2
    du_ijp = ijp(u) - u
    du_ijm = u - ijm(u)
    return (u_ipj * du_ipj + u_imj * du_imj
            + v_ijp * du_ijp + v_ijm * du_ijm) / (2 * dx)


def a_grid_advection_v(u, v, dx):
    """A-grid v self-advection (reference matsuno.py:43-56, same caveat)."""
    u_ipj = (ipj(u) + u) / 2
    u_imj = (imj(u) + u) / 2
    dv_ipj = ipj(v) - v
    dv_imj = v - imj(v)
    v_ijp = (ijp(v) + v) / 2
    v_ijm = (ijm(u) + v) / 2
    dv_ijp = ijp(u) - v
    dv_ijm = v - ijm(v)
    return (u_ipj * dv_ipj + u_imj * dv_imj
            + v_ijp * dv_ijp + v_ijm * dv_ijm) / (2 * dx)


def a_grid_geopotential_gradient_u(p, dx):
    """(reference matsuno.py:59-65)"""
    return (ipj(p) - imj(p)) / (2 * dx) * constants.G


def a_grid_geopotential_gradient_v(p, dx):
    """(reference matsuno.py:68-74)"""
    return (ijp(p) - ijm(p)) / (2 * dx) * constants.G


def a_grid_advection_of_geopotential(u, v, p, dx):
    """(reference matsuno.py:77-86)"""
    up = u * p
    vp = v * p
    up_ipj = (ipj(up) + up) / 2
    up_imj = (imj(up) + up) / 2
    vp_ijp = (ijp(vp) + vp) / 2
    vp_ijm = (ijm(vp) + vp) / 2
    return (up_ipj - up_imj) / dx + (vp_ijp - vp_ijm) / dx


def matsuno_scheme_a_grid(u, v, p, dx, dt):
    """(reference matsuno.py:89-104)"""
    u_star = u - dt * (a_grid_advection_u(u, v, dx)
                       + a_grid_geopotential_gradient_u(p, dx))
    v_star = v - dt * (a_grid_advection_v(u, v, dx)
                       + a_grid_geopotential_gradient_v(p, dx))
    p_star = p - dt * a_grid_advection_of_geopotential(u, v, p, dx)

    u_next = u - dt * (a_grid_advection_u(u_star, v_star, dx)
                       + a_grid_geopotential_gradient_u(p_star, dx))
    v_next = v - dt * (a_grid_advection_v(u_star, v_star, dx)
                       + a_grid_geopotential_gradient_v(p_star, dx))
    p_next = p - dt * a_grid_advection_of_geopotential(u_star, v_star, p_star, dx)
    return u_next, v_next, p_next


# ---------------------------------------------------------------------------
# Shallow water + temperature + viscosity (reference matsumo_temp.py)
# ---------------------------------------------------------------------------

def density_from(p, t):
    """Density from pressure and potential temperature (reference matsumo_temp.py:13-19)."""
    temp = thermo.to_true_temp(t, p)
    return p / (constants.Rd * temp)


def geopotential_from(rho, p):
    """(reference matsumo_temp.py:45-47)"""
    return p / (constants.G * rho)


def _scaling(pa, t, dx):
    """(reference matsumo_temp.py:28-30)"""
    return pa * t * dx * dx


def _unscaling(pb, tt, dx):
    """(reference matsumo_temp.py:33-35)"""
    return tt / (pb * dx * dx)


def matsuno_scheme_temp(u, v, p, t, dx, dt, mu=constants.mu_air):
    """Matsuno SW step with temperature transport and viscosity damping
    (reference matsumo_temp.py:66-99).  Note: both du and dv damp with
    the Laplacian of u, as the reference does (matsumo_temp.py:72,75)."""
    density = density_from(p, t)
    geo = geopotential_from(density, p)
    scaled_t = _scaling(p, t, dx)
    u_star = u - dt * (advection_of_velocity_u(u, v, dx)
                       + geopotential_gradient_u(geo, dx)
                       - incompressible_viscosity_2d(u, mu, dx) / density)
    v_star = v - dt * (advection_of_velocity_v(u, v, dx)
                       + geopotential_gradient_v(geo, dx)
                       - incompressible_viscosity_2d(u, mu, dx) / density)
    p_star = p - dt * advection_of_geopotential(u, v, p, dx)
    tt = scaled_t - dt * advection_of_geopotential(u, v, scaled_t, dx)
    t_star = _unscaling(p_star, tt, dx)

    density_star = density_from(p_star, t_star)
    geo_star = geopotential_from(density_star, p_star)
    scaled_t_star = _scaling(p_star, t_star, dx)
    u_next = u - dt * (advection_of_velocity_u(u_star, v_star, dx)
                       + geopotential_gradient_u(geo_star, dx)
                       - incompressible_viscosity_2d(u_star, mu, dx) / density_star)
    v_next = v - dt * (advection_of_velocity_v(u_star, v_star, dx)
                       + geopotential_gradient_v(geo_star, dx)
                       - incompressible_viscosity_2d(u_star, mu, dx) / density_star)
    p_next = p - dt * advection_of_geopotential(u_star, v_star, p_star, dx)
    tt_next = scaled_t - dt * advection_of_geopotential(u_star, v_star,
                                                        scaled_t_star, dx)
    t_next = _unscaling(p_next, tt_next, dx)
    return u_next, v_next, p_next, t_next


# ---------------------------------------------------------------------------
# 2D GCM-II-form core (reference no_limits_2d.py)
# ---------------------------------------------------------------------------

def advec_p_2d(pu, pv, dx):
    """(reference no_limits_2d.py:41-44)"""
    return (pu - imj(pu)) / dx + (pv - ijm(pv)) / dx


def advec_m_2d(p, u, v, dx):
    """B-grid-flavored momentum advection (reference no_limits_2d.py:47-73)."""
    vph = iph(v)
    p_mid = iph(jph(p))

    puum = imh(u) ** 2 * p
    puup = ipj(puum)
    puvm = jmh(u) * ijm(vph) * ijm(p_mid)
    puvp = ipj(puvm)
    dut = (puum - puup) / dx + (puvm - puvp) / dx

    pvvm = jmh(v) ** 2 * p
    pvvp = ijp(pvvm)
    pvum = imj(p_mid) * imh(v) * imj(jph(u))
    pvup = ipj(pvum)
    dvt = (pvvm - pvvp) / dx + (pvum - pvup) / dx
    return dut, dvt


def pgf_2d(p, t, dx):
    """(reference no_limits_2d.py:76-89)"""
    ppih = iph(p)
    ttu = thermo.to_true_temp(iph(t), ppih)
    rhou = ppih / (constants.Rd * ttu)
    pgfu = ppih / rhou * gradi(p, dx)

    ppjh = jph(p)
    ttv = thermo.to_true_temp(jph(t), ppjh)
    rhov = ppjh / (constants.Rd * ttv)
    pgfv = ppjh / rhov * gradj(p, dx)
    return pgfu, pgfv


def advec_t_2d(pu, pv, t, dx):
    """(reference no_limits_2d.py:92-99)"""
    tpu = pu * iph(t)
    tpv = pv * jph(t)
    return (tpu - imj(tpu)) / dx + (tpv - ijm(tpv)) / dx


def half_timestep_2d(p, u, v, t, q, sp, su, sv, st, sq, dt, dx):
    """(reference no_limits_2d.py:104-126)"""
    pu = u * iph(p)
    spu = su * iph(sp)
    pv = v * jph(p)
    spv = sv * jph(sp)

    p_n = p - advec_p_2d(spu, spv, dx) * dt
    dut, dvt = advec_m_2d(sp, su, sv, dx)
    pgu, pgv = pgf_2d(sp, st, dx)

    pu_n = pu - (dut + pgu) * dt
    pv_n = pv - (dvt + pgv) * dt

    u_n = pu_n / iph(p_n)
    v_n = pv_n / jph(p_n)
    t_n = t - (advec_t_2d(spu, spv, st, dx) / p_n) * dt
    return p_n, u_n, v_n, t_n, q


def matsuno_timestep_2d(p, u, v, t, q, dt, dx):
    """(reference no_limits_2d.py:129-131)"""
    s = half_timestep_2d(p, u, v, t, q, p, u, v, t, q, dt, dx)
    return half_timestep_2d(p, u, v, t, q, *s, dt, dx)
