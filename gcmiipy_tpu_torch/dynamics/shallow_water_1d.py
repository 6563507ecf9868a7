"""1D shallow-water and primitive-equation cores.

Port of ``gcmiipy_tpu/dynamics/shallow_water_1d.py``, the twin of three
reference modules:

* ``primitive_1d.py``: the 1D scheme zoo on a staggered grid: flux-form
  density advection, Matsuno / MacCormack / Lax-Friedrichs / upwind steppers
  and shallow water with a hard wall and optional bed topography;
* ``no_limits.py``: the 1D GCM-II-form core (p, u, T, q with PGF);
* ``primitive_momentum_1d.py``: the momentum-form variant with upwind
  flux limiting.

Grid: P at cell centers, U at i+1/2 (reference ``primitive_1d.py:4-8``).
The hard wall zeroes the last u of a new tensor: no stepper writes into a
tensor it was given.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.diagnostics import safe_div
from gcmiipy_tpu_torch.ops.limiters import donor_cell_flux, limit_flux
from gcmiipy_tpu_torch.ops.stencil import (
    div_1d as div, gradh_1d as gradh, im, imh_1d as imh, ip, iph_1d as iph,
)
from gcmiipy_tpu_torch.physics import thermo


def _wall(u):
    """``u`` with its last cell zeroed (the hard wall), as a new tensor."""
    return torch.cat([u[:-1], torch.zeros_like(u[-1:])])


# ---------------------------------------------------------------------------
# primitive_1d.py: scheme zoo
# ---------------------------------------------------------------------------

def advect_v_u(u, dx):
    """Advective (non-flux) momentum self-advection (reference primitive_1d.py:16-25)."""
    du_ip = ip(u) - u
    du_im = u - im(u)
    return (iph(u) * du_ip + imh(u) * du_im) / dx


def advect_rho(rho, u, dx):
    """Flux-form d(rho)/dt (reference primitive_1d.py:44-50)."""
    urho = u * iph(rho)
    return (urho - im(urho)) / dx


def advect_forward_euler(rho, u, dx, dt):
    """(reference primitive_1d.py:30-34)"""
    return rho - advect_rho(rho, u, dx) * dt, u


def advect_u_scaled(ut, u, p, pa, dt, dx):
    """Momentum update in p-scaled form (reference primitive_1d.py:53-70)."""
    u_at_h = imh(u)
    adv_val = u_at_h * u_at_h * p
    adv_diff = (adv_val - ip(adv_val)) / dx
    geo_val = p * p * constants.G / 2
    geo_diff = (geo_val - ip(geo_val)) / dx
    return ((ut * p) - (adv_diff + geo_diff) * dt) / pa


def advect_matsumo(rho, u, dt, dx):
    """Matsuno predictor-corrector on pure advection (reference primitive_1d.py:73-79)."""
    rho_star = rho - advect_rho(rho, u, dx) * dt
    rho_next = rho - advect_rho(rho_star, u, dx) * dt
    return rho_next, u


def shallow_water_matsuno(h, u, dt, dx):
    """1D shallow water, Matsuno stepping, hard wall at the right edge
    (reference primitive_1d.py:82-90)."""
    h_star = h - advect_rho(h, u, dx) * dt
    u_star = _wall(advect_u_scaled(u, u, h, h_star, dt, dx))
    h_next = h - advect_rho(h_star, u_star, dx) * dt
    u_next = _wall(advect_u_scaled(u, u_star, h_star, h_next, dt, dx))
    return h_next, u_next


def advect_maccormack(rho, u, dt, dx):
    """MacCormack two-stage (reference primitive_1d.py:93-99)."""
    rho_star = rho - advect_rho(rho, u, dx) * dt
    rho_next = ((rho + rho_star) - advect_rho(rho_star, u, dx) * dt) / 2
    return rho_next, u


def lf_flux(h, u, dt, dx):
    """Lax-Friedrichs numerical flux at i+1/2 (reference primitive_1d.py:107-110)."""
    return u * iph(h) - dx / (2 * dt) * (ip(h) - h)


def advect_lax_friedrichs(rho, u, dt, dx):
    """(reference primitive_1d.py:113-118)"""
    flux = lf_flux(rho, u, dt, dx)
    return rho - dt / dx * (flux - im(flux)), u


def advect_upwind(rho, u, dt, dx):
    """Donor-cell advection (reference primitive_1d.py:124-130)."""
    flux = donor_cell_flux(rho, u)
    return rho - dt / dx * (flux - im(flux)), u


def shallow_water_upwind(rho, u, dt, dx):
    """Upwind shallow water, periodic (reference primitive_1d.py:133-145)."""
    flux = donor_cell_flux(rho, u)
    rho_next = rho - dt / dx * (flux - im(flux))
    ut = u * iph(rho)
    fluxu = donor_cell_flux(ut, iph(u))
    du_advect = dt / dx * (fluxu - im(fluxu))
    geo_diff = (ip(rho) - rho) / dx * constants.G * dt * iph(rho)
    ut_next = ut - du_advect - geo_diff
    return rho_next, ut_next / iph(rho_next)


def shallow_water_upwind_boundary(rho, u, dt, dx):
    """Upwind shallow water with a hard wall (reference primitive_1d.py:148-161)."""
    rho_next, u_next = shallow_water_upwind(rho, u, dt, dx)
    return rho_next, _wall(u_next)


def shallow_water_bed_upwind_boundary(h, u, b, dt, dx):
    """Upwind shallow water over bed topography ``b``
    (reference primitive_1d.py:189-203)."""
    flux = donor_cell_flux(h, u)
    h_next = h - dt / dx * (flux - im(flux))
    ut = u * iph(h)
    fluxu = donor_cell_flux(ut, iph(u))
    du_advect = dt / dx * (fluxu - im(fluxu))
    geo = h + b
    geo_diff = (ip(geo) - geo) / dx * constants.G * dt * iph(h)
    ut_next = ut - du_advect - geo_diff
    u_next = safe_div(ut_next, iph(h_next))
    return h_next, _wall(u_next)


# ---------------------------------------------------------------------------
# no_limits.py: 1D GCM-II-form core (p, u, T, q)
# ---------------------------------------------------------------------------

def advec_q(u, q, dx):
    """C-scheme tracer flux divergence (reference no_limits.py:50-61)."""
    return ((iph(q) * u) - (imh(q) * im(u))) / dx


def calc_pu(u, p):
    """(reference no_limits.py:64-66)"""
    return u * iph(p)


def un_pu(pu, p):
    """(reference no_limits.py:68-69)"""
    return pu / iph(p)


def advec_p(pu, dx):
    """(reference no_limits.py:72-74)"""
    return div(pu, dx)


def advec_pu(p, pu, u, dx):
    """Momentum flux divergence (reference no_limits.py:77-90)."""
    puum = imh(u) ** 2 * p
    puup = iph(u) ** 2 * iph(p)
    return (puup - puum) / dx


def advec_t(pu, t, dx):
    """(reference no_limits.py:93-95)"""
    return div(pu * iph(t), dx)


def pgf(p, t, dx):
    """Pressure-gradient force at i+1/2 (reference no_limits.py:100-112)."""
    pph = iph(p)
    tph = iph(t)
    tt = thermo.to_true_temp(tph, pph)
    rho = pph / (constants.Rd * tt)
    return pph / rho * gradh(p, dx)


def half_timestep(p, u, t, q, sp, su, st, sq, dt, dx):
    """(reference no_limits.py:115-147)"""
    pu = calc_pu(u, p)
    spu = calc_pu(su, sp)
    q_n = q - advec_q(su, sq, dx) * dt
    p_n = p - advec_p(spu, dx) * dt
    pu_n = pu - (advec_pu(sp, spu, su, dx) + pgf(sp, st, dx)) * dt
    u_n = un_pu(pu_n, p_n)
    t_n = t - (advec_t(spu, st, dx) / p_n) * dt
    return p_n, u_n, t_n, q_n


def matsuno_timestep(p, u, t, q, dt, dx):
    """(reference no_limits.py:150-152)"""
    sp, su, st, sq = half_timestep(p, u, t, q, p, u, t, q, dt, dx)
    return half_timestep(p, u, t, q, sp, su, st, sq, dt, dx)


# ---------------------------------------------------------------------------
# primitive_momentum_1d.py: momentum form with upwind limiting
# ---------------------------------------------------------------------------

def advect_q_momentum(q_i, pu_h, dx):
    """Upwind-limited tracer flux divergence (reference primitive_momentum_1d.py:41-42)."""
    return div(limit_flux(q_i, pu_h), dx)


def advect_u_momentum(u_h, pu_h, dx):
    """Upwind-limited momentum self-advection (reference primitive_momentum_1d.py:45-50)."""
    return div(limit_flux(u_h, iph(pu_h)), dx)


def momentum_half_timestep(p, u, t, q, sp, su, st, sq, dt, dx):
    """(reference primitive_momentum_1d.py:53-78)"""
    p_h = iph(p)
    sp_h = iph(sp)
    pu_h = p_h * u
    spu_h = sp_h * su
    pt_i = p * t
    pq_i = p * q

    p_n = p - dt * div(spu_h, dx)
    rho_h = iph(sp / (constants.Rd
                      * (st / (constants.P0 / sp) ** constants.kappa)))
    pu_n = pu_h - dt * (advect_u_momentum(su, spu_h, dx)
                        + (sp_h / rho_h) * gradh(sp, dx))
    pt_n = pt_i - dt * advect_q_momentum(st, spu_h, dx)
    pq_n = pq_i - dt * advect_q_momentum(sq, spu_h, dx)
    return p_n, pu_n / p_n, pt_n / p_n, pq_n / p_n


def momentum_matsuno_timestep(p, u, t, q, dt, dx):
    """(reference primitive_momentum_1d.py:81-83)"""
    s = momentum_half_timestep(p, u, t, q, p, u, t, q, dt, dx)
    return momentum_half_timestep(p, u, t, q, *s, dt, dx)
