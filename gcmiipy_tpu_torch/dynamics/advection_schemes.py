"""1D / 2D advection scheme zoo.

Port of ``gcmiipy_tpu/dynamics/advection_schemes.py``: the 1D finite
difference schemes of reference ``just_units.py`` (FTCS, leapfrog, upwind
of orders 1-3, Lax-Friedrichs, method-of-lines splitting) and the 2D
dimensional-splitting / finite-volume schemes of reference ``two_d.py``
(upwind per axis, corner transport upwind, FV fluxes, A- and C-grid
pressure gradients).

Every stepper is a pure function (state -> new state) on tensors; the
harnesses of :mod:`gcmiipy_tpu_torch.model.harness` add the blow-up and
total-variation guards of the reference's interactive runners
(``just_units.py:298-340``, ``two_d.py:306-346``).
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops.stencil import im, ip


def _plus(v):
    return torch.clamp(v, min=0.0)


def _minus(v):
    return torch.clamp(v, max=0.0)


# ---------------------------------------------------------------------------
# 1D spatial operators (reference just_units.py:99-295)
# ---------------------------------------------------------------------------


def upwind_spatial(dx, v, q):
    """First-order upwind dq/dt contribution (reference just_units.py:99-117),
    in the single-V form the reference later fixed it to (two_d.py:11-32)."""
    fd = ip(q) - q
    bd = q - im(q)
    return (fd * _minus(v) + bd * _plus(v)) / dx


def central_spatial(dx, v, q):
    """Centered dq/dt contribution (reference just_units.py:243-255)."""
    return (ip(q) - im(q)) * v / (2 * dx)


def forward_time(dt, dx, v, q, spatial_func):
    """Forward-Euler in time over any spatial operator
    (reference just_units.py:258-265)."""
    return q - spatial_func(dx, v, q) * dt


def ftcs(dt, dx, v, q):
    """Forward-time centered-space: unconditionally unstable, the negative
    control (reference just_units.py:268-269)."""
    return forward_time(dt, dx, v, q, central_spatial)


def ft_upwind(dt, dx, v, q):
    """Forward-time upwind-space (reference just_units.py:272-273)."""
    return forward_time(dt, dx, v, q, upwind_spatial)


def leapfrog(dt, dx, v, q, q_prev):
    """Leapfrog: centered in space and time (reference just_units.py:78-96)."""
    return q_prev - (ip(q) - im(q)) * v * dt / dx


def upwind_second_order(dt, dx, v, q):
    """Second-order (3-point one-sided) upwind (reference just_units.py:157-183)."""
    fd = 4 * ip(q) - 3 * q - ip(ip(q))
    bd = 3 * q - 4 * im(q) + im(im(q))
    return q - (fd * _minus(v) + bd * _plus(v)) * dt / (2 * dx)


def upwind_third_order(dt, dx, v, q):
    """Third-order upwind-biased (reference just_units.py:186-212)."""
    bd = 2 * ip(q) + 3 * q - 6 * im(q) + im(im(q))
    fd = 6 * ip(q) - 3 * q - ip(ip(q)) - 2 * im(q)
    return q - (fd * _minus(v) + bd * _plus(v)) * dt / (6 * dx)


def lax_friedrichs(dt, dx, v, q):
    """Lax-Friedrichs: centered flux about the neighbor average
    (reference just_units.py:276-295)."""
    q_avg = (ip(q) + im(q)) / 2
    return q_avg - (ip(q) - im(q)) * v * dt / (2 * dx)


# ---------------------------------------------------------------------------
# 1D shallow-water forward-backward operators (reference just_units.py:343-383)
# ---------------------------------------------------------------------------


def sw_g_center_space(dt, dx, h):
    """A-grid geopotential gradient term (reference just_units.py:343-350)."""
    return (ip(h) - im(h)) / (2 * dx) * constants.G * dt


def sw_h_center_space(dt, dx, u, H):
    """A-grid height divergence term (reference just_units.py:353-361)."""
    return (ip(u) - im(u)) / (2 * dx) * H * dt


def sw_g_c_grid(dt, dx, h):
    """C-grid geopotential gradient at the u point (reference just_units.py:364-370)."""
    return (ip(h) - h) / dx * constants.G * dt


def sw_h_c_grid(dt, dx, u, H):
    """C-grid divergence at the h point (reference just_units.py:373-383)."""
    return (u - im(u)) / dx * H * dt


# ---------------------------------------------------------------------------
# 2D dimensional splitting / finite volume (reference two_d.py)
# ---------------------------------------------------------------------------


def upwind_axis(dt, spatial_change, V, q, axis=0):
    """Upwind along one axis; V is the stacked velocity field [dims, ...]
    (reference two_d.py:11-32)."""
    dx = spatial_change[axis]
    q_p_1 = torch.roll(q, -1, dims=axis)
    q_m_1 = torch.roll(q, 1, dims=axis)
    u_minus = q - q_m_1
    u_plus = q_p_1 - q
    return q - (_plus(V[axis]) * u_minus + _minus(V[axis]) * u_plus) * dt / dx


def corner_transport_2d(dt, spatial_change, V, q):
    """CTU via dimensional splitting (reference two_d.py:59-71)."""
    q_star = q
    for axis in range(2):
        q_star = upwind_axis(dt, spatial_change, V, q_star, axis)
    return q_star


def gradient(p, spatial_change, axis):
    """Centered gradient (reference two_d.py:74-77)."""
    return ((torch.roll(p, -1, dims=axis) - torch.roll(p, 1, dims=axis))
            / (2 * spatial_change[axis]))


def pressure_gradient(dt, spatial_change, p, t):
    """A-grid pressure-gradient acceleration, sigma pi/rho del pi
    (reference two_d.py:80-100)."""
    grad = torch.stack([gradient(p, spatial_change, 0),
                        gradient(p, spatial_change, 1)])
    true_t = t / (constants.P0 / p) ** constants.kappa
    rho = p / (constants.Rd * true_t)
    return grad / rho * dt


def fv_advect_axis_upwind(dt, spatial_change, V, p, axis=0):
    """Finite-volume upwind flux along one axis (reference two_d.py:103-116)."""
    dx = spatial_change[axis]
    p_p_1 = torch.roll(p, -1, dims=axis)
    flux = (p * _plus(V[axis]) + p_p_1 * _minus(V[axis])) * dt / dx
    return p - flux + torch.roll(flux, 1, dims=axis)


def fv_advect_axis_plain(dt, spatial_change, V, p, axis=0):
    """Centered-average FV flux (reference two_d.py:135-149)."""
    dx = spatial_change[axis]
    volume = 1.0
    for s in spatial_change:
        volume = volume * s
    area = volume / dx
    average_at_edge = (p + torch.roll(p, -1, dims=axis)) / 2
    flux = V[axis] * average_at_edge * dt * area
    return p - (flux - torch.roll(flux, 1, dims=axis)) / volume


def finite_volume_advection(dt, spatial_change, V, p):
    """Dimensionally-split FV upwind advection (reference two_d.py:198-207)."""
    p_star = p
    for axis in range(2):
        p_star = fv_advect_axis_upwind(dt, spatial_change, V, p_star, axis)
    return p_star


def pgf_c_grid_axis(p, spatial_change, axis=0):
    """C-grid pressure gradient along an axis (reference two_d.py:210-220)."""
    return (torch.roll(p, -1, dims=axis) - p) / spatial_change[axis]


def pgf_c_grid(dt, spatial_change, p, t):
    """C-grid PGF with potential-temperature density (reference two_d.py:223-245)."""
    grad = torch.stack([pgf_c_grid_axis(p, spatial_change, 0),
                        pgf_c_grid_axis(p, spatial_change, 1)])
    true_t = t / (constants.P0 / p) ** constants.kappa
    rho = p / (constants.Rd * true_t)
    return grad / rho * dt


def pressure_at_edge(p):
    """East/south edge-average pressures, stacked (reference two_d.py:264-268)."""
    p_east = (torch.roll(p, -1, dims=0) + p) / 2
    p_south = (torch.roll(p, -1, dims=1) + p) / 2
    return torch.stack([p_east, p_south])


def pgf_templess(dt, spatial_change, p):
    """PGF assuming dry air at standard temperature (reference two_d.py:248-261)."""
    grad = torch.stack([pgf_c_grid_axis(p, spatial_change, 0),
                        pgf_c_grid_axis(p, spatial_change, 1)])
    d_edge = pressure_at_edge(p) / (constants.Rd * constants.standard_temperature)
    return grad * dt / d_edge


def pgf_one_d(dt, dx, p, axis=0):
    """1D C-grid PGF (reference two_d.py:295-303)."""
    grad = (torch.roll(p, -1, dims=axis) - p) / dx
    d_edge = ((torch.roll(p, -1, dims=axis) + p) / 2
              / (constants.Rd * constants.standard_temperature))
    return grad * dt / d_edge


def advect_with_momentum(dt, spatial_change, V, p):
    """Advect pressure by the momentum field (reference two_d.py:277-292)."""
    momentum = V * pressure_at_edge(p)
    return finite_volume_advection(dt, spatial_change, momentum, p)
