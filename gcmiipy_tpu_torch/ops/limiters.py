"""Flux limiters and upwind fluxes.

Port of ``gcmiipy_tpu/ops/limiters.py`` (reference ``flux_limiter.py``)
plus the GCM-II +-0.5*QT flux clamp (reference port_one_d.py:246-251), the
clamp that ``q_limiter`` applies.  Every select is a ``torch.where``.
"""

import torch

from gcmiipy_tpu_torch.diagnostics import safe_div
from gcmiipy_tpu_torch.ops.stencil import im, ip


def van_leer(r):
    """Van Leer limiter psi(r) = (r + |r|)/(1 + |r|) (reference flux_limiter.py:10-11)."""
    return (r + torch.abs(r)) / (1 + torch.abs(r))


def calc_r(q):
    """Slope ratio r = (q_i - q_{i-1}) / (q_{i+1} - q_i), 0 where the
    denominator vanishes (reference flux_limiter.py:14-20), through
    :func:`safe_div`, whose inner select keeps 0/0 out of the unused
    branch (``torch.where`` evaluates both, and a gradient would carry the
    NaN)."""
    return safe_div(q - im(q), ip(q) - q)


def donor_cell_flux(q, u):
    """First-order upwind flux at i+1/2 (reference flux_limiter.py:23-27)."""
    q_edge = torch.where(u > 0, q, ip(q))
    return q_edge * u


def donor_cell_advection(q, u, dx, dt):
    """One forward-Euler donor-cell step (reference flux_limiter.py:30-32)."""
    flux = donor_cell_flux(q, u)
    return q + (im(flux) - flux) * dt / dx


def limit_flux(q, u, dx=None):
    """Upwind interface value times velocity (reference primitive_momentum_1d.py:31-38)."""
    q_h = torch.where(u < 0, ip(q), q)
    return q_h * u


def gcm2_limit_flux(fluxq, qt_scaled):
    """|flux| may not exceed half the upstream scaled tracer mass."""
    half = qt_scaled / 2
    return torch.maximum(torch.minimum(fluxq, half), -ip(half))
