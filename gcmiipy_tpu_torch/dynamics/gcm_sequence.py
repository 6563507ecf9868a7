"""GCM-II DYNAM call sequence, 1D vectorized form.

Port of ``gcmiipy_tpu/dynamics/gcm_sequence.py``, the twin of reference
``port_one_d.py``: the cleanest translation of the original GISS GCM-II
Fortran main loop (AFLUX -> ADVECM -> ADVECV -> ADVECT -> ADVECQ -> PGF,
quoted at reference ``model.py:38-45`` and
``decoding_gcmii_temperature.py:82-128``), with the original's area scaling
of advected quantities and the +-0.5*QT humidity flux clamp.  The 2.5D core
(:mod:`gcmiipy_tpu_torch.dynamics.core25d`) is the production form of the
same scheme.
"""

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops.limiters import gcm2_limit_flux
from gcmiipy_tpu_torch.ops.stencil import im, ip, iph_1d as iph
from gcmiipy_tpu_torch.physics.thermo import thbar


def aflux(u, p, dy):
    """Air-mass fluxes (reference port_one_d.py:7-33).

    Returns (pu, conv, pit): zonal mass flux at edges, horizontal mass
    convergence, and the surface pressure tendency (equal for one layer).
    """
    pu = iph(p) * u * dy
    conv = im(pu) - pu
    pit = conv
    return pu, conv, pit


def advecm(p, pit, dt, area):
    """Advect mass -> new surface pressure (reference port_one_d.py:36-50)."""
    return p + (dt * pit / area)


def scaling(pa, q, dx):
    """Scale a quantity by cell pressure * area (reference port_one_d.py:53-65)."""
    return pa * q * dx * dx


def unscaling(pb, qq, dx):
    """Undo scaling with the new pressure (reference port_one_d.py:68-80)."""
    return qq / (pb * dx * dx)


def advecv(ut, pu, p, pa, u, dt, dx):
    """Advect momentum (reference port_one_d.py:83-125)."""
    ut_s = scaling(p, ut, dx)
    uph = iph(u)
    puph = iph(pu)
    fluxu = dt * puph * uph
    dut = im(fluxu) - fluxu
    ut_next = ut_s + dut
    return unscaling(pa, ut_next, dx)


def pgf(u, p, pa, t, dt, dx):
    """Pressure-gradient force, GISS vertical-differencing form
    (reference port_one_d.py:144-220).  Single layer with the mesopause as
    the layer top, exactly as the reference sets it up."""
    sha = constants.Rd / constants.kappa
    sp = p
    pdn = sp
    pkdn = pdn ** constants.kappa
    pkup = constants.p_mesopause ** constants.kappa

    # SPA: pressure-over-density scaling term (port_one_d.py:171-175)
    spa = 1 * sp * constants.Rd * t * pkdn / pdn

    theta = thbar(t, constants.t_mesopause)
    phi = sha * theta * (pkdn - pkup)

    dp = ip(p) - p
    dphi = ip(phi) - phi
    geo = iph(p) * dphi
    pg = iph(spa) * dp
    dut = (geo + pg) * dt * dx

    paph = iph(pa)
    u_next = u + unscaling(paph, dut, dx)
    return spa, theta, phi, geo, pg, u_next


def advect(pu, pa, tt, pb, t, dt, dx):
    """Advect temperature with area scaling (reference port_one_d.py:223-236)."""
    tt_s = scaling(pa, tt, dx)
    fluxq = pu * iph(t) * dt
    tt_s_next = tt_s + im(fluxq) - fluxq
    return unscaling(pb, tt_s_next, dx)


def advecq(pu, pa, qt, pb, q, dt, dx):
    """Advect humidity with the GCM-II +-0.5*QT flux clamp
    (reference port_one_d.py:239-258)."""
    qt_s = scaling(pa, qt, dx)
    fluxq = pu * iph(q) * dt
    fluxq_limited = gcm2_limit_flux(fluxq, qt_s)
    qt_s_next = qt_s + im(fluxq_limited) - fluxq_limited
    return unscaling(pb, qt_s_next, dx)


def dynam_matsuno(u, p, t, q, dt, dx):
    """Two-pass (Matsuno) DYNAM driver (reference port_one_d.py:261-282)."""
    pu, conv, pit = aflux(u, p, dx)
    pa = advecm(p, pit, dt, dx * dx)

    u_next = advecv(u, pu, p, pa, u, dt, dx)
    t_star = advect(pu, p, t, pa, t, dt, dx)
    q_star = advecq(pu, p, q, pa, q, dt, dx)
    spa, theta, phi, geo, pg, u_star = pgf(u_next, p, pa, t, dt, dx)
    p_star = pa

    # corrector pass against the starred state
    pu, conv, pit = aflux(u_star, p_star, dx)
    pa = advecm(p, pit, dt, dx * dx)

    u_next = advecv(u, pu, p, pa, u_star, dt, dx)
    t_next = advect(pu, p, t, pa, t_star, dt, dx)
    q_next = advecq(pu, p, q, pa, q_star, dt, dx)
    spa, theta, phi, geo, pg, u_next = pgf(u_next, p_star, pa, t, dt, dx)
    p_next = pa
    return u_next, p_next, t_next, q_next
