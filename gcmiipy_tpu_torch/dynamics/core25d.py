"""2.5D primitive-equation dynamical core (flux form, Arakawa C-grid, sigma).

Port of ``gcmiipy_tpu/dynamics/core25d.py`` (itself the twin of reference
``dynamics.py``).  State layout ``[k, j, i]`` with surface pressure ``p`` as
``[j, i]``; u at i+1/2, v at j+1/2, potential temperature ``t`` and specific
humidity ``q`` at cell centers.  Plain PyTorch on plain SI tensors: this is
the twin every CUDA kernel of the port is held against.

Sums over the layer axis are written out in a fixed order (forward for
totals and prefix sums, from the top for suffix sums), so the CUDA kernel
(``csrc/fused_parts.cu``) can reproduce them operation for operation.
"""

import functools

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops import polar_filter
from gcmiipy_tpu_torch.ops.stencil import (
    ijm, ijp, imh, imj, iph, ipj, jmh, jph, km, kmh, kp, kph,
)


def calc_pu(p, u):
    """Zonal mass flux pu = u * p interpolated to i+1/2 (reference dynamics.py:15-17)."""
    return u * iph(p)


def calc_pv(p, v):
    """Meridional mass flux pv = v * p at j+1/2 (reference dynamics.py:20-22)."""
    return v * jph(p)


def un_pu(pu, p):
    """Recover u from the zonal mass flux (reference dynamics.py:25-27):
    2D reciprocal + 3D multiply, as the JAX core does."""
    return pu * (1.0 / iph(p))


def un_pv(pv, p):
    """Recover v from the meridional mass flux (reference dynamics.py:30-32)."""
    return pv * (1.0 / jph(p))


def _sum_k(x):
    """sum over the layer axis, in order k = 0, 1, ..., L-1."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def _suffix_sum_k(x):
    """sd[k] = sum_{k' >= k} x[k'], accumulated from the top layer down."""
    L = x.shape[0]
    ys = [None] * L
    acc = x[L - 1]
    ys[L - 1] = acc
    for k in range(L - 2, -1, -1):
        acc = acc + x[k]
        ys[k] = acc
    return torch.stack(ys, dim=0)


def _prefix_sum_k(x):
    """Cumulative sum over the layer axis, in order."""
    ys = [x[0]]
    for k in range(1, x.shape[0]):
        ys.append(ys[-1] + x[k])
    return torch.stack(ys, dim=0)


def aflux(pu, pv, geom):
    """Mass convergence -> surface-pressure tendency and sigma-dot
    (reference dynamics.py:35-46).

    Returns (pit, sd): ``pit`` is the column-integrated convergence, ``sd``
    the vertical sigma mass flux at layer bottoms with sd[0] pinned to zero.
    """
    rdx_j = 1.0 / geom.dx_j.to(pu.dtype)
    rdy = 1.0 / geom.dy.to(pu.dtype)
    dsig = geom.dsig.to(pu.dtype)
    sigb = geom.sigb.to(pu.dtype)

    conv = ((pu - imj(pu)) * rdx_j + (pv - ijm(pv)) * rdy) * dsig
    pit = _sum_k(conv)
    sd = _suffix_sum_k(conv)
    sd = sd - pit * sigb
    # surface boundary condition (dynamics.py:44)
    sd = torch.cat([torch.zeros_like(sd[:1]), sd[1:]], dim=0)
    return pit, sd


def advec_sig(sd, q, geom):
    """Vertical (sigma) advection tendency of ``q`` (reference dynamics.py:49-53)."""
    rdsig = 1.0 / geom.dsig.to(q.dtype)
    flux = kmh(q) * sd
    dq = (flux - kp(flux)) * rdsig
    return -dq


def advec_m_pu(p, u, v, pu, pv, geom, coriolis=False):
    """Horizontal momentum-flux advection tendencies (dut, dvt)
    (reference dynamics.py:55-108); ``coriolis=True`` enables the term the
    reference computes but disables (dynamics.py:82-95)."""
    rdx_j = 1.0 / geom.dx_j.to(u.dtype)
    rdx_h = 1.0 / geom.dx_h.to(u.dtype)
    rdy = 1.0 / geom.dy.to(u.dtype)

    puum = imh(u) * imh(pu)
    puup = ipj(puum)

    puvp = iph(pv) * jph(u)
    puvm = ijm(puvp)

    pvvm = jmh(v) * jmh(pv)
    pvvp = ijp(pvvm)
    pvup = iph(v) * jph(pu)
    pvum = imj(pvup)

    if coriolis:
        pu_at_pv = imh(jph(pu))
        pv_at_pu = iph(jmh(pv))
        w = 2 * constants.earth_omega  # (dynamics.py:87-89)
        lat = geom.lat.to(u.dtype)
        cp_at_u = torch.sin(lat) * w
        cp_at_v = torch.sin(jph(lat)) * w
        coriolis_u = cp_at_u * -pv_at_pu
        coriolis_v = cp_at_v * pu_at_pv
    else:
        coriolis_u = 0.0
        coriolis_v = 0.0

    dut = (puum - puup) * rdx_j + (puvm - puvp) * rdy + coriolis_u
    dvt = (pvvm - pvvp) * rdy + (pvum - pvup) * rdx_h + coriolis_v
    return dut, dvt


def compute_geopotential(p, t, geom):
    """Layer geopotential via the GISS Cp*thbar*(p^k_dn - p^k_up) ladder
    (reference dynamics.py:111-143, the returned "theirs" form)."""
    dt_ = t.dtype
    sig, dsig = geom.sig.to(dt_), geom.dsig.to(dt_)
    sigt, ptop = geom.sigt.to(dt_), geom.ptop.to(dt_)
    heightmap = geom.heightmap.to(dt_)

    tp = p * sig + ptop
    tt = t / ((constants.P0 / tp) ** constants.kappa)
    rho = tp / (constants.Rd * tt)

    sp = sig * p
    spa = sp / rho
    s1 = spa * dsig

    pkdn = ((sig * p + ptop) / constants.P0) ** constants.kappa
    pkup = kp(pkdn)
    stp = constants.Cp * kph(t) * (pkdn - pkup)
    s2 = sigt * stp
    base = _sum_k(s1 - s2) + heightmap * constants.G
    stp_n = torch.cat([base[None], km(stp)[1:]], dim=0)
    return _prefix_sum_k(stp_n)


def compute_geopotential_hydrostatic(p, t, geom):
    """Hydrostatic-cumsum geopotential (the reference's "mine" form,
    dynamics.py:117-119)."""
    dt_ = t.dtype
    sig, dsig = geom.sig.to(dt_), geom.dsig.to(dt_)
    ptop, heightmap = geom.ptop.to(dt_), geom.heightmap.to(dt_)

    tp = p * sig + ptop
    tt = t / ((constants.P0 / tp) ** constants.kappa)
    rho = tp / (constants.Rd * tt)
    dp = p * dsig
    depth = dp / (rho * constants.G)
    phi = heightmap + torch.cumsum(depth, dim=0) - depth / 2
    return phi * constants.G


def pgf_column(p, t, geom):
    """The column part of :func:`pgf`: the density ``rho`` and the
    geopotential ``phi`` of each layer, with the ladder inlined so tp,
    p^kappa, tt and rho are computed once, as the JAX core does."""
    dt_ = t.dtype
    sig, dsig = geom.sig.to(dt_), geom.dsig.to(dt_)
    sigt, ptop = geom.sigt.to(dt_), geom.ptop.to(dt_)
    heightmap = geom.heightmap.to(dt_)

    tp = p * sig + ptop
    pk = (tp * (1.0 / constants.P0)) ** constants.kappa
    tt = t * pk
    rho = tp / (constants.Rd * tt)
    sp = sig * p

    spa = sp / rho
    s1 = spa * dsig
    pkup = kp(pk)
    stp = constants.Cp * kph(t) * (pk - pkup)
    s2 = sigt * stp
    base = _sum_k(s1 - s2) + heightmap * constants.G
    stp_n = torch.cat([base[None], km(stp)[1:]], dim=0)
    return rho, _prefix_sum_k(stp_n)


def pgf(p, t, geom):
    """Pressure-gradient force terms (pgfu, pgfv, phiu, phiv)
    (reference dynamics.py:147-171) from :func:`pgf_column`'s rho and
    phi."""
    dt_ = t.dtype
    sig = geom.sig.to(dt_)
    rdx_j = 1.0 / geom.dx_j.to(dt_)
    rdy = 1.0 / geom.dy.to(dt_)
    rho, phi = pgf_column(p, t, geom)
    sp = sig * p

    phiu = iph(p) * ((ipj(phi) - phi) * rdx_j)
    phiv = jph(p) * ((ijp(phi) - phi) * rdy)

    pgfu = iph(sp) / iph(rho) * ((ipj(p) - p) * rdx_j)
    pgfv = jph(sp) / jph(rho) * ((ijp(p) - p) * rdy)
    return pgfu, pgfv, phiu, phiv


def advec_t(pu, pv, t, geom):
    """Flux-form horizontal advection of a cell-centered scalar
    (reference dynamics.py:174-181)."""
    rdx_j = 1.0 / geom.dx_j.to(t.dtype)
    rdy = 1.0 / geom.dy.to(t.dtype)
    tpu = pu * iph(t)
    tpv = pv * jph(t)
    return (tpu - imj(tpu)) * rdx_j + (tpv - ijm(tpv)) * rdy


def advec_q_limited(pu, pv, q, qp, dt, geom):
    """Flux-form horizontal advection of ``q`` with the GCM-II ADVECQ
    +-0.5*QT flux clamp (reference port_one_d.py:239-258): a face may move
    at most half the donor cell's tracer mass ``qp = q * p`` in one step."""
    rdx_j = 1.0 / geom.dx_j.to(q.dtype)
    rdy = 1.0 / geom.dy.to(q.dtype)
    half = 0.5 * qp
    fx = pu * iph(q) * (dt * rdx_j)
    fx = torch.clamp(fx, -ipj(half), half)
    fy = pv * jph(q) * (dt * rdy)
    fy = torch.clamp(fy, -ijp(half), half)
    return ((fx - imj(fx)) + (fy - ijm(fy))) * (1.0 / dt)


def half_timestep_parts(p, u, v, t, q, sp, su, sv, st, sq, spu, dt, geom,
                        coriolis=False, q_limiter=False):
    """Everything between the two polar-filter applications of a half step
    (reference dynamics.py:183-227).

    ``spu`` is the already-filtered zonal mass flux.  Returns
    ``(p_n, v_n, t_n, q_n, pu_partial, pg_phi)``: ``pu_partial`` still lacks
    the filtered force, ``pg_phi = pgu + phiu`` awaits the second filter.
    The polar-row v boundary condition is the caller's.
    """
    pu = calc_pu(p, u)
    pv = calc_pv(p, v)
    spv = calc_pv(sp, sv)

    pit, sd = aflux(spu, spv, geom)
    p_n = p - pit * dt

    dut, dvt = advec_m_pu(sp, su, sv, spu, spv, geom, coriolis=coriolis)
    pgu, pgv, phiu, phiv = pgf(sp, st, geom)
    dus = advec_sig(iph(sd), su, geom)
    dvs = advec_sig(jph(sd), sv, geom)

    pu_partial = pu - (dut + dus) * dt
    pv_n = pv - (dvt + dvs + phiv + pgv) * dt
    v_n = un_pv(pv_n, p_n)

    rp_n = 1.0 / p_n
    t_n = (t * p - (advec_t(spu, spv, st, geom) + advec_sig(sd, st, geom)) * dt) * rp_n
    adv_q = (advec_q_limited(spu, spv, sq, q * p, dt, geom) if q_limiter
             else advec_t(spu, spv, sq, geom))
    q_n = (q * p - (adv_q + advec_sig(sd, sq, geom)) * dt) * rp_n

    return p_n, v_n, t_n, q_n, pu_partial, pgu + phiu


def pgf_forces(sp, su, st, geom):
    """The two filter-bound quantities of a half step plus the meridional
    force: ``(spu_raw, pg_phi, pg_phiv)``."""
    pgu, pgv, phiu, phiv = pgf(sp, st, geom)
    return calc_pu(sp, su), pgu + phiu, pgv + phiv


def half_timestep_rest(p, u, v, t, q, sp, su, sv, st, sq, spu, dt, geom,
                       coriolis=False, q_limiter=False):
    """Half-step tendency assembly minus the PGF terms (which
    :func:`pgf_forces` provides).  Returns
    ``(p_n, pu_partial, pv_partial, t_n, q_n)``."""
    spv = calc_pv(sp, sv)
    pit, sd = aflux(spu, spv, geom)
    p_n = p - pit * dt
    return (p_n,) + rest_tendencies(p, u, v, t, q, sp, su, sv, st, sq, spu,
                                    spv, sd, p_n, dt, geom,
                                    coriolis=coriolis, q_limiter=q_limiter)


def rest_tendencies(p, u, v, t, q, sp, su, sv, st, sq, spu, spv, sd, p_n, dt,
                    geom, coriolis=False, q_limiter=False):
    """:func:`half_timestep_rest` after the mass flux divergence, on its
    meridional mass flux ``spv``, sigma-dot ``sd`` and new surface pressure
    ``p_n``.  Returns ``(pu_partial, pv_partial, t_n, q_n)``."""
    pu = calc_pu(p, u)
    pv = calc_pv(p, v)

    dut, dvt = advec_m_pu(sp, su, sv, spu, spv, geom, coriolis=coriolis)
    dus = advec_sig(iph(sd), su, geom)
    dvs = advec_sig(jph(sd), sv, geom)

    pu_partial = pu - (dut + dus) * dt
    pv_partial = pv - (dvt + dvs) * dt

    rp_n = 1.0 / p_n
    t_n = (t * p - (advec_t(spu, spv, st, geom) + advec_sig(sd, st, geom)) * dt) * rp_n
    adv_q = (advec_q_limited(spu, spv, sq, q * p, dt, geom) if q_limiter
             else advec_t(spu, spv, sq, geom))
    q_n = (q * p - (adv_q + advec_sig(sd, sq, geom)) * dt) * rp_n

    return pu_partial, pv_partial, t_n, q_n


def _polar_wall(v_n):
    """Southern-row wall: v = 0 on the last latitude row (dynamics.py:222).
    ``v_n`` is a fresh tensor of this half step, so it is set in place."""
    v_n[:, -1, :] = 0.0
    return v_n


def half_timestep_v2(p, u, v, t, q, sp, su, sv, st, sq, dt, geom,
                     filter_fn=None, coriolis=False, q_limiter=False):
    """Half step with ONE batched polar-filter call (pgf-first pipeline);
    the same half step as :func:`half_timestep` up to float-add
    reassociation of the pv force sum."""
    if filter_fn is None:
        filter_fn = polar_filter.arakawa_1977

    L = u.shape[0]
    spu_raw, pg_phi, pg_phiv = pgf_forces(sp, su, st, geom)
    filt = filter_fn(torch.cat([spu_raw, pg_phi], dim=0), geom)
    spu, pgfu = filt[:L], filt[L:]

    p_n, pu_partial, pv_partial, t_n, q_n = half_timestep_rest(
        p, u, v, t, q, sp, su, sv, st, sq, spu, dt, geom, coriolis=coriolis,
        q_limiter=q_limiter)

    u_n = (pu_partial - pgfu * dt) * (1.0 / iph(p_n))
    v_n = _polar_wall((pv_partial - pg_phiv * dt) * (1.0 / jph(p_n)))
    return p_n, u_n, v_n, t_n, q_n


def half_timestep(p, u, v, t, q, sp, su, sv, st, sq, dt, geom,
                  filter_fn=None, coriolis=False, q_limiter=False):
    """One forward(-backward) half step of the Matsuno scheme
    (reference dynamics.py:183-227).  (p,u,v,t,q) is the base state being
    advanced; (sp,su,...) the state the tendencies are evaluated at."""
    if filter_fn is None:
        filter_fn = polar_filter.arakawa_1977

    spu = filter_fn(calc_pu(sp, su), geom)  # (dynamics.py:189)
    p_n, v_n, t_n, q_n, pu_partial, pg_phi = half_timestep_parts(
        p, u, v, t, q, sp, su, sv, st, sq, spu, dt, geom, coriolis=coriolis,
        q_limiter=q_limiter)
    pgfu = filter_fn(pg_phi, geom)  # (dynamics.py:202)
    u_n = un_pu(pu_partial - pgfu * dt, p_n)
    return p_n, u_n, _polar_wall(v_n), t_n, q_n


def matsuno_timestep(p, u, v, t, q, dt, geom, boundary_conditions=None,
                     filter_fn=None, coriolis=False, q_limiter=False):
    """Full Matsuno (forward-backward predictor-corrector) step
    (reference dynamics.py:230-237)."""
    step = functools.partial(half_timestep, dt=dt, geom=geom,
                             filter_fn=filter_fn, coriolis=coriolis,
                             q_limiter=q_limiter)
    sp, su, sv, st, sq = step(p, u, v, t, q, p, u, v, t, q)
    if boundary_conditions:
        sp, su, sv, st, sq = boundary_conditions(sp, su, sv, st, sq, dt, geom)
    op, ou, ov, ot, oq = step(p, u, v, t, q, sp, su, sv, st, sq)
    if boundary_conditions:
        op, ou, ov, ot, oq = boundary_conditions(op, ou, ov, ot, oq, dt, geom)
    return op, ou, ov, ot, oq
