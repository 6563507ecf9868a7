"""K7: k whole Matsuno steps a call on the packed ping-pong buffer, with
the per-step column physics, as a CUDA kernel.

Replaces ``gcmiipy_tpu/ops/pallas_stream.py:make_stream_kernel`` (its
``pl.pallas_call`` at :652) and its ``physics_epilogue`` (:314-347).  The
state rides in one buffer ``S`` of shape (2, planes, H, W): buffer 0 holds
p, u, v, t, q as planes (:func:`pack_state`), and with the physics the
ground temperature as plane 1+4L; buffer 1 is scratch.  Step s advances
buffer s%2 into buffer (s+1)%2 with K6's whole step, then, with the
physics, runs the epilogue on the destination: grey radiation in the
ladder form, the fixed-sweep convective adjustment and the surface drag,
at the clock ``utc0 + s*dt``.  k is even, so the state ends in buffer 0.

* :func:`stream_steps_ref` is the plain PyTorch version.
* :func:`stream_steps` runs it on CPU tensors and launches
  ``csrc/stream_steps.cu`` (with ``csrc/column_physics.cuh``) on CUDA
  tensors, or raises; ``stream_steps.launches`` counts the launching calls,
  each of which adds to ``fft_filter.launches`` and
  ``pgf_rest.rest_stencil.launches`` the launches of the filter and of the
  rest stencil that its C entry counted (2k each).
* :class:`StreamSteps` holds the filter's buffers, the physics table and
  the kernel's scratch, allocated once and reused by every call.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops import cuda_lib, fft_filter as fft
from gcmiipy_tpu_torch.ops.fused_parts import (
    GEOM_FIELDS, MAX_LAYERS, kernel_consts, on_cpu, pointer_array)
from gcmiipy_tpu_torch.ops.mega_step import (
    MegaStep, _check as check_filter_args, banded_round, filter_args,
    mega_step_ref)
from gcmiipy_tpu_torch.ops.pgf_rest import add_stencil_launches
from gcmiipy_tpu_torch.physics import convection, radiation

CONVECTION_SWEEPS = 4  # the fixed-sweep count of the JAX kernel's epilogue


def n_planes(layers):
    """Packed field-plane count: p + the four (L, H, W) prognostics."""
    return 1 + 4 * layers


def pack_state(p, u, v, t, q, gt=None):
    """Stack (p, u, v, t, q) into the (1+4L, H, W) plane layout, with the
    ground temperature ``gt`` as one more plane when given."""
    planes = [p[None], u, v, t, q]
    if gt is not None:
        planes.append(gt[None])
    return torch.cat(planes, dim=0)


def unpack_state(packed, layers):
    """Inverse of :func:`pack_state` (views of ``packed``)."""
    L = layers
    return (packed[0], packed[1:1 + L], packed[1 + L:1 + 2 * L],
            packed[1 + 2 * L:1 + 3 * L], packed[1 + 3 * L:1 + 4 * L])


class Physics(NamedTuple):
    """The epilogue's parameters as Python floats: the layers' sigma
    midpoints and thicknesses and ptop (from the geometry in the working
    dtype), the grey-radiation parameters, the drag time scale (0: off),
    the fixed convection sweeps (0: off) and the seasonal clock."""
    sig: tuple
    dsig: tuple
    ptop: float
    t_lw: float
    t_sw: float
    albedo: float
    drag_tau: float
    sweeps: int
    seasonal: bool
    obliquity: float
    year_days: float


def make_physics(geom, t_lw=0.1, t_sw=0.9, albedo=0.3, drag_tau=0.0,
                 convection=False, seasonal=False, obliquity=23.44,
                 year_days=365.0):
    """:class:`Physics` of ``geom`` (one host read of its sigma ladder)."""
    return Physics(
        tuple(float(x) for x in geom.sig.flatten().tolist()),
        tuple(float(x) for x in geom.dsig.flatten().tolist()),
        float(geom.ptop), float(t_lw), float(t_sw), float(albedo),
        float(drag_tau), CONVECTION_SWEEPS if convection else 0,
        bool(seasonal), float(obliquity), float(year_days))


def physics_epilogue_ref(p, u, v, t, gt, utc_s, geom, dt, ph):
    """Plain version of the epilogue on one step's new state (JAX
    ``physics_epilogue``): returns ``(u, v, t, gt)`` after grey radiation
    (ladder form), the fixed-sweep convective adjustment and the drag on
    layer 0, at the clock ``utc_s`` (the start of the step)."""
    tp = torch.stack([p * s_ + ph.ptop for s_ in ph.sig])
    exner_inv = (constants.P0 / tp) ** constants.kappa
    tt = t / exner_inv
    decl = (radiation.solar_declination(utc_s, ph.obliquity, ph.year_days)
            if ph.seasonal else 0.0)
    sza = radiation.zenith_angle(geom.long, geom.lat, utc_s,
                                 declination=decl)
    dTdt, dtg = radiation.basic_grey_radiation_ladder(
        p, tt, gt, ph.t_lw, ph.t_sw, ph.albedo, sza, ph.dsig)
    gt_n = gt + dtg * dt
    tt = tt + dTdt * dt
    if ph.sweeps:
        dp = torch.stack([p * d_ for d_ in ph.dsig])
        tt = convection.convective_adjustment(tt, tp, dp, adaptive=False,
                                              sweeps=ph.sweeps)
    t_n = tt * exner_inv
    if ph.drag_tau > 0:
        f = 1.0 / (1.0 + dt / ph.drag_tau)
        u = torch.cat([u[:1] * f, u[1:]], dim=0)
        v = torch.cat([v[:1] * f, v[1:]], dim=0)
    return u, v, t_n, gt_n


def stream_steps_ref(S, utc0, k, dt, geom, fc, coriolis=False,
                     q_limiter=False, physics=None, filter_ref=None):
    """Plain version of K7: ``k`` (even) times, :func:`mega_step_ref` (with
    the filter round ``filter_ref``; None: the banded DFT, built once for
    the call) from buffer s%2 of ``S`` into buffer
    (s+1)%2, then with ``physics`` (a :class:`Physics`)
    :func:`physics_epilogue_ref` at ``utc0 + s*dt``, the ground temperature
    taken from the source buffer.  Updates ``S`` in place and returns it."""
    _check_steps(S, k, geom, physics)
    L, NP = geom.layers, n_planes(geom.layers)
    if filter_ref is None:
        filter_ref = banded_round(geom)
    for s in range(k):
        src, dst = S[s % 2], S[(s + 1) % 2]
        p, u, v, t, q = mega_step_ref(*unpack_state(src, L), dt, geom, fc,
                                      coriolis=coriolis, q_limiter=q_limiter,
                                      filter_ref=filter_ref)
        if physics is not None:
            utc_s = utc0 + torch.full_like(utc0, s) * dt
            u, v, t, gt = physics_epilogue_ref(p, u, v, t, src[NP], utc_s,
                                               geom, dt, physics)
            dst[NP] = gt
        dst[:NP] = pack_state(p, u, v, t, q)
    return S


def physics_table(ph, dt):
    """The epilogue's ``PhysTable`` (``csrc/column_physics.cuh``) as a C
    array of doubles: the scalars, then each per-layer row padded to
    ``MAX_LAYERS``.  Each entry is the Python float that
    :func:`physics_epilogue_ref` uses at that point."""
    lw_t, sw_t, cum_sw_top, clw_b_div = radiation.ladder_constants(
        ph.t_lw, ph.t_sw, ph.dsig)
    sb = constants.sb_constant
    scalars = [
        dt, ph.ptop, constants.P0, constants.kappa, sb,
        constants.solar_constant, constants.Cg, 1.0 - ph.albedo,
        cum_sw_top[0], float(ph.drag_tau > 0),
        1.0 / (1.0 + dt / ph.drag_tau) if ph.drag_tau > 0 else 1.0,
        ph.sweeps, float(ph.seasonal), -math.radians(ph.obliquity),
        ph.year_days, constants.Rd, constants.G, convection.CRITICAL_LAPSE,
        2 * math.pi, math.pi]
    L = len(ph.dsig)
    rows = [
        ph.sig, ph.dsig,
        [(1.0 - lw_t[k]) * sb for k in range(L)],
        clw_b_div,
        [1.0 - x for x in lw_t],
        lw_t,
        [clw_b_div[k] * (1.0 - lw_t[k]) for k in range(L)],
        [(1.0 - sw_t[k]) * cum_sw_top[k] / sw_t[k] for k in range(L)],
        [constants.G / (constants.Cp * float(d)) for d in ph.dsig]]
    flat = list(map(float, scalars))
    for row in rows:
        flat += list(map(float, row)) + [0.0] * (MAX_LAYERS - L)
    return (ctypes.c_double * len(flat))(*flat)


def _check_steps(S, k, geom, physics):
    L, H, W = geom.layers, geom.height, geom.width
    planes = n_planes(L) + (physics is not None)
    if tuple(S.shape) != (2, planes, H, W):
        raise ValueError(f"stream_steps: S of shape (2, {planes}, {H}, {W}) "
                         f"expected, got {tuple(S.shape)}")
    if k < 0 or k % 2:
        raise ValueError(f"k must be even (buffer ping-pong), got {k}")


def _library():
    lib = cuda_lib.load("stream_steps")
    fn = lib.gcm_stream_steps
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        dbl = ctypes.POINTER(ctypes.c_double)
        i, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, vp, i, i, vp, ptrs, ptrs, vp, i,
                       ctypes.POINTER(i), i, ptrs, i, i, i, dbl, i, i, dbl,
                       vp, vp, ctypes.POINTER(i), ctypes.POINTER(i), vp]
        fn.restype = ctypes.c_int
    return fn


def new_scratch(geom, dtype, device):
    """The kernel's scratch: the predictor's p, u, v, t, q, then X (2L,H,W),
    pg_phiv, sd, phi, rho (L,H,W)."""
    L, H, W = geom.layers, geom.height, geom.width

    def new(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    return ([new(H, W)] + [new(L, H, W) for _ in range(4)]
            + [new(2 * L, H, W)] + [new(L, H, W) for _ in range(4)])


def stream_steps(S, utc0, k, dt, geom, fc, coriolis=False, q_limiter=False,
                 physics=None, table=None, scratch=None):
    """K7: advances ``S`` (2, planes, H, W) by ``k`` (even) steps in place
    and returns it, as :func:`stream_steps_ref`.  ``utc0``: 0-dim clock
    tensor at the start of the call (read on the device); ``fc`` from
    :func:`mega_step.build_filter_consts`; ``table``/``scratch``: the
    physics table and :func:`new_scratch`, made here when not given."""
    if on_cpu("stream_steps", (S, utc0)):
        return stream_steps_ref(S, utc0, k, dt, geom, fc, coriolis=coriolis,
                                q_limiter=q_limiter, physics=physics)
    device = S.device
    _check_steps(S, k, geom, physics)
    if not S.is_contiguous():
        raise ValueError("stream_steps: S is not contiguous")
    if (utc0.device != device or utc0.dtype != S.dtype or utc0.dim() != 0):
        raise ValueError(f"stream_steps: utc0 must be a 0-dim {S.dtype} "
                         f"tensor on {device}")
    check_filter_args(unpack_state(S[0], geom.layers), geom, fc)
    lat, lon = geom.lat, geom.long
    for name, x in (("lat", lat), ("long", lon)):
        if x.device != device or x.dtype != S.dtype or not x.is_contiguous():
            raise ValueError(f"geom.{name} must be a contiguous {S.dtype} "
                             f"tensor on {device}")
    if physics is not None and table is None:
        table = physics_table(physics, dt)
    if scratch is None:
        scratch = new_scratch(geom, S.dtype, device)
    fn = _library()
    L, H, W = geom.layers, geom.height, geom.width
    filter_launches, stencil_launches = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(int(S.dtype == torch.float64), S.data_ptr(), S.shape[1],
                 int(k), utc0.data_ptr(),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 *filter_args(fc, W), pointer_array(scratch), L, H, W,
                 kernel_consts(dt), int(bool(coriolis)),
                 int(bool(q_limiter)), table,
                 lat.data_ptr(), lon.data_ptr(), ctypes.byref(filter_launches),
                 ctypes.byref(stencil_launches),
                 torch.cuda.current_stream(device).cuda_stream)
    fft.add_launches(filter_launches)
    add_stencil_launches(stencil_launches)
    if err != 0:
        raise RuntimeError(
            f"stream_steps kernel launch failed: CUDA error {err}")
    stream_steps.launches += 1
    return S


stream_steps.launches = 0


class StreamSteps(MegaStep):
    """The 'stream' launch of one geometry: ``StreamSteps(geom, dt,
    physics=...)(S, utc0, k)`` runs :func:`stream_steps` with the filter
    buffers of :class:`MegaStep`, the physics table and the scratch it
    holds (the scratch is made at the first call on a card and reused by
    every later one)."""

    def __init__(self, geom, dt, coriolis=False, q_limiter=False,
                 physics=None):
        super().__init__(geom, dt, coriolis=coriolis, q_limiter=q_limiter)
        self.physics = physics
        self.table = (None if physics is None
                      else physics_table(physics, self.dt))
        self.scratch = None

    def forward(self, S, utc0, k):
        scratch = None
        if S.device.type == "cuda":
            if (self.scratch is None or self.scratch[0].dtype != S.dtype
                    or self.scratch[0].device != S.device):
                self.scratch = new_scratch(self.geom, S.dtype, S.device)
            scratch = self.scratch
        return stream_steps(S, utc0, k, self.dt, self.geom, self.consts,
                            coriolis=self.coriolis, q_limiter=self.q_limiter,
                            physics=self.physics, table=self.table,
                            scratch=scratch)


def make_stream_matsuno(geom, dt, steps_per_launch=8, coriolis=False,
                        q_limiter=False):
    """Plain-state wrapper (JAX ``make_stream_matsuno``):
    ``advance(p, u, v, t, q, n) -> (p, u, v, t, q)`` packs once, runs
    ``n // steps_per_launch`` calls of ``steps_per_launch`` steps and
    unpacks once; ``n`` must be a multiple of ``steps_per_launch``."""
    step = StreamSteps(geom, dt, coriolis=coriolis, q_limiter=q_limiter)
    L = geom.layers

    def advance(p, u, v, t, q, n):
        if n % steps_per_launch:
            raise ValueError(f"n={n} not a multiple of {steps_per_launch}")
        packed = pack_state(p, u, v, t, q)
        S = torch.stack([packed, torch.zeros_like(packed)])
        utc0 = torch.zeros((), dtype=S.dtype, device=S.device)
        for _ in range(n // steps_per_launch):
            step(S, utc0, steps_per_launch)
        return tuple(x.clone() for x in unpack_state(S[0], L))

    return advance
