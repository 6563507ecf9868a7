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
  each of which adds to ``pgf_rest.pgf_tile.launches``,
  ``fft_filter.launches`` and ``pgf_rest.rest_stencil.launches`` the
  launches of the pgf tile, the filter and the rest tile that its C
  entry counted (2k each), and to ``column_physics.launches`` the
  epilogue's (k with the physics).
* :func:`stream_steps_shard` is K7's shard form (JAX ``make_stream_kernel(
  local_height=, geom_as_args=True)``): the same kernel without the
  epilogue on a lat-ring shard's block (:class:`StreamSteps` with
  ``rows``); ``stream_steps_shard.launches`` counts its calls.
* :func:`column_physics` is the epilogue alone (C entry
  ``gcm_column_physics``), with the arguments of
  :func:`physics_epilogue_ref`, its plain version;
  :func:`column_physics_inplace` is its launch on K7's in-place terms.
* :class:`StreamSteps` holds the filter's buffers, the physics table and
  the kernel's scratch, allocated once and reused by every call.
"""

import ctypes
import math
from typing import NamedTuple

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops.fused_parts import (
    GEOM_FIELDS, MAX_LAYERS, check_args, kernel_consts, on_cpu,
    pointer_array)
from gcmiipy_tpu_torch.ops.mega_step import (
    MegaStep, _check as check_filter_args, add_stage_launches, banded_round,
    filter_args, mega_step_ref)
from gcmiipy_tpu_torch.physics import convection, radiation

CONVECTION_SWEEPS = 4  # the fixed-sweep count of the JAX kernel's epilogue
# kPhysScalars and kPhysRows of csrc/column_physics.cuh
PHYS_SCALARS, PHYS_ROWS = 20, 9


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


def physics_table(ph, dt, device="cpu"):
    """The epilogue's table (``csrc/column_physics.cuh``) as a float64
    tensor on ``device``: the scalars, then each per-layer row padded to
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
    return torch.tensor(flat, dtype=torch.float64, device=device)


def _check_steps(S, k, geom, physics):
    L, H, W = geom.layers, geom.height, geom.width
    planes = n_planes(L) + (physics is not None)
    if tuple(S.shape) != (2, planes, H, W):
        raise ValueError(f"stream_steps: S of shape (2, {planes}, {H}, {W}) "
                         f"expected, got {tuple(S.shape)}")
    if k < 0 or k % 2:
        raise ValueError(f"k must be even (buffer ping-pong), got {k}")


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_COUNT = ctypes.POINTER(ctypes.c_int)
_I, _VP = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    "gcm_stream_steps": [_I, _VP, _I, _I, _VP, _PTRS, _PTRS, _VP, _I, _COUNT,
                         _I, _PTRS, _I, _I, _I,
                         ctypes.POINTER(ctypes.c_double), _I, _I, _VP, _VP,
                         _VP, _COUNT, _COUNT, _COUNT, _COUNT, _VP],
    "gcm_column_physics": [_I, _PTRS, _VP, _VP, _VP, _VP, _I, _I, _I, _COUNT,
                           _VP],
}


def _function(name, double):
    fn = getattr(cuda_lib.load(cuda_lib.library_name("stream_steps", double)),
                 name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def new_scratch(geom, dtype, device):
    """The kernel's scratch: the predictor's p, u, v, t, q, then X (2L,H,W)
    and pg_phiv (L,H,W)."""
    L, H, W = geom.layers, geom.height, geom.width

    def new(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    return ([new(H, W)] + [new(L, H, W) for _ in range(4)]
            + [new(2 * L, H, W), new(L, H, W)])


def _check_table(kernel, table, device):
    n = PHYS_SCALARS + PHYS_ROWS * MAX_LAYERS
    if (table.device != device or table.dtype != torch.float64
            or tuple(table.shape) != (n,) or not table.is_contiguous()):
        raise ValueError(f"{kernel}: the physics table must be a contiguous "
                         f"float64 ({n},) tensor on {device}")


def _check_lat_lon(kernel, geom, dtype, device):
    for name in ("lat", "long"):
        x = getattr(geom, name)
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{kernel}: geom.{name} must be a contiguous "
                             f"{dtype} tensor on {device}")


def stream_steps(S, utc0, k, dt, geom, fc, coriolis=False, q_limiter=False,
                 physics=None, table=None, scratch=None):
    """K7: advances ``S`` (2, planes, H, W) by ``k`` (even) steps in place
    and returns it, as :func:`stream_steps_ref`.  ``utc0``: 0-dim clock
    tensor at the start of the call (read on the device); ``fc`` from
    :func:`mega_step.build_filter_consts`; ``table``/``scratch``: the
    physics table on S's device (:func:`physics_table`) and
    :func:`new_scratch`, made here when not given."""
    if on_cpu("stream_steps", (S, utc0)):
        return stream_steps_ref(S, utc0, k, dt, geom, fc, coriolis=coriolis,
                                q_limiter=q_limiter, physics=physics)
    _launch("stream_steps", S, utc0, k, dt, geom, fc, coriolis, q_limiter,
            physics, table, scratch)
    stream_steps.launches += 1
    return S


stream_steps.launches = 0


def stream_steps_shard(S, k, dt, block_geom, fc, coriolis=False,
                       q_limiter=False, scratch=None):
    """K7's shard form (JAX ``make_stream_kernel(local_height=,
    geom_as_args=True)``, ``pallas_stream.py:108``, :153-166, :587-592,
    :668-684): ``k`` steps of a lat-ring shard's block, its Hl core rows
    and k*PHJ halo rows above and below, in place.  It is K7 with the
    block as its grid (``block_geom``: :meth:`Geom.take_rows`; ``fc``: the
    block's filter buffers with the global wall,
    :func:`mega_step.build_filter_consts` with ``rows``).  Each step spoils
    PHJ = 8 more rows inward from the block's edges, where its rows wrap,
    so after k steps the core is the whole globe's.  No physics epilogue:
    the JAX kernel refuses ``physics`` with ``geom_as_args``, and the
    ring's extras run between calls.  ``stream_steps_shard.launches``
    counts its launches."""
    utc0 = torch.zeros((), dtype=S.dtype, device=S.device)
    if on_cpu("stream_steps_shard", (S,)):
        return stream_steps_ref(S, utc0, k, dt, block_geom, fc,
                                coriolis=coriolis, q_limiter=q_limiter)
    _launch("stream_steps_shard", S, utc0, k, dt, block_geom, fc, coriolis,
            q_limiter, None, None, scratch)
    stream_steps_shard.launches += 1
    return S


stream_steps_shard.launches = 0


def _launch(kernel, S, utc0, k, dt, geom, fc, coriolis, q_limiter, physics,
            table, scratch):
    """K7's launch on CUDA tensors (checked), with the stage and epilogue
    launches added to their counts; raises if the launch fails."""
    device = S.device
    _check_steps(S, k, geom, physics)
    if not S.is_contiguous():
        raise ValueError(f"{kernel}: S is not contiguous")
    if (utc0.device != device or utc0.dtype != S.dtype or utc0.dim() != 0):
        raise ValueError(f"{kernel}: utc0 must be a 0-dim {S.dtype} "
                         f"tensor on {device}")
    check_filter_args(unpack_state(S[0], geom.layers), geom, fc, kernel)
    _check_lat_lon(kernel, geom, S.dtype, device)
    if physics is not None:
        if table is None:
            table = physics_table(physics, dt, device)
        _check_table(kernel, table, device)
    if scratch is None:
        scratch = new_scratch(geom, S.dtype, device)
    fn = _function("gcm_stream_steps", S.dtype == torch.float64)
    L, H, W = geom.layers, geom.height, geom.width
    counts = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        err = fn(int(S.dtype == torch.float64), S.data_ptr(), S.shape[1],
                 int(k), utc0.data_ptr(),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 *filter_args(fc, W), pointer_array(scratch), L, H, W,
                 kernel_consts(dt), int(bool(coriolis)),
                 int(bool(q_limiter)),
                 table.data_ptr() if physics is not None else None,
                 geom.lat.data_ptr(), geom.long.data_ptr(),
                 *map(ctypes.byref, counts),
                 torch.cuda.current_stream(device).cuda_stream)
    add_stage_launches(counts[:3])
    column_physics.launches += counts[3].value
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def column_physics(p, u, v, t, gt, utc_s, geom, dt, ph, table=None):
    """The epilogue alone: ``(u, v, t, gt)`` after one step's column
    physics, as :func:`physics_epilogue_ref` (new tensors; the inputs are
    not changed).  ``p``, ``gt`` are (H,W), ``u``, ``v``, ``t`` (L,H,W),
    ``utc_s`` a 0-dim clock tensor; ``table``: :func:`physics_table` on the
    fields' device, made here when not given."""
    if on_cpu("column_physics", (p, u, v, t, gt, utc_s)):
        return physics_epilogue_ref(p, u, v, t, gt, utc_s, geom, dt, ph)
    if table is None:
        table = physics_table(ph, dt, p.device)
    u, v, t = u.clone(), v.clone(), t.clone()
    gt_n = torch.empty_like(gt)
    column_physics_inplace(p, u, v, t, gt, gt_n, utc_s, geom, table)
    return u, v, t, gt_n


def column_physics_inplace(p, u, v, t, gt, gt_out, utc_s, geom, table):
    """The epilogue's launch on CUDA tensors, as K7 runs it on its
    destination buffer: updates layer 0 of ``u`` and ``v`` and ``t`` in
    place and writes ``gt_out`` from ``gt``.  ``table``: :func:`physics_table`
    on the fields' device.  Raises on CPU tensors."""
    L, H, W = geom.layers, geom.height, geom.width
    fields = (p, u, v, t, gt, gt_out)
    if on_cpu("column_physics", fields + (utc_s,)):
        raise ValueError("column_physics_inplace: CUDA tensors expected")
    check_args("column_physics", fields, [(H, W)] + [(L, H, W)] * 3
               + [(H, W)] * 2, geom)
    device, dtype = p.device, p.dtype
    if utc_s.device != device or utc_s.dtype != dtype or utc_s.dim() != 0:
        raise ValueError(f"column_physics: utc_s must be a 0-dim {dtype} "
                         f"tensor on {device}")
    _check_lat_lon("column_physics", geom, dtype, device)
    _check_table("column_physics", table, device)
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _function("gcm_column_physics", dtype == torch.float64)(
            int(dtype == torch.float64), pointer_array(fields),
            geom.lat.data_ptr(), geom.long.data_ptr(), utc_s.data_ptr(),
            table.data_ptr(), L, H, W, ctypes.byref(count),
            torch.cuda.current_stream(device).cuda_stream)
    column_physics.launches += count.value
    if err != 0:
        raise RuntimeError(
            f"column_physics kernel launch failed: CUDA error {err}")


# every launch of the epilogue, counted where the C entries make it
column_physics.launches = 0


class StreamSteps(MegaStep):
    """The 'stream' launch of one geometry: ``StreamSteps(geom, dt,
    physics=...)(S, utc0, k)`` runs :func:`stream_steps` with the filter
    buffers of :class:`MegaStep`, the physics table and the scratch it
    holds (both made at the first call on a card and reused by every later
    one).  With ``rows`` (a lat-ring shard's block) it runs
    :func:`stream_steps_shard` on the block, which takes no physics."""

    def __init__(self, geom, dt, coriolis=False, q_limiter=False,
                 physics=None, rows=None):
        if rows is not None and physics is not None:
            raise ValueError("K7's shard form has no physics epilogue (as "
                             "the JAX kernel refuses physics with "
                             "geom_as_args); run the extras between calls")
        super().__init__(geom, dt, coriolis=coriolis, q_limiter=q_limiter,
                         rows=rows)
        self.physics = physics
        self.scratch = self.table = None

    def forward(self, S, utc0, k):
        scratch = table = None
        if S.device.type == "cuda":
            if (self.scratch is None or self.scratch[0].dtype != S.dtype
                    or self.scratch[0].device != S.device):
                self.scratch = new_scratch(self.geom, S.dtype, S.device)
                self.table = (None if self.physics is None else
                              physics_table(self.physics, self.dt, S.device))
            scratch, table = self.scratch, self.table
        if self.shard:
            return stream_steps_shard(S, k, self.dt, self.geom, self.consts,
                                      coriolis=self.coriolis,
                                      q_limiter=self.q_limiter,
                                      scratch=scratch)
        return stream_steps(S, utc0, k, self.dt, self.geom, self.consts,
                            coriolis=self.coriolis, q_limiter=self.q_limiter,
                            physics=self.physics, table=table,
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
