"""K6: one whole Matsuno step of the 'mega4' backend, as a CUDA kernel.

Replaces ``gcmiipy_tpu/ops/pallas_stencil.py:make_mega_step_kernel`` (its
``pl.pallas_call`` at :1521) with its bodies ``matsuno_block_body`` (:1290)
and ``matsuno_block_stages`` (:1009).  Each half step runs ``pgf_forces``,
one round of the polar filter on the stacked ``[spu_raw; pg_phi]``,
``half_timestep_rest`` and the momentum epilogue with the polar wall; the
corrector repeats it on (base, starred).

* :func:`mega_step_ref` is the plain PyTorch version, on whole fields, with
  the TPU kernel's banded DFT filter (:func:`banded_filter_ref`, its
  factors built from the geometry where the plain version is called).
* :class:`MegaStep` holds the kernel's filter buffers (the FFT's mask,
  twiddles and listed latitudes, and the wall) built from the port's own
  geometry; its ``forward`` calls :func:`mega_step`, which runs the plain
  version on CPU tensors and launches ``csrc/mega_step.cu`` on CUDA
  tensors, or raises.

:func:`mega_step_shard` is K6's shard form (JAX ``make_mega_step_kernel(
local_height=, geom_as_args=True)``): the same kernel on a lat-ring shard's
block of rows, with the block's row tables and the global wall
(:class:`MegaStep` with ``rows``; :mod:`gcmiipy_tpu_torch.parallel.shard_step`
runs it).

``mega_step.launches`` and ``mega_step_shard.launches`` count the calls
that launched the kernel; each adds
to ``pgf_rest.pgf_tile.launches``, ``fft_filter.launches`` and
``pgf_rest.rest_stencil.launches`` the launches of the pgf tile, the
filter and the rest tile that its C entry counted (two each: six a
step).  The
kernel's filter stage is the float64 FFT of
:mod:`gcmiipy_tpu_torch.ops.fft_filter`, which computes the banded DFT's
function, so the kernel agrees with its plain version to rounding.

The filter sums in float64 for float32 fields too (see
``ModelConfig.filter_precision``): its correction form ``Y = X +
correction`` cancels on the polar rows, where the raw forces are some 70
times the filtered ones, and float32 sums there leave about 1e-4 of the
field's scale (:mod:`gcmiipy_tpu_torch.filter_accuracy` measures it).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gcmiipy_tpu_torch.ops import cuda_lib, fft_filter as fft, polar_filter
from gcmiipy_tpu_torch.ops.fused_parts import (
    GEOM_FIELDS, check_args, kernel_consts, on_cpu, pointer_array)
from gcmiipy_tpu_torch.ops.pgf_rest import (
    add_pgf_launches, add_stencil_launches, pgf_parts_ref, rest_parts_ref)

CHUNK_COLUMNS = 2 * polar_filter.FILTER_CHUNK  # C and S halves of a chunk


class FilterConsts(NamedTuple):
    """The kernel's polar filter of one geometry, on the working device:
    ``mask``, ``twiddle`` and ``lats`` of :class:`fft_filter.FftConsts`,
    and ``keep`` (H, 1): 0 on the wall row H-1, else 1, in the working
    dtype."""
    mask: torch.Tensor
    twiddle: torch.Tensor
    lats: torch.Tensor
    keep: torch.Tensor


def build_filter_consts(geom, rows=None):
    """:class:`FilterConsts` of ``geom`` on its device.  With ``rows`` (a
    lat-ring shard's block, :meth:`Geom.take_rows`), those of the block:
    its rows' mask and listed latitudes, and ``keep`` 0 where the block
    holds the global wall row H-1 (in the core of the last shard and the
    halo of the first), not on the block's own last row."""
    H = geom.height
    wall = np.arange(H) == H - 1
    if rows is not None:
        geom, wall = geom.take_rows(rows), wall[np.asarray(rows)]
    keep = torch.as_tensor((~wall).astype(np.float64)[:, None])
    return FilterConsts(*fft.build_fft_consts(geom),
                        keep.to(dtype=geom.polar_mask.dtype,
                                device=geom.polar_mask.device))


class BandedConsts(NamedTuple):
    """The TPU kernels' banded DFT filter of one geometry, for the plain
    version (:func:`banded_filter_ref`): ``CS`` (W, 2nb) and ``CwSw`` (2nb,
    W), the chunk-interleaved factors, ``mcc`` (H, 2nb), the correction
    mask, all three float64, and ``counts`` (H,) int32, each latitude
    row's trip count."""
    CS: torch.Tensor
    CwSw: torch.Tensor
    mcc: torch.Tensor
    counts: torch.Tensor


def build_banded_consts(geom, band_limit=True):
    """:class:`BandedConsts` of ``geom`` on its device.  The builders run in
    numpy at float64 from ``geom.polar_mask`` (in ``geom``'s dtype, as the
    JAX package's float32 geometry holds it).  ``band_limit=False`` gives
    every row all chunks: the TPU kernel's unbanded filter, the same
    function."""
    H, W = geom.height, geom.width
    device = geom.polar_mask.device
    CS, CwSw, nb = polar_filter.banded_pair_matrices(W, dtype=np.float64)
    mcc = polar_filter.banded_correction_mask_pair(geom.polar_mask, nb,
                                                   dtype=np.float64)
    if band_limit:
        counts = polar_filter.band_chunk_counts(geom.polar_mask)
    else:
        counts = np.full(H, nb // polar_filter.FILTER_CHUNK, np.int32)

    def real(x):
        return torch.as_tensor(x).to(device=device, dtype=torch.float64)

    return BandedConsts(
        real(CS), real(CwSw), real(mcc),
        torch.as_tensor(np.asarray(counts, np.int32)).to(device))


def banded_filter_ref(X, bc):
    """The filter round on stacked fields ``X`` (P, H, W) with the
    :class:`BandedConsts` ``bc``: ``Y = X``, then for each chunk c in
    order, on the rows whose count exceeds c,
    ``Y = Y + ((X @ CS_c) * mcc_c) @ CwSw_c``, in the factors' dtype
    (float64), rounded to ``X``'s dtype at the end."""
    dtype = X.dtype
    X = Y = X.to(bc.CS.dtype)
    counts = bc.counts.to(X.device)
    for c in range(int(counts.max()) if counts.numel() else 0):
        sel = counts > c
        cols = slice(c * CHUNK_COLUMNS, (c + 1) * CHUNK_COLUMNS)
        ab = torch.matmul(X[:, sel], bc.CS[:, cols]) * bc.mcc[sel, cols]
        Y = Y.clone() if Y is X else Y
        Y[:, sel] = Y[:, sel] + torch.matmul(ab, bc.CwSw[cols])
    return Y.to(dtype)


def banded_round(geom, band_limit=True):
    """The banded DFT round of ``geom`` as a function of the stacked X:
    :func:`banded_filter_ref` with :func:`build_banded_consts`, built
    once."""
    bc = build_banded_consts(geom, band_limit)
    return lambda X: banded_filter_ref(X, bc)


def mega_half_ref(base, seval, dt, geom, fc, coriolis=False,
                  q_limiter=False, filter_ref=None):
    """One half step of K6's plain version, which is K5's
    (:mod:`gcmiipy_tpu_torch.ops.mega_half`):
    ``pgf_forces`` -> filter round on ``[spu_raw; pg_phi]`` ->
    ``half_timestep_rest`` -> ``u = (pu - pgfu dt) / iph(p_n)``,
    ``v = (pv - pg_phiv dt) / jph(p_n) * keep`` (K3's and K4's plain
    versions around the filter, and the wall).  ``filter_ref`` is the
    round, a function of the stacked fields: None for the TPU kernel's
    banded DFT (:func:`banded_round`), or ``fft_filter.fft_filter_ref``
    with ``fc``, the plan the kernels run (in float64 the two differ by the
    DFT's rounding, which the polar rows' cancellation brings to 1e-11 of
    u's scale at width 1024)."""
    if filter_ref is None:
        filter_ref = banded_round(geom)
    sp, su, _, st, _ = seval
    stack, pg_phiv = pgf_parts_ref(sp, su, st, geom)
    p_n, u_n, v_n, t_n, q_n = rest_parts_ref(
        *base, *seval, filter_ref(stack), pg_phiv, dt, geom,
        coriolis=coriolis, q_limiter=q_limiter)
    return p_n, u_n, v_n * fc.keep, t_n, q_n


def mega_step_ref(p, u, v, t, q, dt, geom, fc, coriolis=False,
                  q_limiter=False, filter_ref=None):
    """Plain PyTorch version of K6: one Matsuno step, two
    :func:`mega_half_ref` halves with the round ``filter_ref`` (None: the
    banded DFT, built once for both)."""
    base = (p, u, v, t, q)
    if filter_ref is None:
        filter_ref = banded_round(geom)
    kw = dict(coriolis=coriolis, q_limiter=q_limiter, filter_ref=filter_ref)
    return mega_half_ref(base, mega_half_ref(base, base, dt, geom, fc, **kw),
                         dt, geom, fc, **kw)


def _library(double):
    lib = cuda_lib.load(cuda_lib.library_name("mega_step", double))
    fn = lib.gcm_mega_step
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        i, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, ptrs, ptrs, ptrs, vp, i, ctypes.POINTER(i), i,
                       ptrs, ptrs, ptrs, i, i, i,
                       ctypes.POINTER(ctypes.c_double), i, i,
                       ctypes.POINTER(i), ctypes.POINTER(i),
                       ctypes.POINTER(i), vp]
        fn.restype = ctypes.c_int
    return fn


def _check(fields, geom, fc, kernel="mega_step"):
    """The checks of :func:`fused_parts.check_args` on the five fields, and
    of the filter buffers the kernel reads; raises on anything ``kernel``
    does not take."""
    L, H, W = geom.layers, geom.height, geom.width
    check_args(kernel, fields,
               [(H, W)] + [(L, H, W)] * 4, geom)
    p = fields[0]
    fft.check_consts(kernel, fc, p.device, H, W)
    if (fc.keep.device != p.device or fc.keep.dtype != p.dtype
            or tuple(fc.keep.shape) != (H, 1) or not fc.keep.is_contiguous()):
        raise ValueError(f"{kernel} filter buffer keep: a contiguous "
                         f"{p.dtype} ({H}, 1) tensor on {p.device} expected")


def add_stage_launches(counts):
    """Adds the launches a C entry of K5, K6 or K7 counted (``counts``: the
    ``ctypes.c_int`` of the pgf tile, the filter and the rest tile) to
    ``pgf_rest.pgf_tile``'s, ``fft_filter``'s and ``pgf_rest.rest_stencil``'s
    counts."""
    pgf, filt, stencil = counts
    add_pgf_launches(pgf)
    fft.add_launches(filt)
    add_stencil_launches(stencil)


def filter_args(fc, W):
    """The kernel's filter arguments: the buffer table (mask, twiddles,
    keep), the latitude list, its length, the radix plan and its length."""
    plan, nstages = fft.plan_array(W)
    return (pointer_array([fc.mask, fc.twiddle, fc.keep]),
            fc.lats.data_ptr(), int(fc.lats.shape[0]), plan, nstages)


def mega_step(p, u, v, t, q, dt, geom, fc, coriolis=False, q_limiter=False):
    """K6: ``(p, u, v, t, q)`` after one Matsuno step, as
    :func:`mega_step_ref` to rounding (the kernel's filter is the FFT).
    ``p`` is (H,W), the rest (L,H,W); ``fc`` from
    :func:`build_filter_consts` on the same device and dtype."""
    fields = (p, u, v, t, q)
    if on_cpu("mega_step", fields):
        return mega_step_ref(*fields, dt, geom, fc, coriolis=coriolis,
                             q_limiter=q_limiter)
    outs = _launch("mega_step", fields, dt, geom, fc, coriolis, q_limiter)
    mega_step.launches += 1
    return outs


mega_step.launches = 0


def mega_step_shard(p, u, v, t, q, dt, block_geom, fc, coriolis=False,
                    q_limiter=False):
    """K6's shard form (JAX ``make_mega_step_kernel(local_height=,
    geom_as_args=True)``, ``pallas_stencil.py:1340``, :1359-1373, :1556):
    one Matsuno step of a lat-ring shard's block, its Hl core rows and
    PHJ = 8 halo rows above and below from the ring neighbours.  It is K6
    with the block as its grid: ``block_geom`` holds the block's row tables
    (:meth:`Geom.take_rows`) and ``fc`` the block's filter buffers with the
    global wall (:func:`build_filter_consts` with ``rows``).  The kernel's
    rows wrap modulo the block's height, which spoils only the halo rows
    within a step's reach (8) of the block's edges: the core rows are the
    whole globe's.  ``mega_step_shard.launches`` counts its launches."""
    fields = (p, u, v, t, q)
    if on_cpu("mega_step_shard", fields):
        return mega_step_ref(*fields, dt, block_geom, fc, coriolis=coriolis,
                             q_limiter=q_limiter)
    outs = _launch("mega_step_shard", fields, dt, block_geom, fc, coriolis,
                   q_limiter)
    mega_step_shard.launches += 1
    return outs


mega_step_shard.launches = 0


def _launch(kernel, fields, dt, geom, fc, coriolis, q_limiter):
    """K6's launch on CUDA tensors (checked), with the stage launches added
    to their counts; raises if the launch fails."""
    _check(fields, geom, fc, kernel)
    p = fields[0]
    device = p.device
    fn = _library(p.dtype == torch.float64)
    L, H, W = geom.layers, geom.height, geom.width

    def new(*shape):
        return torch.empty(shape, dtype=p.dtype, device=device)

    starred = [new(H, W)] + [new(L, H, W) for _ in range(4)]
    outs = [new(H, W)] + [new(L, H, W) for _ in range(4)]
    scratch = [new(2 * L, H, W), new(L, H, W)]  # X, pg_phiv
    counts = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(int(p.dtype == torch.float64), pointer_array(fields),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 *filter_args(fc, W), pointer_array(starred),
                 pointer_array(outs), pointer_array(scratch), L, H, W,
                 kernel_consts(dt), int(bool(coriolis)), int(bool(q_limiter)),
                 *map(ctypes.byref, counts),
                 torch.cuda.current_stream(device).cuda_stream)
    add_stage_launches(counts)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    return tuple(outs)


class MegaStep(torch.nn.Module):
    """The 'mega4' step of one geometry: ``MegaStep(geom, dt)(p, u, v, t,
    q)`` runs :func:`mega_step` with the filter buffers it holds.  With
    ``rows`` (global row indices of a lat-ring shard's block) it is K6's
    shard form: ``self.geom`` is the block's geometry, the buffers the
    block's (:func:`build_filter_consts`), and ``forward`` runs
    :func:`mega_step_shard` on the block's fields."""

    def __init__(self, geom, dt, coriolis=False, q_limiter=False, rows=None):
        super().__init__()
        self.shard = rows is not None
        self.geom = geom.take_rows(rows) if self.shard else geom
        self.dt = float(dt)
        self.coriolis, self.q_limiter = bool(coriolis), bool(q_limiter)
        for name, x in build_filter_consts(geom, rows)._asdict().items():
            self.register_buffer(name, x)

    @property
    def consts(self):
        return FilterConsts(*(getattr(self, n) for n in FilterConsts._fields))

    def forward(self, p, u, v, t, q):
        step = mega_step_shard if self.shard else mega_step
        return step(p, u, v, t, q, self.dt, self.geom, self.consts,
                    coriolis=self.coriolis, q_limiter=self.q_limiter)
