"""K6: one whole Matsuno step of the 'mega4' backend, as a CUDA kernel.

Replaces ``gcmiipy_tpu/ops/pallas_stencil.py:make_mega_step_kernel`` (its
``pl.pallas_call`` at :1521) with its bodies ``matsuno_block_body`` (:1290)
and ``matsuno_block_stages`` (:1009).  Each half step runs ``pgf_forces``,
one round of the banded DFT polar filter on the stacked
``[spu_raw; pg_phi]``, ``half_timestep_rest`` and the momentum epilogue with
the polar wall; the corrector repeats it on (base, starred).

* :func:`mega_step_ref` is the plain PyTorch version, on whole fields.
* :class:`MegaStep` holds the filter's device buffers (factors, correction
  mask, per-row trip counts, wall) built from the port's own geometry; its
  ``forward`` calls :func:`mega_step`, which runs the plain version on CPU
  tensors and launches ``csrc/mega_step.cu`` on CUDA tensors, or raises.

``mega_step.launches`` counts the calls that launched the kernel.  Per-row
trip counts (:func:`polar_filter.band_chunk_counts`) take the place of the
TPU's per-block ``block_chunk_counts``: a chunk beyond a row's count adds
exact zeros (its correction mask is 0), so the result does not depend on
blocking.

The filter sums in float64 for float32 fields too (factors and mask in
float64; see ``ModelConfig.filter_precision``): its correction form
``Y = X + correction`` cancels on the polar rows, where the raw forces are
some 70 times the filtered ones, and float32 sums there leave about 1e-4 of
the field's scale (:mod:`gcmiipy_tpu_torch.filter_accuracy` measures it).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gcmiipy_tpu_torch.ops import cuda_lib, polar_filter
from gcmiipy_tpu_torch.ops.fused_parts import (
    GEOM_FIELDS, check_args, kernel_consts, on_cpu, pointer_array)
from gcmiipy_tpu_torch.ops.pgf_rest import pgf_parts_ref, rest_parts_ref

CHUNK_COLUMNS = 2 * polar_filter.FILTER_CHUNK  # C and S halves of a chunk


class FilterConsts(NamedTuple):
    """The banded filter of one geometry, on the working device.

    ``CS`` (W, 2nb) and ``CwSw`` (2nb, W): the chunk-interleaved factors;
    ``mcc`` (H, 2nb): the correction mask, all three float64 (the filter's
    sums run in float64); ``counts`` (H,) int32: each
    latitude row's trip count; ``keep`` (H, 1): 0 on the wall row H-1,
    else 1, in the working dtype; ``rows``/``row_counts`` (R,) int32: the stacked rows
    ``plane*H + j`` with a count above 0, largest count first, and their
    counts (the kernel's work list)."""
    CS: torch.Tensor
    CwSw: torch.Tensor
    mcc: torch.Tensor
    counts: torch.Tensor
    keep: torch.Tensor
    rows: torch.Tensor
    row_counts: torch.Tensor


def filter_rows(counts, planes):
    """(rows, row_counts) int32 numpy arrays: for each latitude with a
    count above 0, largest count first, the stacked rows of all
    ``planes``."""
    counts = np.asarray(counts, np.int32)
    H = counts.shape[0]
    order = np.argsort(-counts, kind="stable")
    order = order[counts[order] > 0]
    rows = (np.arange(planes)[None, :] * H + order[:, None]).reshape(-1)
    return rows.astype(np.int32), np.repeat(counts[order], planes)


def build_filter_consts(geom, band_limit=True):
    """:class:`FilterConsts` of ``geom`` on its device.  The builders run in
    numpy at float64 from ``geom.polar_mask`` (in ``geom``'s dtype, as the
    JAX package's float32 geometry holds it).  ``band_limit=False`` gives
    every row all chunks."""
    H, W, L = geom.height, geom.width, geom.layers
    dtype, device = geom.polar_mask.dtype, geom.polar_mask.device
    CS, CwSw, nb = polar_filter.banded_pair_matrices(W, dtype=np.float64)
    mcc = polar_filter.banded_correction_mask_pair(geom.polar_mask, nb,
                                                   dtype=np.float64)
    if band_limit:
        counts = polar_filter.band_chunk_counts(geom.polar_mask)
    else:
        counts = np.full(H, nb // polar_filter.FILTER_CHUNK, np.int32)
    keep = np.ones((H, 1))
    keep[H - 1, 0] = 0.0
    rows, row_counts = filter_rows(counts, 2 * L)

    def real(x, dtype=torch.float64):
        return torch.as_tensor(x).to(device=device, dtype=dtype)

    def ints(x):
        return torch.as_tensor(np.asarray(x, np.int32)).to(device)

    return FilterConsts(real(CS), real(CwSw), real(mcc), ints(counts),
                        real(keep, dtype), ints(rows), ints(row_counts))


def banded_filter_ref(X, fc):
    """The filter round on stacked fields ``X`` (P, H, W): ``Y = X``, then
    for each chunk c in order, on the rows whose count exceeds c,
    ``Y = Y + ((X @ CS_c) * mcc_c) @ CwSw_c``, in the factors' dtype
    (float64), rounded to ``X``'s dtype at the end."""
    dtype = X.dtype
    X = Y = X.to(fc.CS.dtype)
    counts = fc.counts.to(X.device)
    for c in range(int(counts.max()) if counts.numel() else 0):
        sel = counts > c
        cols = slice(c * CHUNK_COLUMNS, (c + 1) * CHUNK_COLUMNS)
        ab = torch.matmul(X[:, sel], fc.CS[:, cols]) * fc.mcc[sel, cols]
        Y = Y.clone() if Y is X else Y
        Y[:, sel] = Y[:, sel] + torch.matmul(ab, fc.CwSw[cols])
    return Y.to(dtype)


def mega_half_ref(base, seval, dt, geom, fc, coriolis=False,
                  q_limiter=False):
    """One half step of K6's plain version, which is K5's
    (:mod:`gcmiipy_tpu_torch.ops.mega_half`):
    ``pgf_forces`` -> filter round on ``[spu_raw; pg_phi]`` ->
    ``half_timestep_rest`` -> ``u = (pu - pgfu dt) / iph(p_n)``,
    ``v = (pv - pg_phiv dt) / jph(p_n) * keep`` (K3's and K4's plain
    versions around the filter, and the wall)."""
    sp, su, _, st, _ = seval
    stack, pg_phiv = pgf_parts_ref(sp, su, st, geom)
    p_n, u_n, v_n, t_n, q_n = rest_parts_ref(
        *base, *seval, banded_filter_ref(stack, fc), pg_phiv, dt, geom,
        coriolis=coriolis, q_limiter=q_limiter)
    return p_n, u_n, v_n * fc.keep, t_n, q_n


def mega_step_ref(p, u, v, t, q, dt, geom, fc, coriolis=False,
                  q_limiter=False):
    """Plain PyTorch version of K6: one Matsuno step, two
    :func:`mega_half_ref` halves."""
    base = (p, u, v, t, q)
    kw = dict(coriolis=coriolis, q_limiter=q_limiter)
    return mega_half_ref(base, mega_half_ref(base, base, dt, geom, fc, **kw),
                         dt, geom, fc, **kw)


def _library():
    lib = cuda_lib.load("mega_step")
    fn = lib.gcm_mega_step
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        i, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, ptrs, ptrs, ptrs, vp, vp, i, i, ptrs, ptrs, ptrs,
                       i, i, i, ctypes.POINTER(ctypes.c_double), i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _check(fields, geom, fc, kernel="mega_step"):
    """The checks of :func:`fused_parts.check_args` on the five fields, and
    of the filter buffers ``fc``; raises on anything ``kernel`` does not
    take."""
    L, H, W = geom.layers, geom.height, geom.width
    check_args(kernel, fields,
               [(H, W)] + [(L, H, W)] * 4, geom)
    p = fields[0]
    ncols = fc.CS.shape[1]
    real = {"CS": ((W, ncols), torch.float64),
            "CwSw": ((ncols, W), torch.float64),
            "mcc": ((H, ncols), torch.float64), "keep": ((H, 1), p.dtype)}
    for name, (shape, dtype) in real.items():
        x = getattr(fc, name)
        if (x.device != p.device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{kernel} filter buffer {name}: a contiguous "
                             f"{dtype} {shape} tensor on {p.device} "
                             f"expected, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    if ncols % CHUNK_COLUMNS or not ncols:
        raise ValueError(f"{kernel}: {ncols} factor columns, not a "
                         f"multiple of {CHUNK_COLUMNS}")
    for name in ("rows", "row_counts"):
        x = getattr(fc, name)
        if (x.device != p.device or x.dtype != torch.int32
                or x.shape != fc.rows.shape or not x.is_contiguous()):
            raise ValueError(f"{kernel} filter buffer {name}: a contiguous "
                             f"int32 tensor on {p.device} expected")


def mega_step(p, u, v, t, q, dt, geom, fc, coriolis=False, q_limiter=False):
    """K6: ``(p, u, v, t, q)`` after one Matsuno step, exactly as
    :func:`mega_step_ref` up to the filter's summation order.  ``p`` is
    (H,W), the rest (L,H,W); ``fc`` from :func:`build_filter_consts` on the
    same device and dtype."""
    fields = (p, u, v, t, q)
    if on_cpu("mega_step", fields):
        return mega_step_ref(*fields, dt, geom, fc, coriolis=coriolis,
                             q_limiter=q_limiter)
    _check(fields, geom, fc)
    device = p.device
    fn = _library()
    L, H, W = geom.layers, geom.height, geom.width
    R, ncols = int(fc.rows.shape[0]), int(fc.CS.shape[1])

    def new(*shape):
        return torch.empty(shape, dtype=p.dtype, device=device)

    starred = [new(H, W)] + [new(L, H, W) for _ in range(4)]
    outs = [new(H, W)] + [new(L, H, W) for _ in range(4)]
    scratch = ([new(2 * L, H, W)] + [new(L, H, W) for _ in range(4)]
               + [torch.empty((max(R, 1), ncols), dtype=torch.float64,
                              device=device)])
    with torch.cuda.device(device):
        err = fn(int(p.dtype == torch.float64), pointer_array(fields),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 pointer_array([fc.CS, fc.CwSw, fc.mcc, fc.keep]),
                 fc.rows.data_ptr(), fc.row_counts.data_ptr(), R, ncols,
                 pointer_array(starred), pointer_array(outs),
                 pointer_array(scratch), L, H, W, kernel_consts(dt),
                 int(bool(coriolis)), int(bool(q_limiter)),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_step kernel launch failed: CUDA error {err}")
    mega_step.launches += 1
    return tuple(outs)


mega_step.launches = 0


class MegaStep(torch.nn.Module):
    """The 'mega4' step of one geometry: ``MegaStep(geom, dt)(p, u, v, t,
    q)`` runs :func:`mega_step` with the filter buffers it holds."""

    def __init__(self, geom, dt, coriolis=False, q_limiter=False,
                 band_limit=True):
        super().__init__()
        self.geom, self.dt = geom, float(dt)
        self.coriolis, self.q_limiter = bool(coriolis), bool(q_limiter)
        for name, x in build_filter_consts(geom, band_limit)._asdict().items():
            self.register_buffer(name, x)

    @property
    def consts(self):
        return FilterConsts(*(getattr(self, n) for n in FilterConsts._fields))

    def forward(self, p, u, v, t, q):
        return mega_step(p, u, v, t, q, self.dt, self.geom, self.consts,
                         coriolis=self.coriolis, q_limiter=self.q_limiter)
