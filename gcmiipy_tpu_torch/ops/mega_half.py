"""K5: one half step of the 'mega' backend, as a CUDA kernel.

Replaces ``gcmiipy_tpu/ops/pallas_stencil.py:make_mega_kernel_padded`` (its
``pl.pallas_call`` at :849): ``pgf_forces``, the DFT polar filter in
correction form on the stacked ``[spu_raw; pg_phi]``, ``half_timestep_rest``
and the momentum epilogue, one launch of K6's stages per half step.  The
'mega' step (``dynamics.fused.make_fused_step(pipeline="mega")``) runs it
twice: predictor, then corrector on the starred state.

The JAX kernel filters every row over every wavenumber chunk.  A chunk
beyond a row's band has a correction mask of exactly 0 and adds +0.0 after
the row's own chunks, so the banded filter (``mega_step.build_filter_consts``,
as K6 holds it) gives the same result to the bit with 23040 row-chunks a
half at 9x512x1024 instead of 36864; the tests and ``chip_smoke.py`` hold
the two forms equal.

* :func:`mega_half_ref` (from :mod:`gcmiipy_tpu_torch.ops.mega_step`: one
  half of K6's plain version) is the plain PyTorch version.
* :class:`MegaHalf` holds the banded filter constants; its ``forward``
  calls :func:`mega_half`, which runs the plain version on CPU tensors and
  launches ``csrc/mega_half.cu`` on CUDA tensors, or raises.

``mega_half.launches`` counts the calls that launched the kernel.  The
polar wall is applied inside (the constants' ``keep``), where the JAX
kernel leaves it to its caller; the result is the same.  The filter sums in
float64 for float32 fields too, as K6's does (``mega_step``'s docstring);
the JAX kernel's TPU-only 3-pass bf16 split is not ported.
"""

import ctypes

import torch

from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops.fused_parts import (
    GEOM_FIELDS, kernel_consts, on_cpu, pointer_array)
from gcmiipy_tpu_torch.ops.mega_step import (
    FilterConsts, _check, build_filter_consts, mega_half_ref)

__all__ = ["MegaHalf", "mega_half", "mega_half_ref"]


def _library():
    lib = cuda_lib.load("mega_half")
    fn = lib.gcm_mega_half
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        i, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, ptrs, ptrs, ptrs, ptrs, vp, vp, i, i, ptrs, ptrs,
                       i, i, i, ctypes.POINTER(ctypes.c_double), i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def scratch_A(fc, device):
    """The filter's (R, 2nb) float64 scratch of one half step (75.5 MB at
    9x512x1024)."""
    return torch.empty((max(int(fc.rows.shape[0]), 1), fc.CS.shape[1]),
                       dtype=torch.float64, device=device)


def _check_half(fields, geom, fc, A):
    """K6's checks on base and seval (``fields``, ten tensors) and the
    filter buffers, and the scratch ``A``'s."""
    _check(fields[:5], geom, fc, "mega_half")
    _check(fields[5:], geom, fc, "mega_half")
    want = (max(int(fc.rows.shape[0]), 1), int(fc.CS.shape[1]))
    p = fields[0]
    if (A.device != p.device or A.dtype != torch.float64
            or tuple(A.shape) != want or not A.is_contiguous()):
        raise ValueError(f"mega_half scratch A: a contiguous float64 {want} "
                         f"tensor on {p.device} expected")


def mega_half(base, seval, dt, geom, fc, coriolis=False, q_limiter=False,
              A=None):
    """K5: ``(p_n, u_n, v_n, t_n, q_n)`` of one half step, ``base``
    advanced with the tendencies at ``seval`` (each a (p, u, v, t, q)
    tuple; they may be the same), exactly as :func:`mega_half_ref` up to
    the filter's summation order, v walled.  ``fc`` from
    :func:`build_filter_consts` on the same device and dtype; ``A`` the
    scratch of :func:`scratch_A`, made per call when None."""
    fields = tuple(base) + tuple(seval)
    if on_cpu("mega_half", fields):
        return mega_half_ref(tuple(base), tuple(seval), dt, geom, fc,
                             coriolis=coriolis, q_limiter=q_limiter)
    device = fields[0].device
    if A is None:
        A = scratch_A(fc, device)
    _check_half(fields, geom, fc, A)
    R, ncols = int(fc.rows.shape[0]), int(fc.CS.shape[1])
    fn = _library()
    L, H, W = geom.layers, geom.height, geom.width
    dtype = fields[0].dtype

    def new(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    outs = [new(H, W)] + [new(L, H, W) for _ in range(4)]
    scratch = [new(2 * L, H, W)] + [new(L, H, W) for _ in range(4)] + [A]
    with torch.cuda.device(device):
        err = fn(int(dtype == torch.float64), pointer_array(fields[:5]),
                 pointer_array(fields[5:]),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 pointer_array([fc.CS, fc.CwSw, fc.mcc, fc.keep]),
                 fc.rows.data_ptr(), fc.row_counts.data_ptr(), R, ncols,
                 pointer_array(outs), pointer_array(scratch), L, H, W,
                 kernel_consts(dt), int(bool(coriolis)), int(bool(q_limiter)),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_half kernel launch failed: CUDA error {err}")
    mega_half.launches += 1
    return tuple(outs)


mega_half.launches = 0


class MegaHalf(torch.nn.Module):
    """The 'mega' half step of one geometry: ``MegaHalf(geom, dt)(base,
    seval)`` runs :func:`mega_half` with the banded filter buffers it holds
    and, on the card, one filter scratch made at the first call."""

    def __init__(self, geom, dt, coriolis=False, q_limiter=False):
        super().__init__()
        self.geom, self.dt = geom, float(dt)
        self.coriolis, self.q_limiter = bool(coriolis), bool(q_limiter)
        for name, x in build_filter_consts(geom)._asdict().items():
            self.register_buffer(name, x)
        self._A = None

    @property
    def consts(self):
        return FilterConsts(*(getattr(self, n) for n in FilterConsts._fields))

    def forward(self, base, seval):
        fc = self.consts
        A = None
        if base[0].device.type == "cuda":
            if self._A is None or self._A.device != base[0].device:
                self._A = scratch_A(fc, base[0].device)
            A = self._A
        return mega_half(base, seval, self.dt, self.geom, fc,
                         coriolis=self.coriolis, q_limiter=self.q_limiter,
                         A=A)
