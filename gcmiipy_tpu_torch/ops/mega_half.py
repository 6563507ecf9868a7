"""K5: one half step of the 'mega' backend, as a CUDA kernel.

Replaces ``gcmiipy_tpu/ops/pallas_stencil.py:make_mega_kernel_padded`` (its
``pl.pallas_call`` at :849): ``pgf_forces``, the DFT polar filter in
correction form on the stacked ``[spu_raw; pg_phi]``, ``half_timestep_rest``
and the momentum epilogue, one launch of K6's stages per half step.  The
'mega' step (``dynamics.fused.make_fused_step(pipeline="mega")``) runs it
twice: predictor, then corrector on the starred state.

The JAX kernel filters every row over every wavenumber chunk.  A chunk
beyond a row's band has a correction mask of exactly 0 and adds +0.0 after
the row's own chunks, so the plain version's banded filter
(``mega_step.build_banded_consts``) gives the same result to
the bit with 23040 row-chunks a half at 9x512x1024 instead of 36864; the
tests hold the two forms equal.  The kernel's filter stage is K6's float64
FFT over the latitudes with some damping
(:mod:`gcmiipy_tpu_torch.ops.fft_filter`), the same function to rounding.

* :func:`mega_half_ref` (from :mod:`gcmiipy_tpu_torch.ops.mega_step`: one
  half of K6's plain version) is the plain PyTorch version.
* :class:`MegaHalf` holds the kernel's filter constants (K6's); its
  ``forward`` calls
  :func:`mega_half`, which runs the plain version on CPU tensors and
  launches ``csrc/mega_half.cu`` on CUDA tensors, or raises.

:func:`mega_half_shard` is K5's shard form (JAX ``make_mega_kernel_padded(
local_height=, geom_as_args=True)``, :663-692, :884): the same kernel on a
lat-ring shard's block of Hl + 2*PHJ rows with the block's row tables and
the global wall (:class:`MegaHalf` with ``rows``, as ``MegaStep(rows=)``);
:func:`gcmiipy_tpu_torch.parallel.shard_step.make_shard_step_fused` runs it.

``mega_half.launches`` and ``mega_half_shard.launches`` count the calls
that launched the kernel; each adds
to ``pgf_rest.pgf_tile.launches``, ``fft_filter.launches`` and
``pgf_rest.rest_stencil.launches`` the launches of the pgf tile, the
filter and the rest tile that its C entry counted (one each).  The
polar wall is applied inside (the constants' ``keep``), where the JAX
kernel leaves it to its caller; the result is the same.  The filter sums
in float64 for float32 fields too, as K6's does (``mega_step``'s
docstring); the JAX kernel's TPU-only 3-pass bf16 split is not ported.
"""

import ctypes

import torch

from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops.fused_parts import (
    GEOM_FIELDS, kernel_consts, on_cpu, pointer_array)
from gcmiipy_tpu_torch.ops.mega_step import (
    FilterConsts, _check, add_stage_launches, build_filter_consts,
    filter_args, mega_half_ref)

__all__ = ["MegaHalf", "mega_half", "mega_half_ref", "mega_half_shard"]


def _library(double):
    lib = cuda_lib.load(cuda_lib.library_name("mega_half", double))
    fn = lib.gcm_mega_half
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        i, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, ptrs, ptrs, ptrs, ptrs, vp, i, ctypes.POINTER(i), i,
                       ptrs, ptrs, i, i, i, ctypes.POINTER(ctypes.c_double),
                       i, i, ctypes.POINTER(i), ctypes.POINTER(i),
                       ctypes.POINTER(i), vp]
        fn.restype = ctypes.c_int
    return fn


def _check_half(fields, geom, fc, kernel="mega_half"):
    """K6's checks on base and seval (``fields``, ten tensors) and the
    filter buffers."""
    _check(fields[:5], geom, fc, kernel)
    _check(fields[5:], geom, fc, kernel)


def mega_half(base, seval, dt, geom, fc, coriolis=False, q_limiter=False):
    """K5: ``(p_n, u_n, v_n, t_n, q_n)`` of one half step, ``base``
    advanced with the tendencies at ``seval`` (each a (p, u, v, t, q)
    tuple; they may be the same), as :func:`mega_half_ref` to rounding (the
    kernel's filter is the FFT), v walled.  ``fc`` from
    :func:`build_filter_consts` on the same device and dtype."""
    return _half(mega_half, base, seval, dt, geom, fc, coriolis, q_limiter)


def mega_half_shard(base, seval, dt, block_geom, fc, coriolis=False,
                    q_limiter=False):
    """K5's shard form: :func:`mega_half` on a lat-ring shard's block, its
    Hl core rows and PHJ = 8 halo rows above and below from the ring
    neighbours, ``block_geom`` the block's row tables
    (:meth:`Geom.take_rows`) and ``fc`` the block's filter buffers with the
    global wall (:func:`build_filter_consts` with ``rows``).  The kernel's
    rows wrap modulo the block's height, which spoils only the halo rows
    within a half step's reach of the block's edges."""
    return _half(mega_half_shard, base, seval, dt, block_geom, fc, coriolis,
                 q_limiter)


mega_half_shard.launches = 0


def _half(wrapper, base, seval, dt, geom, fc, coriolis, q_limiter):
    """K5 for ``wrapper`` (:func:`mega_half` or its shard form): the plain
    version on CPU tensors, else the checked launch, counted on
    ``wrapper.launches`` and with the stage launches added to their counts;
    raises if the launch fails."""
    kernel = wrapper.__name__
    fields = tuple(base) + tuple(seval)
    if on_cpu(kernel, fields):
        return mega_half_ref(tuple(base), tuple(seval), dt, geom, fc,
                             coriolis=coriolis, q_limiter=q_limiter)
    _check_half(fields, geom, fc, kernel)
    L, H, W = geom.layers, geom.height, geom.width
    dtype, device = fields[0].dtype, fields[0].device
    fn = _library(dtype == torch.float64)

    def new(*shape):
        return torch.empty(shape, dtype=dtype, device=device)

    outs = [new(H, W)] + [new(L, H, W) for _ in range(4)]
    scratch = [new(2 * L, H, W), new(L, H, W)]  # X, pg_phiv
    counts = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(int(dtype == torch.float64), pointer_array(fields[:5]),
                 pointer_array(fields[5:]),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 *filter_args(fc, W), pointer_array(outs),
                 pointer_array(scratch), L, H, W, kernel_consts(dt),
                 int(bool(coriolis)), int(bool(q_limiter)),
                 *map(ctypes.byref, counts),
                 torch.cuda.current_stream(device).cuda_stream)
    add_stage_launches(counts)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return tuple(outs)


mega_half.launches = 0


class MegaHalf(torch.nn.Module):
    """The 'mega' half step of one geometry: ``MegaHalf(geom, dt)(base,
    seval)`` runs :func:`mega_half` with the filter buffers it holds.  With
    ``rows`` (global row indices of a lat-ring shard's block) it is K5's
    shard form: ``self.geom`` is the block's geometry, the buffers the
    block's (:func:`build_filter_consts`), and ``forward`` runs
    :func:`mega_half_shard` on the block's fields."""

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

    def forward(self, base, seval):
        half = mega_half_shard if self.shard else mega_half
        return half(base, seval, self.dt, self.geom, self.consts,
                    coriolis=self.coriolis, q_limiter=self.q_limiter)
