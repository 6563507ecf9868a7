"""Arakawa & Lamb 1977 polar zonal low-pass filter.

Port of ``gcmiipy_tpu/ops/polar_filter.py``: near the poles zonal
wavenumber ``n`` is damped by the static per-geometry mask
``Geom.polar_mask`` in rFFT space along longitude.  Three interchangeable
forms, as in the JAX package:

* :func:`arakawa_1977`: rFFT / mask / irFFT in ``torch.fft`` (outside any
  kernel).  The inverse length is pinned to ``n=I`` so odd widths work
  (reference low_pass.py:77 breaks there).
* :func:`arakawa_1977_matmul` with :func:`build_filter_matrices`: the
  per-latitude real circulant I x I matrix.
* :func:`arakawa_1977_dft` with :func:`build_dft_matrices`: the shared real
  DFT factor matrices, in the correction form ``q + irfft((mask-1) rfft q)``.

The banded builders (:func:`build_dft_matrices_banded`,
:func:`banded_pair_matrices`, :func:`banded_correction_mask_pair`,
:func:`band_chunk_counts`) feed the whole-step kernel
(:mod:`gcmiipy_tpu_torch.ops.mega_step`).  Their columns run in DESCENDING
wavenumber order (n = W//2, ..., 1; n = 0 is never damped), so each row's
damped band is a column prefix and a row needs only its first
``band_chunk_counts`` chunks.  Every builder is numpy at float64 and casts
at the end, as the JAX package's builders do.  :func:`avrx` (reference
low_pass.py:14-38) is the earlier hard-cutoff variant.
"""

import numpy as np
import torch

FILTER_CHUNK = 128  # width of one banded chunk (pallas_stencil.FILTER_CHUNK)


def arakawa_1977(q, geom):
    """Filter ``q`` ([j,i] or [k,j,i]) along longitude (reference low_pass.py:41-78)."""
    width = q.shape[-1]
    if width == 1:  # (reference low_pass.py:58-59)
        return q
    f_q = torch.fft.rfft(q, dim=-1) * geom.polar_mask.to(q.dtype)
    return torch.fft.irfft(f_q, n=width, dim=-1).to(q.dtype)


def avrx(q, geom):
    """Hard-cutoff zonal filter (reference low_pass.py:14-38): zeroes every
    wavenumber with n/I * dy/dx_j > 1/2."""
    width = q.shape[-1]
    if width == 1:
        return q
    freqs = np.fft.rfftfreq(width)
    dx_row = geom.dx_j.double().cpu().numpy().reshape(-1)
    ratios = freqs[None, :] / dx_row[:, None] * float(geom.dy)
    mask = torch.as_tensor((ratios <= 0.5).astype(np.float64))
    f_q = torch.fft.rfft(q, dim=-1) * mask.to(device=q.device, dtype=q.dtype)
    return torch.fft.irfft(f_q, n=width, dim=-1).to(q.dtype)


def _mask_np(polar_mask):
    """The damping mask as a float64 numpy array (from a tensor or array)."""
    if torch.is_tensor(polar_mask):
        polar_mask = polar_mask.detach().cpu().double().numpy()
    return np.asarray(polar_mask, np.float64)


def build_filter_matrices(geom, dtype=np.float32):
    """Per-latitude real circulant filter matrices F, shape (J, I, I):
    ``F[j, a, b] = irfft(mask[j], n=I)[(a - b) mod I]``."""
    width = geom.width
    kernel = np.fft.irfft(_mask_np(geom.polar_mask), n=width, axis=-1)
    a = np.arange(width)
    idx = (a[:, None] - a[None, :]) % width
    return kernel[:, idx].astype(dtype)


def arakawa_1977_matmul(q, filter_matrices):
    """The polar filter as a batched per-row product:
    ``out[..., j, a] = sum_b F[j, a, b] q[..., j, b]``."""
    F = torch.as_tensor(filter_matrices).to(device=q.device, dtype=q.dtype)
    return torch.einsum("jab,...jb->...ja", F, q)


def build_dft_matrices(width, dtype=np.float32):
    """Real-DFT factors ``(C, S, Cw, Sw)``: ``a = q @ C``, ``b = q @ S``
    ((W, nf)), ``y = (a*m) @ Cw + (b*m) @ Sw`` ((nf, W)), with weight
    w_n = 1 for n in {0, W/2}, else 2, folding conjugate symmetry."""
    nf = width // 2 + 1
    n = np.arange(nf)
    x = np.arange(width)
    ang = 2 * np.pi * np.outer(x, n) / width       # (W, nf)
    C = np.cos(ang)
    S = -np.sin(ang)                               # b_n = -Im F_n
    w = np.full(nf, 2.0)
    w[0] = 1.0
    if width % 2 == 0:
        w[-1] = 1.0
    Cw = (w[:, None] * np.cos(ang).T) / width      # (nf, W)
    Sw = (w[:, None] * -np.sin(ang).T) / width
    return (C.astype(dtype), S.astype(dtype),
            Cw.astype(dtype), Sw.astype(dtype))


def build_dft_matrices_banded(width, dtype=np.float32, chunk=FILTER_CHUNK):
    """The DFT factors restricted to n = W//2, ..., 1 (descending), zero
    padded to ``nb = max(chunk, ceil((W//2)/chunk)*chunk)`` columns.
    Returns ``(C, S, Cw, Sw, nb)`` with forward factors (W, nb) and inverse
    factors (nb, W)."""
    C, S, Cw, Sw = build_dft_matrices(width, dtype=np.float64)
    nf = width // 2 + 1
    rev = np.arange(nf - 1, 0, -1)          # n = W//2, ..., 1
    nb = max(chunk, -(-(nf - 1) // chunk) * chunk)
    Cb = np.zeros((width, nb))
    Sb = np.zeros((width, nb))
    Cwb = np.zeros((nb, width))
    Swb = np.zeros((nb, width))
    Cb[:, :nf - 1] = C[:, rev]
    Sb[:, :nf - 1] = S[:, rev]
    Cwb[:nf - 1] = Cw[rev]
    Swb[:nf - 1] = Sw[rev]
    return (Cb.astype(dtype), Sb.astype(dtype),
            Cwb.astype(dtype), Swb.astype(dtype), nb)


def banded_correction_mask(polar_mask, nb, dtype=np.float32):
    """(J, nb) correction mask ``mask - 1`` in the descending banded column
    order (zero padded)."""
    mask = _mask_np(polar_mask)
    nf = mask.shape[-1]
    out = np.zeros((mask.shape[0], nb))
    out[:, :nf - 1] = mask[:, :0:-1] - 1.0
    return out.astype(dtype)


def banded_pair_matrices(width, dtype=np.float32, chunk=FILTER_CHUNK):
    """Banded factors with C and S interleaved chunk by chunk: ``CS`` is
    (W, 2nb) with columns ``[C_0 | S_0 | C_1 | S_1 | ...]`` and ``CwSw`` the
    matching (2nb, W) rows, so one product per chunk applies both.
    Returns ``(CS, CwSw, nb)``."""
    C, S, Cw, Sw, nb = build_dft_matrices_banded(width, dtype=np.float64,
                                                 chunk=chunk)
    nch = nb // chunk
    W = width
    CS = np.stack([C.reshape(W, nch, chunk),
                   S.reshape(W, nch, chunk)], axis=2).reshape(W, 2 * nb)
    CwSw = np.stack([Cw.reshape(nch, chunk, W),
                     Sw.reshape(nch, chunk, W)], axis=1).reshape(2 * nb, W)
    return CS.astype(dtype), CwSw.astype(dtype), nb


def banded_correction_mask_pair(polar_mask, nb, dtype=np.float32,
                                chunk=FILTER_CHUNK):
    """(J, 2nb) correction mask in the interleaved layout of
    :func:`banded_pair_matrices` (each chunk's mask for C and for S)."""
    mc = banded_correction_mask(polar_mask, nb, dtype=np.float64)
    J = mc.shape[0]
    nch = nb // chunk
    mcc = np.stack([mc.reshape(J, nch, chunk)] * 2,
                   axis=2).reshape(J, 2 * nb)
    return mcc.astype(dtype)


def band_chunk_counts(polar_mask, chunk=FILTER_CHUNK):
    """Per-row number of ``chunk``-wide banded chunks that carry any
    damping: the row's trip count."""
    mask = _mask_np(polar_mask)
    nf = mask.shape[-1]
    damped = (mask[:, :0:-1] - 1.0) != 0.0      # (J, nf-1), descending n
    band = np.where(damped.any(axis=-1),
                    nf - 1 - np.argmax(damped[:, ::-1], axis=-1), 0)
    return -(-band // chunk).astype(np.int32)


def band_chunk_counts_above(polar_mask, tau, chunk=FILTER_CHUNK):
    """Per-row number of banded chunks whose largest correction
    ``|mask - 1|`` exceeds ``tau`` (a prefix of the active chunks, since
    the damping grows with n); ``tau=0`` gives :func:`band_chunk_counts`."""
    mask = _mask_np(polar_mask)
    nf = mask.shape[-1]
    strong = np.abs(mask[:, :0:-1] - 1.0) > tau
    band = np.where(strong.any(axis=-1),
                    nf - 1 - np.argmax(strong[:, ::-1], axis=-1), 0)
    return -(-band // chunk).astype(np.int32)


def arakawa_1977_dft(q, geom, dft_mats):
    """Polar filter through the shared DFT factors of
    :func:`build_dft_matrices` (same mask as :func:`arakawa_1977`), in the
    correction form ``q + irfft((mask-1) rfft(q))``: the identity passes
    through exactly.  The products and sums run in the factors' dtype and
    the result is rounded to ``q``'s: with float64 factors a float32 field
    is filtered right to its final rounding, where float32 sums leave about
    1e-4 of the field's scale on heavily damped polar rows (the correction
    there cancels nearly all of ``q``).  No TF32 on the card: the caller
    keeps ``torch.backends.cuda.matmul.allow_tf32`` off.  The JAX
    function's ``precision`` (TPU matmul passes) and ``form='direct'`` are
    not ported: nothing in the port uses them."""
    if q.shape[-1] == 1:
        return q
    work = torch.as_tensor(dft_mats[0]).dtype
    x = q.to(work)
    C, S, Cw, Sw = (torch.as_tensor(m).to(device=q.device, dtype=work)
                    for m in dft_mats)
    mask = geom.polar_mask.to(work) - 1.0
    a = torch.matmul(x, C) * mask
    b = torch.matmul(x, S) * mask
    return (x + (torch.matmul(a, Cw) + torch.matmul(b, Sw))).to(q.dtype)
