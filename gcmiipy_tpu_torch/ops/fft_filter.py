"""The polar filter's FFT stage: one filter round, as a hand-written float64
shared-memory FFT for Hopper (``csrc/fft_filter.cuh``).

K5, K6 and K7 run the kernel as the filter stage of every half step; this
module also exposes it as a standalone op.  It replaces the in-kernel DFT
filter of ``gcmiipy_tpu/ops/pallas_stencil.py`` (``make_mega_kernel_padded``
:806-830, ``matsuno_block_stages.correction`` :1082, ``filter_round``
:1182) and computes the same function on stacked fields ``X`` (P, H, W):
``Y = X + irfft((m - 1) * rfft(X))`` along W, all sums in float64, the
result rounded to ``X``'s dtype once.

* :func:`radix_plan` is the factor list the kernel runs: radix 16 first
  on the power-of-two widths 512-4096 (the kernel's register-tiled path),
  4, 2, 3, 5 and other primes on any other width (its general path).
* :func:`build_fft_consts` gives the float64 correction mask, the twiddle
  table and the listed latitudes (those with some damping).
* :func:`fft_filter_ref` is the plain version: the same plan and the same
  pairing in complex128 PyTorch ops, so the CPU tests hold the plan and the
  pairing, not only ``torch.fft``.
* :func:`fft_filter` filters ``X`` in place: the plain version on CPU
  tensors, the kernel on CUDA tensors, or raises.

``fft_filter.launches`` counts every launch of the kernel, as the C
entries count them where they launch it: :func:`fft_filter`'s, and those
that K5, K6 and K7 make inside their C entries (one each half step), which
their wrappers add after the call (:func:`add_launches`).
"""

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gcmiipy_tpu_torch.ops import cuda_lib

MAX_STAGES = 16  # kFftMaxStages of csrc/fft_filter.cuh
SHARED_BYTES = 232448  # a block's shared memory on the H100
POW2_WIDTHS = (512, 1024, 2048, 4096)  # pow2_width of csrc/fft_filter.cuh
# float64 operations of one R-point butterfly as the kernel writes it: the
# complex adds, subtracts and real scalings, and for 8 and 16 the internal
# twiddle products (6 each; a multiple of -i is a swap)
BUTTERFLY_OPS = {2: 4, 3: 16, 4: 16, 5: 48, 8: 60, 16: 176}


class FftConsts(NamedTuple):
    """The FFT filter of one geometry, on the working device.

    ``mask`` (H, W//2+1) float64: the correction mask ``m - 1``;
    ``twiddle`` (W, 2) float64: ``exp(-2 pi i n / W)`` as (re, im);
    ``lats`` (R,) int32: the latitudes the kernel filters."""
    mask: torch.Tensor
    twiddle: torch.Tensor
    lats: torch.Tensor


def radix_plan(width):
    """The radices of the kernel's Stockham stages for ``width`` points, in
    order.  The power-of-two widths of :data:`POW2_WIDTHS` (the kernel's
    register-tiled path): 16s while 16 divides the rest, then the rest.
    Any other width: 4s, then one 2, then 3s and 5s, then any other prime
    factor (a direct sum in the kernel).  Their product is ``width``; 1
    gives ()."""
    n = int(width)
    if n < 1:
        raise ValueError(f"width must be at least 1, got {width}")
    if n in POW2_WIDTHS:
        plan = []
        while n > 1:
            plan.append(min(n, 16))
            n //= plan[-1]
        return tuple(plan)
    plan = []
    for p in (4, 2, 3, 5):
        while n % p == 0:
            plan.append(p)
            n //= p
    p = 7
    while n > 1:
        while n % p == 0:
            plan.append(p)
            n //= p
        p += 2
    return tuple(plan)


def twiddles(width):
    """(W, 2) float64: ``exp(-2 pi i n / W)`` for n < W as (re, im).  Each
    angle is taken to [-pi, pi] and split into the nearest quarter turn,
    applied exactly, and a rest of at most pi/4, so w^(W-n) is conj(w^n)
    and the quarter and half turns are exact."""
    n = np.arange(width)
    m = np.where(2 * n <= width, n, n - width)
    q = np.rint(4 * m / width).astype(np.int64)
    rest = np.pi * (4 * m - q * width) / (2 * width)
    c, s = np.cos(rest), np.sin(rest)
    turn = q % 4
    cos = np.choose(turn, [c, -s, -c, s])
    sin = np.choose(turn, [s, c, -s, -c])
    return np.stack([cos, -sin], axis=-1)


def build_fft_consts(geom):
    """:class:`FftConsts` of ``geom`` on its device.  The mask is
    ``polar_mask - 1`` in float64 from the geometry's own dtype, as
    ``polar_filter.banded_correction_mask`` builds it.  The latitudes are
    those with some damping."""
    device = geom.polar_mask.device
    mask = geom.polar_mask.detach().cpu().double().numpy() - 1.0
    lats = np.flatnonzero((mask != 0.0).any(axis=-1))
    return FftConsts(
        torch.as_tensor(mask).to(device),
        torch.as_tensor(twiddles(geom.width)).to(device),
        torch.as_tensor(lats.astype(np.int32)).to(device))


def stockham(z, plan, tw):
    """The forward DFT of complex ``z`` (..., W) by the kernel's Stockham
    stages: for radix R after stages of product Ns, butterfly j (k = j mod
    Ns) takes ``v_r = z[j + r W/R] * tw[r k W/(Ns R)]`` and writes its
    R-point DFT ``V_q`` to ``(j - k) R + k + q Ns``.  ``tw`` is the complex
    twiddle table of :func:`twiddles`."""
    W = z.shape[-1]
    lead = z.shape[:-1]
    ns = 1
    for R in plan:
        nb = W // R
        r = torch.arange(R, device=z.device)
        k = torch.arange(nb, device=z.device) % ns
        v = z.reshape(*lead, R, nb) * tw[r[:, None] * k * (W // (ns * R))]
        dft = tw[(r[:, None] * r * nb) % W]                   # (q, r)
        y = torch.einsum("qr,...rj->...qj", dft, v)           # (..., q, j)
        # y[q, a Ns + k] goes to a Ns R + q Ns + k
        z = y.reshape(*lead, R, nb // ns, ns).transpose(-3, -2)
        z = z.reshape(*lead, W)
        ns *= R
    return z


def fft_filter_ref(X, fc):
    """Plain version of the kernel on ``X`` (P, H, W): the listed rows of
    one latitude paired as ``z = x_a + i x_b`` (an odd last plane with 0),
    ``Z = fft(z)``, the correction ``conj(fft(conj(Z) (m - 1) / W))`` (bin k
    scaled by ``mask[j, min(k, W - k)]``), its real part added to ``x_a``
    and its imaginary part to ``x_b``, in float64, rounded to ``X``'s dtype
    once.  Returns a new tensor."""
    P, H, W = X.shape
    Y = X.clone()
    lats = fc.lats.to(device=X.device, dtype=torch.long)
    if lats.numel() == 0:
        return Y
    x = X[:, lats].to(torch.float64)                          # (P, R, W)
    if P % 2:
        x = torch.cat([x, torch.zeros_like(x[:1])])
    plan = radix_plan(W)
    tw = torch.complex(fc.twiddle[:, 0], fc.twiddle[:, 1])
    Z = stockham(torch.complex(x[0::2], x[1::2]), plan, tw)
    k = torch.arange(W, device=X.device)
    scale = fc.mask[lats][:, torch.minimum(k, W - k)] * (1.0 / W)
    c = stockham(Z.conj() * scale, plan, tw)
    x[0::2] = x[0::2] + c.real
    x[1::2] = x[1::2] - c.imag
    Y[:, lats] = x[:P].to(X.dtype)
    return Y


def transform_ops(width):
    """float64 operations of one complex transform of ``width`` points as
    the kernel does it: each stage of radix R after stages of product Ns,
    W/R butterflies of :data:`BUTTERFLY_OPS`, 6 (R - 1) more for the
    twiddle products on the W/R - W/(R Ns) of them whose twiddles are not
    1; a radix without a written-out butterfly, W outputs of R complex
    multiply-adds (8 each)."""
    ops, ns = 0, 1
    for R in radix_plan(width):
        if R in BUTTERFLY_OPS:
            ops += (width // R * BUTTERFLY_OPS[R]
                    + (width // R - width // (R * ns)) * 6 * (R - 1))
        else:
            ops += width * R * 8
        ns *= R
    return ops


def round_ops(planes, width, n_lats):
    """float64 operations of one filter round on ``planes`` stacked planes
    over ``n_lats`` listed latitudes: per row pair two transforms, 3 a bin
    for the mask and 2 a point for the final adds."""
    return n_lats * ((planes + 1) // 2) * (2 * transform_ops(width)
                                           + 5 * width)


def check_consts(kernel, fc, device, H, W):
    """Device, dtype, shape and contiguity checks of the filter's buffers;
    raises on anything the kernel does not take (also a width whose row
    pair does not fit a block's shared memory)."""
    want = {"mask": ((H, W // 2 + 1), torch.float64),
            "twiddle": ((W, 2), torch.float64)}
    for name, (shape, dtype) in want.items():
        x = getattr(fc, name)
        if (x.device != device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{kernel} filter buffer {name}: a contiguous "
                             f"{dtype} {shape} tensor on {device} expected, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    lats = fc.lats
    if (lats.device != device or lats.dtype != torch.int32 or lats.dim() != 1
            or lats.numel() > H or not lats.is_contiguous()):
        raise ValueError(f"{kernel} filter buffer lats: a contiguous int32 "
                         f"vector of at most {H} latitudes on {device} "
                         "expected")
    if 2 * W * 16 > SHARED_BYTES:
        raise ValueError(f"{kernel}: a row pair of width {W} needs "
                         f"{2 * W * 16} bytes of shared memory, above a "
                         f"block's {SHARED_BYTES}")


def plan_array(width):
    """The radix plan of ``width`` as a C int array and its length."""
    plan = radix_plan(width)
    return (ctypes.c_int * max(len(plan), 1))(*plan), len(plan)


def add_launches(count):
    """Adds to ``fft_filter.launches`` the launches a C entry reports in
    ``count`` (a ``ctypes.c_int`` it set)."""
    fft_filter.launches += count.value


def _library(double):
    lib = cuda_lib.load(cuda_lib.library_name("fft_filter", double))
    fn = lib.gcm_fft_filter
    if fn.argtypes is None:
        i, vp = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, vp, i, i, i, vp, vp, vp, i,
                       ctypes.POINTER(i), i, ctypes.POINTER(i), vp]
        fn.restype = ctypes.c_int
    return fn


def fft_filter(X, fc):
    """One filter round on ``X`` (P, H, W), float32 or float64, in place;
    returns ``X``.  ``fc`` from :func:`build_fft_consts` (or a
    ``mega_step.FilterConsts``) on ``X``'s device."""
    device = X.device
    if device.type == "cpu":
        X.copy_(fft_filter_ref(X, fc))
        return X
    if device.type != "cuda":
        raise ValueError(f"fft_filter runs on cuda or cpu, not {device}")
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fft_filter takes float32 or float64, got {X.dtype}")
    if X.dim() != 3 or not X.is_contiguous():
        raise ValueError("fft_filter: X must be a contiguous (P, H, W) tensor")
    P, H, W = X.shape
    check_consts("fft_filter", fc, device, H, W)
    plan, nstages = plan_array(W)
    R = int(fc.lats.shape[0])
    fn = _library(X.dtype == torch.float64)
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(int(X.dtype == torch.float64), X.data_ptr(), P, H, W,
                 fc.mask.data_ptr(), fc.twiddle.data_ptr(),
                 fc.lats.data_ptr(), R, plan, nstages, ctypes.byref(count),
                 torch.cuda.current_stream(device).cuda_stream)
    add_launches(count)
    if err != 0:
        raise RuntimeError(
            f"fft_filter kernel launch failed: CUDA error {err}")
    return X


fft_filter.launches = 0
