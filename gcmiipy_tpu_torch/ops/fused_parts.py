"""K1: the half-step parts of the v1 'fused' backend, as a CUDA kernel.

Replaces ``gcmiipy_tpu/ops/pallas_stencil.py:make_fused_parts_padded`` (its
``pl.pallas_call`` at :324).  :func:`fused_parts` computes what
:func:`gcmiipy_tpu_torch.dynamics.core25d.half_timestep_parts` computes, on
unpadded contiguous tensors:

* on CPU tensors it runs the plain version :func:`fused_parts_ref`;
* on CUDA tensors it launches ``csrc/fused_parts.cu`` (built at first use,
  see :mod:`gcmiipy_tpu_torch.ops.cuda_lib`) or raises; it never falls back.

:func:`pgf_column` is K1's first stage alone, the pgf column pass (rho and
phi), with its plain version :func:`gcmiipy_tpu_torch.dynamics.core25d.
pgf_column`.

``fused_parts.launches`` counts the calls that launched the kernel;
``column_pass.launches`` and ``parts_stencil.launches`` count the launches
of its two stages, the pgf column pass and the tiled stencil (with its
aflux prologue), where the C entries make them.  The kernel is bound by
bytes: about 0.081 ms per call at 9x512x1024 float32 on an H100's 3.35 TB/s
(the source's header works the number out).
"""

import ctypes
import types

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.ops import cuda_lib

MAX_LAYERS = 64  # kMaxLayers of csrc/gcm_limits.cuh
GEOM_FIELDS = ("dx_j", "dx_h", "lat", "heightmap", "sig", "sigt", "sigb",
               "dsig", "dy", "ptop")


def fused_parts_ref(p, u, v, t, q, sp, su, sv, st, sq, spu, dt, geom,
                    coriolis=False, q_limiter=False):
    """Plain PyTorch version of K1: ``core25d.half_timestep_parts``."""
    return core25d.half_timestep_parts(p, u, v, t, q, sp, su, sv, st, sq, spu,
                                       dt, geom, coriolis=coriolis,
                                       q_limiter=q_limiter)


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_I, _VP = ctypes.c_int, ctypes.c_void_p
_CONSTS, _COUNT = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    "gcm_fused_parts": [_I, _PTRS, _PTRS, _PTRS, _PTRS, _I, _I, _I, _CONSTS,
                        _I, _I, _COUNT, _COUNT, _VP],
    "gcm_pgf_column": [_I, _VP, _VP, _PTRS, _VP, _VP, _I, _I, _I, _CONSTS,
                       _COUNT, _VP],
}


def _function(name, double):
    fn = getattr(cuda_lib.load(cuda_lib.library_name("fused_parts", double)),
                 name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def check_args(kernel, fields, shapes, geom):
    """Device, dtype, shape and contiguity checks of a kernel's tensor
    arguments and of the geometry it reads; raises on anything the kernel
    does not take."""
    p = fields[0]
    if p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kernel} takes float32 or float64, got {p.dtype}")
    if not 1 <= geom.layers <= MAX_LAYERS:
        raise ValueError(f"{kernel} takes 1..{MAX_LAYERS} layers, got "
                         f"{geom.layers}")
    for n, (x, want) in enumerate(zip(fields, shapes)):
        if x.device != p.device or x.dtype != p.dtype:
            raise ValueError(f"{kernel} argument {n}: {x.dtype} on "
                             f"{x.device}, expected {p.dtype} on {p.device}")
        if tuple(x.shape) != tuple(want):
            raise ValueError(f"{kernel} argument {n}: shape "
                             f"{tuple(x.shape)}, expected {tuple(want)}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel} argument {n} is not contiguous")
    for name in GEOM_FIELDS:
        g = getattr(geom, name)
        if g.device != p.device or g.dtype != p.dtype or not g.is_contiguous():
            raise ValueError(f"geom.{name} must be a contiguous {p.dtype} "
                             f"tensor on {p.device}, got {g.dtype} on "
                             f"{g.device}")


def on_cpu(kernel, fields):
    """Where a wrapper runs: True for CPU tensors (its plain version), False
    for CUDA tensors (its kernel); raises on mixed or other devices."""
    device = fields[0].device
    if device.type == "cpu":
        if any(x.device.type != "cpu" for x in fields):
            raise ValueError(f"{kernel}: mixed devices")
        return True
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {device}")
    return False


def _check(fields, geom):
    L, H, W = geom.layers, geom.height, geom.width
    check_args("fused_parts", fields,
               [(H, W) if n in (0, 5) else (L, H, W)
                for n in range(len(fields))], geom)


def pointer_array(tensors):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])


def kernel_consts(dt):
    """The C array of the scalars the kernels read: dt, 1/dt, kappa, Rd,
    Cp, G, 1/P0, 2*omega (Python floats, as the plain version uses them)."""
    dt = float(dt)
    return (ctypes.c_double * 8)(
        dt, 1.0 / dt, constants.kappa, constants.Rd, constants.Cp, constants.G,
        1.0 / constants.P0, 2 * constants.earth_omega)


def fused_parts(p, u, v, t, q, sp, su, sv, st, sq, spu, dt, geom,
                coriolis=False, q_limiter=False):
    """K1: returns ``(p_n, v_n, t_n, q_n, pu_partial, pg_phi)`` exactly as
    :func:`fused_parts_ref`.  ``p``/``sp`` are (H,W), the rest (L,H,W)."""
    fields = (p, u, v, t, q, sp, su, sv, st, sq, spu)
    if on_cpu("fused_parts", fields):
        return fused_parts_ref(*fields, dt, geom, coriolis=coriolis,
                               q_limiter=q_limiter)
    _check(fields, geom)
    device = p.device
    fn = _function("gcm_fused_parts", p.dtype == torch.float64)
    L, H, W = geom.layers, geom.height, geom.width
    outs = [torch.empty((H, W), dtype=p.dtype, device=device)] + [
        torch.empty((L, H, W), dtype=p.dtype, device=device) for _ in range(5)]
    # the column pass's phi and rho, which the tiled launch reads
    scratch = [torch.empty((L, H, W), dtype=p.dtype, device=device)
               for _ in range(2)]
    counts = [ctypes.c_int(0) for _ in range(2)]
    with torch.cuda.device(device):
        err = fn(int(p.dtype == torch.float64), pointer_array(fields),
                 pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
                 pointer_array(outs), pointer_array(scratch), L, H, W,
                 kernel_consts(dt),
                 int(bool(coriolis)), int(bool(q_limiter)),
                 *map(ctypes.byref, counts),
                 torch.cuda.current_stream(device).cuda_stream)
    column_pass.launches += counts[0].value
    parts_stencil.launches += counts[1].value
    if err != 0:
        raise RuntimeError(f"fused_parts kernel launch failed: CUDA error {err}")
    fused_parts.launches += 1
    return tuple(outs)


fused_parts.launches = 0
# the launches of K1's two stages, counted where the C entry makes them
column_pass = types.SimpleNamespace(launches=0)
parts_stencil = types.SimpleNamespace(launches=0)


def pgf_column(sp, st, geom):
    """K1's column pass alone: ``(rho, phi)`` exactly as
    ``core25d.pgf_column(sp, st, geom)``.  ``sp`` is (H,W), ``st``
    (L,H,W); the outputs are new tensors."""
    if on_cpu("pgf_column", (sp, st)):
        return core25d.pgf_column(sp, st, geom)
    L, H, W = geom.layers, geom.height, geom.width
    check_args("pgf_column", (sp, st), [(H, W), (L, H, W)], geom)
    rho, phi = (torch.empty((L, H, W), dtype=sp.dtype, device=sp.device)
                for _ in range(2))
    count = ctypes.c_int(0)
    with torch.cuda.device(sp.device):
        double = sp.dtype == torch.float64
        err = _function("gcm_pgf_column", double)(
            int(double), sp.data_ptr(), st.data_ptr(),
            pointer_array([getattr(geom, n) for n in GEOM_FIELDS]),
            rho.data_ptr(), phi.data_ptr(), L, H, W, kernel_consts(1.0),
            ctypes.byref(count),
            torch.cuda.current_stream(sp.device).cuda_stream)
    column_pass.launches += count.value
    if err != 0:
        raise RuntimeError(f"pgf_column kernel launch failed: CUDA error {err}")
    return rho, phi
