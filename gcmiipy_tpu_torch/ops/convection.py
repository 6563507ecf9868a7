"""The adaptive convective adjustment as one CUDA kernel.

:func:`column_adjustment` launches ``csrc/convection.cu`` on CUDA tensors
(built at first use, see :mod:`gcmiipy_tpu_torch.ops.cuda_lib`) or raises.
Its plain version is the loop of
:func:`gcmiipy_tpu_torch.physics.convection.convective_adjustment`, which
calls it for ``adaptive=True`` where :func:`on_card` says the tensors are
on a card; it takes the two constant tables that function forms with
PyTorch, so that they round as the plain version's.

Each column sweeps until a sweep finds it stable, at most ``sweeps``
times, which gives each column what the plain version's global stop gives
it, with one launch a call and no host read.  ``column_adjustment.launches``
counts the launches, where the C entry makes them.  The largest number of
sweeps any column ran since the last reset is kept on the device
(:func:`sweeps_max` reads it; no run function does).  The kernel is bound
by bytes: about 0.027 ms a call at 9x512x1024 float32 on an H100's
3.35 TB/s (the source's header works the number out).
"""

import ctypes

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops.fused_parts import MAX_LAYERS, on_cpu

_I, _VP, _LL, _D = (ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_double)
_ARGTYPES = [_I, _VP, _VP, _LL, _LL, _LL, _VP, _VP, _VP, _VP, _D, _D, _D, _I,
             _I, _I, _I, ctypes.POINTER(ctypes.c_int), _VP]
# device -> the (1,) int32 tensor the kernel raises to its largest sweep
# count
_SWEEPS_MAX = {}


def _function(double):
    lib = cuda_lib.load(cuda_lib.library_name("convection", double))
    fn = lib.gcm_convection
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _sweeps_max_of(device):
    if device not in _SWEEPS_MAX:
        _SWEEPS_MAX[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _SWEEPS_MAX[device]


def on_card(tt):
    """Whether ``convective_adjustment`` launches the kernel for ``tt``:
    True on a card, False for a CPU tensor (the plain version)."""
    return not on_cpu("convection", (tt,))


def sweeps_max(device, reset=False):
    """The largest number of sweeps any column of any call on ``device``
    ran since the last reset (one host read; 0 before any call);
    ``reset`` sets it to 0 afterwards."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = _SWEEPS_MAX.get(device)
    if counter is None:
        return 0
    out = int(counter.item())
    if reset:
        counter.zero_()
    return out


def column_adjustment(tt, dp, log_ratio, inv_mass, critical_lapse, sweeps):
    """The adaptive adjustment of ``tt`` (L,H,W) on its card: a new tensor,
    equal to the plain version's to the bit.  ``dp``: the layer masses,
    (L,H,W) or a broadcast view of that shape; ``log_ratio``, ``inv_mass``:
    (L-1,H,W), ``log(p_k / p_k+1)`` and ``1 / (m_k + m_k+1)``; ``sweeps``:
    the most sweeps a column runs.  Raises on what the kernel does not
    take."""
    L, H, W = tt.shape
    if tt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"convection kernel takes float32 or float64, got "
                        f"{tt.dtype}")
    if not 2 <= L <= MAX_LAYERS:
        raise ValueError(f"convection kernel takes 2..{MAX_LAYERS} layers, "
                         f"got {L}")
    device = tt.device
    for name, x, shape in (("dp", dp, (L, H, W)),
                           ("log_ratio", log_ratio, (L - 1, H, W)),
                           ("inv_mass", inv_mass, (L - 1, H, W))):
        if x.device != device or x.dtype != tt.dtype:
            raise ValueError(f"convection kernel: {name} is {x.dtype} on "
                             f"{x.device}, expected {tt.dtype} on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"convection kernel: {name} of shape "
                             f"{tuple(x.shape)}, expected {shape}")
    if not (log_ratio.is_contiguous() and inv_mass.is_contiguous()):
        raise ValueError("convection kernel: the tables must be contiguous")
    tt = tt.contiguous()
    out = torch.empty_like(tt)
    count = ctypes.c_int(0)
    double = tt.dtype == torch.float64
    with torch.cuda.device(device):
        err = _function(double)(
            int(double), tt.data_ptr(), dp.data_ptr(), *dp.stride(),
            log_ratio.data_ptr(), inv_mass.data_ptr(), out.data_ptr(),
            _sweeps_max_of(device).data_ptr(), constants.Rd, constants.G,
            float(critical_lapse), int(sweeps), L, H, W, ctypes.byref(count),
            torch.cuda.current_stream(device).cuda_stream)
    column_adjustment.launches += count.value
    if err != 0:
        raise RuntimeError(f"convection kernel launch failed: CUDA error "
                           f"{err}")
    return out


# every launch of the kernel, counted where the C entry makes it
column_adjustment.launches = 0
