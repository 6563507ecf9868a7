"""The work of a model step, counted the same whatever computes it, and the
card's peaks that the work is held against.

Operations are counted over the benchmark's plain reference
(``gcmbench/reference``) as it runs, by :class:`OpCounter`: one operation
per output element of each elementwise arithmetic, comparison or select op
(two for a complex output), one per input element of each reduction or
scan, and ``2.5 n log2 n`` per real FFT of ``n`` points.  Data movement
(rolls, copies, concatenations, casts) is not counted.  Only what the
inputs need is counted: the adaptive convection runs, and is counted for,
the sweeps it needed.

Bytes are the prognostic and ground state, read once and written once a
step, at the configuration's type (:func:`state_bytes`).
"""

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM data sheet: float32 and float64 outside the tensor
# cores, HBM3 bandwidth
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES_PER_S = 3.35e12

ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "pow", "exp",
    "log", "sqrt", "rsqrt", "sin", "cos", "tan", "acos", "arccos", "abs",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "lt", "le",
    "gt", "ge", "eq", "ne", "where", "logical_or", "logical_and",
    "bitwise_or", "bitwise_and", "isnan"))
REDUCTIONS = frozenset(("sum", "cumsum", "cumprod", "prod", "max", "min",
                        "amax", "amin", "any", "all"))


def fft_ops(n):
    """Operations of one real FFT of ``n`` points."""
    return 2.5 * n * math.log2(n) if n > 1 else 0.0


def state_bytes(layers, height, width, dtype):
    """Bytes a step must move at least: the prognostic state (p and the
    layers of u, v, t, q) and the ground (gt, gw, snow, ice), each read once
    and written once."""
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    return 2 * (4 * layers + 5) * height * width * itemsize


class OpCounter(TorchDispatchMode):
    """Counts the operations of the code run under it (``ops``)."""

    def __init__(self):
        super().__init__()
        self.ops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0].rstrip("_")
        if name in ELEMENTWISE and torch.is_tensor(out):
            self.ops += out.numel() * (2 if out.is_complex() else 1)
        elif name in REDUCTIONS and torch.is_tensor(args[0]):
            self.ops += args[0].numel()
        elif name == "_fft_r2c":
            x, dims = args[0], args[1]
            n = x.shape[dims[-1]]
            self.ops += x.numel() // n * fft_ops(n)
        elif name == "_fft_c2r":
            n = args[3] if len(args) > 3 else kwargs["last_dim_size"]
            self.ops += out.numel() // n * fft_ops(n)
        return out


def least_seconds(ops, nbytes, dtype):
    """The least time the work could take on the card: the larger of the
    operations at the type's peak and the bytes at the bandwidth; and
    which of the two bounds it."""
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
