"""Device selection shared by the port's entry points."""

import torch


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no GPU, instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return device


def torch_dtype(name):
    """``torch.float32`` / ``torch.float64`` from ``"float32"``/``"float64"``."""
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    if str(name) not in dtypes:
        raise ValueError(f"dtype must be float32 or float64, got {name!r}")
    return dtypes[str(name)]
