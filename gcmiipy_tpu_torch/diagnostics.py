"""Blow-up diagnostics used by the run guard.

Port of ``gcmiipy_tpu/diagnostics.py:any_nan``: the reference's NaN sweep
(reference no_limits_2_5d.py:213), kept on the device as a bool tensor so a
guarded run needs no host sync per step.
"""

import torch


def any_nan(*tensors):
    """0-dim bool tensor: True if any tensor contains a NaN."""
    out = torch.isnan(tensors[0]).any()
    for x in tensors[1:]:
        out = out | torch.isnan(x).any()
    return out
