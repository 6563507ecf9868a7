"""GCM-II ADVECQ flux clamp.

Port of ``gcmiipy_tpu/ops/limiters.py:gcm2_limit_flux`` (reference
port_one_d.py:246-251), the clamp that ``q_limiter`` applies.
"""

import torch

from gcmiipy_tpu_torch.ops.stencil import ip


def gcm2_limit_flux(fluxq, qt_scaled):
    """|flux| may not exceed half the upstream scaled tracer mass."""
    half = qt_scaled / 2
    return torch.maximum(torch.minimum(fluxq, half), -ip(half))
