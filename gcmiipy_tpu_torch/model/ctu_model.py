"""Corner-transport-upwind model driver sketch.

Port of ``gcmiipy_tpu/model/ctu_model.py``, the twin of reference
``model.py``: the "advect everything with CTU" top-level sketch (SURVEY.md
section 2 #28), which also records the original GCM-II DYNAM call order
(reference ``model.py:38-45``; implemented in
:mod:`gcmiipy_tpu_torch.dynamics.gcm_sequence`).
"""

import torch

from gcmiipy_tpu_torch.device import resolve_device
from gcmiipy_tpu_torch.dynamics.advection_schemes import corner_transport_2d


def get_initial_conditions(world_shape=(16, 32), device="cuda"):
    """(reference model.py:16-33): a tracer square and a velocity stripe,
    ``(V, q, p, rho, t)`` in float64 on ``device``."""
    kw = dict(dtype=torch.float64, device=resolve_device(device))
    half = world_shape[0] // 2
    quarter = half // 2
    V = torch.zeros((2, *world_shape), **kw)
    V[0, half] = 1.0
    p = torch.zeros(world_shape, **kw)
    rho = torch.zeros(world_shape, **kw)
    q = torch.zeros(world_shape, **kw)
    q[quarter:half, quarter:half] = 1.0
    t = torch.full(world_shape, 273.15, **kw)
    return V, q, p, rho, t


def ctu_step(V, q, p, rho, t, dt=1.0, spatial_change=(10.0, 10.0)):
    """Advect every field with CTU (reference model.py:47-53)."""
    def adv(f):
        return corner_transport_2d(dt, spatial_change, V, f)

    V_next = torch.stack([adv(V[0]), adv(V[1])])
    return V_next, adv(q), adv(p), rho, adv(t)
