"""Dry convective adjustment (Manabe & Strickler 1964).

Port of ``gcmiipy_tpu/physics/convection.py``: pairwise adjustment of
adjacent sigma layers (k = 0 is the surface layer) toward the critical
6.5 K/km lapse rate, conserving column enthalpy ``sum_k Cp tt dp``.  An
unstable pair moves to the critical profile
``T_up = T_dn - gamma dz``, ``dz = (Rd Tbar / g) ln(p_dn / p_up)``.

The adaptive form on a card is one kernel launch
(:mod:`gcmiipy_tpu_torch.ops.convection`); the loop here is its plain
version, and the fixed-sweep form on every device.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops import convection as convection_op

CRITICAL_LAPSE = 0.0065  # K/m (Manabe & Strickler 1964)


def convective_adjustment(tt, tp, dp, critical_lapse=CRITICAL_LAPSE,
                          sweeps=None, adaptive=True):
    """Adjust true temperature ``tt`` (L,H,W) toward the critical lapse.

    ``tp``: mid-layer pressure (L,H,W) or broadcastable; ``dp``: layer
    mass weights (``p * dsig``).  Bottom-up sweeps over the L-1 layer
    pairs, ``sweeps`` of them (default 2L).  ``adaptive=True`` stops after
    the first sweep that changed no column (the same fixed point: a sweep
    over a converged field is the identity): on a card one kernel launch
    in which each column stops after its own first stable sweep, which
    gives the same field to the bit with no host read; on the CPU the loop
    below, which reads the stop on the host after each sweep.
    ``adaptive=False`` runs every sweep, the form K7's epilogue runs.  The
    temperature-independent ``log(p_k / p_k+1)`` and ``1 / (m_k + m_k+1)``
    are computed once."""
    L = tt.shape[0]
    if L < 2:
        return tt
    if sweeps is None:
        sweeps = 2 * L
    tp = torch.broadcast_to(torch.as_tensor(tp, dtype=tt.dtype), tt.shape)
    dp = torch.broadcast_to(torch.as_tensor(dp, dtype=tt.dtype), tt.shape)
    log_ratio = torch.log(tp[:-1] / tp[1:])
    inv_mass = 1.0 / (dp[:-1] + dp[1:])
    if adaptive and convection_op.on_card(tt):
        return convection_op.column_adjustment(tt, dp, log_ratio, inv_mass,
                                               critical_lapse, sweeps)
    ms = [dp[k] for k in range(L)]

    def pair(k, t_dn, t_up):
        tbar = 0.5 * (t_dn + t_up)
        dz = constants.Rd * tbar / constants.G * log_ratio[k]
        D = critical_lapse * dz
        unstable = t_up < t_dn - D
        t_dn_new = (ms[k] * t_dn + ms[k + 1] * t_up
                    + ms[k + 1] * D) * inv_mass[k]
        t_up_new = t_dn_new - D
        return (torch.where(unstable, t_dn_new, t_dn),
                torch.where(unstable, t_up_new, t_up), unstable)

    layers = [tt[k] for k in range(L)]
    for _ in range(sweeps):
        touched = torch.zeros((), dtype=torch.bool, device=tt.device)
        for k in range(L - 1):
            layers[k], layers[k + 1], unstable = pair(k, layers[k],
                                                      layers[k + 1])
            if adaptive:
                touched = touched | unstable.any()
        if adaptive and not bool(touched):
            break
    return torch.stack(layers, dim=0)
