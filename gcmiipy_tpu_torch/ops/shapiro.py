"""N-th order Shapiro filter in the zonal direction (GCM-II FILTER/SHAP1D).

Port of ``gcmiipy_tpu/ops/shapiro.py``.  GCM-II smooths selected
prognostics zonally with an 8th-order Shapiro filter every few hours (the
reference stubs FILTER and SHAP1D, ``port.py:566-590``).  The order-n filter
(n even) is

    S_n x = x - (-1)^(n/2) F^(n/2) x,      F x = (x_{i+1} - 2 x_i + x_{i-1})/4

with periodic longitude: its response 1 - sin^n(k dx / 2) removes the
2-grid wave, passes resolved scales nearly untouched and keeps each row's
zonal mean (Shapiro 1970, Rev. Geophys. 8(2)).

Over topography GCM-II filters sea-level pressure (MFILTR=1): the surface
pressure is reduced with ``exp(g z / (R_d T_1))`` from the lowest layer's
true temperature, smoothed, and restored, so that the static orographic
signal is not diffused (``filter_prognostics(..., slp=True)``).  The
potential temperature is smoothed on sigma surfaces.
"""

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.physics import thermo


def shap1d(x, order=8, dim=-1):
    """The order-``order`` Shapiro filter along ``dim`` (periodic);
    ``order`` a positive even integer."""
    if order <= 0 or order % 2:
        raise ValueError(f"Shapiro order must be positive and even, got {order}")
    half = order // 2
    d = x
    for _ in range(half):
        d = (torch.roll(d, -1, dim) - 2 * d + torch.roll(d, 1, dim)) * 0.25
    sign = -1.0 if half % 2 else 1.0
    return x - sign * d


def slp_factor(p, t, geom):
    """Barometric sea-level reduction factor ``exp(g z / (R_d T_1))``, with
    ``T_1`` the true temperature of the lowest layer (k = 0); 1 where the
    ground is at sea level."""
    sig0 = geom.sig.to(t.dtype).reshape(-1)[0]
    ptop = geom.ptop.to(t.dtype)
    heightmap = geom.heightmap.to(t.dtype)
    tp_low = p * sig0 + ptop
    tt_low = thermo.to_true_temp(t[0], tp_low)
    return torch.exp(constants.G * heightmap / (constants.Rd * tt_low))


def filter_prognostics(p, t, order=8, fields="p", slp=False, geom=None):
    """GCM-II FILTER: smooth the surface pressure and/or the potential
    temperature zonally (``port.py:566-576``; ``fields`` 'p', 't' or 'pt').
    With ``slp=True`` (``geom`` needed) the pressure is reduced to sea level
    before smoothing and restored after.  Returns ``(p, t)``."""
    if fields not in ("p", "t", "pt"):
        raise ValueError(f"shapiro fields must be 'p', 't' or 'pt', "
                         f"got {fields!r}")
    if "p" in fields:
        if slp:
            if geom is None:
                raise ValueError("slp=True needs geom (heightmap/sig/ptop)")
            ptop = geom.ptop.to(p.dtype)
            factor = slp_factor(p, t, geom)
            psl = (p + ptop) * factor
            p = shap1d(psl, order=order) / factor - ptop
        else:
            p = shap1d(p, order=order)
    if "t" in fields:
        t = shap1d(t, order=order)
    return p, t
