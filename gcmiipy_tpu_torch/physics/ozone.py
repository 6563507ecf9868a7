"""Ozone mass-mixing-ratio profile.

Port of ``gcmiipy_tpu/physics/ozone.py`` (reference ``ozone.py``): a
26-point pressure -> mmr table sourced from the climlab grey-radiation
notebook (reference ``ozone.py:4-18``), interpolated linearly and held
constant beyond its ends, as ``np.interp`` does (reference
``ozone.py:21-22``).  Pressures here are SI [Pa] (the reference table is
hPa).
"""

import numpy as np
import torch

# (reference ozone.py:6-10, converted hPa -> Pa)
O_PRESSURE_PA = np.asarray([
    3.544638, 7.388814, 13.967214, 23.944625, 37.23029, 53.114605,
    70.05915, 85.439115, 100.514695, 118.250335, 139.115395, 163.66207,
    192.539935, 226.513265, 266.481155, 313.501265, 368.81798, 433.895225,
    510.455255, 600.5242, 696.79629, 787.70206, 867.16076, 929.648875,
    970.55483, 992.5561,
]) * 100.0

# (reference ozone.py:12-18)
O_VALUE = np.asarray([
    7.82792878e-06, 8.64150529e-06, 7.58940028e-06, 5.24567145e-06,
    3.17761574e-06, 1.82320006e-06, 9.80756960e-07, 6.22870516e-07,
    4.47620550e-07, 3.34481169e-07, 2.62570302e-07, 2.07898125e-07,
    1.57074555e-07, 1.12425545e-07, 8.06004999e-08, 6.27826498e-08,
    5.42990561e-08, 4.99506089e-08, 4.60075681e-08, 4.22977789e-08,
    3.80559071e-08, 3.38768568e-08, 3.12171619e-08, 2.97807119e-08,
    2.87980968e-08, 2.75429934e-08,
])


def interp(x, xp, fp):
    """``np.interp`` on a tensor ``x``: piecewise-linear through the
    increasing table ``(xp, fp)`` (numpy arrays), the end values beyond
    its ends; the tables are cast to ``x``'s dtype and device."""
    xp = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, len(xp) - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    w = (x - x0) / (x1 - x0)
    y = f0 + w * (f1 - f0)
    return torch.where(x <= xp[0], fp[0], torch.where(x >= xp[-1], fp[-1], y))


def ozone_at(p):
    """Ozone mass mixing ratio at pressure ``p`` [Pa] (reference
    ozone.py:21-22)."""
    return interp(p, O_PRESSURE_PA, O_VALUE)
