"""Humidity conversions (port of ``gcmiipy_tpu/physics/humidity.py``,
reference humidity.py).  SI units; temperatures in Kelvin."""

import torch

from gcmiipy_tpu_torch import constants

_EPS = constants.Rd / constants.Rv  # ratio of gas constants, ~0.6226


def manabe_rh(sig):
    """Manabe 1967 relative-humidity profile 0.77 (sigma - 0.02)/0.98
    (reference humidity.py:4-7)."""
    return 0.77 * (sig - 0.02) / (1 - 0.02)


def saturation_vapor_pressure(tt):
    """Buck-equation saturation vapor pressure [Pa] (reference humidity.py:10-14)."""
    t = tt - 273.15
    return 611.21 * torch.exp((18.678 - t / 234.5) * (t / (257.14 + t)))


def w_s_at(tp, tt):
    """Saturation mixing ratio (reference humidity.py:17-20)."""
    e_s = saturation_vapor_pressure(tt)
    return _EPS * e_s / (tp - e_s)


def vmr_from_mmr(mmr, mmg, mma):
    """Volumetric from mass mixing ratio (reference humidity.py:23-24)."""
    return mma / mmg * mmr


def rh_to_mmr(rh, tp, tt):
    """Relative humidity -> mass mixing ratio (reference humidity.py:27-37)."""
    e_s = saturation_vapor_pressure(tt)
    e = rh * e_s
    w = e * _EPS / (tp - e)
    return w / (w + 1)


def mmr_to_rh(mmr, tp, tt):
    """Mass mixing ratio -> relative humidity (reference humidity.py:40-60)."""
    e_s = saturation_vapor_pressure(tt)
    w = mmr / (1 - mmr)
    e = w * tp / (_EPS + w)
    return e / e_s
