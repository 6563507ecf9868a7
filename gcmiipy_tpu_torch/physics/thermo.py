"""Thermodynamic conversions (port of ``gcmiipy_tpu/physics/thermo.py``,
reference temperature.py:7-27).  SI units: Pa, K, kg/m^3."""

import torch

from gcmiipy_tpu_torch import constants


def to_true_temp(t, p):
    """Potential temperature -> true temperature (reference temperature.py:7-12)."""
    return t / ((constants.P0 / p) ** constants.kappa)


def to_potential_temp(tt, p):
    """True temperature -> potential temperature (reference temperature.py:15-19)."""
    return tt * ((constants.P0 / p) ** constants.kappa)


def to_density(tt, p):
    """Ideal-gas density from true temperature (reference temperature.py:22-24)."""
    return p / (constants.Rd * tt)


def exbyk(p):
    """p^kappa, GCM-II's EXPBYK (reference port.py:602-603)."""
    return p ** constants.kappa


def thbar(t1, t2):
    """Arakawa log-mean THBAR(T1,T2) = T1 * ln(x)/(x-1), x = T1/T2, with the
    x -> 1 limit t1 (reference port_one_d.py:128-141)."""
    x = t1 / t2
    near = torch.abs(x - 1) < 1e-12
    safe = torch.where(near, torch.full_like(x, 2.0), x)
    g = torch.where(near, torch.ones_like(x), torch.log(safe) / (safe - 1))
    return t1 * g
