"""Model state tuples and initial conditions.

Port of ``gcmiipy_tpu/model/state.py``: the reference's ``PrognosticVars`` /
``GroundVars`` namedtuples (reference no_limits_2_5d.py:142-143) holding
tensors, plus the reference initial conditions.
"""

from typing import NamedTuple

import numpy as np
import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.physics import humidity, thermo


class PrognosticVars(NamedTuple):
    """Prognostic atmosphere state: p [j,i]; u,v,t,q [k,j,i]."""
    p: torch.Tensor   # surface pressure minus ptop [Pa]
    u: torch.Tensor   # zonal velocity at i+1/2 [m/s]
    v: torch.Tensor   # meridional velocity at j+1/2 [m/s]
    t: torch.Tensor   # potential temperature [K]
    q: torch.Tensor   # specific humidity [kg/kg]


class GroundVars(NamedTuple):
    """Ground state (reference no_limits_2_5d.py:143)."""
    gt: torch.Tensor    # ground temperature [K]
    gw: torch.Tensor    # ground water [m]
    snow: torch.Tensor  # snow depth [m]
    ice: torch.Tensor   # ice depth [m]


class ModelState(NamedTuple):
    """Atmosphere + ground + model time [s] (0-dim, working dtype) + exact
    integer step count (0-dim int32)."""
    prog: PrognosticVars
    ground: GroundVars
    utc: torch.Tensor
    step: torch.Tensor


def gen_initial_conditions(geom, dtype=torch.float32, surface_pressure=None):
    """Reference initial conditions (reference no_limits_2_5d.py:146-168):
    p = 1e5 Pa - ptop, u = 1 m/s, v = 0, tt = 360 K isothermal,
    q = max(3e-6, Manabe RH profile converted to mmr), ground at 360 K.

    ``surface_pressure``: optional (J, I) absolute surface pressure [Pa]
    replacing the uniform 1e5.  Tensors land on ``geom``'s device.
    """
    dev = geom.device
    full = (geom.layers, geom.height, geom.width)
    surface = (geom.height, geom.width)
    sig = geom.sig.to(dtype)
    ptop = geom.ptop.to(dtype)

    if surface_pressure is None:
        p = torch.full(surface, 100000.0, dtype=dtype, device=dev) - ptop
    else:
        p = torch.as_tensor(surface_pressure).to(dtype=dtype, device=dev) - ptop
    u = torch.full(full, 1.0, dtype=dtype, device=dev)
    v = torch.zeros(full, dtype=dtype, device=dev)
    tt = torch.full(full, 360.0, dtype=dtype, device=dev)
    tp = p * sig + ptop
    t = thermo.to_potential_temp(tt, tp)
    q = torch.full(full, 3.0e-6, dtype=dtype, device=dev)
    q = torch.maximum(q, humidity.rh_to_mmr(humidity.manabe_rh(sig), tp, tt))

    gt = torch.full(surface, 360.0, dtype=dtype, device=dev)
    gw = torch.zeros(surface, dtype=dtype, device=dev)
    snow = torch.zeros(surface, dtype=dtype, device=dev)
    ice = torch.zeros(surface, dtype=dtype, device=dev)
    return PrognosticVars(p, u, v, t, q), GroundVars(gt, gw, snow, ice)


def random_prognostics(geom, seed, dtype=None):
    """A random (p, u, v, t, q) from numpy's generator seeded with ``seed``
    (the recipe of tests/test_pallas_fused.py:_initial), in ``dtype``
    (``geom``'s by default) on ``geom``'s device: a start where every field
    moves from the first step, for the kernel checks and measurements."""
    rng = np.random.default_rng(seed)
    L, H, W = geom.layers, geom.height, geom.width
    p = 1e5 * (1 + 1e-3 * rng.standard_normal((H, W)))
    u = 0.5 * rng.standard_normal((L, H, W))
    v = 0.5 * rng.standard_normal((L, H, W))
    tp = p[None] * geom.sig.double().cpu().numpy() + float(geom.ptop)
    t = ((300 + 5 * rng.standard_normal((L, H, W)))
         * (constants.P0 / tp) ** constants.kappa)
    q = 1e-5 * (1 + 0.1 * rng.random((L, H, W)))
    dtype = geom.sig.dtype if dtype is None else dtype
    return PrognosticVars(*(torch.as_tensor(x).to(device=geom.device,
                                                  dtype=dtype)
                            for x in (p, u, v, t, q)))


def moist_start(state, geom):
    """``state`` cooled to 280 K, air and ground, with the lowest layer at
    1.2 times the saturation mixing ratio and the layers above at the
    Manabe relative humidity (with the reference's 3e-6 floor): a start
    where rain falls from the first physics step.  The reference's 360 K
    start is a steam bath where no cell reaches ``rh_crit``, and over the
    Hansen terrain, where the surface pressure falls below the 62 kPa of
    saturation at 360 K, the evaporation there blows the run up within a
    few steps; with every layer at 1.2 w_s the upper layers condense about
    0.1 kg/kg at once and trip the guard by step 5 (64x128 and 128x256 at
    dt = 30 s)."""
    tp = state.prog.p * geom.sig.to(state.prog.p.dtype) + geom.ptop
    tt = torch.full_like(tp, 280.0)
    ws = humidity.w_s_at(tp, tt)
    rh = humidity.manabe_rh(geom.sig.to(tp.dtype)).expand_as(ws).clone()
    rh[0] = 1.2
    return state._replace(
        prog=state.prog._replace(t=thermo.to_potential_temp(tt, tp),
                                 q=torch.clamp(rh * ws, min=3.0e-6)),
        ground=state.ground._replace(gt=torch.full_like(state.ground.gt,
                                                        280.0)))
