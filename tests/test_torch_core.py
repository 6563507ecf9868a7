"""PyTorch port: the plain dynamical core against the JAX core, at
float64 on the CPU.  Bounds are those of tests/test_parity.py (1e-10 over
10 steps) and the historical GISS-grid blow-up step (106)."""

import jax
import numpy as np
import pytest
import torch

from gcmiipy_tpu.dynamics import core25d as jcore
from gcmiipy_tpu.dynamics import energy as jenergy
from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu_torch.dynamics import core25d, energy
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig

from torch_port_helpers import (
    FIELDS, as_jax, as_torch, assert_close, port_geom, port_state,
    random_state)

torch.set_num_threads(1)


def _manabe(h, w, l, **kw):
    return jgeometry.gen_geometry(h, w, l, sig_func=jgeometry.manabe_sig, **kw)


def _hill(h, w):
    hm = np.zeros((h, w))
    hm[h // 4:h // 2, w // 8:w // 3] = 1500.0
    return hm


def test_aflux_pgf_advection_match_jax():
    jg = _manabe(16, 32, 4, heightmap=_hill(16, 32))
    tg = port_geom(jg)
    p, u, v, t, q = random_state(jg, seed=11)
    pu = u * 0.5 * (p + np.roll(p, -1, -1))
    pv = v * 0.5 * (p + np.roll(p, -1, -2))
    checks = [
        (core25d.aflux, jcore.aflux, (pu, pv)),
        (core25d.pgf, jcore.pgf, (p, t)),
        (core25d.compute_geopotential, jcore.compute_geopotential, (p, t)),
        (core25d.compute_geopotential_hydrostatic,
         jcore.compute_geopotential_hydrostatic, (p, t)),
        (core25d.advec_t, jcore.advec_t, (pu, pv, t)),
        (core25d.pgf_forces, jcore.pgf_forces, (p, u, t)),
    ]
    for fn, jfn, args in checks:
        out = fn(*as_torch(args), tg)
        ref = jfn(*as_jax(args), jg)
        out = out if isinstance(out, tuple) else (out,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert_close(out, ref, 1e-12, 1e-9, names=[fn.__name__] * len(out))


@pytest.mark.parametrize("coriolis", [False, True])
def test_advec_m_pu_and_limited_q_match_jax(coriolis):
    jg = _manabe(16, 32, 4)
    tg = port_geom(jg)
    p, u, v, t, q = random_state(jg, seed=12)
    pu = u * 0.5 * (p + np.roll(p, -1, -1))
    pv = v * 0.5 * (p + np.roll(p, -1, -2))
    out = core25d.advec_m_pu(*as_torch((p, u, v, pu, pv)), tg,
                             coriolis=coriolis)
    ref = jcore.advec_m_pu(*as_jax((p, u, v, pu, pv)), jg, coriolis=coriolis)
    assert_close(out, ref, 1e-12, 1e-9)
    # 3000x the fluxes so the clamp binds on some faces
    args = (3000 * pu, 3000 * pv, q, q * p)
    out = core25d.advec_q_limited(*as_torch(args), 300.0, tg)
    ref = jcore.advec_q_limited(*as_jax(args), 300.0, jg)
    assert_close((out,), (ref,), 1e-12, 1e-12)


@pytest.mark.parametrize("coriolis,q_limiter,hill",
                         [(False, False, False), (True, False, True),
                          (False, True, False)])
def test_half_timestep_parts_matches_jax(coriolis, q_limiter, hill):
    jg = _manabe(16, 128, 3, heightmap=_hill(16, 128) if hill else None)
    tg = port_geom(jg)
    s = random_state(jg, seed=3)
    spu = s[1] * 0.5 * (s[0] + np.roll(s[0], -1, -1))
    out = core25d.half_timestep_parts(*as_torch(s + s + (spu,)), 300.0, tg,
                                      coriolis=coriolis, q_limiter=q_limiter)
    ref = jcore.half_timestep_parts(*as_jax(s + s + (spu,)), 300.0, jg,
                                    coriolis=coriolis, q_limiter=q_limiter)
    assert_close(out, ref, 1e-11, 1e-11)


def test_half_timestep_v2_matches_jax():
    jg = _manabe(16, 128, 3)
    tg = port_geom(jg)
    s = random_state(jg, seed=5)
    out = core25d.half_timestep_v2(*as_torch(s + s), 300.0, tg)
    ref = jcore.half_timestep_v2(*as_jax(s + s), 300.0, jg)
    assert_close(out, ref, 1e-11, 1e-11, FIELDS)


@pytest.mark.parametrize("grid,kw", [
    ((8, 8, 3), {}),
    ((24, 36, 9), dict(sige_table=jgeometry.GISS_SIGE, ptop=1000.0)),
    ((16, 128, 3), dict(coriolis=True, q_limiter=True)),
])
def test_matsuno_10_steps_match_jax(grid, kw):
    geo_kw = {k: kw[k] for k in ("sige_table", "ptop") if k in kw}
    flags = {k: kw[k] for k in ("coriolis", "q_limiter") if k in kw}
    jg = (jgeometry.gen_geometry(*grid, **geo_kw) if geo_kw
          else _manabe(*grid))
    tg = port_geom(jg)
    s = random_state(jg, seed=0)
    jstep = jax.jit(lambda *x: jcore.matsuno_timestep(*x, 900.0, jg, **flags))
    sj, st = as_jax(s), as_torch(s)
    for _ in range(10):
        sj = jstep(*sj)
        st = core25d.matsuno_timestep(*st, 900.0, tg, **flags)
    assert_close(st, sj, 1e-10, 1e-10, FIELDS)


def test_energy_matches_jax():
    jg = _manabe(16, 32, 4)
    tg = port_geom(jg)
    s = random_state(jg, seed=9)
    assert_close(energy.calc_energy(*as_torch(s), tg),
                 jenergy.calc_energy(*as_jax(s), jg), 1e-12, 0)


def test_historical_sige_blowup_at_step_106():
    """The 24x36x9 GISS grid at dt=900 blows up at step 106 with the guard
    on, as the JAX core and the numpy oracle do (tests/test_parity.py)."""
    jg = jgeometry.gen_geometry(24, 36, 9, sige_table=jgeometry.GISS_SIGE,
                                ptop=1000.0)
    tg = port_geom(jg)
    config = ModelConfig(dt=900.0, dtype="float64", guard=True)
    state = port_state(jdriver.gen_model_state(
        jg, JModelConfig(dt=900.0, dtype="float64", guard=True)))
    out_state, stats, info = driver.make_run_fn(tg, config, 110)(state)
    assert not bool(info.ok)
    assert int(info.blown_step) == 106
    p = out_state.prog.p
    assert torch.isfinite(p).all() and p.max() <= config.guard_p_max
    assert int(out_state.step) == 106  # frozen at the last good step
    assert stats.total_energy.shape == (110,)
