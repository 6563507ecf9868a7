"""Top-level 2.5D model driver.

Port of ``gcmiipy_tpu/model/driver.py`` for the dynamics-only path: builds
geometry and initial conditions, then advances the Matsuno core for N steps
with the per-step ``StepStats`` and the blow-up guard.

Where the JAX driver compiles the run as one ``lax.scan``, this one is an
eager loop.  The guard is still a device-side flag carried through the loop:
``torch.where`` freezes the state at the last good step (as JAX's
``guarded_body``), so there is no host sync per step; the host reads the
flag once, at the end of the run.
"""

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from gcmiipy_tpu_torch.device import resolve_device, torch_dtype
from gcmiipy_tpu_torch.diagnostics import any_nan
from gcmiipy_tpu_torch.dynamics import core25d, energy, fused
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model.config import ModelConfig, check_ported
from gcmiipy_tpu_torch.model.state import (
    ModelState, PrognosticVars, gen_initial_conditions)
from gcmiipy_tpu_torch.ops import polar_filter


class StepStats(NamedTuple):
    """Per-step diagnostics (reference no_limits_2_5d.py:85-91)."""
    u_max: torch.Tensor
    u_min: torch.Tensor
    v_max: torch.Tensor
    v_min: torch.Tensor
    ke: torch.Tensor
    ate: torch.Tensor
    geo: torch.Tensor
    total_energy: torch.Tensor


class GuardInfo(NamedTuple):
    """Result of the blow-up guard: ``ok`` per run, first bad step (-1 when
    the run stayed healthy)."""
    ok: torch.Tensor
    blown_step: torch.Tensor


def make_filter_fn(config, geom):
    """The polar filter of the 'xla' and 'fused' backends (JAX
    ``driver.make_filter_fn``): 'fft' (``torch.fft``), 'matmul' (per-row
    circulant, O(J*I^2) memory: small grids) or 'dft' (shared real-DFT
    factors, correction form; with 'xla' the plain yardstick of 'mega4').
    The matrices are built once on the geometry's device: the circulant in
    the config's dtype, the DFT factors in float64, in which the 'dft'
    filter sums as 'mega4''s does (see ``polar_filter.arakawa_1977_dft``)."""
    check_ported(config)
    if config.polar_filter == "matmul":
        F = torch.as_tensor(polar_filter.build_filter_matrices(
            geom, dtype=np.dtype(config.dtype))).to(geom.device)
        return lambda q, geom: polar_filter.arakawa_1977_matmul(q, F)
    if config.polar_filter == "dft":
        mats = tuple(torch.as_tensor(m).to(geom.device) for m in
                     polar_filter.build_dft_matrices(geom.width,
                                                     dtype=np.float64))
        return lambda q, geom: polar_filter.arakawa_1977_dft(q, geom, mats)
    return polar_filter.arakawa_1977


def make_dynamics_step(geom, config, filter_fn):
    """The stencil backend: 'xla' runs the plain PyTorch core, 'fused' the
    K1 kernel pipeline, 'mega4' the K6 whole-step kernel
    (:mod:`gcmiipy_tpu_torch.dynamics.fused`; 'mega4' has its own filter
    and does not use ``filter_fn``)."""
    check_ported(config)
    if config.backend in ("fused", "mega4"):
        return fused.make_fused_step(
            geom, config.dt, coriolis=config.coriolis, filter_fn=filter_fn,
            q_limiter=config.q_limiter,
            pipeline="mega4" if config.backend == "mega4" else "v1")
    return lambda *s: core25d.matsuno_timestep(
        *s, config.dt, geom, filter_fn=filter_fn, coriolis=config.coriolis,
        q_limiter=config.q_limiter)


def full_timestep(state: ModelState, geom, config, filter_fn,
                  dynamics_step=None) -> ModelState:
    """One dynamics step (reference no_limits_2_5d.py:79-104).  The physics
    extras and the Shapiro filter are not ported; :func:`check_ported`
    refuses a config that asks for them."""
    if dynamics_step is None:
        dynamics_step = make_dynamics_step(geom, config, filter_fn)
    prog, g, utc, step = state
    prog = PrognosticVars(*dynamics_step(*prog))
    return ModelState(prog, g, utc + config.dt, step + 1)


def collect_stats(state: ModelState, geom) -> StepStats:
    prog = state.prog
    ke, ate, geo, tot = energy.calc_energy(
        prog.p, prog.u, prog.v, prog.t, prog.q, geom)
    return StepStats(
        u_max=prog.u.max(), u_min=prog.u.min(),
        v_max=prog.v.max(), v_min=prog.v.min(),
        ke=ke, ate=ate, geo=geo, total_energy=tot)


def state_bad(state: ModelState, config) -> torch.Tensor:
    """0-dim bool tensor: NaN sweep over the prognostics + the GCM-II
    surface-pressure bounds (port.py:295-310) + the CHECKT
    potential-temperature bounds when ``guard_t_max``/``guard_t_min`` > 0."""
    p = state.prog.p
    bad = any_nan(*state.prog)
    bad = bad | (p > config.guard_p_max).any()
    bad = bad | (p <= config.guard_p_min).any()
    t = state.prog.t
    if config.guard_t_max > 0:
        bad = bad | (t > config.guard_t_max).any()
    if config.guard_t_min > 0:
        bad = bad | (t <= config.guard_t_min).any()
    return bad


def _where_state(cond, new: ModelState, old: ModelState) -> ModelState:
    def pick(a, b):
        return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))
    return ModelState(pick(new.prog, old.prog), pick(new.ground, old.ground),
                      torch.where(cond, new.utc, old.utc),
                      torch.where(cond, new.step, old.step))


def _stack_stats(stats_list):
    if not stats_list:
        return None
    return StepStats(*(torch.stack(col) for col in zip(*stats_list)))


def make_run_fn(geom, config, timesteps):
    """Build ``run(state) -> (state, stats)`` over ``timesteps`` Matsuno
    steps; with ``config.guard`` on, ``run(state) -> (state, stats,
    GuardInfo)``: the state stops advancing (freezes at the last good step)
    once a step produces NaNs or out-of-bounds values.  ``stats`` is a
    :class:`StepStats` of (timesteps,) tensors, or None with
    ``config.stats`` off."""
    check_ported(config)
    filter_fn = make_filter_fn(config, geom)
    dynamics_step = make_dynamics_step(geom, config, filter_fn)

    def run(state):
        stats = []
        if config.guard:
            ok = torch.ones((), dtype=torch.bool, device=geom.device)
            blown = torch.full((), -1, dtype=torch.int32, device=geom.device)
        for step_idx in range(timesteps):
            new_state = full_timestep(state, geom, config, filter_fn,
                                      dynamics_step)
            if config.guard:
                bad = state_bad(new_state, config)
                advance = ok & ~bad
                state = _where_state(advance, new_state, state)
                blown = torch.where(ok & bad,
                                    torch.full_like(blown, step_idx), blown)
                ok = advance
            else:
                state = new_state
            if config.stats:
                stats.append(collect_stats(state, geom))
        if config.guard:
            return state, _stack_stats(stats), GuardInfo(ok, blown)
        return state, _stack_stats(stats)

    return run


def gen_model_state(geom, config) -> ModelState:
    """Initial state incl. the reference's driver-level tweaks
    (``run_model`` sets u = 0 and seeds v[0,0,0] = 0.1,
    reference no_limits_2_5d.py:224-226)."""
    check_ported(config)
    dtype = torch_dtype(config.dtype)
    prog, ground = gen_initial_conditions(geom, dtype=dtype)
    v = prog.v.clone()
    v[0, 0, 0] = 0.1
    prog = prog._replace(u=torch.zeros_like(prog.u), v=v)
    return ModelState(prog, ground,
                      torch.zeros((), dtype=dtype, device=geom.device),
                      torch.zeros((), dtype=torch.int32, device=geom.device))


def _warn_blown(guard_info, config):
    if bool(guard_info.ok):
        return
    causes = ("NaN or surface pressure out of "
              f"[{config.guard_p_min}, {config.guard_p_max}] Pa")
    if config.guard_t_max > 0 or config.guard_t_min > 0:
        causes += (" or potential temperature out of "
                   f"[{config.guard_t_min}, "
                   f"{config.guard_t_max or float('inf')}] K")
    warnings.warn(
        f"run blew up ({causes}) at step {int(guard_info.blown_step)}; "
        "state frozen at the last good step", RuntimeWarning, stacklevel=3)


def run_model(height, width, layers, dt, timesteps, callback=None,
              config: ModelConfig = None, device="cuda"):
    """Reference-compatible entry point (reference no_limits_2_5d.py:220-236).

    Returns (p, u, v, t, q, ground, geom, stats), tensors on ``device``.
    With ``callback`` (called with (p,u,v,t,q) after every step) the loop
    runs without the guard, as in the JAX driver.  With ``config.guard`` a
    run that blows up stops advancing and a RuntimeWarning names the first
    bad step.  ``device`` defaults to the GPU; a missing GPU raises.
    """
    device = resolve_device(device)
    if config is None:
        config = ModelConfig(height=height, width=width, layers=layers, dt=dt)
    else:
        config = dataclasses.replace(config, height=height, width=width,
                                     layers=layers, dt=dt)
    check_ported(config)
    dtype = torch_dtype(config.dtype)
    if config.giss_sige:
        geom = geometry.gen_geometry(
            height, width, layers, sige_table=geometry.GISS_SIGE,
            ptop=config.ptop or 1000.0, dtype=dtype, device=device)
    else:
        geom = geometry.gen_geometry(height, width, layers,
                                     sig_func=config.sig_func,
                                     ptop=config.ptop, dtype=dtype,
                                     device=device)
    state = gen_model_state(geom, config)

    if callback is None:
        out = make_run_fn(geom, config, timesteps)(state)
        state, stats = out[0], out[1]
        if config.guard:
            _warn_blown(out[2], config)
    else:
        filter_fn = make_filter_fn(config, geom)
        dynamics_step = make_dynamics_step(geom, config, filter_fn)
        stats_list = []
        for _ in range(timesteps):
            state = full_timestep(state, geom, config, filter_fn,
                                  dynamics_step)
            if config.stats:
                stats_list.append(collect_stats(state, geom))
            callback(*state.prog)
        stats = _stack_stats(stats_list)

    prog, ground = state.prog, state.ground
    return prog.p, prog.u, prog.v, prog.t, prog.q, ground, geom, stats
