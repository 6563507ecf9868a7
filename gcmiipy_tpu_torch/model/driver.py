"""Top-level 2.5D model driver.

Port of ``gcmiipy_tpu/model/driver.py``: builds geometry (optionally over
the Hansen terrain and land cover) and initial conditions, then advances
the Matsuno core for N steps, with the zonal Shapiro filter and the
cadenced physics (grey or four-band radiation, convection, surface drag,
evaporation and precipitation), the per-step ``StepStats`` and the blow-up
guard.  The 'stream' backend advances
``stream_steps`` steps a call through K7 (:func:`_make_stream_run_fn`).
``run_model`` writes checkpoints every ``checkpoint_every`` steps and the
per-step stats as JSON lines (``metrics_path``); ``make_run_fn(start_step=)``
resumes a run.  With ``mesh`` (:mod:`gcmiipy_tpu_torch.parallel.mesh`) every
rank steps its own latitude band with the shard forms of K6 or K7, the
halos going over ``torch.distributed``.

Where the JAX driver compiles the run as one ``lax.scan``, this one is an
eager loop, one for every path (:func:`_plan_run`).  The guard is still a
device-side flag carried through the loop: ``torch.where`` freezes the
state at the last good step (as JAX's ``guarded_body``), so there is no
host sync per step; the host reads the flag once, at the end of the run.
On a card a run function's later calls replay its walk as one CUDA graph
(:mod:`gcmiipy_tpu_torch.model.run_graph`).
"""

import dataclasses
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.device import resolve_device, torch_dtype
from gcmiipy_tpu_torch.diagnostics import any_nan
from gcmiipy_tpu_torch.dynamics import core25d, energy, fused
from gcmiipy_tpu_torch.grid import geometry, topography
from gcmiipy_tpu_torch.model import run_graph
from gcmiipy_tpu_torch.model.config import ModelConfig, check_ported
from gcmiipy_tpu_torch.model.observability import span
from gcmiipy_tpu_torch.model.state import (
    GroundVars, ModelState, PrognosticVars, gen_initial_conditions)
from gcmiipy_tpu_torch.ops import polar_filter, shapiro, stream_steps
from gcmiipy_tpu_torch.ops import radiation as radiation_op
from gcmiipy_tpu_torch.parallel import distributed, halo
from gcmiipy_tpu_torch.parallel import mesh as mesh_mod
from gcmiipy_tpu_torch.physics import (
    condensation, convection, evaporation, radiation, thermo)

# The JAX package's streaming envelope (pallas_stream.py:73-99, TPU VMEM
# limits), kept so that one config chooses the same path and cadence in
# both packages: the widest grid with the per-step physics inside the
# stream kernel, and the widest grid the kernel streams at all.
STREAM_RESIDENT_MAX_WIDTH = 2048
STREAM_MAX_WIDTH = 4096


def stream_grid_supported(geom):
    """The JAX package's streaming-kernel envelope
    (``pallas_stream.stream_grid_supported``): 8 | H, H >= 16, 128 | W and
    W <= :data:`STREAM_MAX_WIDTH`."""
    H, W = geom.height, geom.width
    if H % 8 or W % 128 or H < 16:
        return False
    return W <= STREAM_MAX_WIDTH


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


def validate_config(config):
    """Cross-field checks that would otherwise be silent no-ops (JAX
    ``validate_config``)."""
    if config.evaporation and not config.physics:
        raise ValueError(
            "ModelConfig(evaporation=True) requires physics=True — the "
            "evaporation step runs inside the physics step (it needs the "
            "radiatively updated ground state)")
    if config.physics_every < 1:
        raise ValueError(
            f"physics_every must be >= 1, got {config.physics_every}")
    if config.radiation not in ("grey", "4band"):
        raise ValueError(
            f"radiation must be 'grey' or '4band', got "
            f"{config.radiation!r} (a typo would silently run grey)")
    if config.precipitation and not config.physics:
        raise ValueError(
            "ModelConfig(precipitation=True) requires physics=True — "
            "condensation runs inside the physics step")
    if config.topography not in ("flat", "hansen"):
        raise ValueError(f"topography must be 'flat' or 'hansen', got "
                         f"{config.topography!r}")
    if config.land_cover not in ("none", "hansen"):
        raise ValueError(f"land_cover must be 'none' or 'hansen', got "
                         f"{config.land_cover!r}")


def normalize_config(config):
    """Validate and resolve the automatic fields (JAX ``normalize_config``):
    ``shapiro_slp=None`` becomes True over terrain (the sea-level-pressure
    filter keeps the orographic signal out of the smoothing) and False on
    flat ground."""
    check_ported(config)
    validate_config(config)
    if config.shapiro_slp is None:
        config = dataclasses.replace(config,
                                     shapiro_slp=config.topography != "flat")
    return config


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


def make_dynamics_step(geom, config, filter_fn, mesh=None, warn_degrade=True):
    """The stencil backend: 'xla' runs the plain PyTorch core, 'fused' the
    K1 kernel pipeline, 'mega' the K5 half-step kernel twice, 'mega4' the
    K6 whole-step kernel (:mod:`gcmiipy_tpu_torch.dynamics.fused`; 'mega'
    and 'mega4' have their own filters and do not use ``filter_fn``).
    'stream' advances many steps a call (:func:`make_run_fn`); a per-step
    caller of it gets 'mega4', with a RuntimeWarning unless
    ``warn_degrade`` is False, as in the JAX package.

    With ``mesh`` the step runs on the rank's block and ``geom`` is the
    global geometry: 'fused', 'mega' and 'mega4' run K6's shard form on a
    lat ring (:func:`shard_step.make_shard_step_fused4`) and K3's and K4's
    with the spectral-psum filter on a 2D mesh
    (:func:`shard_step.make_shard_step_fused2d`), as the JAX package's
    ``make_dynamics_step(mesh=)``; 'xla' runs the plain core with the
    spectral-psum filter on either (:func:`shard_step.make_shard_step_2d`:
    PyTorch has no GSPMD; JAX's 'xla' mesh run takes the DFT filter
    too)."""
    check_ported(config)
    backend = config.backend
    if backend == "stream":
        backend = "mega4"
        if warn_degrade:
            why = ("a device mesh" if mesh is not None
                   else "a per-step caller (callback path)")
            warnings.warn(
                f"backend 'stream' does not support {why}; running "
                "'mega4' instead — timings/numerics are mega4's",
                RuntimeWarning, stacklevel=3)
    if mesh is not None:
        from gcmiipy_tpu_torch.parallel import shard_step
        if backend == "xla":
            return shard_step.make_shard_step_2d(
                mesh, geom, config.dt, coriolis=config.coriolis,
                q_limiter=config.q_limiter)
        if mesh.nx > 1:
            return shard_step.make_shard_step_fused2d(
                mesh, geom, config.dt, coriolis=config.coriolis,
                q_limiter=config.q_limiter)
        return shard_step.make_shard_step_fused4(
            mesh, geom, config.dt, coriolis=config.coriolis,
            q_limiter=config.q_limiter)
    if backend in ("fused", "mega", "mega4"):
        return fused.make_fused_step(
            geom, config.dt, coriolis=config.coriolis, filter_fn=filter_fn,
            q_limiter=config.q_limiter,
            pipeline="v1" if backend == "fused" else backend)
    return lambda *s: core25d.matsuno_timestep(
        *s, config.dt, geom, filter_fn=filter_fn, coriolis=config.coriolis,
        q_limiter=config.q_limiter)


def solar_timestep(t, p, g, dt, utc, geom, config, q=None):
    """Radiative heating step (reference no_limits_2_5d.py:66-75), plus the
    optional Manabe-Strickler convective adjustment; ``dt`` is the cadence
    interval.  With ``config.seasonal`` the declination follows the clock
    ``utc``; with ``land_cover`` the albedo blends the ocean's and the
    land's by the land fraction; ``radiation='4band'`` runs the four-band
    longwave scheme, which needs the humidity ``q``: on a card as one
    kernel launch with both updates (:mod:`gcmiipy_tpu_torch.ops.radiation`),
    on the CPU as :func:`radiation.four_band_radiation`, its plain version.
    Returns (t, GroundVars) with the ground temperature advanced."""
    sig = geom.sig.to(t.dtype)
    ptop = geom.ptop.to(t.dtype)
    tp = p * sig + ptop
    # one Exner factor serves both conversions (thermo.to_true_temp and
    # to_potential_temp)
    exner_inv = (constants.P0 / tp) ** constants.kappa
    tt = t / exner_inv
    declination = 0.0
    if config.seasonal:
        with span("gcm.physics.sun"):
            declination = radiation.solar_declination(
                utc, config.obliquity, config.year_days)
    albedo = config.albedo
    if config.land_cover != "none":
        f_land = geom.land_fraction.to(t.dtype)
        albedo = config.albedo * (1.0 - f_land) + config.albedo_land * f_land
    if config.radiation == "4band" and q is None:
        raise ValueError("radiation='4band' needs the humidity field "
                         "q (pass it to solar_timestep)")
    with span("gcm.physics.radiation"):
        if config.radiation == "4band" and radiation_op.on_card(tt):
            # the radiation and both updates as one launch
            tt_n, gt_n = radiation_op.four_band_column(
                p.contiguous(), tt, q.contiguous(), g.gt.contiguous(),
                albedo, utc, dt, geom, config.t_sw, declination=declination)
        else:
            if config.radiation == "4band":
                dt_air, dt_ground = radiation.four_band_radiation(
                    p, tp, tt, q, g.gt, config.t_sw, albedo, utc, geom,
                    declination=declination)
            else:
                dt_air, dt_ground = radiation.basic_grey_radiation(
                    p, tp, tt, g.gt, config.t_lw, config.t_sw, albedo, utc,
                    geom, declination=declination)
            gt_n = g.gt + dt_ground * dt
            tt_n = tt + dt_air * dt
    if config.convection:
        with span("gcm.physics.convection"):
            tt_n = convection.convective_adjustment(
                tt_n, tp, p * geom.dsig.to(t.dtype))
    t_n = tt_n * exner_inv
    return t_n, GroundVars(gt_n, g.gw, g.snow, g.ice)


def physics_extras(prog: PrognosticVars, g: GroundVars, utc, geom, config,
                   dt_eff):
    """The per-cadence extras: Rayleigh drag on the surface layer's u and v
    (implicit, stable at any ``dt_eff``), the radiation step with the
    optional convection, then the bulk evaporation (on the true temperature
    after the radiation; with the land fraction under ``land_cover``) and
    the large-scale condensation.  ``dt_eff = physics_every * dt``: the extras
    integrate over the whole cadence interval.  ``utc`` is the clock at the
    start of the triggering dynamics step (the reference's call order,
    no_limits_2_5d.py:97 / :231-232)."""
    p, u, v, t, q = prog
    with span("gcm.physics"):
        if config.drag_tau > 0:
            f = 1.0 / (1.0 + dt_eff / config.drag_tau)
            u = torch.cat([u[:1] * f, u[1:]], dim=0)
            v = torch.cat([v[:1] * f, v[1:]], dim=0)
        if config.physics:
            t, g = solar_timestep(t, p, g, dt_eff, utc, geom, config, q=q)
        if config.physics and config.evaporation:
            with span("gcm.physics.evaporation"):
                tt = thermo.to_true_temp(
                    t, p * geom.sig.to(t.dtype) + geom.ptop.to(t.dtype))
                land = (geom.land_fraction if config.land_cover != "none"
                        else None)
                q, gt_n, gw_n = evaporation.evaporation_step(
                    p, q, u, v, tt, g.gt, g.gw, dt_eff, geom,
                    land_fraction=land)
            g = g._replace(gt=gt_n, gw=gw_n)
        if config.physics and config.precipitation:
            with span("gcm.physics.condensation"):
                t, q, gw_n = condensation.condensation_step(
                    p, t, q, g.gw, geom, rh_crit=config.rh_crit)
            g = g._replace(gw=gw_n)
    return PrognosticVars(p, u, v, t, q), g


class Cadence(NamedTuple):
    """The cadences of a run in steps, 0 where off: the extras (physics or
    drag) unless K7 runs them in its epilogue, and the Shapiro filter.
    Every path asks it when each falls due and whether to read the step."""
    extras: int
    shapiro: int

    @classmethod
    def of(cls, config, inkernel=False):
        runs_extras = (config.physics or config.drag_tau > 0) and not inkernel
        return cls(config.physics_every if runs_extras else 0,
                   max(config.shapiro_every, 0))

    @property
    def active(self):
        return any(self)

    def keyed(self, steps):
        """Whether a unit of ``steps`` steps must know its step: some active
        cadence is longer than the unit."""
        return max(self) > steps

    @property
    def period(self):
        """The steps after which every active cadence falls as before: the
        least common multiple of the active cadences (1 when none)."""
        return math.lcm(*(c for c in self if c))

    def extras_due(self, step_next, granularity=1):
        return self._due(self.extras, step_next, granularity)

    def shapiro_due(self, step_next, granularity=1):
        return self._due(self.shapiro, step_next, granularity)

    @staticmethod
    def _due(every, step_next, granularity):
        """Whether a cadence point falls in the step window ``(step_next -
        granularity, step_next]``: False when off, True when every window
        holds one, else a bool for a step held on the host (a Python int)
        or a 0-dim bool tensor for the carry's step counter."""
        if not every:
            return False
        if every <= granularity:
            return True
        return step_next % every < granularity


def _runs(due):
    """Whether work that is ``due`` is computed at all: a tensor flag
    chooses on the device, after the work."""
    return isinstance(due, torch.Tensor) or due


def apply_cadenced_extras(prog, g, utc, step_next, geom, config,
                          granularity=1):
    """Run :func:`physics_extras` iff a ``physics_every`` cadence point falls
    in the step window ``(step_next - granularity, step_next]``; ``utc``
    is the clock at the start of the completed step.  ``granularity`` is 1
    on the per-step paths and the chunk length on the stream path.  With a
    Python int ``step_next`` (a loop that counts its steps on the host) the
    extras run only on a cadence step, as the JAX package's ``lax.cond``
    skips them.  With the step counter tensor the choice is a
    ``torch.where`` on the device, so there is no host read, and the
    extras are computed on every call."""
    due = Cadence.of(config).extras_due(step_next, granularity)
    if not _runs(due):
        return prog, g
    new_prog, new_g = physics_extras(prog, g, utc, geom, config,
                                     config.physics_every * config.dt)
    if not isinstance(due, torch.Tensor):
        return new_prog, new_g
    return _pick(due, new_prog, prog), _pick(due, new_g, g)


def apply_cadenced_shapiro(prog, step_next, geom, config, granularity=1):
    """The zonal Shapiro filter of p and/or t (:func:`shapiro.filter_prognostics`)
    iff a ``shapiro_every`` cadence point falls in the step window
    ``(step_next - granularity, step_next]``; a Python int ``step_next``
    skips the work off cadence, the step counter tensor chooses on the
    device, as :func:`apply_cadenced_extras` does."""
    due = Cadence.of(config).shapiro_due(step_next, granularity)
    if not _runs(due):
        return prog
    with span("gcm.shapiro"):
        p, t = shapiro.filter_prognostics(
            prog.p, prog.t, order=config.shapiro_order,
            fields=config.shapiro_fields, slp=config.shapiro_slp, geom=geom)
        if isinstance(due, torch.Tensor):
            p, t = torch.where(due, p, prog.p), torch.where(due, t, prog.t)
    return prog._replace(p=p, t=t)


def full_timestep(state: ModelState, geom, config, filter_fn,
                  dynamics_step=None, host_step=None, ring=None) -> ModelState:
    """One dynamics step, the Shapiro filter at ``(step + 1) %
    shapiro_every == 0`` and the cadenced physics extras (reference
    no_limits_2_5d.py:79-104).  Both key off the state's integer step
    counter, or off ``host_step``, the same count held on the host (a
    Python int), which lets them skip the work off cadence.  ``ring``: the
    rank's :class:`_Ring` on a mesh, which runs the filter and the extras
    on its band."""
    if dynamics_step is None:
        dynamics_step = make_dynamics_step(geom, config, filter_fn)
    prog, g, utc, step = state
    with span("gcm.dynamics"):
        prog = PrognosticVars(*dynamics_step(*prog))
    if Cadence.of(config).active:
        step_next = step + 1 if host_step is None else host_step + 1
        with span("gcm.extras"):
            if ring is None:
                prog = apply_cadenced_shapiro(prog, step_next, geom, config)
                prog, g = apply_cadenced_extras(prog, g, utc, step_next,
                                                geom, config)
            else:
                prog, g = ring.cadenced(prog, g, utc, step_next)
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


def _pick(cond, new, old):
    """``torch.where(cond, new, old)`` over the tensors of a (nested)
    NamedTuple, such as a :class:`ModelState`."""
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    return type(new)(*(_pick(cond, x, y) for x, y in zip(new, old)))


def _stack_stats(stats_list):
    if not stats_list:
        return None
    return StepStats(*(torch.stack(col) for col in zip(*stats_list)))


def _cat_stats(a, b):
    """Two stacked :class:`StepStats` joined along the step axis (either
    may be None)."""
    if a is None or b is None:
        return b if a is None else a
    return StepStats(*(torch.cat([x, y]) for x, y in zip(a, b)))


class _Unit(NamedTuple):
    """A unit of a run's plan: ``steps`` steps from step offset ``start``,
    of ``kind`` 'call' (K steps), 'rem' (the even remainder, one shorter
    call) or 'tail' (an odd last step on the per-step 'mega4' path)."""
    start: int
    steps: int
    kind: str


def _chunk_plan(n, K):
    """The units of an ``n``-step run with launch size ``K``, in order: the
    K-step calls, the even remainder, the odd tail.  The per-step paths
    run the plan with K = 1."""
    calls, rem = divmod(n, K)
    plan = [_Unit(i * K, K, "call") for i in range(calls)]
    if rem > 1:
        plan.append(_Unit(calls * K, rem - rem % 2, "rem"))
    if rem % 2:
        plan.append(_Unit(n - 1, 1, "tail"))
    return plan


def _plan_run(plan, config, cadence, device, advance, bad_of, stats_of,
              select=_pick, snapshot=None, pack=None, unpack=None,
              capture=True):
    """``run(state)`` of every path: the units of ``plan`` in order, each
    by ``advance(carry, unit, host_step)``, on the state or on what
    ``pack(state)`` makes of it and ``unpack`` turns back.  ``host_step``:
    the step at the unit's start, read once a run iff some unit has an
    active ``cadence`` longer than itself (:meth:`Cadence.keyed`), else
    None.  On a card, and unless ``capture`` is False (a mesh), the walk is
    captured as a CUDA graph at a run function's second call of a key and
    replayed on every later one (:class:`run_graph.GraphedRun`, whose key
    holds the step's phase within :attr:`Cadence.period`).  With
    ``config.guard`` the carry freezes at the last good unit:
    ``select(good, new, old)`` keeps the new carry or the old one, or what
    ``snapshot(carry)`` saved of a carry that a unit advances in place;
    ``GuardInfo.blown_step`` is the start of the first unit that
    ``bad_of`` finds bad.  ``stats_of`` gives an entry a unit; without the
    guard the remainder and the odd tail give one, as in JAX."""
    keyed = any(cadence.keyed(unit.steps) for unit in plan)

    def walk(state, step0):
        carry = state if pack is None else pack(state)
        if config.guard:
            ok = torch.ones((), dtype=torch.bool, device=device)
            blown = torch.full((), -1, dtype=torch.int32, device=device)
        stats = []
        for unit in plan:
            host_step = None if step0 is None else step0 + unit.start
            if config.guard:
                old = carry
                if snapshot is not None:
                    with span("gcm.guard"):
                        old = snapshot(carry)
                new = advance(carry, unit, host_step)
                with span("gcm.guard"):
                    bad = bad_of(new)
                    good = ok & ~bad
                    carry = select(good, new, old)
                    blown = torch.where(
                        ok & bad, torch.full_like(blown, unit.start), blown)
                    ok = good
                # the snapshot and the carry not kept are freed before the
                # stats: a packed buffer's snapshot is the state's size
                del old, new
            else:
                carry = advance(carry, unit, host_step)
            if config.stats and (config.guard or unit.kind != "rem"
                                 or unit is plan[-1]):
                with span("gcm.stats"):
                    stats.append(stats_of(carry))
        out = (carry if unpack is None else unpack(carry),
               _stack_stats(stats))
        return out + (GuardInfo(ok, blown),) if config.guard else out

    return run_graph.GraphedRun(walk, cadence.period if keyed else 0,
                                capture=capture)


class _Ring:
    """What a rank of a mesh runs besides the dynamics, on its block of Hl
    rows (and Wl columns on a 2D mesh): the guard, the stats and the
    cadenced extras.

    * :meth:`bad`: :func:`state_bad` of the block, its maximum over the
      mesh (``all_reduce``, on the device), so that every rank freezes at
      the same step without a host read.
    * :meth:`stats`: :func:`collect_stats` over the block's core, the
      energies summed and the extrema reduced over the mesh.  The kinetic
      energy averages v with the row above (and u with the column to the
      left), so the block is padded by one cell from its neighbours, whose
      cell areas count as zero.
    * :meth:`cadenced`: the Shapiro filter and the extras.  On a lat ring
      both run on the band padded by one row, then trimmed: the filter is
      zonal over complete rows, the extras are column-local but the
      evaporation's wind averages v with the row above.  On a 2D mesh the
      filter needs whole latitude rows: p and t are gathered over the mesh
      row, filtered and cut back (cadence steps only); the extras run on
      the block padded by one cell on both axes (the evaporation's wind
      also averages u with the column to the left), then trimmed.  The
      adaptive convection is column-local: on a card each rank's columns
      stop sweeping on their own, in one launch with no host read, and no
      collective waits on it.
    """

    def __init__(self, mesh, geom, config):
        self.mesh, self.config = mesh, config
        self.two_d = mesh.nx > 1
        self.axes = (-2, -1) if self.two_d else (-2,)
        geom = geom.to(device=mesh.device)
        rows = mesh_mod.block_rows(geom.height, mesh.ny, mesh.index, 1)
        if self.two_d:
            self.geom = geom.take_block(rows, mesh_mod.block_cols(
                geom.width, mesh.nx, mesh.x_index, 1))
            self.rows_geom = geom.take_rows(
                mesh_mod.band_rows(geom.height, mesh.ny, mesh.index))
            self.cols = mesh_mod.band_cols(geom.width, mesh.nx,
                                           mesh.x_index)
            area = self.geom.area.expand(-1, self.geom.width).clone()
            area[:, 0] = area[:, -1] = 0.0
        else:
            self.geom = geom.take_rows(rows)
            area = self.geom.area.clone()
        area[0] = area[-1] = 0.0
        self.stats_geom = dataclasses.replace(self.geom, area=area)

    def _pad(self, *fields):
        """Each field padded by one cell from the neighbours along the cut
        axes (one exchange of the fields stacked as planes)."""
        planes = [x if x.dim() == 3 else x[None] for x in fields]
        stack = torch.cat(planes)
        block = (halo.exchange_2d(stack, 1, self.mesh) if self.two_d
                 else halo.exchange_axis(stack, 1, self.mesh))
        out = list(torch.split(block, [x.shape[0] for x in planes]))
        return [b if x.dim() == 3 else b[0] for b, x in zip(out, fields)]

    def _trim(self, x):
        return halo.trim(x, 1, self.axes).contiguous()

    def bad(self, state):
        flag = state_bad(state, self.config).to(torch.int32)
        return distributed.all_reduce(flag, dist.ReduceOp.MAX,
                                      self.mesh.group) > 0

    def stats(self, state):
        prog = state.prog
        ke, ate, geo, _ = energy.calc_energy(*self._pad(*prog),
                                             self.stats_geom)
        sums = distributed.all_reduce(torch.stack([ke, ate, geo]),
                                      dist.ReduceOp.SUM, self.mesh.group)
        ext = distributed.all_reduce(
            torch.stack([prog.u.max(), prog.v.max(), -prog.u.min(),
                         -prog.v.min()]), dist.ReduceOp.MAX, self.mesh.group)
        return StepStats(u_max=ext[0], u_min=-ext[2], v_max=ext[1],
                         v_min=-ext[3], ke=sums[0], ate=sums[1], geo=sums[2],
                         total_energy=sums[0] + sums[1] + sums[2])

    def _shapiro_rows(self, prog, step_next, granularity):
        """The Shapiro filter of a 2D mesh's block: p and t gathered into
        whole latitude rows over the mesh row, filtered, and cut back."""
        row_group = self.mesh.row_group
        whole = prog._replace(**{
            k: distributed.all_gather_rows(getattr(prog, k), row_group,
                                           dim=-1) for k in ("p", "t")})
        out = apply_cadenced_shapiro(whole, step_next, self.rows_geom,
                                     self.config, granularity=granularity)
        c0, c1 = int(self.cols[0]), int(self.cols[-1]) + 1
        return prog._replace(p=out.p[..., c0:c1].contiguous(),
                             t=out.t[..., c0:c1].contiguous())

    def cadenced(self, prog, g, utc, step_next, granularity=1):
        config = self.config
        cadence = Cadence.of(config)
        due_shapiro = _runs(cadence.shapiro_due(step_next, granularity))
        due_extras = _runs(cadence.extras_due(step_next, granularity))
        if not (due_shapiro or due_extras):
            return prog, g
        if self.two_d:
            if due_shapiro:
                prog = self._shapiro_rows(prog, step_next, granularity)
            if not due_extras:
                return prog, g
        padded = self._pad(*prog, *g)
        pprog, pg = PrognosticVars(*padded[:5]), GroundVars(*padded[5:])
        if not self.two_d:
            pprog = apply_cadenced_shapiro(pprog, step_next, self.geom,
                                           config, granularity=granularity)
        if due_extras:
            pprog, pg = apply_cadenced_extras(pprog, pg, utc, step_next,
                                              self.geom, config,
                                              granularity=granularity)
        return (PrognosticVars(*map(self._trim, pprog)),
                GroundVars(*map(self._trim, pg)))


def make_run_fn(geom, config, timesteps, mesh=None, start_step=0):
    """Build ``run(state) -> (state, stats)`` over ``timesteps`` Matsuno
    steps; with ``config.guard`` on, ``run(state) -> (state, stats,
    GuardInfo)``: the state stops advancing (freezes at the last good step)
    once a step produces NaNs or out-of-bounds values.  ``stats`` is a
    :class:`StepStats` of (timesteps,) tensors, or None with
    ``config.stats`` off.  The 'stream' backend advances ``stream_steps``
    steps a call; see :func:`_make_stream_run_fn` for its guard and stats
    granularity.

    ``start_step``: the step counter the state carries on entry (0 for a
    fresh run; the restored step when resuming).  A 'stream' run with
    cadenced extras that starts off a multiple of its launch size first
    runs the steps up to it on the per-step 'mega4' path
    (:func:`_with_alignment_head`), so that the cadence points land on
    call boundaries.  The per-step backends key off the state's own
    counter and ignore it.

    With ``mesh`` (a lat ring, :func:`mesh.make_mesh`) ``state`` is the
    rank's band (:func:`mesh.shard_state`) and ``geom`` the global
    geometry: the dynamics run the ring's step (K6's or K7's shard form),
    and the guard, the stats and the extras are those of :class:`_Ring`."""
    config = normalize_config(config)
    if config.backend == "stream":
        if mesh is not None:
            return _make_stream_ring_run_fn(geom, config, timesteps, mesh,
                                            start_step=start_step)
        return _make_stream_run_fn(geom, config, timesteps,
                                   start_step=start_step)
    filter_fn = make_filter_fn(config, geom) if mesh is None else None
    dynamics_step = make_dynamics_step(geom, config, filter_fn, mesh=mesh)
    ring = _Ring(mesh, geom, config) if mesh is not None else None
    return _plan_run(
        _chunk_plan(timesteps, 1), config, Cadence.of(config),
        mesh.device if mesh is not None else geom.device,
        lambda state, unit, host_step: full_timestep(
            state, geom, config, filter_fn, dynamics_step, host_step,
            ring=ring),
        ring.bad if ring else (lambda s: state_bad(s, config)),
        ring.stats if ring else (lambda s: collect_stats(s, geom)),
        capture=ring is None)


def _with_alignment_head(geom, config, timesteps, K, make_rest, start_step,
                         mesh=None):
    """A 'stream' run (single-device or ring) behind a per-step alignment
    head (JAX ``_with_alignment_head``): its calls apply the cadenced
    extras at their boundaries, which must land on multiples of the launch
    size K.  When ``start_step`` is not a multiple of K and extras or the
    Shapiro filter run at a cadence, ``head = (-start_step) % K`` steps run
    on the per-step 'mega4' path first, then ``make_rest(timesteps -
    head)``, which starts aligned.  Returns None when no head is needed."""
    head = (-start_step) % K if Cadence.of(config).active else 0
    if not head:
        return None
    head = min(head, timesteps)
    head_run = make_run_fn(geom, dataclasses.replace(config, backend="mega4"),
                           head, mesh=mesh)
    rest_run = make_rest(timesteps - head) if timesteps > head else None

    def run(state):
        out = head_run(state)
        if rest_run is None:
            return out
        if config.guard:
            with span("gcm.sync"):
                head_ok = bool(out[2].ok)
            if not head_ok:
                return out
        rest = rest_run(out[0])
        if not config.guard:
            return rest[0], _cat_stats(out[1], rest[1])
        gi = rest[2]
        blown = torch.where(gi.blown_step >= 0, gi.blown_step + head,
                            gi.blown_step)
        return rest[0], _cat_stats(out[1], rest[1]), GuardInfo(gi.ok, blown)

    run.chunk_steps = K
    run.head_steps = head
    return run


def _resolve_stream_cadence(config, timesteps, inkernel=False):
    """Resolve the 'stream' launch size K against the active cadences (JAX
    ``_resolve_stream_cadence``).  Extras that do not run inside the
    kernel (physics and drag at ``physics_every`` unless ``inkernel``, the
    Shapiro filter at ``shapiro_every``) run between launches, so K must
    divide every active cadence (their gcd), and launches are even (buffer
    ping-pong).  ``physics_every=1`` with extras promotes to 2 with a
    warning; odd cadences raise.  Returns ``(config, K)``."""
    if Cadence.of(config, inkernel).extras == 1:
        warnings.warn(
            "backend 'stream' runs physics/drag BETWEEN multi-step "
            "launches: physics_every=1 promotes to 2 (extras every 2 "
            "steps, dt_eff = 2*dt); set physics_every explicitly to pick "
            "the cadence", stacklevel=4)
        config = dataclasses.replace(config, physics_every=2)
    cadences = [c for c in Cadence.of(config, inkernel) if c]
    for c in cadences:
        if c % 2:
            raise ValueError(
                f"backend 'stream' applies cadenced extras between even-"
                f"sized launches; cadence {c} (physics_every / "
                "shapiro_every) must be even — or use backend 'mega4' "
                "for odd per-step cadences")
    K = max(2, config.stream_steps - config.stream_steps % 2)
    K = min(K, timesteps - timesteps % 2)
    if cadences:
        g = math.gcd(*cadences)
        if g % K:
            # the largest even divisor of g that fits in K
            K = max(d for d in range(2, min(K, g) + 1, 2) if g % d == 0)
        config = dataclasses.replace(config, stream_steps=K)
    return config, K


def _inkernel_physics(config, geom):
    """Whether K7 runs the physics inside each step (JAX
    ``_make_stream_run_fn`` :713-721, mirrored as it stands): grey
    radiation at ``physics_every=1``; the width limit is the JAX
    kernel's."""
    return (config.physics and config.physics_every == 1
            and config.radiation == "grey" and not config.evaporation
            and not config.precipitation and config.shapiro_every == 0
            and config.land_cover == "none" and not config.stream_pipeline
            and geom.width <= STREAM_RESIDENT_MAX_WIDTH)


def _cadence_clamp(config, K, k_cap):
    """K clamped to ``k_cap`` (the ring's halo bound) so that it still
    divides every active cadence (JAX ``_cadence_clamp``): the largest even
    divisor of ``stream_steps`` (which :func:`_resolve_stream_cadence` made
    divide them) up to ``k_cap``, else ``min(2, k_cap)``."""
    if K <= k_cap:
        return K
    g = config.stream_steps
    cands = [d for d in range(2, k_cap + 1, 2) if g % d == 0]
    return max(cands) if cands else min(2, k_cap)


def _make_stream_run_fn(geom, config, timesteps, start_step=0):
    """``run`` of the 'stream' backend: the state is packed once into the
    (2, planes, H, W) ping-pong buffer, advanced ``K`` steps a call by
    :class:`stream_steps.StreamSteps` (K7), and unpacked at the end.

    With grey physics at ``physics_every=1`` the physics runs inside each
    step (the ground temperature rides as the extra plane; convection in
    the fixed 4-sweep form).  Otherwise the extras and the Shapiro filter
    run between calls at their cadences, which K divides.  An even remainder runs as one shorter
    call, an odd last step on the per-step 'mega4' path (K6 and the
    per-step extras).

    Where the JAX package falls back to its per-step 'mega4' path (JAX
    ``_make_stream_run_fn``, with its warnings), a run with extras does
    too, so that they run at the configured ``physics_every`` with the
    adaptive convection, as there: fewer than 2 steps, a grid outside
    :func:`stream_grid_supported`, or W > 2048 with H > 64.  Without
    extras K7 runs on every grid but below 2 steps: there 'stream' equals
    'mega4' to the bit, and the kernels' own TPU fall-backs are not carried
    over.

    Guard and stats act once per call: ``GuardInfo.blown_step`` names the
    first step of the call that went bad, which :func:`run_model` narrows
    to the exact step (:func:`localize_blown_step`), and the stats hold one
    entry per call.  A run that starts at a ``start_step`` off the launch
    size runs an alignment head first (:func:`_with_alignment_head`)."""
    wide_tall = geom.width > STREAM_RESIDENT_MAX_WIDTH and geom.height > 64
    off_envelope = (not stream_grid_supported(geom)
                    or (wide_tall and not config.stream_wide_native))
    if timesteps < 2 or (Cadence.of(config).active and off_envelope):
        H, W = geom.height, geom.width
        if wide_tall and stream_grid_supported(geom) and timesteps >= 2:
            warnings.warn(
                f"grid {H}x{W}: running the per-step 'mega4' path, as the "
                "JAX package leaves its native tall-wide streaming kernel "
                "for its v1 fused pipeline at this width; the extras run "
                "at the configured physics_every", stacklevel=3)
        else:
            warnings.warn(
                f"backend 'stream' needs >= 2 steps and a grid inside the "
                f"streaming envelope (8 | H >= 16, 128 | W <= 4096 at any "
                f"height); {timesteps} steps on {H}x{W} falls back to "
                "'mega4'", stacklevel=3)
        return make_run_fn(geom, dataclasses.replace(config, backend="mega4"),
                           timesteps)
    inkernel = _inkernel_physics(config, geom)
    config, K = _resolve_stream_cadence(config, timesteps, inkernel)
    if inkernel:
        physics = stream_steps.make_physics(
            geom, t_lw=config.t_lw, t_sw=config.t_sw, albedo=config.albedo,
            drag_tau=config.drag_tau, convection=config.convection,
            seasonal=config.seasonal, obliquity=config.obliquity,
            year_days=config.year_days)
    else:
        physics = None
        headed = _with_alignment_head(
            geom, config, timesteps, K,
            lambda n: _make_stream_run_fn(geom, config, n), start_step)
        if headed is not None:
            return headed
    plan = _chunk_plan(timesteps, K)
    L = geom.layers
    NP = stream_steps.n_planes(L)
    dtype = torch_dtype(config.dtype)
    multi = stream_steps.StreamSteps(geom, config.dt,
                                     coriolis=config.coriolis,
                                     q_limiter=config.q_limiter,
                                     physics=physics)
    tail_step = (make_dynamics_step(geom, config, None, warn_degrade=False)
                 if plan[-1].kind == "tail" else None)
    cadence = Cadence.of(config, inkernel)
    # the planes the between-call work can change (p is plane 0, u and v
    # of layer 0 planes 1 and 1+L, t planes 1+2L.., q planes 1+3L..)
    p_changed = cadence.shapiro and "p" in config.shapiro_fields
    t_changed = config.physics or (cadence.shapiro
                                   and "t" in config.shapiro_fields)
    q_changed = config.physics and (config.evaporation
                                    or config.precipitation)

    def to_model_state(carry):
        S, g, utc, step = carry
        if inkernel:
            g = g._replace(gt=S[0, NP])
        return ModelState(
            PrognosticVars(*stream_steps.unpack_state(S[0], L)), g, utc, step)

    def advance(carry, unit, host_step):
        """A call of K7 (K steps or the even remainder), then the Shapiro
        filter and the extras that fall due in it, on the packed buffer,
        whose planes they change are written back; or the odd tail on the
        per-step path, packed into the buffer."""
        S, g, utc, step = carry
        if unit.kind == "tail":
            state = full_timestep(to_model_state(carry), geom, config, None,
                                  tail_step, host_step)
            S[0].copy_(stream_steps.pack_state(
                *state.prog, gt=state.ground.gt if inkernel else None))
            return S, state.ground, state.utc, state.step
        k = unit.steps
        with span("gcm.dynamics"):
            multi(S, utc, k)
        utc, step = utc + k * config.dt, step + k
        step_now = step if host_step is None else host_step + k
        due_extras = _runs(cadence.extras_due(step_now, k))
        if not (due_extras or _runs(cadence.shapiro_due(step_now, k))):
            return S, g, utc, step
        with span("gcm.extras"):
            prog = PrognosticVars(*stream_steps.unpack_state(S[0], L))
            prog = apply_cadenced_shapiro(prog, step_now, geom, config,
                                          granularity=k)
            if due_extras:
                # utc at the start of the cadence-triggering step, as the
                # per-step path passes it
                prog, g = apply_cadenced_extras(
                    prog, g, utc - config.dt, step_now, geom, config,
                    granularity=k)
            if p_changed:
                S[0, 0].copy_(prog.p)
            if config.drag_tau > 0:
                S[0, 1].copy_(prog.u[0])
                S[0, 1 + L].copy_(prog.v[0])
            if t_changed:
                S[0, 1 + 2 * L:1 + 3 * L].copy_(prog.t)
            if q_changed:
                S[0, 1 + 3 * L:1 + 4 * L].copy_(prog.q)
        return S, g, utc, step

    def pack_initial(state):
        gt = state.ground.gt.to(dtype) if inkernel else None
        packed = stream_steps.pack_state(
            *(x.to(dtype) for x in state.prog), gt=gt)
        return (torch.stack([packed, torch.zeros_like(packed)]),
                state.ground, state.utc, state.step)

    def snapshot(carry):
        S, g, utc, step = carry
        return S[0].clone(), g, utc, step

    def select(good, new, old):
        """The new carry, or the old one with the buffer restored from its
        snapshot: the calls advance the buffer in place."""
        S = new[0]
        S[0].copy_(torch.where(good, S[0], old[0]))
        return (S, *(_pick(good, x, y) for x, y in zip(new[1:], old[1:])))

    run = _plan_run(plan, config, cadence, geom.device, advance,
                    lambda c: state_bad(to_model_state(c), config),
                    lambda c: collect_stats(to_model_state(c), geom),
                    select=select, snapshot=snapshot, pack=pack_initial,
                    unpack=to_model_state)
    run.chunk_steps = K
    return run


def _make_stream_ring_run_fn(geom, config, timesteps, mesh, start_step=0):
    """``run`` of backend 'stream' on a lat ring (JAX
    ``_make_stream_ring_run_fn``): each call advances the rank's band K
    steps with one K*PHJ-row exchange and one call of K7's shard form
    (:func:`shard_step.make_shard_stream_ring`).  The extras, the Shapiro
    filter, the guard and the stats run between calls, as on one device,
    over the ring (:class:`_Ring`); an even remainder runs as one shorter
    call, an odd last step on the per-step 'mega4' ring.

    K is ``stream_steps`` resolved against the cadences, then clamped to
    at most 4 and to the halo bound ``k_cap`` (K*PHJ <= Hl, even), keeping
    it a divisor of every cadence (:func:`_cadence_clamp`).  Fewer than 2
    steps, a grid outside the streaming envelope or shards of fewer than
    2*PHJ rows run the 'mega4' ring, with JAX's warning; a 2D mesh runs the
    per-step fused2d path with JAX's warning."""
    from gcmiipy_tpu_torch.parallel import shard_step

    if mesh.nx > 1:
        warnings.warn(
            "sharded backend 'stream' decomposes over latitude only; a "
            "2D ('y','x') mesh runs the per-step fused2d path instead "
            "(mega4-class timings)", stacklevel=3)
        return make_run_fn(geom, dataclasses.replace(config, backend="mega4"),
                           timesteps, mesh=mesh, start_step=start_step)
    ny = mesh.shape.get("y", 1)
    hl = geom.height // ny if geom.height % ny == 0 else 0
    k_cap = (hl // shard_step.PHJ) - (hl // shard_step.PHJ) % 2
    if timesteps < 2 or not stream_grid_supported(geom) or k_cap < 2:
        warnings.warn(
            f"sharded backend 'stream' needs >= 2 steps, a grid inside "
            f"the streaming envelope and shard rows >= 2*PHJ; "
            f"{timesteps} steps on {geom.height}x{geom.width} over "
            f"{ny} shards falls back to the 'mega4' ring", stacklevel=3)
        return make_run_fn(geom, dataclasses.replace(config, backend="mega4"),
                           timesteps, mesh=mesh)
    config, K = _resolve_stream_cadence(config, timesteps)
    # the ring's halo rows are recomputed every call: cap the launch at 4
    # steps, as the JAX package does
    K = _cadence_clamp(config, K, min(k_cap, 4))
    headed = _with_alignment_head(
        geom, config, timesteps, K,
        lambda n: _make_stream_ring_run_fn(geom, config, n, mesh),
        start_step, mesh=mesh)
    if headed is not None:
        return headed
    plan = _chunk_plan(timesteps, K)
    advance_by = {k: shard_step.make_shard_stream_ring(
        mesh, geom, config.dt, steps_per_launch=k,
        coriolis=config.coriolis, q_limiter=config.q_limiter)
        for k in dict.fromkeys(u.steps for u in plan if u.kind != "tail")}
    tail_step = (make_dynamics_step(geom, config, None, mesh=mesh,
                                    warn_degrade=False)
                 if plan[-1].kind == "tail" else None)
    ring = _Ring(mesh, geom, config)
    cadence = Cadence.of(config)

    def advance(state, unit, host_step):
        if unit.kind == "tail":
            return full_timestep(state, geom, config, None, tail_step,
                                 host_step, ring=ring)
        k = unit.steps
        with span("gcm.dynamics"):
            prog = PrognosticVars(*advance_by[k](*state.prog))
        utc = state.utc + k * config.dt
        # the extras see the clock at the start of the call's last step, as
        # on one device
        g = state.ground
        if cadence.active:
            with span("gcm.extras"):
                prog, g = ring.cadenced(
                    prog, g, utc - config.dt,
                    state.step + k if host_step is None else host_step + k,
                    granularity=k)
        return ModelState(prog, g, utc, state.step + k)

    run = _plan_run(plan, config, cadence, mesh.device, advance, ring.bad,
                    ring.stats, capture=False)
    run.chunk_steps = K
    return run


def _blown_chunk_len(blown, n, K, head=0):
    """Length of the stream call that starts at step offset ``blown`` of an
    ``n``-step run with launch size ``K`` behind ``head`` per-step
    alignment steps: K for the main calls, the even remainder for the
    remainder call, 1 for the odd tail and the head's steps (JAX
    ``_blown_chunk_len``)."""
    if blown < head:
        return 1
    b = blown - head
    for unit in _chunk_plan(n - head, K):
        # a call's every step names it; the remainder's start alone
        if unit.start == b or (unit.kind == "call"
                               and unit.start < b < unit.start + K):
            return unit.steps
    return 1


def localize_blown_step(state, geom, config, max_steps, mesh=None):
    """Replay up to ``max_steps`` steps one at a time on the 'mega4' path
    (the 'mega4' ring with ``mesh``) from the frozen last-good ``state``;
    returns the 0-based offset of the first bad step, or None when the
    replay stays healthy (the call-level report then stands)."""
    cfg = dataclasses.replace(config, backend="mega4", stats=False,
                              guard=True, checkpoint_dir=None,
                              metrics_path=None)
    gi = make_run_fn(geom, cfg, max_steps, mesh=mesh)(state)[2]
    return None if bool(gi.ok) else int(gi.blown_step)


def gen_model_state(geom, config) -> ModelState:
    """Initial state incl. the reference's driver-level tweaks
    (``run_model`` sets u = 0 and seeds v[0,0,0] = 0.1,
    reference no_limits_2_5d.py:224-226).  Over terrain the surface
    pressure starts in barometric balance with the heightmap
    (:func:`geometry.pressure_from_heightmap` at ``sea_level_temp``), and
    the ground water starts at ``gw0``."""
    check_ported(config)
    dtype = torch_dtype(config.dtype)
    ps = None
    if config.topography != "flat":
        ps = geometry.pressure_from_heightmap(
            geom.heightmap.to(torch.float64), 1.0e5, config.sea_level_temp)
    prog, ground = gen_initial_conditions(geom, dtype=dtype,
                                          surface_pressure=ps)
    v = prog.v.clone()
    v[0, 0, 0] = 0.1
    prog = prog._replace(u=torch.zeros_like(prog.u), v=v)
    if config.gw0 > 0:
        ground = ground._replace(gw=torch.full_like(ground.gw, config.gw0))
    return ModelState(prog, ground,
                      torch.zeros((), dtype=dtype, device=geom.device),
                      torch.zeros((), dtype=torch.int32, device=geom.device))


def gen_model_geometry(config, device="cuda"):
    """The geometry :func:`run_model` builds for ``config``: its grid and
    sigma ladder (the GISS table with ``giss_sige``), with the Hansen maps
    resampled to the grid (:func:`topography.resample_map`) under
    ``topography='hansen'`` / ``land_cover='hansen'``, in the config's
    dtype on ``device``."""
    height, width = config.height, config.width
    dtype = torch_dtype(config.dtype)
    maps = dict(
        heightmap=(topography.resample_map(topography.TOPOGRAPHY_M, height,
                                           width)
                   if config.topography == "hansen" else None),
        land_fraction=(topography.resample_map(topography.LAND_COVER, height,
                                               width)
                       if config.land_cover == "hansen" else None))
    if config.giss_sige:
        return geometry.gen_geometry(
            height, width, config.layers, sige_table=geometry.GISS_SIGE,
            ptop=config.ptop or 1000.0, dtype=dtype, device=device, **maps)
    return geometry.gen_geometry(height, width, config.layers,
                                 sig_func=config.sig_func, ptop=config.ptop,
                                 dtype=dtype, device=device, **maps)


def _warn_blown(guard_info, config, geom, state, chunk_steps, n_steps,
                base_step=0, head=0, mesh=None):
    """Warn that the run blew up, naming the first bad step; returns
    whether it did.  A stream run reports the start of its bad call; the
    call is replayed step by step from the frozen state to name the exact
    step (the reference's port.py:295-310 names it).  ``base_step``: the
    step the run started at; ``head``: its alignment steps."""
    if bool(guard_info.ok):
        return False
    causes = ("NaN or surface pressure out of "
              f"[{config.guard_p_min}, {config.guard_p_max}] Pa")
    if config.guard_t_max > 0 or config.guard_t_min > 0:
        causes += (" or potential temperature out of "
                   f"[{config.guard_t_min}, "
                   f"{config.guard_t_max or float('inf')}] K")
    blown = int(guard_info.blown_step)
    step = base_step + blown
    detail = ""
    replay = (_blown_chunk_len(blown, n_steps, chunk_steps, head)
              if chunk_steps else 1)
    if replay > 1:
        off = localize_blown_step(state, geom, config, replay, mesh=mesh)
        if off is not None:
            step += off
            detail = (" (exact; localized by a per-step replay of the "
                      f"blown {replay}-step chunk)")
        else:
            detail = (f" (chunk granularity {replay}; the per-step replay "
                      "did not reproduce the blow)")
    warnings.warn(
        f"run blew up ({causes}) at step {step}{detail}; state frozen at "
        "the last good step", RuntimeWarning, stacklevel=3)
    return True


def _log_metrics(config, stats, n_steps=None):
    """The stats as JSON lines at ``config.metrics_path``, one line a stats
    entry (a step; a call on 'stream'), written by rank 0 alone (JAX
    ``_log_metrics``)."""
    if not (config.metrics_path and stats is not None):
        return
    if distributed.rank() != 0:
        return
    from gcmiipy_tpu_torch.model.observability import MetricsLogger
    host = StepStats(*(x.detach().cpu().numpy() for x in stats))
    n = len(host.total_energy)
    if n_steps is not None:
        n = min(n, n_steps)
    logger = MetricsLogger(config.metrics_path)
    for i in range(n):
        logger.log(i, **{k: getattr(host, k)[i] for k in StepStats._fields})
    logger.close()


def _run_checkpointed(geom, config, timesteps, state, mesh):
    """``run_model``'s chunked loop (JAX ``run_model`` :1233-1283): runs of
    ``checkpoint_every`` steps, a checkpoint after each, stamped with the
    last good step when the guard froze the run (which then stops).  A
    'stream' run with cadenced extras rounds ``checkpoint_every`` to a
    multiple of its launch size, with a warning, so that every chunk starts
    aligned."""
    from gcmiipy_tpu_torch.model.checkpoint import save_checkpoint
    every = config.checkpoint_every
    run_chunk = make_run_fn(geom, config, every, mesh=mesh)
    K = getattr(run_chunk, "chunk_steps", 1)
    if K > 1 and Cadence.of(config).active and every % K:
        new_every = max(K, every - every % K)
        warnings.warn(
            f"checkpoint_every={every} is not a multiple of the stream "
            f"launch size K={K}; rounding to {new_every} so cadenced "
            "extras stay chunk-aligned", stacklevel=3)
        every = new_every
        run_chunk = make_run_fn(geom, config, every, mesh=mesh)
    stats, done = None, 0
    while done < timesteps:
        n = min(every, timesteps - done)
        run_n = (run_chunk if n == every else
                 make_run_fn(geom, config, n, mesh=mesh, start_step=done))
        out = run_n(state)
        state = out[0]
        stats = _cat_stats(stats, out[1])
        done += n
        blown = config.guard and not bool(out[2].ok)
        good_step = done - n + int(out[2].blown_step) if blown else done
        save_checkpoint(config.checkpoint_dir, state, good_step, mesh=mesh)
        if blown and _warn_blown(out[2], config, geom, state,
                                 getattr(run_n, "chunk_steps", None), n,
                                 base_step=done - n,
                                 head=getattr(run_n, "head_steps", 0),
                                 mesh=mesh):
            break
    return state, stats, done


def run_model(height, width, layers, dt, timesteps, callback=None,
              config: ModelConfig = None, device="cuda", mesh=None):
    """Reference-compatible entry point (reference no_limits_2_5d.py:220-236).

    Returns (p, u, v, t, q, ground, geom, stats), tensors on ``device``;
    the geometry is :func:`gen_model_geometry`'s, over the Hansen terrain
    and land cover when the config asks for them.
    With ``callback`` (called with (p,u,v,t,q) after every step) the loop
    runs without the guard, as in the JAX driver.  With ``config.guard`` a
    run that blows up stops advancing and a RuntimeWarning names the first
    bad step.  ``device`` defaults to the GPU; a missing GPU raises.

    With ``config.checkpoint_dir`` and ``checkpoint_every`` the run goes in
    chunks with a checkpoint after each (:func:`_run_checkpointed`); with
    ``config.metrics_path`` the stats are written as JSON lines.

    With ``mesh`` (a lat ring, :func:`mesh.make_mesh`) every rank calls
    ``run_model``: each steps its own band of rows on the mesh's device,
    the guard, the stats and the checkpoints span the ring, and every rank
    receives the full fields.
    """
    if mesh is not None:
        if callback is not None:
            raise ValueError("mesh runs use the run function; callback is "
                             "not supported")
        device = mesh.device
    device = resolve_device(device)
    if config is None:
        config = ModelConfig(height=height, width=width, layers=layers, dt=dt)
    else:
        config = dataclasses.replace(config, height=height, width=width,
                                     layers=layers, dt=dt)
    config = normalize_config(config)
    geom = gen_model_geometry(config, device)
    state = gen_model_state(geom, config)
    if mesh is not None:
        state = mesh_mod.shard_state(state, mesh)

    if callback is None and config.checkpoint_dir \
            and config.checkpoint_every > 0:
        state, stats, done = _run_checkpointed(geom, config, timesteps,
                                               state, mesh)
        _log_metrics(config, stats, done)
    elif callback is None:
        run = make_run_fn(geom, config, timesteps, mesh=mesh)
        out = run(state)
        state, stats = out[0], out[1]
        if config.guard:
            _warn_blown(out[2], config, geom, state,
                        getattr(run, "chunk_steps", None), timesteps,
                        head=getattr(run, "head_steps", 0), mesh=mesh)
        _log_metrics(config, stats, timesteps)
    else:
        filter_fn = make_filter_fn(config, geom)
        dynamics_step = make_dynamics_step(geom, config, filter_fn)
        stats_list = []
        step0 = int(state.step)
        for step_idx in range(timesteps):
            state = full_timestep(state, geom, config, filter_fn,
                                  dynamics_step, step0 + step_idx)
            if config.stats:
                stats_list.append(collect_stats(state, geom))
            callback(*state.prog)
        stats = _stack_stats(stats_list)

    if mesh is not None:
        state = mesh_mod.gather_state(state, mesh)
    prog, ground = state.prog, state.ground
    return prog.p, prog.u, prog.v, prog.t, prog.q, ground, geom, stats
