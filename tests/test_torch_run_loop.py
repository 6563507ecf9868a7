"""PyTorch port: the one cadence rule and the one run loop of the driver.

* ``driver.Cadence`` decides, for a step window, whether the extras and the
  Shapiro filter fall due: held to the JAX package's decisions
  (``_chunk_extras_state``, which applies both with the window's
  granularity), for a step held on the host and for the step counter
  tensor, through ``apply_cadenced_extras``/``apply_cadenced_shapiro``;
* the guarded and the unguarded walk of a run's plan end in the same state
  on 'xla', 'mega4' and 'stream', and give the stats one entry a unit
  (guarded) or join the remainder and the odd tail (unguarded);
* a run reads its step counter on the host (one ``gcm.sync``) iff some
  unit has an active cadence longer than itself.
"""

import warnings

import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu_torch.model import driver, observability
from gcmiipy_tpu_torch.model import state as state_mod
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import GroundVars, PrognosticVars

from torch_port_helpers import (
    as_jax, port_geom, port_state, random_state)

torch.set_num_threads(1)


@pytest.mark.parametrize("physics_every,shapiro_every,granularity,step_next",
                         [(4, 8, 1, 4), (4, 8, 1, 8), (4, 8, 1, 7),
                          (4, 8, 4, 6), (2, 4, 2, 6), (2, 4, 2, 5),
                          (4, 4, 4, 7), (6, 4, 2, 9), (3, 0, 1, 5)])
@pytest.mark.parametrize("keyed_on", ["host", "tensor"])
def test_cadence_decides_as_jax(physics_every, shapiro_every, granularity,
                                step_next, keyed_on):
    """Whether the drag and the Shapiro filter of t run in the window
    ``(step_next - granularity, step_next]``: JAX's ``_chunk_extras_state``
    against the helper and the port's two cadenced functions."""
    cfg = dict(drag_tau=3600.0, physics_every=physics_every,
               shapiro_every=shapiro_every, shapiro_fields="t",
               shapiro_slp=False, dtype="float64")
    jg = jgeometry.gen_geometry(16, 32, 2, sig_func=jgeometry.manabe_sig)
    jstate = jdriver.gen_model_state(jg, JModelConfig(**cfg))
    jstate = jstate._replace(
        prog=jstate.prog._replace(**dict(zip("puvtq", as_jax(
            random_state(jg, 5))))),
        step=np.int32(step_next))
    state = port_state(jstate)
    ref = jdriver._chunk_extras_state(jstate, jg, JModelConfig(**cfg),
                                      granularity=granularity)
    ref_extras = not np.array_equal(np.asarray(ref.prog.u),
                                    np.asarray(jstate.prog.u))
    ref_shapiro = not np.array_equal(np.asarray(ref.prog.t),
                                     np.asarray(jstate.prog.t))

    config = ModelConfig(**cfg)
    step = step_next if keyed_on == "host" else state.step
    cadence = driver.Cadence.of(config)
    assert cadence == (physics_every, shapiro_every)
    for due, ref_due in ((cadence.extras_due(step, granularity), ref_extras),
                         (cadence.shapiro_due(step, granularity),
                          ref_shapiro)):
        if keyed_on == "host" or due is True or due is False:
            assert due is ref_due
        else:
            assert due.dim() == 0 and bool(due) == ref_due
    if keyed_on == "tensor":
        # a cadence no longer than the window is due without a device flag
        assert (cadence.extras_due(step, granularity) is True) == (
            physics_every <= granularity)
    prog, g = PrognosticVars(*state.prog), GroundVars(*state.ground)
    geom = port_geom(jg)
    new_prog, _ = driver.apply_cadenced_extras(
        prog, g, state.utc, step, geom, config, granularity=granularity)
    assert (not torch.equal(new_prog.u, prog.u)) == ref_extras
    filtered = driver.apply_cadenced_shapiro(prog, step, geom, config,
                                             granularity=granularity)
    assert (not torch.equal(filtered.t, prog.t)) == ref_shapiro


# 16x128 is inside the streaming envelope: 'stream' runs a K=4 call, the
# even remainder of 2 and the odd tail in 7 steps
CADENCED = dict(height=16, width=128, layers=3, dt=300.0, dtype="float64",
                physics=True, drag_tau=86400.0, physics_every=4,
                shapiro_every=8, shapiro_fields="pt", stream_steps=4)


@pytest.mark.parametrize("backend,entries", [("xla", (7, 7)),
                                             ("mega4", (7, 7)),
                                             ("stream", (3, 2))])
def test_guard_on_and_off_walk_the_same_plan(backend, entries):
    """The guarded and the unguarded run of a healthy start end in the same
    state, to the bit; the guarded stats hold an entry a unit, the
    unguarded ones join the remainder and the tail into one."""
    outs = {}
    for guard in (True, False):
        config = ModelConfig(backend=backend, guard=guard, **CADENCED)
        geom = driver.gen_model_geometry(config, "cpu")
        state = driver.gen_model_state(geom, config)
        outs[guard] = driver.make_run_fn(geom, config, 7)(state)
    (on, stats_on, info), (off, stats_off) = outs[True], outs[False]
    assert bool(info.ok) and int(info.blown_step) == -1
    assert int(on.step) == int(off.step) == 7
    for a, b in zip([*on.prog, *on.ground, on.utc],
                    [*off.prog, *off.ground, off.utc]):
        assert torch.equal(a, b)
    assert (stats_on.ke.shape[0], stats_off.ke.shape[0]) == entries
    # both end on the run's last state; the calls' entries agree
    for a, b in zip(stats_on, stats_off):
        assert torch.equal(a[-1], b[-1])
        assert torch.equal(a[:entries[1] - 1], b[:-1])


def _sync_spans(config, steps, moist=False):
    """The ``gcm.sync`` spans of one run of ``config``, and its result."""
    geom = driver.gen_model_geometry(config, "cpu")
    state = driver.gen_model_state(geom, config)
    if moist:
        state = state_mod.moist_start(state, geom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        run = driver.make_run_fn(geom, config, steps)
    observability.span_totals(reset=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = run(state)
    totals = observability.span_totals(reset=True)
    return totals.get("gcm.sync", {}).get("count", 0), out


@pytest.mark.parametrize("name,cfg,steps,reads", [
    # every cadence equals the 2-step call: every call holds a point
    ("extras_every_call", dict(CADENCED, physics_every=2, shapiro_every=0,
                               stream_steps=2), 4, 0),
    # the odd tail is one step, shorter than the cadence
    ("extras_every_call_and_a_tail",
     dict(CADENCED, physics_every=2, shapiro_every=0, stream_steps=2), 5,
     1),
    # surface-flagship's cadences: the Shapiro filter every 4 steps is
    # longer than K = 2
    ("surface", dict(height=16, width=128, layers=3, dt=30.0,
                     topography="hansen", land_cover="hansen", physics=True,
                     physics_every=2, convection=True, radiation="4band",
                     evaporation=True, gw0=0.05, precipitation=True,
                     rh_crit=0.8, drag_tau=86400.0, shapiro_every=4,
                     shapiro_fields="pt", stream_steps=20,
                     guard_p_max=115000.0), 4, 1),
])
def test_a_run_reads_its_step_only_when_a_cadence_outlasts_a_unit(
        name, cfg, steps, reads):
    config = ModelConfig(backend="stream", guard=True, stats=True, **cfg)
    count, out = _sync_spans(config, steps,
                             moist=config.topography == "hansen")
    assert count == reads
    assert bool(out[2].ok) and int(out[0].step) == steps
