"""PyTorch port: the zonal Shapiro filter (``ops/shapiro.py``) against the
JAX package at float64 on the CPU, its properties, its cadence in the
driver (per step, and between the calls of 'stream' with the launch size
the gcd of the cadences), and ``stream_pipeline``.  Bounds: rtol 1e-12 for
each function (the same operations in the same order), 1e-10 of each
field's scale for whole runs (tests/test_parity.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.ops import shapiro as jshapiro
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import ModelState
from gcmiipy_tpu_torch.ops import shapiro

from torch_port_helpers import (
    FIELDS, assert_close, assert_states_close, hansen_jgeom, port_geom,
    port_state, random_state)

torch.set_num_threads(1)
RTOL = 1e-12   # one function against its JAX function
RUN = 1e-10    # a whole run, of each field's scale
ARGS = (16, 128, 3, 300.0)


@pytest.mark.parametrize("order", [2, 4, 8])
@pytest.mark.parametrize("axis", [-1, -2])
def test_shap1d_matches_jax(order, axis):
    """rtol 1e-12 (atol 1e-12 of the field's scale: the filtered field
    crosses 0)."""
    x = np.random.default_rng(order).standard_normal((3, 12, 20))
    out = shapiro.shap1d(torch.as_tensor(x), order, axis)
    ref = jshapiro.shap1d(jnp.asarray(x), order, axis)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=RTOL)


def test_shap1d_kills_the_two_grid_wave_and_keeps_the_mean():
    """Each row's mean kept to rounding, the 2-grid wave removed, a
    constant passed exactly; odd orders raise."""
    W = 32
    i = np.arange(W)
    rng = np.random.default_rng(1)
    smooth = 1.5 + np.sin(2 * np.pi * i / W)[None] + 0 * rng.random((4, 1))
    x = smooth + 0.7 * (-1.0) ** i
    out = shapiro.shap1d(torch.as_tensor(x), 8).numpy()
    np.testing.assert_allclose(out.mean(-1), x.mean(-1), rtol=1e-14)
    assert np.abs(out - smooth).max() < 1e-6
    const = torch.full((3, W), 2.5, dtype=torch.float64)
    assert torch.equal(shapiro.shap1d(const, 8), const)
    for bad in (0, 3, -2):
        with pytest.raises(ValueError, match="even"):
            shapiro.shap1d(const, bad)


def _terrain_state(seed=0):
    jg = hansen_jgeom(16, 36, 3, land_cover="none")
    p, u, v, t, q = random_state(jg, seed)
    p = p * np.exp(-np.asarray(jg.heightmap) / 8000.0)   # balanced-ish
    return jg, p, t


def test_slp_factor_matches_jax():
    """rtol 1e-12 over the Hansen terrain; 1 at sea level."""
    jg, p, t = _terrain_state()
    out = shapiro.slp_factor(torch.as_tensor(p), torch.as_tensor(t),
                             port_geom(jg))
    ref = jshapiro.slp_factor(jnp.asarray(p), jnp.asarray(t), jg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=0)
    sea = np.asarray(jg.heightmap) == 0
    assert (out.numpy()[sea] == 1).all() and out.max() > 1.5


@pytest.mark.parametrize("slp", [False, True])
@pytest.mark.parametrize("fields", ["p", "t", "pt"])
def test_filter_prognostics_matches_jax(fields, slp):
    """rtol 1e-12 for each field choice, with and without the sea-level
    reduction; the fields not chosen pass unchanged."""
    jg, p, t = _terrain_state(1)
    out = shapiro.filter_prognostics(torch.as_tensor(p), torch.as_tensor(t),
                                     order=8, fields=fields, slp=slp,
                                     geom=port_geom(jg))
    ref = jshapiro.filter_prognostics(jnp.asarray(p), jnp.asarray(t),
                                      order=8, fields=fields, slp=slp,
                                      geom=jg)
    assert_close(out, ref, RTOL, 0, ("p", "t"))
    for name, x, x0 in zip("pt", out, (p, t)):
        assert (name in fields) != np.array_equal(x.numpy(), x0), name


def test_filter_prognostics_checks_its_arguments():
    x = torch.ones(4, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="fields"):
        shapiro.filter_prognostics(x, x[None], fields="q")
    with pytest.raises(ValueError, match="geom"):
        shapiro.filter_prognostics(x, x[None], slp=True)


@pytest.mark.parametrize("host", [False, True])
def test_full_timestep_filters_on_cadence_steps(host):
    """full_timestep applies the filter after the steps 4, 8, ... of
    shapiro_every=4, keyed off the step counter tensor or off the host's
    count: 6 steps equal JAX's to 1e-10 of each field's scale, and the
    state after step 3 equals the unfiltered run's to the bit."""
    kw = dict(shapiro_every=4, shapiro_fields="pt", dtype="float64",
              topography="hansen", height=16, width=128, layers=3, dt=300.0)
    jg = hansen_jgeom(16, 128, 3, land_cover="none")
    jcfg = jdriver.normalize_config(JModelConfig(**kw))
    jstate = jdriver.gen_model_state(jg, jcfg)
    tg = port_geom(jg)
    cfg = driver.normalize_config(ModelConfig(**kw))
    assert cfg.shapiro_slp
    plain = driver.normalize_config(ModelConfig(**dict(kw, shapiro_every=0)))
    state = unfiltered = port_state(jstate)
    for i in range(6):
        state = driver.full_timestep(state, tg, cfg, None,
                                     host_step=i if host else None)
        if i < 3:
            unfiltered = driver.full_timestep(unfiltered, tg, plain, None)
            if i == 2:
                for a, b in zip(state.prog, unfiltered.prog):
                    assert torch.equal(a, b)
    for _ in range(6):
        jstate = jdriver.full_timestep(jstate, jg, jcfg, None)
    assert_states_close(state, jstate, RUN)
    assert int(state.step) == 6


@pytest.mark.parametrize("physics_every,shapiro_every,K", [
    (4, 2, 2), (4, 6, 2), (8, 4, 4), (2, 0, 2), (0, 8, 8)])
def test_stream_launch_size_is_the_gcd_of_the_cadences(physics_every,
                                                       shapiro_every, K):
    """stream_steps=8: K divides every active cadence, as in JAX."""
    kw = dict(backend="stream", stream_steps=8, shapiro_every=shapiro_every)
    if physics_every:
        kw.update(drag_tau=3600.0, physics_every=physics_every)
    out = driver._resolve_stream_cadence(ModelConfig(**kw), 24)
    ref = jdriver._resolve_stream_cadence(JModelConfig(**kw), 24)
    assert out[1] == ref[1] == K
    assert out[0].stream_steps == ref[0].stream_steps


def test_odd_shapiro_cadence_raises_on_stream_as_in_jax():
    cfg = dict(backend="stream", shapiro_every=3, dt=300.0, height=16,
               width=128, layers=3)
    jg = hansen_jgeom(16, 128, 3, topography="flat", land_cover="none")
    with pytest.raises(ValueError, match="must be even"):
        jdriver.make_run_fn(jg, JModelConfig(**cfg), 8)
    with pytest.raises(ValueError, match="must be even"):
        driver.make_run_fn(port_geom(jg), ModelConfig(**cfg), 8)


def test_stream_shapiro_alone_matches_jax():
    """The Shapiro filter of p over the terrain (sea-level reduction on)
    with no other extras: K7 calls of 2 steps with the filter between
    them, 7 steps (three calls and the odd tail), against JAX's 'stream'
    within 1e-10 of each field's scale."""
    kw = dict(backend="stream", stream_steps=4, shapiro_every=2,
              topography="hansen", dtype="float64")
    port = driver.run_model(*ARGS, 7, config=ModelConfig(**kw), device="cpu")
    ref = jdriver.run_model(*ARGS, 7, config=JModelConfig(**kw))
    assert_close(port[:5], ref[:5], RUN, RUN, FIELDS)
    assert port[7].total_energy.shape == (4,)


@pytest.mark.parametrize("physics", [False, True])
def test_stream_pipeline_matches_jax(physics):
    """stream_pipeline=True runs K7 unchanged; with the physics the flag
    keeps it out of the kernel, so physics_every=1 promotes to 2 between
    the calls, as in JAX: 8 steps within 1e-10 of each field's scale."""
    kw = dict(backend="stream", stream_steps=4, stream_pipeline=True,
              dtype="float64")
    if physics:
        kw.update(physics=True, drag_tau=86400.0, convection=True)
        with pytest.warns(UserWarning, match="promotes to 2"):
            port = driver.run_model(*ARGS, 8, config=ModelConfig(**kw),
                                    device="cpu")
        with pytest.warns(UserWarning, match="promotes to 2"):
            ref = jdriver.run_model(*ARGS, 8, config=JModelConfig(**kw))
    else:
        port = driver.run_model(*ARGS, 8, config=ModelConfig(**kw),
                                device="cpu")
        ref = jdriver.run_model(*ARGS, 8, config=JModelConfig(**kw))
    assert_close(port[:5], ref[:5], RUN, RUN, FIELDS)
    assert_close((port[5].gt,), (ref[5].gt,), RUN, RUN, ("gt",))
    assert port[7].total_energy.shape == ((4,) if physics else (2,))


def test_stream_state_counts_the_filter_in_its_cadence():
    """A 'stream' run restarted at step 2 of shapiro_every=4 (K = 2)
    filters after its first call, as a run from step 0 does after its
    second: the windowed test ``step % shapiro_every < k``."""
    kw = dict(backend="stream", stream_steps=2, shapiro_every=4,
              dtype="float64", height=16, width=128, layers=3, dt=300.0)
    jg = hansen_jgeom(16, 128, 3, topography="flat", land_cover="none")
    jstate = jdriver.gen_model_state(jg, JModelConfig(**kw))
    jstate = jstate._replace(step=jnp.asarray(2, jnp.int32))
    state = port_state(jstate)
    out = driver.make_run_fn(port_geom(jg), ModelConfig(**kw), 4)(state)
    ref = jdriver.make_run_fn(jg, JModelConfig(**kw), 4)(jstate)
    assert isinstance(out[0], ModelState) and int(out[0].step) == 6
    assert_states_close(out[0], ref[0], RUN)
