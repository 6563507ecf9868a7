"""PyTorch port: the cadence of the physics extras, against the JAX package.

Off the JAX package's streaming envelope (``pallas_stream.
stream_grid_supported``: 8 | H >= 16, 128 | W <= 4096; and W > 2048 with
H > 64), JAX's 'stream' runs the per-step 'mega4' path, so that drag and
physics keep the configured ``physics_every`` and the adaptive
convection.  The port's 'stream' does the same whenever the run has
extras: held against JAX at float64 on the reference's 24x36 grid at
1e-10 (tests/test_parity.py's bound), and on a wide and tall grid to the
bit against the port's own 'mega4' run (JAX's interpret-mode kernels take
minutes there).  A loop that counts its steps on the host runs
``physics_extras`` on the cadence steps only, as JAX's ``lax.cond``
skips it.
"""

import warnings

import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig

from torch_port_helpers import FIELDS, assert_close, port_geom, port_state

torch.set_num_threads(1)

CONFIGS = {
    # drag alone at physics_every=1: inside the envelope 'stream' promotes
    # it to 2
    "drag": dict(drag_tau=3600.0),
    # grey physics with convection: inside the envelope it runs in the
    # kernel with the fixed 4-sweep convection
    "convection": dict(physics=True, convection=True, drag_tau=86400.0),
}


def _convecting(jstate):
    """The state with its lowest five layers' potential temperature raised
    above the stable profile, 12 K more a layer further down, so that the
    adaptive convection takes more sweeps than the fixed form's four."""
    t = np.array(jstate.prog.t)
    for k in range(5):
        t[k] = t[5] + 12.0 * (5 - k)
    return jstate._replace(prog=jstate.prog._replace(t=t))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_off_the_envelope_matches_jax(name):
    """4 steps of 'stream' at stream_steps=4 and physics_every=1 on 24x36x9,
    outside the envelope (128 does not divide 36), from a convecting start:
    both packages warn and run the per-step path, equal within 1e-10."""
    L, H, W, steps = 9, 24, 36, 4
    cfg = dict(backend="stream", stream_steps=4, dtype="float64", height=H,
               width=W, layers=L, dt=300.0, **CONFIGS[name])
    jg = jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig
                                ).astype(np.float64)
    jstate = _convecting(jdriver.gen_model_state(jg, JModelConfig(**cfg)))
    state = port_state(jstate)  # before the JAX run, which donates it
    with pytest.warns(UserWarning, match="falls back to 'mega4'"):
        jrun = jdriver.make_run_fn(jg, JModelConfig(**cfg), steps)
    ref = jrun(jstate)
    with pytest.warns(UserWarning, match="falls back to 'mega4'"):
        run = driver.make_run_fn(port_geom(jg), ModelConfig(**cfg), steps)
    out = run(state)
    assert int(out[0].step) == steps
    assert_close(out[0].prog, ref[0].prog, 1e-10, 1e-10, FIELDS)
    assert_close((out[0].ground.gt,), (ref[0].ground.gt,), 1e-12, 1e-12,
                 ("gt",))
    assert_close(out[1], ref[1], 1e-10, 1e-10, out[1]._fields)


def test_stream_on_a_wide_tall_grid_runs_mega4():
    """72x2176 (W > 2048, H > 64, inside stream_grid_supported) with
    physics at physics_every=1: the port's 'stream' warns as the JAX
    package does and equals its own per-step 'mega4' run to the bit."""
    L, H, W, steps = 2, 72, 2176, 2
    cfg = dict(dtype="float64", height=H, width=W, layers=L, dt=300.0,
               **CONFIGS["convection"])
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=torch.float64, device="cpu")
    assert driver.stream_grid_supported(geom)
    state = driver.gen_model_state(geom, ModelConfig(**cfg))
    with pytest.warns(UserWarning, match=f"grid {H}x{W}: running"):
        run = driver.make_run_fn(geom, ModelConfig(backend="stream", **cfg),
                                 steps)
    out = run(state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = driver.make_run_fn(geom, ModelConfig(backend="mega4", **cfg),
                                 steps)(state)
    for a, b in zip(out[0].prog, ref[0].prog):
        assert torch.equal(a, b)
    assert torch.equal(out[0].ground.gt, ref[0].ground.gt)
    jg = jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)
    with pytest.warns(UserWarning, match=f"grid {H}x{W}: running"):
        jdriver.make_run_fn(jg, JModelConfig(backend="stream", **cfg), steps)


def test_stream_grid_supported_matches_jax():
    from gcmiipy_tpu.ops import pallas_stream
    for H, W in ((16, 128), (8, 128), (24, 36), (20, 128), (512, 4096),
                 (512, 4224), (72, 2176)):
        jg = jgeometry.gen_geometry(H, W, 1)
        assert (driver.stream_grid_supported(port_geom(jg))
                == pallas_stream.stream_grid_supported(jg))


def _counted_extras(monkeypatch):
    """Counts the calls of ``driver.physics_extras``."""
    calls = []
    extras = driver.physics_extras

    def counted(*args, **kw):
        calls.append(1)
        return extras(*args, **kw)

    monkeypatch.setattr(driver, "physics_extras", counted)
    return calls


@pytest.mark.parametrize("backend,guard,stream_steps", [
    ("xla", False, 4), ("xla", True, 4), ("stream", False, 2),
    ("stream", True, 2)])
def test_physics_extras_run_on_cadence_steps_only(monkeypatch, backend, guard,
                                                  stream_steps):
    """physics_every=4: 16 steps make 4 calls of physics_extras, on the
    eager loop and between the 'stream' calls of 2 steps, with and without
    the guard, and the run equals the one that keys the cadence off the
    step counter tensor (every call computed, the result picked)."""
    cfg = ModelConfig(backend=backend, height=16, width=128, layers=3,
                      dt=300.0, dtype="float64", physics=True,
                      convection=True, drag_tau=86400.0, physics_every=4,
                      stream_steps=stream_steps, guard=guard)
    geom = geometry.gen_geometry(16, 128, 3, sig_func=geometry.manabe_sig,
                                 dtype=torch.float64, device="cpu")
    state = driver.gen_model_state(geom, cfg)
    calls = _counted_extras(monkeypatch)
    out = driver.make_run_fn(geom, cfg, 16)(state)
    assert len(calls) == 4
    assert int(out[0].step) == 16
    picked = state
    step = driver.make_dynamics_step(geom, cfg, driver.make_filter_fn(
        cfg, geom), warn_degrade=False)
    for _ in range(16):
        picked = driver.full_timestep(picked, geom, cfg, None, step)
    assert len(calls) == 4 + 16
    tol = 1e-10 if backend == "stream" else 0.0
    assert_close(out[0].prog, picked.prog, tol, tol, FIELDS)
    assert_close((out[0].ground.gt,), (picked.ground.gt,), tol, tol, ("gt",))


def test_run_model_callback_runs_extras_on_cadence_steps_only(monkeypatch):
    calls = _counted_extras(monkeypatch)
    seen = []
    driver.run_model(16, 128, 3, 300.0, 8, callback=lambda *s: seen.append(1),
                     config=ModelConfig(dtype="float64", drag_tau=3600.0,
                                        physics_every=4), device="cpu")
    assert (len(calls), len(seen)) == (2, 8)
