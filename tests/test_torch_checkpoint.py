"""The port's run services against the JAX package's: checkpoints, resume,
the metrics log (tests/test_checkpoint.py's cases), on the CPU at float64.

A checkpoint is ``step_{step:010d}.npz`` with the JAX package's keys, so a
file written by either package restores in the other.  Resumed runs equal
the straight run (1e-12 per step, 1e-10 across a 'stream' alignment head)
and the JAX package's resumed run at 1e-10.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import checkpoint as jcheckpoint
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu_torch.model import checkpoint, driver, observability
from gcmiipy_tpu_torch.model.config import ModelConfig
from torch_port_helpers import (
    FIELDS, assert_states_close, port_geom, port_state, state_dict)

torch.set_num_threads(1)
PARITY = 1e-10


def _state(height=4, width=4, layers=2):
    config = ModelConfig(height=height, width=width, layers=layers,
                         dtype="float64")
    geom = driver.gen_model_geometry(config, "cpu")
    return geom, config, driver.gen_model_state(geom, config)


def _assert_same_state(a, b):
    for x, y in zip(list(a.prog) + list(a.ground), list(b.prog)
                    + list(b.ground)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(a.utc.numpy(), b.utc.numpy())


def test_checkpoint_roundtrip(tmp_path):
    geom, config, state = _state()
    state = state._replace(utc=state.utc + 900.0,
                           step=torch.tensor(7, dtype=torch.int32))
    checkpoint.save_checkpoint(str(tmp_path), state, 7)
    assert os.listdir(tmp_path) == ["step_0000000007.npz"]
    restored, step = checkpoint.restore_checkpoint(str(tmp_path),
                                                   device="cpu")
    assert step == 7 and int(restored.step) == 7
    assert restored.step.dtype == torch.int32
    _assert_same_state(state, restored)


def test_latest_step_selection(tmp_path):
    _, _, state = _state()
    for s in (3, 12, 9):
        checkpoint.save_checkpoint(str(tmp_path), state, s)
    assert checkpoint.latest_step(str(tmp_path)) == 12
    # the file name's step is the counter, as in the JAX package
    restored, step = checkpoint.restore_checkpoint(str(tmp_path),
                                                   device="cpu")
    assert step == 12 and int(restored.step) == 12


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path / "nope"), device="cpu")
    assert checkpoint.latest_step(str(tmp_path / "nope")) is None
    # a JAX orbax checkpoint is a directory: not ported, and said so
    os.makedirs(tmp_path / "step_0000000005")
    with pytest.raises(FileNotFoundError, match="orbax"):
        checkpoint.restore_checkpoint(str(tmp_path), device="cpu")


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jgeom = jgeometry.gen_geometry(4, 4, 2, sig_func=jgeometry.manabe_sig)
    jcfg = JModelConfig(height=4, width=4, layers=2, dtype="float64")
    jstate, _ = jdriver.make_run_fn(jgeom.astype(np.float64), jcfg, 3)(
        jdriver.gen_model_state(jgeom.astype(np.float64), jcfg))
    jcheckpoint.save_checkpoint(str(tmp_path), jstate, 3, use_orbax=False)
    restored, step = checkpoint.restore_checkpoint(str(tmp_path),
                                                   device="cpu")
    assert step == 3
    _assert_same_state(port_state(jstate), restored)


def test_port_checkpoint_restores_in_jax(tmp_path):
    geom, config, state = _state()
    state, _ = driver.make_run_fn(geom, config, 3)(state)
    checkpoint.save_checkpoint(str(tmp_path), state, 3)
    jstate, step = jcheckpoint.restore_checkpoint(str(tmp_path),
                                                  use_orbax=False)
    assert step == 3
    for k, v in state_dict(jstate).items():
        if k == "step":
            assert int(v) == 3
            continue
        port = (state.prog._asdict() | state.ground._asdict()
                | {"utc": state.utc})[k]
        np.testing.assert_array_equal(v, port.numpy())


@pytest.mark.parametrize("backend", ["xla", "mega4"])
def test_resume_equals_straight_run(tmp_path, backend):
    """6 steps == 3, checkpoint, restore, 3 more (JAX
    test_resume_equals_straight_run), and == JAX's straight run."""
    config = ModelConfig(height=8, width=16, layers=2, dtype="float64",
                         backend=backend, dt=900.0)
    geom = driver.gen_model_geometry(config, "cpu")
    full, _ = driver.make_run_fn(geom, config, 6)(
        driver.gen_model_state(geom, config))
    half, _ = driver.make_run_fn(geom, config, 3)(
        driver.gen_model_state(geom, config))
    checkpoint.save_checkpoint(str(tmp_path), half, 3)
    restored, step = checkpoint.restore_checkpoint(str(tmp_path),
                                                   device="cpu")
    resumed, _ = driver.make_run_fn(geom, config, 3, start_step=step)(
        restored)
    for name, a, b in zip(FIELDS, full.prog, resumed.prog):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12,
                                   err_msg=name)
    assert int(resumed.step) == 6
    jgeom = jgeometry.gen_geometry(8, 16, 2, sig_func=jgeometry.manabe_sig)
    jcfg = JModelConfig(height=8, width=16, layers=2, dtype="float64",
                        backend=backend, dt=900.0)
    jfull, _ = jdriver.make_run_fn(jgeom.astype(np.float64), jcfg, 6)(
        jdriver.gen_model_state(jgeom.astype(np.float64), jcfg))
    assert_states_close(resumed, jfull, PARITY)


STREAM = dict(backend="stream", stream_steps=4, dtype="float64",
              physics=True, physics_every=4, drag_tau=86400.0, stats=False,
              dt=300.0)


def _stream_geoms():
    jgeom = jgeometry.gen_geometry(16, 128, 3, sig_func=jgeometry.manabe_sig
                                   ).astype(np.float64)
    return jgeom, port_geom(jgeom)


@pytest.mark.parametrize("split", [4, 6])
def test_stream_resume_keeps_the_cadence(tmp_path, split):
    """A 'stream' run with physics every 4 steps and the Shapiro filter
    every 8, split at step 4 (a multiple of K = 4) or at step 6 (not: the
    resumed run starts with a 2-step alignment head on 'mega4'), equals
    the straight run, and JAX's split run (JAX
    test_stream_resume_preserves_cadence and
    test_stream_misaligned_resume_keeps_cadence)."""
    cfg = dict(STREAM, shapiro_every=8)
    total = 2 * split
    jgeom, geom = _stream_geoms()
    config = ModelConfig(**cfg)
    full, _ = driver.make_run_fn(geom, config, total)(
        driver.gen_model_state(geom, config))
    part, _ = driver.make_run_fn(geom, config, split)(
        driver.gen_model_state(geom, config))
    checkpoint.save_checkpoint(str(tmp_path), part, split)
    restored, step = checkpoint.restore_checkpoint(str(tmp_path),
                                                   device="cpu")
    run = driver.make_run_fn(geom, config, split, start_step=step)
    assert getattr(run, "head_steps", 0) == (-split) % 4
    resumed, _ = run(restored)
    assert int(resumed.step) == total
    assert_states_close(resumed, _jax_state(full), PARITY)

    jcfg = JModelConfig(**cfg)
    jpart, _ = jdriver.make_run_fn(jgeom, jcfg, split)(
        jdriver.gen_model_state(jgeom, jcfg))
    jresumed, _ = jdriver.make_run_fn(jgeom, jcfg, split, start_step=split)(
        jpart)
    assert_states_close(resumed, jresumed, PARITY)


def _jax_state(state):
    """A port ModelState as the numpy pytree assert_states_close reads."""
    from gcmiipy_tpu.model.state import GroundVars, ModelState, PrognosticVars
    return ModelState(PrognosticVars(*(x.numpy() for x in state.prog)),
                      GroundVars(*(x.numpy() for x in state.ground)),
                      state.utc.numpy(), state.step.numpy())


def test_unaligned_resume_without_start_step_still_runs_the_extras(
        tmp_path):
    """Without ``start_step`` the extras still fire (delayed to a call
    boundary), so the ground temperature keeps moving, as in JAX."""
    _, geom = _stream_geoms()
    config = ModelConfig(**STREAM)
    part, _ = driver.make_run_fn(geom, config, 6)(
        driver.gen_model_state(geom, config))
    unaligned, _ = driver.make_run_fn(geom, config, 6)(part)
    assert not torch.allclose(unaligned.ground.gt, part.ground.gt, rtol=0,
                              atol=1e-12)


@pytest.mark.parametrize("blown,n,K,head", [
    (0, 12, 4, 2), (1, 12, 4, 2), (2, 12, 4, 2), (6, 12, 4, 2),
    (10, 12, 4, 2), (8, 13, 4, 0), (12, 13, 4, 0), (3, 14, 4, 3)])
def test_blown_chunk_len_with_a_head_matches_jax(blown, n, K, head):
    assert (driver._blown_chunk_len(blown, n, K, head)
            == jdriver._blown_chunk_len(blown, n, K, head))


def test_metrics_logger(tmp_path):
    path = tmp_path / "metrics.jsonl"
    log = observability.MetricsLogger(str(path))
    log.log(0, ke=1.5, u_max=2.0)
    log.log(1, ke=1.6, u_max=torch.tensor(2.1))
    log.close()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert lines[0]["step"] == 0 and lines[1]["ke"] == 1.6
    assert log.history[0]["u_max"] == 2.0


def test_run_model_metrics_path_matches_jax(tmp_path):
    """One JSON line a step, the stats of JAX's run at 1e-10."""
    lines = {}
    for pkg, run, cfg in (("port", driver.run_model, ModelConfig),
                          ("jax", jdriver.run_model, JModelConfig)):
        path = tmp_path / f"{pkg}.jsonl"
        kw = dict(device="cpu") if pkg == "port" else {}
        run(4, 4, 2, 900.0, 3, config=cfg(dtype="float64",
                                          metrics_path=str(path)), **kw)
        lines[pkg] = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ln["step"] for ln in lines["port"]] == [0, 1, 2]
    for a, b in zip(lines["port"], lines["jax"]):
        assert set(a) == set(b)
        for k in a:
            if k not in ("step", "time"):
                np.testing.assert_allclose(a[k], b[k], rtol=PARITY,
                                           atol=1e-12, err_msg=k)


def test_checkpoint_cadence_in_run_model(tmp_path):
    """checkpoint_every=3 over 7 steps leaves the step-3/6/7 checkpoints,
    equals an unchunked run to the bit and JAX's chunked run at 1e-10;
    the stats are stitched to 7 entries."""
    config = ModelConfig(dtype="float64", checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=3)
    out = driver.run_model(4, 4, 2, 900.0, 7, config=config, device="cpu")
    assert sorted(os.listdir(tmp_path / "ck")) == [
        f"step_{s:010d}.npz" for s in (3, 6, 7)]
    restored, step = checkpoint.restore_checkpoint(str(tmp_path / "ck"),
                                                   device="cpu")
    assert step == 7
    plain = driver.run_model(4, 4, 2, 900.0, 7, device="cpu",
                             config=ModelConfig(dtype="float64"))
    np.testing.assert_array_equal(out[0].numpy(), restored.prog.p.numpy())
    np.testing.assert_array_equal(out[0].numpy(), plain[0].numpy())
    assert len(out[7].ke) == 7
    ref = jdriver.run_model(4, 4, 2, 900.0, 7, config=JModelConfig(
        dtype="float64", checkpoint_dir=str(tmp_path / "jck"),
        checkpoint_every=3))
    for a, b in zip(out[:5], ref[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=PARITY,
                                   atol=PARITY)
    np.testing.assert_allclose(out[7].total_energy.numpy(),
                               np.asarray(ref[7].total_energy), rtol=PARITY)


def test_stream_checkpoint_every_rounds_to_the_launch_size(tmp_path):
    """A cadenced 'stream' run with checkpoint_every off K rounds it to a
    multiple of K, with JAX's warning, and equals the straight run."""
    cfg = dict(STREAM, checkpoint_dir=str(tmp_path), checkpoint_every=6)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = driver.run_model(16, 128, 3, 300.0, 12, device="cpu",
                               config=ModelConfig(**cfg))
    assert any("rounding to 4" in str(w.message) for w in caught)
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{s:010d}.npz" for s in (4, 8, 12)]
    straight = driver.run_model(16, 128, 3, 300.0, 12, device="cpu",
                                config=ModelConfig(**STREAM))
    for a, b in zip(out[:5], straight[:5]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_blown_checkpointed_run_stamps_the_last_good_step(tmp_path):
    """The guard freezes a chunked run: its checkpoint is stamped with the
    last good step and the run stops, as in JAX."""
    for pkg, run, cfg, kw in (
            ("port", driver.run_model, ModelConfig, dict(device="cpu")),
            ("jax", jdriver.run_model, JModelConfig, {})):
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            run(4, 4, 2, 900.0, 6, config=cfg(
                dtype="float64", guard=True, guard_t_max=200.0,
                checkpoint_dir=str(tmp_path / pkg), checkpoint_every=2),
                **kw)
    # the JAX run writes its orbax form here, a directory of the same stem
    assert os.listdir(tmp_path / "port") == ["step_0000000000.npz"]
    assert os.listdir(tmp_path / "jax") == ["step_0000000000"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with observability.trace(str(tmp_path)):
        torch.ones(4) + 1
    assert os.path.exists(tmp_path / "trace.json")
