"""PyTorch port: K7 (``ops/stream_steps.py``) and the 'stream' backend.

On the CPU the wrapper runs its plain version, held against the JAX
package's streaming kernel (``pallas_stream.make_stream_kernel``) in
interpret mode, as tests/test_stream.py runs it, at float64 on 16x128x3:
1e-11 per call with and without the physics epilogue.  The model's
'stream' runs are held against JAX's 'stream' for 7 steps (a K=4 call, an
even remainder and an odd tail) at 1e-10 on the fields and 1e-12 on the
ground temperature.  The CUDA kernel is held against its plain version by
the ``gpu`` tests (skipped without a card) and by chip_smoke.py.
"""

import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.ops import pallas_stream as jstream
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.ops import mega_step as ms
from gcmiipy_tpu_torch.ops import stream_steps as ss
from gcmiipy_tpu_torch.ops.fused_parts import MAX_LAYERS

from torch_port_helpers import (
    FIELDS, as_jax, as_torch, assert_close, port_geom, port_state,
    random_state, state_dict)

torch.set_num_threads(1)
ARGS = (16, 128, 3, 300.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _jgeom(L=3, H=16, W=128):
    return jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)


def _packed(jg, seed, physics):
    """A random packed state (1+4L[+1], H, W) as float64 numpy, with a
    random ground temperature plane when ``physics``."""
    planes = list(random_state(jg, seed))
    planes[0] = planes[0][None]
    if physics:
        rng = np.random.default_rng(seed + 50)
        planes.append(290.0 + 20.0 * rng.random((1, jg.height, jg.width)))
    return np.concatenate(planes, axis=0)


PHYSICS = {
    "radiation": dict(),
    "all": dict(drag_tau=86400.0, convection=True, seasonal=True),
    "drag": dict(drag_tau=7200.0),
}


def _physics_pair(jg, tg, name):
    """The epilogue's parameters for both packages."""
    kw = dict(t_lw=0.1, t_sw=0.9, albedo=0.3, **PHYSICS[name])
    jkw = dict(kw, convection_sweeps=4 if kw.pop("convection", False) else 0)
    return jkw, ss.make_physics(tg, convection=bool(jkw["convection_sweeps"]),
                                **kw)


def test_pack_state_round_trip_and_layout():
    jg = _jgeom()
    state = as_torch(random_state(jg, 4))
    gt = torch.full(state[0].shape, 300.0, dtype=torch.float64)
    packed = ss.pack_state(*state, gt=gt)
    assert packed.shape == (ss.n_planes(3) + 1, 16, 128)
    ref = jstream.pack_state(*as_jax(random_state(jg, 4)),
                             gt=jnp.asarray(gt.numpy()))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))
    for a, b in zip(ss.unpack_state(packed, 3), state):
        assert torch.equal(a, b)
    assert torch.equal(packed[ss.n_planes(3)], gt)


@pytest.mark.parametrize("k,physics,utc0", [
    (4, None, 0.0), (2, "all", 3.1e4), (4, "radiation", 5.0e4),
    (2, "drag", 0.0)])
def test_stream_steps_ref_matches_jax_interpret(k, physics, utc0):
    jg = _jgeom()
    tg = port_geom(jg)
    packed = _packed(jg, 7, physics is not None)
    S = np.stack([packed, np.zeros_like(packed)])
    if physics is None:
        multi = jstream.make_stream_kernel(jg, 300.0, k, dtype=jnp.float64,
                                           interpret=True)
        ref = multi(jnp.asarray(S))
        phys = None
    else:
        jphys, phys = _physics_pair(jg, tg, physics)
        multi = jstream.make_stream_kernel(jg, 300.0, k, dtype=jnp.float64,
                                           interpret=True, physics=jphys)
        ref = multi(jnp.asarray(S), utc0)
    out = ss.stream_steps_ref(torch.as_tensor(S.copy()),
                              torch.tensor(utc0, dtype=torch.float64), k,
                              300.0, tg, ms.build_filter_consts(tg),
                              physics=phys)
    names = list(FIELDS) + (["gt"] if physics else [])
    L = jg.layers
    got = list(ss.unpack_state(out[0], L))
    want = list(jstream.unpack_state(np.asarray(ref)[0], L))
    if physics:
        got.append(out[0, ss.n_planes(L)])
        want.append(np.asarray(ref)[0, ss.n_planes(L)])
    assert_close(got, want, 1e-11, 1e-11, names)
    assert not np.allclose(out[0].numpy(), packed)


def test_epilogue_reads_the_clock_at_each_step_start():
    """Step s runs its physics at utc0 + s*dt: two steps of K7's plain
    version equal two single steps at utc0 and utc0 + dt, and a clock one
    step late moves the ground temperature by far more than rounding."""
    jg = _jgeom()
    tg = port_geom(jg)
    fc = ms.build_filter_consts(tg)
    _, phys = _physics_pair(jg, tg, "radiation")
    packed = torch.as_tensor(_packed(jg, 8, True))
    S = torch.stack([packed, torch.zeros_like(packed)])
    utc0 = torch.tensor(2.0e4, dtype=torch.float64)
    out = ss.stream_steps_ref(S.clone(), utc0, 2, 300.0, tg, fc, physics=phys)
    NP = ss.n_planes(3)

    def one(buf, utc):
        state = ss.mega_step_ref(*ss.unpack_state(buf, 3), 300.0, tg, fc)
        u, v, t, gt = ss.physics_epilogue_ref(state[0], state[1], state[2],
                                              state[3], buf[NP], utc, tg,
                                              300.0, phys)
        return ss.pack_state(state[0], u, v, t, state[4], gt=gt)

    manual = one(one(packed, utc0), utc0 + 300.0)
    assert torch.equal(out[0], manual)
    late = one(one(packed, utc0 + 300.0), utc0 + 600.0)
    shift = float((late[NP] - manual[NP]).abs().max())
    assert shift > 1e-6, shift


def test_epilogue_takes_the_ground_temperature_from_the_source_buffer():
    """Whatever the destination buffer's ground plane holds before a call
    is never read."""
    jg = _jgeom()
    tg = port_geom(jg)
    fc = ms.build_filter_consts(tg)
    _, phys = _physics_pair(jg, tg, "radiation")
    packed = torch.as_tensor(_packed(jg, 9, True))
    a = torch.stack([packed, torch.zeros_like(packed)])
    b = a.clone()
    b[1, ss.n_planes(3)] = 1e4
    utc0 = torch.tensor(0.0, dtype=torch.float64)
    ss.stream_steps_ref(a, utc0, 4, 300.0, tg, fc, physics=phys)
    ss.stream_steps_ref(b, utc0, 4, 300.0, tg, fc, physics=phys)
    assert torch.equal(a[0], b[0])


def test_make_stream_matsuno_matches_jax():
    jg = _jgeom()
    s = random_state(jg, 1)
    ref = jstream.make_stream_matsuno(jg, 300.0, steps_per_launch=2,
                                      dtype=jnp.float64, interpret=True)(
        *as_jax(s), 4)
    out = ss.make_stream_matsuno(port_geom(jg), 300.0, steps_per_launch=2)(
        *as_torch(s), 4)
    assert_close(out, ref, 1e-11, 1e-11, FIELDS)
    with pytest.raises(ValueError, match="multiple"):
        ss.make_stream_matsuno(port_geom(jg), 300.0, 2)(*as_torch(s), 3)


def test_stream_steps_on_cpu_runs_the_plain_version():
    jg = _jgeom()
    tg = port_geom(jg)
    _, phys = _physics_pair(jg, tg, "all")
    step = ss.StreamSteps(tg, 300.0, coriolis=True, physics=phys)
    packed = torch.as_tensor(_packed(jg, 3, True))
    S = torch.stack([packed, torch.zeros_like(packed)])
    utc0 = torch.tensor(600.0, dtype=torch.float64)
    before = ss.stream_steps.launches
    out = step(S.clone(), utc0, 2)
    ref = ss.stream_steps_ref(S.clone(), utc0, 2, 300.0, tg, step.consts,
                              coriolis=True, physics=phys)
    assert torch.equal(out, ref)
    assert ss.stream_steps.launches == before
    assert step.scratch is None


def _epilogue_args(jg, tg, physics, seed=3):
    """p, u, v, t, the ground temperature, the clock, the geometry, dt and
    the parameters of the epilogue on a random packed state."""
    packed = torch.as_tensor(_packed(jg, seed, True))
    p, u, v, t, _ = ss.unpack_state(packed, jg.layers)
    return (p, u, v, t, packed[-1], torch.tensor(7200.0, dtype=torch.float64),
            tg, 300.0, _physics_pair(jg, tg, physics)[1])


def test_column_physics_on_cpu_runs_the_plain_version():
    jg = _jgeom()
    args = _epilogue_args(jg, port_geom(jg), "all")
    before = ss.column_physics.launches
    out = ss.column_physics(*args)
    assert ss.column_physics.launches == before
    for a, b in zip(out, ss.physics_epilogue_ref(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensors expected"):
        ss.column_physics_inplace(*args[:5], torch.empty_like(args[4]),
                                  args[5], args[6], None)


def test_physics_table_holds_the_c_layout():
    """The epilogue's table: the scalars, then each per-layer row padded to
    kMaxLayers, float64, on the device asked for."""
    jg = _jgeom()
    ph = _physics_pair(jg, port_geom(jg), "all")[1]
    table = ss.physics_table(ph, 300.0)
    assert table.dtype == torch.float64 and table.device.type == "cpu"
    assert table.shape == (ss.PHYS_SCALARS + ss.PHYS_ROWS * MAX_LAYERS,)
    assert float(table[0]) == 300.0  # kDt
    rows = table[ss.PHYS_SCALARS:].reshape(ss.PHYS_ROWS, MAX_LAYERS)
    assert rows[0, :3].tolist() == list(ph.sig)
    assert rows[1, :3].tolist() == list(ph.dsig)
    assert bool((rows[:, 3:] == 0).all())


def test_stream_steps_checks_its_arguments():
    jg = _jgeom()
    tg = port_geom(jg)
    fc = ms.build_filter_consts(tg)
    packed = torch.as_tensor(_packed(jg, 3, False))
    S = torch.stack([packed, torch.zeros_like(packed)])
    utc0 = torch.tensor(0.0, dtype=torch.float64)
    with pytest.raises(ValueError, match="even"):
        ss.stream_steps(S, utc0, 3, 300.0, tg, fc)
    _, phys = _physics_pair(jg, tg, "radiation")
    with pytest.raises(ValueError, match="shape"):
        ss.stream_steps(S, utc0, 2, 300.0, tg, fc, physics=phys)
    with pytest.raises(ValueError, match="mixed devices"):
        ss.stream_steps(S, utc0.to("meta"), 2, 300.0, tg, fc)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.stream_steps(S.to("meta"), utc0, 2, 300.0, tg, fc)


def _runs(steps, **cfg):
    """(port, JAX) run_model outputs for the same 16x128x3 run."""
    args = ARGS + (steps,)
    port = driver.run_model(*args, config=ModelConfig(**cfg), device="cpu")
    ref = jdriver.run_model(*args, config=JModelConfig(**cfg))
    return port, ref


@pytest.mark.parametrize("physics", [None, "radiation", "all"])
def test_run_model_stream_matches_jax_stream(physics):
    """7 steps at stream_steps=4: one call of 4, the even remainder of 2
    and the odd tail on the per-step path."""
    cfg = dict(backend="stream", stream_steps=4, dtype="float64")
    if physics:
        cfg.update(physics=True, physics_every=1, drag_tau=86400.0,
                   convection=physics == "all", seasonal=physics == "all")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        port, ref = _runs(7, **cfg)
    assert_close(port[:5], ref[:5], 1e-10, 1e-10, FIELDS)
    assert_close((port[5].gt,), (ref[5].gt,), 1e-12, 1e-12, ("gt",))
    assert_close(port[7], ref[7], 1e-10, 1e-10, port[7]._fields)
    assert port[7].total_energy.shape == (2,)   # one call + the tail


@pytest.mark.parametrize("physics", [False, True])
def test_guarded_stream_run_matches_jax(physics):
    """make_run_fn with the guard: one stats entry per call, the remainder
    and the tail; the step counter reaches 7; the caller's state is not
    changed."""
    cfg = dict(backend="stream", stream_steps=4, dtype="float64", guard=True,
               height=16, width=128, layers=3, dt=300.0)
    if physics:
        cfg.update(physics=True, drag_tau=86400.0)
    jg = _jgeom().astype(np.float64)
    jstate = jdriver.gen_model_state(jg, JModelConfig(**cfg))
    state = port_state(jstate)
    jout = jdriver.make_run_fn(jg, JModelConfig(**cfg), 7)(jstate)
    before = [x.clone() for x in state.prog]
    run = driver.make_run_fn(port_geom(jg), ModelConfig(**cfg), 7)
    out = run(state)
    assert run.chunk_steps == 4
    assert bool(out[2].ok) and bool(jout[2].ok)
    assert int(out[2].blown_step) == int(jout[2].blown_step) == -1
    assert int(out[0].step) == 7 and float(out[0].utc) == 2100.0
    assert_close(out[0].prog, jout[0].prog, 1e-10, 1e-10, FIELDS)
    assert_close((out[0].ground.gt,), (jout[0].ground.gt,), 1e-12, 1e-12,
                 ("gt",))
    assert_close(out[1], jout[1], 1e-10, 1e-10, out[1]._fields)
    assert out[1].total_energy.shape == (3,)
    for a, b in zip(state.prog, before):
        assert torch.equal(a, b)


def test_stream_between_call_extras_match_jax():
    """Drag without the radiation cannot run inside the kernel: the
    extras run between calls at physics_every=4 (K clamps to a divisor)."""
    cfg = dict(backend="stream", stream_steps=6, dtype="float64",
               drag_tau=3600.0, physics_every=4)
    port, ref = _runs(8, **cfg)
    assert_close(port[:5], ref[:5], 1e-10, 1e-10, FIELDS)
    assert port[7].total_energy.shape == np.asarray(ref[7].total_energy).shape


def test_physics_every_one_promotes_to_two_as_in_jax():
    """physics_every=1 with extras that cannot run inside the kernel (drag
    alone) promotes to 2 with the JAX package's warning; grey physics at
    physics_every=1 runs inside the kernel with no warning."""
    cfg = dict(backend="stream", dtype="float64", drag_tau=3600.0)
    with pytest.warns(UserWarning, match="promotes to 2"):
        port = driver.run_model(*ARGS, 4, config=ModelConfig(**cfg),
                                device="cpu")
    with pytest.warns(UserWarning, match="promotes to 2"):
        ref = jdriver.run_model(*ARGS, 4, config=JModelConfig(**cfg))
    assert_close(port[:5], ref[:5], 1e-10, 1e-10, FIELDS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        driver.run_model(*ARGS, 4, device="cpu", config=ModelConfig(
            backend="stream", dtype="float64", physics=True))
    assert not any("promotes to 2" in str(w.message) for w in caught)


def test_odd_cadence_raises_as_in_jax():
    cfg = dict(backend="stream", physics=True, physics_every=3, dt=300.0,
               height=16, width=128, layers=3)
    jg = _jgeom()
    with pytest.raises(ValueError, match="must be even"):
        jdriver.make_run_fn(jg, JModelConfig(**cfg), 8)
    with pytest.raises(ValueError, match="must be even"):
        driver.make_run_fn(port_geom(jg), ModelConfig(**cfg), 8)


def test_per_step_callers_of_stream_get_mega4_with_a_warning():
    cfg = ModelConfig(backend="stream", dt=300.0)
    with pytest.warns(RuntimeWarning, match="mega4"):
        step = driver.make_dynamics_step(port_geom(_jgeom()), cfg, None)
    assert isinstance(step, ms.MegaStep)


def test_one_step_runs_on_mega4():
    port = driver.run_model(*ARGS, 1, device="cpu", config=ModelConfig(
        backend="stream", dtype="float64", physics=True))
    ref = driver.run_model(*ARGS, 1, device="cpu", config=ModelConfig(
        backend="mega4", dtype="float64", physics=True))
    for a, b in zip(port[:5], ref[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,K", [(8, 4), (7, 4), (11, 4), (6, 6), (9, 2)])
def test_blown_chunk_len_matches_jax(n, K):
    for blown in range(n):
        assert (driver._blown_chunk_len(blown, n, K)
                == jdriver._blown_chunk_len(blown, n, K))


def test_blown_step_localization_names_jax_step():
    """The guard trips inside a 4-step call; run_model replays the call
    step by step on 'mega4' and names the exact step, as JAX's does
    (tests/test_stream.py:227, whose threshold recipe this reuses)."""
    jg = _jgeom()
    jstate = jdriver.gen_model_state(jg.astype(np.float64),
                                     JModelConfig(dtype="float64"))
    state = port_state(jstate)
    step = driver.make_dynamics_step(
        port_geom(jg), ModelConfig(dt=1800.0, dtype="float64"), None)
    s, maxima = tuple(state.prog), []
    for _ in range(8):
        s = step(*s)
        maxima.append(float(s[0].max()))
    thr = 0.5 * (maxima[5] + maxima[6])
    cfg = dict(backend="stream", stream_steps=4, dtype="float64",
               stats=False, guard=True, guard_p_max=thr)

    def blown(run, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run(16, 128, 3, 1800.0, 8, **kw)
        msg = [str(w.message) for w in caught if "blew up" in str(w.message)]
        return int(re.search(r"at step (\d+)", msg[0]).group(1)), msg[0]

    port = blown(driver.run_model, config=ModelConfig(**cfg), device="cpu")
    ref = blown(jdriver.run_model, config=JModelConfig(**cfg))
    assert port[0] == ref[0] == 6
    assert "exact" in port[1]


def test_state_from_jax_carries_ground_clock_and_step():
    jg = _jgeom()
    jstate = jdriver.gen_model_state(jg.astype(np.float64), JModelConfig(
        dtype="float64"))
    jstate = jstate._replace(utc=jnp.asarray(4500.0), step=jnp.asarray(
        15, jnp.int32))
    state = port_state(jstate)
    d = state_dict(jstate)
    for name in ("gt", "gw", "snow", "ice"):
        np.testing.assert_array_equal(getattr(state.ground, name).numpy(),
                                      d[name])
    assert float(state.utc) == 4500.0 and int(state.step) == 15
    assert state.step.dtype == torch.int32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,physics,k", [
    (torch.float64, None, 2), (torch.float64, "all", 4),
    (torch.float32, "all", 4), (torch.float32, "radiation", 2)])
def test_kernel_matches_plain_version_on_gpu(cuda_device, dtype, physics, k):
    L, H, W = 3, 24, 36
    jg = jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)
    geom = port_geom(jg).to(dtype=dtype, device=cuda_device)
    phys = _physics_pair(jg, geom, physics)[1] if physics else None
    packed = torch.as_tensor(_packed(jg, 3, physics is not None)).to(
        dtype=dtype, device=cuda_device)
    S = torch.stack([packed, torch.zeros_like(packed)])
    utc0 = torch.tensor(7200.0, dtype=dtype, device=cuda_device)
    step = ss.StreamSteps(geom, 300.0, physics=phys)
    before = ss.stream_steps.launches
    out = step(S.clone(), utc0, k)
    torch.cuda.synchronize()
    assert ss.stream_steps.launches == before + 1
    ref = ss.stream_steps_ref(S.clone(), utc0, k, 300.0, geom, step.consts,
                              physics=phys)
    bound = 1e-11 if dtype == torch.float64 else 1e-4
    for n in range(out.shape[1]):
        a, b = out[0, n], ref[0, n]
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        assert err <= bound, (n, err)


@pytest.mark.gpu
def test_run_model_stream_on_gpu_launches_k7_once_per_call(cuda_device):
    """On a grid inside the JAX package's streaming envelope (with the
    physics on, 'stream' runs per-step 'mega4' outside it)."""
    cfg = ModelConfig(backend="stream", stream_steps=4, dtype="float64",
                      physics=True, drag_tau=86400.0)
    before = (ss.stream_steps.launches, ms.mega_step.launches)
    out = driver.run_model(*ARGS, 7, device=cuda_device, config=cfg)
    torch.cuda.synchronize()
    # one call of 4, the remainder of 2, the odd tail on K6
    assert ss.stream_steps.launches == before[0] + 2
    assert ms.mega_step.launches == before[1] + 1
    ref = driver.run_model(*ARGS, 7, device="cpu", config=cfg)
    assert_close(out[:5], [x.numpy() for x in ref[:5]], 1e-11, 1e-11, FIELDS)
    assert_close((out[5].gt,), (ref[5].gt.numpy(),), 1e-11, 1e-11, ("gt",))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-6)])
@pytest.mark.parametrize("physics", ["radiation", "all", "drag"])
def test_column_physics_matches_plain_version_on_gpu(cuda_device, dtype,
                                                     bound, physics):
    """The epilogue alone against physics_epilogue_ref: the same
    operations in the same order, only pow/log/sin/cos ulps apart.  The
    plain version moves t (and u with the drag) by ten times the bound or
    more, so a skipped or mis-scaled term cannot pass."""
    L, H, W = 3, 24, 36
    jg = jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)
    args = list(_epilogue_args(jg, port_geom(jg), physics, seed=5))
    args[:6] = [x.to(dtype=dtype, device=cuda_device) for x in args[:6]]
    args[6] = args[6].to(dtype=dtype, device=cuda_device)
    before = ss.column_physics.launches
    out = ss.column_physics(*args)
    torch.cuda.synchronize()
    assert ss.column_physics.launches == before + 1
    ref = ss.physics_epilogue_ref(*args)
    for name, a, b in zip(("u", "v", "t", "gt"), out, ref):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= bound, (name, err)
    moved = {"t": (ref[2], args[3])}
    if args[8].drag_tau:
        moved["u"] = (ref[0], args[1])
    for name, (b, x) in moved.items():
        move = float((b - x).abs().max() / x.abs().max())
        assert move >= 10 * bound, (name, move)
