"""PyTorch port: the deep column, GISS ModelE2.1's 40 layers under a 10 Pa
(0.1 hPa) top (gcmbench's gcm2-grey-l40), above the 32 layers up to which
the kernels hold a column whole in shared memory.

On the CPU, at float64: the plain path ('xla') with the per-step grey
physics, the convection and the drag against the JAX package's for 10
steps at the 1e-10 bound of tests/test_parity.py, and against the
benchmark's own reference for 5; K7's plain version (the twin of the pgf
tile, the rest tile and the epilogue) against the JAX package's streaming
kernel in interpret mode; the adaptive convection against JAX's; and every
backend through ``make_run_fn`` against 'xla' at both types, the kernels'
plain versions standing in for them.  The CUDA sources' deep forms run
here through the host emulation (tests/test_torch_host_emulation.py) and
on the card through tests/test_torch_deep_column_gpu.py and
chip_smoke.py's phase deep.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.ops import pallas_stream as jstream
from gcmiipy_tpu.physics import convection as jconvection
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import BACKENDS, ModelConfig
from gcmiipy_tpu_torch.ops import mega_step as ms
from gcmiipy_tpu_torch.ops import stream_steps as ss
from gcmiipy_tpu_torch.ops.fused_parts import MAX_LAYERS
from gcmiipy_tpu_torch.physics import convection

from torch_port_helpers import (
    FIELDS, assert_close, port_geom, random_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gcmbench import bench, members  # noqa: E402
from gcmbench.reference import model as ref_model  # noqa: E402

torch.set_num_threads(1)
L, PTOP = 40, 10.0
# gcm2-grey-l40's physics: grey radiation every step, convection, a
# one-day drag of the lowest layer's winds
PHYSICS = dict(physics=True, physics_every=1, convection=True,
               drag_tau=86400.0)


def test_the_cap_holds_modele3():
    assert MAX_LAYERS >= 62


def test_plain_path_at_40_layers_matches_jax_float64():
    args = (16, 32, L, 300.0, 10)
    cfg = dict(ptop=PTOP, dtype="float64", **PHYSICS)
    port = driver.run_model(*args, config=ModelConfig(**cfg), device="cpu")
    ref = jdriver.run_model(*args, config=JModelConfig(**cfg))
    assert_close(port[:5], ref[:5], 1e-10, 1e-10, FIELDS)
    assert_close(port[5], ref[5], 1e-10, 1e-10, port[5]._fields)
    assert_close(port[7], ref[7], 1e-10, 1e-10, port[7]._fields)
    assert port[7].total_energy.shape == (10,)


def test_plain_path_at_40_layers_matches_the_benchmark_reference():
    """gcm2-grey-l40 on the plain path at float64 (16x32, 5 steps from pool
    member 5) against gcmbench's reference, an independent plain PyTorch
    implementation of the same operations: the same bound as
    gcmbench/tests/test_gcmbench_reference.py's cells, 1e-11 of each
    field's scale and 1e-12 of the energy, float64 rounding in another
    operation order over 5 steps."""
    loaded = bench.load_cell("grey-l40-flagship", ROOT)
    config = dict(loaded["config"])
    config["model"] = dict(config["model"], backend="xla", dtype="float64")
    traffic = dict(loaded["traffic"], height=16, width=32, member_steps=5,
                   interval_steps=5)
    pool = members.Pool(config["perturbation"], L, 16, 32, "cpu")
    program = bench.Program(config, traffic, pool, "cpu")
    state, ok, energy = program.read(program.run(program.start(5)))
    assert ok
    ref = ref_model.Reference(config["model"], 16, 32, traffic["dt"])
    s = bench.perturbed_start(ref, ref.start(False), pool, 5)
    for n in range(5):
        s = ref.step(s, n, n * traffic["dt"])
    assert not ref.bad(s)
    assert bench.field_gap(bench.program_fields(state), s) < 1e-11
    assert abs(energy - float(ref.energy(s))) / abs(float(ref.energy(s))) \
        < 1e-12
    start = ref.start(False)
    assert float((s.gt - start.gt).abs().max()) > 1e-3


def test_stream_twin_at_40_layers_matches_jax_interpret():
    """K7's plain version (the pgf and rest stages, the filter and the
    epilogue with its four sweeps, the drag and the seasonal clock) at 40
    layers under the 10 Pa top against the JAX package's streaming kernel
    in interpret mode: 1e-11 per call, as at 3 layers
    (tests/test_torch_stream.py)."""
    jg = jgeometry.gen_geometry(16, 128, L, sig_func=jgeometry.manabe_sig,
                                ptop=PTOP)
    tg = port_geom(jg)
    planes = list(random_state(jg, 7))
    planes[0] = planes[0][None]
    rng = np.random.default_rng(57)
    planes.append(290.0 + 20.0 * rng.random((1, 16, 128)))
    packed = np.concatenate(planes, axis=0)
    S = np.stack([packed, np.zeros_like(packed)])
    kw = dict(t_lw=0.1, t_sw=0.9, albedo=0.3, drag_tau=86400.0,
              seasonal=True)
    multi = jstream.make_stream_kernel(
        jg, 300.0, 2, dtype=jnp.float64, interpret=True,
        physics=dict(kw, convection_sweeps=4))
    ref = np.asarray(multi(jnp.asarray(S), 3.1e4))
    phys = ss.make_physics(tg, convection=True, **kw)
    out = ss.stream_steps_ref(torch.as_tensor(S.copy()),
                              torch.tensor(3.1e4, dtype=torch.float64), 2,
                              300.0, tg, ms.build_filter_consts(tg),
                              physics=phys)
    got = list(ss.unpack_state(out[0], L)) + [out[0, ss.n_planes(L)]]
    want = list(jstream.unpack_state(ref[0], L)) + [ref[0, ss.n_planes(L)]]
    assert_close(got, want, 1e-11, 1e-11, list(FIELDS) + ["gt"])
    assert not np.allclose(out[0].numpy(), packed)


@pytest.mark.parametrize("adaptive", [True, False])
def test_convection_twin_at_40_layers_matches_jax(adaptive):
    """The adaptive convection's plain loop (the kernel's twin) and the
    epilogue's four fixed sweeps at 40 layers against JAX's, from a warm,
    noisy lower column."""
    jg = jgeometry.gen_geometry(4, 5, L, sig_func=jgeometry.manabe_sig,
                                ptop=PTOP)
    rng = np.random.default_rng(3)
    p = 1e5 * (1 + 0.01 * rng.standard_normal((4, 5)))
    tp = p * np.asarray(jg.sig) + float(jg.ptop)
    dp = p * np.asarray(jg.dsig)
    tt = 250.0 + 0.05 * rng.standard_normal((L, 4, 5))
    tt[:3] += np.array([40.0, 20.0, 8.0])[:, None, None]
    sweeps = None if adaptive else 4
    out = convection.convective_adjustment(
        *(torch.as_tensor(x) for x in (tt, tp, dp)), sweeps=sweeps,
        adaptive=adaptive)
    ref = jconvection.convective_adjustment(
        jnp.asarray(tt), jnp.asarray(tp), jnp.asarray(dp), sweeps=sweeps,
        adaptive=adaptive)
    assert not np.array_equal(out.numpy(), tt)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=0.0)


@pytest.mark.parametrize("dtype,bound", [("float64", 1e-12),
                                         ("float32", 1e-4)])
def test_every_backend_runs_40_layers(dtype, bound):
    """Every backend of BACKENDS through make_run_fn at 40 layers under the
    10 Pa top with the per-step physics (4 steps on 16x128, inside the
    streaming envelope: 'stream' is K7 with its epilogue), from the
    reference's start with smooth winds (a scale of 1 m/s, so that u and v
    are not rounding alone), against 'xla' at the same type: the kernels'
    plain versions run on the CPU, in other operation orders than the
    core's at float32, and the epilogue's four sweeps stand for the
    adaptive convection, which adjusts nothing in this stable column."""
    outs = {}
    for backend in BACKENDS:
        cfg = ModelConfig(height=16, width=128, layers=L, ptop=PTOP, dt=30.0,
                          backend=backend, dtype=dtype, guard=True,
                          stream_steps=4, **PHYSICS)
        geom = driver.gen_model_geometry(cfg, "cpu")
        state = driver.gen_model_state(geom, cfg)
        lat, lon = geom.lat.reshape(-1, 1), geom.long.reshape(1, -1)
        prog = state.prog
        state = state._replace(prog=prog._replace(
            u=prog.u + torch.cos(lat) * torch.cos(2 * lon),
            v=prog.v + torch.cos(lat) * torch.sin(3 * lon),
            t=prog.t + 0.5 * torch.sin(lon + 2 * lat)))
        st, _, guard = driver.make_run_fn(geom, cfg, 4)(state)
        assert bool(guard.ok), backend
        assert st.prog.t.shape == (L, 16, 128)
        outs[backend] = list(st.prog) + [st.ground.gt]
    for backend, out in outs.items():
        for a, b in zip(out, outs["xla"]):
            assert float((a - b).abs().max() / b.abs().max()) <= bound, \
                backend
