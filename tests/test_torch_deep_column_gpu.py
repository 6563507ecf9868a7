"""PyTorch port on the card: the column kernels at 40 layers and at
kMaxLayers, in the forms their C entries launch there (csrc/gcm_limits.cuh:
at 40 layers the pgf tile and the convection hold the column in shared
memory, the rest tile and the epilogue launch their deep forms; at 64 all
launch their deep forms but the float32 convection), against their plain
versions (tests/test_torch_deep_column.py holds the plain versions
to the JAX package on the CPU; this file imports no JAX).  At 40 layers
(GISS ModelE2.1's) and at kMaxLayers, float32 and float64: the pgf tile
(K3), the rest tile (K4) and K1 to the bit; the epilogue within the
bounds of its 3-layer tests (the card's pow, log, sin and cos); the
adaptive convection to the bit; K7 with its epilogue; and every backend
through ``make_run_fn`` against 'xla'.  Each skips without a card.
"""

import numpy as np
import pytest
import torch

from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import BACKENDS, ModelConfig
from gcmiipy_tpu_torch.model.state import random_prognostics
from gcmiipy_tpu_torch.ops import convection as cv
from gcmiipy_tpu_torch.ops import fused_parts as fp
from gcmiipy_tpu_torch.ops import pgf_rest as pr
from gcmiipy_tpu_torch.ops import polar_filter
from gcmiipy_tpu_torch.ops import stream_steps as ss
from gcmiipy_tpu_torch.physics import convection

DT = 300.0
DEEP = [(40, 24, 36), (64, 19, 45)]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _geom(shape, device, dtype, ptop=0.0):
    L, H, W = shape
    return geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 ptop=ptop, dtype=dtype, device=device)


def _equal(out, ref):
    for a, b in zip(out, ref):
        assert torch.equal(a, b), float((a - b).abs().max()
                                        / b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DEEP)
def test_deep_tiles_equal_plain_versions_on_gpu(cuda_device, shape, dtype):
    """K3 (the pgf tile), K4 (the rest tile) and K1 (its column pass and
    its tiled launch) at 40 and 64 layers, with Coriolis and the q
    limiter, each launched once and equal to its plain version."""
    geom = _geom(shape, cuda_device, dtype)
    base = random_prognostics(geom, 0)
    seval = random_prognostics(geom, 1)
    sp, su, st = seval[0], seval[1], seval[3]
    flags = dict(coriolis=True, q_limiter=True)
    before = pr.pgf_tile.launches
    out = pr.pgf_parts(sp, su, st, geom)
    torch.cuda.synchronize()
    assert pr.pgf_tile.launches == before + 1
    _equal(out, pr.pgf_parts_ref(sp, su, st, geom))
    stack, pg_phiv = out
    filt = polar_filter.arakawa_1977(stack, geom)
    args = (*base, *seval, filt, pg_phiv, DT, geom)
    before = pr.rest_stencil.launches
    out = pr.rest_parts(*args, **flags)
    torch.cuda.synchronize()
    assert pr.rest_stencil.launches == before + 1
    _equal(out, pr.rest_parts_ref(*args, **flags))
    spu = polar_filter.arakawa_1977(core25d.calc_pu(sp, su), geom)
    args = (*base, *seval, spu, DT, geom)
    before = fp.parts_stencil.launches
    out = fp.fused_parts(*args, **flags)
    torch.cuda.synchronize()
    assert fp.parts_stencil.launches == before + 1
    _equal(out, fp.fused_parts_ref(*args, **flags))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-6)])
@pytest.mark.parametrize("L", [40, 64])
def test_deep_epilogue_matches_plain_version_on_gpu(cuda_device, L, dtype,
                                                    bound):
    """The epilogue's deep form (three arrays of L a thread: at kMaxLayers
    and float64 the largest block) with the sweeps, the drag and the
    seasonal clock, against physics_epilogue_ref."""
    geom = _geom((L, 24, 36), cuda_device, dtype, ptop=10.0)
    p, u, v, t, _ = random_prognostics(geom, 5)
    rng = np.random.default_rng(55)
    gt = torch.as_tensor(290.0 + 20.0 * rng.random((24, 36))).to(
        device=cuda_device, dtype=dtype)
    ph = ss.make_physics(geom, drag_tau=86400.0, convection=True,
                         seasonal=True)
    args = (p, u, v, t, gt, torch.tensor(3.1e4, dtype=dtype,
                                         device=cuda_device), geom, DT, ph)
    before = ss.column_physics.launches
    out = ss.column_physics(*args)
    torch.cuda.synchronize()
    assert ss.column_physics.launches == before + 1
    ref = ss.physics_epilogue_ref(*args)
    for name, a, b in zip(("u", "v", "t", "gt"), out, ref):
        assert float((a - b).abs().max() / b.abs().max()) <= bound, name
    assert float((ref[2] - t).abs().max() / t.abs().max()) >= 10 * bound


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [40, 64])
def test_deep_convection_equals_plain_loop_on_gpu(cuda_device, L, dtype,
                                                  monkeypatch):
    """The adaptive convection at 40 and 64 layers (its deep form at 64 in
    float64) against its plain loop on the card, to the bit."""
    geom = _geom((L, 24, 36), "cpu", torch.float64)
    rng = np.random.default_rng(3)
    p = torch.as_tensor(1e5 * (1 + 0.01 * rng.standard_normal((24, 36))))
    tt = torch.full((L, 24, 36), 250.0, dtype=torch.float64)
    tt[:3] += torch.tensor([40.0, 20.0, 8.0]).reshape(3, 1, 1)
    tt[:3] += torch.as_tensor(rng.standard_normal((3, 24, 36)))
    tp = p * geom.sig.reshape(L, 1, 1) + geom.ptop
    dp = p * geom.dsig.reshape(L, 1, 1)
    tt, tp, dp = (x.to(device=cuda_device, dtype=dtype)
                  for x in (tt, tp, dp))
    before = cv.column_adjustment.launches
    out = convection.convective_adjustment(tt, tp, dp)
    assert cv.column_adjustment.launches == before + 1
    monkeypatch.setattr(cv, "on_card", lambda tt: False)
    ref = convection.convective_adjustment(tt, tp, dp)
    assert torch.equal(out, ref)
    assert not torch.equal(out, tt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_deep_stream_call_matches_plain_version_on_gpu(cuda_device, dtype):
    """K7 with its epilogue at 40 layers (every stage in its deep form),
    one call of 4 steps, against stream_steps_ref."""
    geom = _geom((40, 24, 36), cuda_device, dtype, ptop=10.0)
    rng = np.random.default_rng(60)
    gt = torch.as_tensor(290.0 + 20.0 * rng.random((24, 36))).to(
        device=cuda_device, dtype=dtype)
    packed = ss.pack_state(*random_prognostics(geom, 60), gt=gt)
    S = torch.stack([packed, torch.zeros_like(packed)])
    ph = ss.make_physics(geom, drag_tau=86400.0, convection=True)
    utc0 = torch.tensor(7200.0, dtype=dtype, device=cuda_device)
    step = ss.StreamSteps(geom, DT, physics=ph)
    out = step(S.clone(), utc0, 4)
    torch.cuda.synchronize()
    ref = ss.stream_steps_ref(S.clone(), utc0, 4, DT, geom, step.consts,
                              physics=ph)
    bound = 1e-11 if dtype == torch.float64 else 1e-4
    for n in range(out.shape[1]):
        a, b = out[0, n], ref[0, n]
        err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        assert err <= bound, (n, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [("float64", 1e-9),
                                         ("float32", 2e-3)])
def test_every_backend_runs_40_layers_on_gpu(cuda_device, dtype, bound):
    """Every backend through make_run_fn at 40 layers under the 10 Pa top
    with the per-step physics (20 steps on 64x128), guard clean and held
    to 'xla' at its type (chip_smoke.py's phase deep at a smaller grid)."""
    outs = {}
    for backend in BACKENDS:
        cfg = ModelConfig(height=64, width=128, layers=40, ptop=10.0,
                          dt=30.0, backend=backend, dtype=dtype, guard=True,
                          stream_steps=20, physics=True, physics_every=1,
                          convection=True, drag_tau=86400.0)
        geom = driver.gen_model_geometry(cfg, cuda_device)
        state = driver.gen_model_state(geom, cfg)
        lat, lon = geom.lat.reshape(-1, 1), geom.long.reshape(1, -1)
        prog = state.prog
        state = state._replace(prog=prog._replace(
            u=prog.u + torch.cos(lat) * torch.cos(2 * lon),
            v=prog.v + torch.cos(lat) * torch.sin(3 * lon),
            t=prog.t + 0.5 * torch.sin(lon + 2 * lat)))
        st, _, guard = driver.make_run_fn(geom, cfg, 20)(state)
        torch.cuda.synchronize()
        assert bool(guard.ok), backend
        outs[backend] = list(st.prog) + [st.ground.gt]
    for backend, out in outs.items():
        for a, b in zip(out, outs["xla"]):
            assert float((a - b).abs().max() / b.abs().max()) <= bound, \
                backend
