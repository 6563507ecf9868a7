"""PyTorch port: K6 (``ops/mega_step.py``) and the 'mega4' backend.

On the CPU the wrapper runs its plain version, which is held against the
JAX package's v4 whole-step kernel (``pallas_stencil.make_mega_step_kernel``)
in interpret mode, as tests/test_pallas_fused.py runs it, at float64: 2 steps
at 1e-9 (the bound of tests/test_pallas_fused.py for the same kernel; the
DFT filter's summation order differs).  The CUDA kernel itself is held
against the plain version by the ``gpu`` test (skipped without a card) and
by chip_smoke.py.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.dynamics import core25d as jcore
from gcmiipy_tpu.dynamics import fused as jfused
from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.ops import pallas_stencil as ps
from gcmiipy_tpu_torch.dynamics import core25d, fused
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.ops import mega_step as ms
from gcmiipy_tpu_torch.ops.fft_filter import fft_filter_ref
from gcmiipy_tpu_torch.ops import polar_filter

from torch_port_helpers import (
    BANDED_REL64, FIELDS, as_jax, as_torch, assert_close, port_geom,
    random_state)

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _jgeom(L, H, W, hill=False):
    hm = None
    if hill:  # tests/test_pallas_fused.py:46-60
        hm = np.zeros((H, W))
        hm[4:8, 10:40] = 1500.0
    return jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig,
                                  heightmap=hm)


def _jax_v4_steps(jg, state, steps, **kw):
    """The JAX v4 kernel in interpret mode on rows-padded fields."""
    step = jfused.make_fused_matsuno_padded_v4(
        jg, 300.0, dtype=jnp.float64, interpret=True, **kw)
    s = tuple(ps.pad_rows(x) for x in as_jax(state))
    for _ in range(steps):
        s = step(*s)
    return tuple(ps.core_rows(x) for x in s)


@pytest.mark.parametrize("grid,kw,hill", [
    ((3, 16, 128), {}, False),
    ((3, 16, 128), {"coriolis": True}, True),
    ((3, 16, 128), {"q_limiter": True}, False),
    ((2, 128, 384), {}, False),     # rows with 1 and 2 chunks
    ((3, 24, 36), {}, False),       # rows with 0 and 1 chunk
])
def test_mega_step_ref_matches_jax_v4_interpret(grid, kw, hill):
    jg = _jgeom(*grid, hill=hill)
    tg = port_geom(jg)
    s = random_state(jg, seed=12)
    ref = _jax_v4_steps(jg, s, 2, **kw)
    step = ms.MegaStep(tg, 300.0, **kw)
    out = as_torch(s)
    for _ in range(2):
        out = step(*out)
    assert_close(out, ref, 1e-9, 1e-9, FIELDS)
    assert torch.all(out[2][:, -1, :] == 0)  # polar wall


def test_trip_counts_cover_both_multichunk_and_zero_rows():
    """The grids above reach the cases they are there for."""
    for (H, W), want in (((128, 384), [0, 58, 70]), ((24, 36), [12, 12]),
                         ((16, 384), [0, 0, 16])):
        mask = port_geom(jgeometry.gen_geometry(H, W, 2)).polar_mask
        assert np.bincount(polar_filter.band_chunk_counts(mask)).tolist() == want


def test_per_row_trip_counts_equal_all_chunks():
    jg = _jgeom(2, 128, 384)
    tg = port_geom(jg)
    s = as_torch(random_state(jg, seed=14))
    a = b = s
    fc = ms.build_filter_consts(tg)
    assert int(ms.build_banded_consts(tg).counts.min()) == 1
    assert int(ms.build_banded_consts(tg, band_limit=False).counts.min()) == 2
    banded, every = ms.banded_round(tg), ms.banded_round(tg, band_limit=False)
    for _ in range(2):
        a = ms.mega_step_ref(*a, 300.0, tg, fc, filter_ref=banded)
        b = ms.mega_step_ref(*b, 300.0, tg, fc, filter_ref=every)
    assert_close(a, [x.numpy() for x in b], 1e-12, 1e-12, FIELDS)


def test_random_prognostics_is_the_tests_recipe():
    """The port's random start (chip_smoke.py, filter_accuracy) is the
    state these tests hand to both packages."""
    from gcmiipy_tpu_torch.model.state import random_prognostics
    jg = _jgeom(3, 24, 36)
    out = random_prognostics(port_geom(jg), 7)
    for a, b in zip(out, random_state(jg, seed=7)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_mega_step_on_cpu_runs_the_plain_version():
    jg = _jgeom(3, 16, 128, hill=True)
    tg = port_geom(jg)
    s = as_torch(random_state(jg, seed=4))
    step = ms.MegaStep(tg, 300.0, coriolis=True, q_limiter=True)
    before = ms.mega_step.launches
    out = step(*s)
    ref = ms.mega_step_ref(*s, 300.0, tg, step.consts, coriolis=True,
                           q_limiter=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert ms.mega_step.launches == before  # no kernel launched on the CPU


def test_mega_step_refuses_other_devices():
    jg = _jgeom(3, 16, 128)
    step = ms.MegaStep(port_geom(jg), 300.0)
    s = list(as_torch(random_state(jg)))
    with pytest.raises(ValueError, match="mixed devices"):
        step(*s[:-1], s[-1].to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        step(*[x.to("meta") for x in s])


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity",
                                   "geom_dtype", "factor_dtype", "rows"])
def test_mega_step_checks_its_arguments(fault):
    jg = _jgeom(3, 16, 128)
    geom = port_geom(jg)
    fc = ms.build_filter_consts(geom)
    args = list(as_torch(random_state(jg)))
    if fault == "dtype":
        args = [x.to(torch.float16) for x in args]
    elif fault == "shape":
        args[3] = args[3][:, :8]
    elif fault == "contiguity":
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "geom_dtype":
        geom = geom.to(dtype=torch.float32)
    elif fault == "factor_dtype":
        fc = fc._replace(twiddle=fc.twiddle.float())
    else:
        fc = fc._replace(lats=fc.lats.long())
    with pytest.raises((TypeError, ValueError)):
        ms._check(args, geom, fc)


def test_mega_step_checks_accept_valid_arguments():
    jg = _jgeom(3, 16, 128)
    geom = port_geom(jg)
    ms._check(as_torch(random_state(jg)), geom, ms.build_filter_consts(geom))


def test_run_model_mega4_matches_jax_and_xla_dft():
    args = (16, 128, 3, 900.0, 3)
    cfg = dict(backend="mega4", dtype="float64")
    port = driver.run_model(*args, config=ModelConfig(**cfg), device="cpu")
    ref = jdriver.run_model(*args, config=JModelConfig(**cfg))
    assert_close(port[:5], ref[:5], 1e-9, 1e-9, FIELDS)
    assert_close(port[7], ref[7], 1e-9, 1e-9, port[7]._fields)
    dft = driver.run_model(*args, config=ModelConfig(
        backend="xla", polar_filter="dft", dtype="float64"), device="cpu")
    assert_close(port[:5], [x.numpy() for x in dft[:5]], 1e-9, 1e-9, FIELDS)


def test_mega4_off_the_jax_tiles_matches_the_jax_core():
    """JAX's 'mega4' takes its XLA core on 24x36 (not 8 | H and 128 | W);
    the port runs K6 there, held against that core."""
    jg = jgeometry.gen_geometry(24, 36, 9)
    tg = port_geom(jg)
    s = random_state(jg, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = fused.make_fused_step(tg, 300.0, pipeline="mega4")
    out = as_torch(s)
    ref = as_jax(s)
    for _ in range(2):
        out = step(*out)
        ref = jcore.matsuno_timestep(*ref, 300.0, jg)
    assert_close(out, ref, 1e-9, 1e-9, FIELDS)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_filter_precisions_run_at_full_precision(precision):
    args = (8, 8, 3, 900.0, 2)
    port = driver.run_model(*args, device="cpu", config=ModelConfig(
        backend="mega4", dtype="float64", filter_precision=precision,
        filter_split_tau=0.5))
    ref = driver.run_model(*args, device="cpu", config=ModelConfig(
        backend="mega4", dtype="float64"))
    for a, b in zip(port[:5], ref[:5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["fwd_high", "default"])
def test_bf16_filter_precisions_are_not_ported(precision):
    with pytest.raises(NotImplementedError, match="filter_precision"):
        driver.run_model(8, 8, 3, 900.0, 1, device="cpu", config=ModelConfig(
            backend="mega4", filter_precision=precision))


def test_stream_backend_still_raises():
    """'stream' with its TPU scheduling switch, stream_pipeline, runs K7
    unchanged: equal to the bit to the run without it (one step, which
    takes the per-step 'mega4' path, and 4 steps, one K7 call).  The
    backend still raises where JAX's does: on an odd Shapiro cadence."""
    for steps in (1, 4):
        runs = [driver.run_model(16, 128, 3, 300.0, steps, device="cpu",
                                 config=ModelConfig(
                                     backend="stream", dtype="float64",
                                     stream_pipeline=pipeline))
                for pipeline in (True, False)]
        for a, b in zip(runs[0][:5], runs[1][:5]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="must be even"):
        driver.run_model(16, 128, 3, 300.0, 4, device="cpu",
                         config=ModelConfig(backend="stream",
                                            stream_pipeline=True,
                                            shapiro_every=3))


def test_float64_sums_filter_float32_fields_to_their_rounding():
    """The float32 filter of K6 and its plain version sums in float64: on
    the polar rows, where the correction cancels nearly all of pg_phi,
    float32 sums are far off while float64 sums leave the final rounding."""
    from gcmiipy_tpu_torch import filter_accuracy
    out = filter_accuracy.measure(64, 256, 3, 2, torch.device("cpu"))
    for name in ("spu_raw", "pg_phi"):
        assert out["filter"]["dft float64 sums"][name] < 2e-7, name
    assert out["filter"]["dft float32 sums"]["pg_phi"] > 1e-5
    for name, err in out["mega_step float32 vs float64"].items():
        assert err < 1e-4, name


@pytest.mark.gpu
@pytest.mark.parametrize("grid,coriolis,q_limiter", [
    ((3, 24, 36), False, False), ((3, 24, 36), True, True),
    ((2, 16, 37), True, False),     # odd width
    ((2, 8, 2048), False, True),    # wider than the TPU kernel's 1024
])
def test_kernel_matches_plain_version_on_gpu(cuda_device, grid, coriolis,
                                             q_limiter):
    L, H, W = grid
    jg = jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)
    geom = port_geom(jg).to(device=cuda_device)
    s = [x.to(cuda_device) for x in as_torch(random_state(jg, seed=3))]
    step = ms.MegaStep(geom, 300.0, coriolis=coriolis, q_limiter=q_limiter)
    before = ms.mega_step.launches
    out = step(*s)
    torch.cuda.synchronize()
    assert ms.mega_step.launches == before + 1
    # the plain version with the kernel's FFT plan, and with the banded DFT
    # (None), whose own float64 rounding on the polar rows reaches 5e-11 of
    # u's scale at width 2048 (tests/test_torch_fft_filter.py)
    fc = step.consts
    for filter_ref, bound in ((lambda X: fft_filter_ref(X, fc), 1e-11),
                              (None, 1e-11 if W <= 1024 else BANDED_REL64)):
        ref = ms.mega_step_ref(*s, 300.0, geom, fc, coriolis=coriolis,
                               q_limiter=q_limiter, filter_ref=filter_ref)
        for name, a, b in zip(FIELDS, out, ref):
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= bound, (name, err)
    ref_core = core25d.matsuno_timestep(*s, 300.0, geom, coriolis=coriolis,
                                        q_limiter=q_limiter)
    for name, a, b in zip(FIELDS, out, ref_core):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-9, name


@pytest.mark.gpu
def test_run_model_mega4_on_gpu_launches_k6_every_step(cuda_device):
    before = ms.mega_step.launches
    out = driver.run_model(24, 36, 3, 300.0, 3, device=cuda_device,
                           config=ModelConfig(backend="mega4",
                                              dtype="float64"))
    torch.cuda.synchronize()
    assert ms.mega_step.launches == before + 3
    ref = driver.run_model(24, 36, 3, 300.0, 3, device="cpu",
                           config=ModelConfig(backend="mega4",
                                              dtype="float64"))
    assert_close(out[:5], [x.numpy() for x in ref[:5]], 1e-11, 1e-11, FIELDS)
