"""PyTorch port: K5 (``ops/mega_half.py``) and the 'mega' backend.

On the CPU the wrapper runs its plain version, which is held against the
JAX package's v3 half-step kernel (``pallas_stencil.make_mega_kernel_padded``)
in interpret mode, as tests/test_pallas_fused.py runs it, at float64: one
half, and 2 steps of ``make_fused_step(pipeline='mega')`` against JAX's
``make_fused_matsuno_padded_v3`` at 1e-9 (the bound of
tests/test_pallas_fused.py for the same kernel; the DFT filter sums in
another order).  K5 holds K6's banded filter, which equals the JAX
kernel's unbanded one to the bit (a chunk beyond a row's band adds exact
zeros), so 'mega' equals 'mega4' to the bit.  The CUDA kernel itself is held
against the plain version by the ``gpu`` tests (skipped without a card) and
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
from gcmiipy_tpu.ops import polar_filter as jpolar
from gcmiipy_tpu_torch import step_profile
from gcmiipy_tpu_torch.dynamics import fused
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import BACKENDS, ModelConfig
from gcmiipy_tpu_torch.ops import mega_half as mh
from gcmiipy_tpu_torch.ops.fft_filter import fft_filter, fft_filter_ref
from gcmiipy_tpu_torch.ops import mega_step as ms
from gcmiipy_tpu_torch.ops import polar_filter

from torch_port_helpers import (
    BANDED_REL64, FIELDS, as_jax, as_torch, assert_close, port_geom,
    random_state)

torch.set_num_threads(1)

DT = 300.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _jgeom(L=3, H=16, W=128, hill=False):
    hm = None
    if hill:  # tests/test_pallas_fused.py:46-60
        hm = np.zeros((H, W))
        hm[4:8, 10:40] = 1500.0
    return jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig,
                                  heightmap=hm)


def _jax_half(jg, base, seval, **kw):
    """One JAX v3 half in interpret mode, the wall applied as its caller
    (make_fused_matsuno_padded_v3) applies it."""
    half = ps.make_mega_kernel_padded(jg, DT, dtype=jnp.float64,
                                      interpret=True, **kw)
    out = half(tuple(ps.pad_rows(x) for x in as_jax(base)),
               tuple(ps.pad_rows(x) for x in as_jax(seval)))
    out = [np.array(ps.core_rows(x)) for x in out]
    out[2][:, -1, :] = 0.0
    return out


@pytest.mark.parametrize("kw,hill,same", [
    ({}, False, True), ({}, False, False),
    ({"coriolis": True}, True, False), ({"q_limiter": True}, False, False)])
def test_mega_half_ref_matches_jax_v3_half_interpret(kw, hill, same):
    """The predictor's half (base = seval) and a corrector's."""
    jg = _jgeom(hill=hill)
    base = random_state(jg, seed=41)
    seval = base if same else random_state(jg, seed=42)
    ref = _jax_half(jg, base, seval, **kw)
    half = mh.MegaHalf(port_geom(jg), DT, **kw)
    out = half(as_torch(base), as_torch(seval))
    assert_close(out, ref, 1e-9, 1e-9, FIELDS)
    assert torch.all(out[2][:, -1, :] == 0)  # polar wall


def _jax_v3_steps(jg, state, steps, **kw):
    step = jfused.make_fused_matsuno_padded_v3(jg, DT, dtype=jnp.float64,
                                               interpret=True, **kw)
    s = tuple(ps.pad_rows(x) for x in as_jax(state))
    for _ in range(steps):
        s = step(*s)
    return tuple(ps.core_rows(x) for x in s)


@pytest.mark.parametrize("kw,hill", [
    ({}, False), ({"coriolis": True}, True), ({"q_limiter": True}, False)])
def test_mega_step_matches_jax_v3_interpret(kw, hill):
    jg = _jgeom(hill=hill)
    s = random_state(jg, seed=43)
    ref = _jax_v3_steps(jg, s, 2, **kw)
    step = fused.make_fused_step(port_geom(jg), DT, pipeline="mega", **kw)
    out = as_torch(s)
    for _ in range(2):
        out = step(*out)
    assert_close(out, ref, 1e-9, 1e-9, FIELDS)


def test_run_model_mega_matches_jax_mega_and_port_mega4():
    args = (16, 128, 3, 900.0, 3)
    cfg = dict(backend="mega", dtype="float64")
    port = driver.run_model(*args, config=ModelConfig(**cfg), device="cpu")
    ref = jdriver.run_model(*args, config=JModelConfig(**cfg))
    assert_close(port[:5], ref[:5], 1e-9, 1e-9, FIELDS)
    assert_close(port[7], ref[7], 1e-9, 1e-9, port[7]._fields)
    mega4 = driver.run_model(*args, config=ModelConfig(
        backend="mega4", dtype="float64"), device="cpu")
    for a, b in zip(port[:5] + tuple(port[7]), mega4[:5] + tuple(mega4[7])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(9, 24, 36), (3, 20, 100)])
def test_mega_off_the_jax_tiles_matches_the_jax_core_with_the_dft(shape):
    """Grids that are not 8 | H and 128 | W, where JAX's 'mega' takes its
    XLA core: the port runs K5 there, held against that core with the
    DFT filter."""
    L, H, W = shape
    jg = jgeometry.gen_geometry(H, W, L)
    mats = jpolar.build_dft_matrices(W, dtype=np.float64)

    def filt(q, g):
        return jpolar.arakawa_1977_dft(q, g, mats, precision="highest")

    s = random_state(jg, seed=44)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step = fused.make_fused_step(port_geom(jg), DT, pipeline="mega")
    out, ref = as_torch(s), as_jax(s)
    for _ in range(2):
        out = step(*out)
        ref = jcore.matsuno_timestep(*ref, DT, jg, filter_fn=filt)
    assert_close(out, ref, 1e-9, 1e-9, FIELDS)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_mega_float32_as_close_as_jax_float32():
    """Float32 against the float64 truth (JAX v3 at float64), held within
    four times JAX's own float32 v3 distance from it (ROADMAP Queue C
    items 2 and 5: the port's filter sums in float64, JAX's float32
    interpret path in float32)."""
    jg = _jgeom()
    s = random_state(jg, seed=45)
    truth = _jax_v3_steps(jg, s, 2)
    jstep = jfused.make_fused_matsuno_padded_v3(jg, DT, dtype=jnp.float32,
                                                interpret=True)
    j32 = tuple(ps.pad_rows(x.astype(jnp.float32)) for x in as_jax(s))
    step = fused.make_fused_step(port_geom(jg).to(dtype=torch.float32), DT,
                                 pipeline="mega")
    out = tuple(x.float() for x in as_torch(s))
    for _ in range(2):
        j32 = jstep(*j32)
        out = step(*out)
    for name, a, b32, b64 in zip(FIELDS, out, j32, truth):
        assert a.dtype == torch.float32
        err = _scaled_err(a, b64)
        jax_err = _scaled_err(ps.core_rows(b32), b64)
        assert err <= 4 * jax_err + 1e-7, (name, err, jax_err)


def test_mega_half_holds_the_unbanded_filter():
    """MegaHalf's plain version runs the banded filter, which gives the
    JAX kernel's unbanded filter (every row over every chunk) to the bit:
    each chunk beyond a row's band has a correction mask of exactly 0, so
    it adds +0.0 after the row's own chunks.  The kernel's constants list
    the damped latitudes, those of some band, and hold no DFT factors."""
    jg = _jgeom(L=2, H=128, W=384)
    tg = port_geom(jg)
    half = mh.MegaHalf(tg, DT, coriolis=True)
    bc = ms.build_banded_consts(tg)
    every = ms.build_banded_consts(tg, band_limit=False)
    nchunks = bc.CS.shape[1] // ms.CHUNK_COLUMNS
    assert nchunks == 2
    assert bool((every.counts == nchunks).all())
    banded = polar_filter.band_chunk_counts(tg.polar_mask)
    assert banded.min() < banded.max() == nchunks
    assert np.array_equal(bc.counts.numpy(), banded)
    assert half.lats.tolist() == np.flatnonzero(banded).tolist()
    assert set(half.consts._fields) == {"mask", "twiddle", "lats", "keep"}
    for j, c in enumerate(banded):
        assert bool((bc.mcc[j, c * ms.CHUNK_COLUMNS:] == 0).all())
    base = as_torch(random_state(jg, seed=49))
    seval = as_torch(random_state(jg, seed=50))
    out = half(base, seval)
    ref = mh.mega_half_ref(base, seval, DT, tg, half.consts, coriolis=True,
                           filter_ref=ms.banded_round(tg, band_limit=False))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_mega_step_is_two_mega_halves_and_mega4_to_the_bit():
    jg = _jgeom(L=2, H=128, W=384)
    tg = port_geom(jg)
    s = as_torch(random_state(jg, seed=46))
    half = mh.MegaHalf(tg, DT, coriolis=True)
    out = half(s, half(s, s))
    step = fused.make_fused_step(tg, DT, coriolis=True, pipeline="mega")
    mega4 = ms.MegaStep(tg, DT, coriolis=True)
    for a, b, c in zip(out, step(*s), mega4(*s)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_mega_with_per_step_physics_equals_mega4():
    """The per-step plain physics extras run after each 'mega' step, as
    after each 'mega4' step."""
    args = (8, 128, 3, 900.0, 3)
    cfg = dict(dtype="float64", physics=True, convection=True,
               drag_tau=86400.0)
    a = driver.run_model(*args, device="cpu",
                         config=ModelConfig(backend="mega", **cfg))
    b = driver.run_model(*args, device="cpu",
                         config=ModelConfig(backend="mega4", **cfg))
    for x, y in zip(a[:5] + (a[5].gt,), b[:5] + (b[5].gt,)):
        assert torch.equal(x, y)
    assert not torch.equal(a[5].gt, driver.run_model(
        *args[:4], 0, device="cpu",
        config=ModelConfig(backend="mega", **cfg))[5].gt)


def test_mega_is_a_backend_and_keeps_the_bf16_modes_out():
    assert "mega" in BACKENDS and "mega" in fused.PIPELINES
    for precision in ("fwd_high", "default"):
        with pytest.raises(NotImplementedError, match="filter_precision"):
            driver.run_model(8, 8, 3, 900.0, 1, device="cpu",
                             config=ModelConfig(backend="mega",
                                                filter_precision=precision))


def test_mega_half_on_cpu_runs_the_plain_version():
    jg = _jgeom(hill=True)
    tg = port_geom(jg)
    base, seval = as_torch(random_state(jg, seed=47)), as_torch(
        random_state(jg, seed=48))
    half = mh.MegaHalf(tg, DT, coriolis=True, q_limiter=True)
    before = mh.mega_half.launches
    filter_before = fft_filter.launches
    out = half(base, seval)
    ref = mh.mega_half_ref(base, seval, DT, tg, half.consts, coriolis=True,
                           q_limiter=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert mh.mega_half.launches == before  # no kernel launched on the CPU
    assert fft_filter.launches == filter_before


def test_mega_half_refuses_other_devices():
    jg = _jgeom()
    half = mh.MegaHalf(port_geom(jg), DT)
    s = list(as_torch(random_state(jg)))
    with pytest.raises(ValueError, match="mixed devices"):
        half(s, s[:-1] + [s[-1].to("meta")])
    meta = [x.to("meta") for x in s]
    with pytest.raises(ValueError, match="cuda or cpu"):
        mh.mega_half(meta, meta, DT, port_geom(jg), half.consts)


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity",
                                   "seval_dtype", "geom_dtype",
                                   "factor_dtype", "mask_dtype",
                                   "mask_shape", "twiddle_length"])
def test_mega_half_checks_its_arguments(fault):
    jg = _jgeom()
    geom = port_geom(jg)
    fc = ms.build_filter_consts(geom)
    fields = list(as_torch(random_state(jg))) * 2
    if fault == "dtype":
        fields = [x.to(torch.float16) for x in fields]
    elif fault == "shape":
        fields[3] = fields[3][:, :8]
    elif fault == "contiguity":
        fields[6] = fields[6].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "seval_dtype":
        fields[5:] = [x.float() for x in fields[5:]]
    elif fault == "geom_dtype":
        geom = geom.to(dtype=torch.float32)
    elif fault == "factor_dtype":
        fc = fc._replace(twiddle=fc.twiddle.float())
    elif fault == "mask_dtype":
        fc = fc._replace(mask=fc.mask.float())
    elif fault == "mask_shape":
        fc = fc._replace(mask=fc.mask[:, :-1].contiguous())
    else:
        fc = fc._replace(twiddle=fc.twiddle[:-1])
    with pytest.raises((TypeError, ValueError)):
        mh._check_half(fields, geom, fc)


def test_mega_half_checks_accept_valid_arguments():
    jg = _jgeom()
    geom = port_geom(jg)
    mh._check_half(list(as_torch(random_state(jg))) * 2, geom,
                   ms.build_filter_consts(geom))


def test_step_profile_drives_the_mega_step():
    from gcmiipy_tpu_torch.grid import geometry
    geom = geometry.gen_geometry(16, 128, 3, sig_func=geometry.manabe_sig,
                                 dtype=torch.float64, device="cpu")
    config = ModelConfig(backend="mega", dt=DT, dtype="float64")
    before = mh.mega_half.launches
    step_profile._stepper("mega", geom, config, 2)()
    assert mh.mega_half.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("grid,coriolis,q_limiter,dtype,bound,banded", [
    ((3, 24, 36), False, False, torch.float64, 1e-11, 1e-11),
    ((3, 24, 36), True, True, torch.float64, 1e-11, 1e-11),
    ((2, 16, 37), True, False, torch.float64, 1e-11, 1e-11),    # odd width
    # wider than 1024: the banded DFT's own rounding reaches 5e-11
    ((2, 8, 2048), False, True, torch.float64, 1e-11, BANDED_REL64),
    ((3, 64, 256), True, False, torch.float32, 1e-4, 1e-4),
])
def test_kernel_matches_plain_version_on_gpu(cuda_device, grid, coriolis,
                                             q_limiter, dtype, bound,
                                             banded):
    L, H, W = grid
    jg = jgeometry.gen_geometry(H, W, L, sig_func=jgeometry.manabe_sig)
    geom = port_geom(jg).to(dtype=dtype, device=cuda_device)
    base = [x.to(dtype=dtype, device=cuda_device)
            for x in as_torch(random_state(jg, seed=3))]
    seval = [x.to(dtype=dtype, device=cuda_device)
             for x in as_torch(random_state(jg, seed=4))]
    half = mh.MegaHalf(geom, DT, coriolis=coriolis, q_limiter=q_limiter)
    before = (mh.mega_half.launches, fft_filter.launches)
    out = half(base, seval)
    torch.cuda.synchronize()
    assert (mh.mega_half.launches, fft_filter.launches) == (
        before[0] + 1, before[1] + 1)
    # the plain version with the kernel's FFT plan, and with the banded
    # DFT (None), whose own float64 rounding on the polar rows reaches
    # 5e-11 of u's scale at width 2048 (tests/test_torch_fft_filter.py)
    fc = half.consts
    for filter_ref, held in ((lambda X: fft_filter_ref(X, fc), bound),
                             (None, banded)):
        ref = mh.mega_half_ref(base, seval, DT, geom, fc,
                               coriolis=coriolis, q_limiter=q_limiter,
                               filter_ref=filter_ref)
        for name, a, b in zip(FIELDS, out, ref):
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= held, (name, err)
    assert bool((out[2][:, -1] == 0).all())


@pytest.mark.gpu
def test_run_model_mega_on_gpu_launches_k5_twice_a_step(cuda_device):
    before = (mh.mega_half.launches, ms.mega_step.launches,
              fft_filter.launches)
    out = driver.run_model(24, 36, 3, 300.0, 3, device=cuda_device,
                           config=ModelConfig(backend="mega",
                                              dtype="float64"))
    torch.cuda.synchronize()
    assert (mh.mega_half.launches, ms.mega_step.launches,
            fft_filter.launches) == (before[0] + 6, before[1], before[2] + 6)
    ref = driver.run_model(24, 36, 3, 300.0, 3, device="cpu",
                           config=ModelConfig(backend="mega",
                                              dtype="float64"))
    assert_close(out[:5], [x.numpy() for x in ref[:5]], 1e-11, 1e-11, FIELDS)
    mega4 = driver.run_model(24, 36, 3, 300.0, 3, device=cuda_device,
                             config=ModelConfig(backend="mega4",
                                                dtype="float64"))
    for a, b in zip(out[:5], mega4[:5]):
        assert torch.equal(a, b)
