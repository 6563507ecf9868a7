"""PyTorch port: K3 and K4 (``ops/pgf_rest.py``) and the v2 Matsuno step.

On the CPU the wrappers run their plain versions, which are held against
the JAX package's pgf and rest kernels (``pallas_stencil.
make_pgf_kernel_padded`` / ``make_rest_kernel_padded``) in interpret mode,
as tests/test_pallas_fused.py runs them, at float64: 1e-12 for each kernel's
function, 1e-11 for two v2 steps (the bound of tests/test_pallas_fused.py
for the same pipeline).  The CUDA kernels themselves are held against the
plain versions by the ``gpu`` tests (skipped without a card) and by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.dynamics import core25d as jcore
from gcmiipy_tpu.dynamics import fused as jfused
from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.ops import pallas_stencil as ps
from gcmiipy_tpu.ops import polar_filter as jpolar
from gcmiipy_tpu_torch import step_profile
from gcmiipy_tpu_torch.dynamics import core25d, fused
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import random_prognostics
from gcmiipy_tpu_torch.ops import mega_step as ms
from gcmiipy_tpu_torch.ops import pgf_rest as pr
from gcmiipy_tpu_torch.ops import polar_filter as tpolar
from gcmiipy_tpu_torch.ops.fft_filter import fft_filter_ref

from torch_port_helpers import (
    FIELDS, as_jax, as_torch, assert_close, port_geom, random_state)

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


def assert_scaled(port, ref, rel, names):
    """Each element within ``rel`` of itself or of its field's scale: the
    forces cancel (pg_phi = pgu + phiu), and an absolute 1e-12 on a field
    of scale 1e4-1e5 would sit below one float64 ulp of it."""
    for name, a, b in zip(names, port, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=rel,
                                   atol=rel * np.abs(b).max(),
                                   err_msg=f"field {name}")


def _jax_k3(jg, seval):
    """The JAX pgf kernel in interpret mode: (stack, pg_phiv) as numpy."""
    pgfk = ps.make_pgf_kernel_padded(jg, dtype=jnp.float64, interpret=True)
    sp, su, _, st, _ = (ps.pad_state(x) for x in as_jax(seval))
    return tuple(np.asarray(x) for x in pgfk(sp, su, st))


def _k4_inputs(jg, seed):
    """base, seval and the filtered stack and pg_phiv of the JAX pgf
    kernel and the JAX FFT filter on seval."""
    base, seval = random_state(jg, seed), random_state(jg, seed + 1)
    stack, pg_phiv = _jax_k3(jg, seval)
    filt = np.asarray(jpolar.arakawa_1977(jnp.asarray(stack), jg))
    return base, seval, filt, pg_phiv


@pytest.mark.parametrize("hill", [False, True])
def test_pgf_parts_ref_matches_jax_k3_interpret(hill):
    jg = _jgeom(hill=hill)
    seval = random_state(jg, seed=21)
    ref = _jax_k3(jg, seval)
    sp, su, _, st, _ = as_torch(seval)
    out = pr.pgf_parts_ref(sp, su, st, port_geom(jg))
    assert tuple(out[0].shape) == (6, 16, 128)
    assert_scaled(out, ref, 1e-12, ("stack", "pg_phiv"))


@pytest.mark.parametrize("coriolis,q_limiter,hill", [
    (False, False, False), (True, False, True), (False, True, False)])
def test_rest_parts_ref_matches_jax_k4_interpret(coriolis, q_limiter, hill):
    jg = _jgeom(hill=hill)
    L = jg.layers
    base, seval, filt, pg_phiv = _k4_inputs(jg, seed=23)
    restk = ps.make_rest_kernel_padded(jg, DT, coriolis=coriolis,
                                       dtype=jnp.float64, interpret=True,
                                       q_limiter=q_limiter)
    pad = lambda xs: tuple(ps.pad_state(x) for x in as_jax(xs))  # noqa: E731
    ref = restk(*pad(base), *pad(seval), ps.pad_state(jnp.asarray(filt[:L])),
                jnp.asarray(filt), jnp.asarray(pg_phiv))
    ref = [np.asarray(ps.core(x)) for x in ref]
    out = pr.rest_parts_ref(*as_torch(base + seval + (filt, pg_phiv)), DT,
                            port_geom(jg), coriolis=coriolis,
                            q_limiter=q_limiter)
    assert_scaled(out, ref, 1e-12, FIELDS)
    # v is not walled: the wall row is the caller's, as in the JAX kernel
    assert float(out[2][:, -1].abs().max()) > 0


def _jax_v2_steps(jg, state, steps, **kw):
    step = jfused.make_fused_matsuno_padded_v2(jg, DT, dtype=jnp.float64,
                                               interpret=True, **kw)
    s = tuple(ps.pad_state(x) for x in as_jax(state))
    for _ in range(steps):
        s = step(*s)
    return tuple(ps.core(x) for x in s)


@pytest.mark.parametrize("kw,hill", [
    ({}, False), ({"coriolis": True}, True), ({"q_limiter": True}, False)])
def test_fused_matsuno_v2_matches_jax_v2_interpret(kw, hill):
    jg = _jgeom(hill=hill)
    s = random_state(jg, seed=25)
    ref = _jax_v2_steps(jg, s, 2, **kw)
    step = fused.make_fused_matsuno_v2(port_geom(jg), DT, **kw)
    out = as_torch(s)
    for _ in range(2):
        out = step(*out)
    assert_close(out, ref, 1e-11, 1e-11, FIELDS)
    assert torch.all(out[2][:, -1, :] == 0)  # polar wall


def test_fused_matsuno_v2_is_the_port_half_timestep_v2():
    """The kernels' plain versions around the filter are the port's
    ``half_timestep_v2``, to the bit."""
    jg = _jgeom(hill=True)
    tg = port_geom(jg)
    s = as_torch(random_state(jg, seed=26))
    out = fused.make_fused_matsuno_v2(tg, DT, coriolis=True)(*s)
    star = core25d.half_timestep_v2(*s, *s, DT, tg, coriolis=True)
    ref = core25d.half_timestep_v2(*s, *star, DT, tg, coriolis=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(9, 24, 36), (3, 20, 100)])
def test_fused_matsuno_v2_off_the_jax_tiles_matches_the_jax_core(shape):
    """Grids that are not 8 | H and 128 | W, where JAX's fused backends take
    the XLA core: the port's v2 step against that core with the FFT filter
    (the v2 half step reassociates the pv force sum: rounding only)."""
    L, H, W = shape
    jg = jgeometry.gen_geometry(H, W, L)
    s = random_state(jg, seed=27)
    step = fused.make_fused_matsuno_v2(port_geom(jg), DT)
    out, ref = as_torch(s), as_jax(s)
    for _ in range(2):
        out = step(*out)
        ref = jcore.matsuno_timestep(*ref, DT, jg)
    assert_close(out, ref, 1e-11, 1e-11, FIELDS)


def _scaled_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_fused_matsuno_v2_float32_as_close_as_jax_float32():
    """Float32 against the float64 truth (JAX v2 at float64), held within
    four times JAX's own float32 v2 distance from it (two independent
    float32 roundings; ROADMAP Queue C item 5)."""
    jg = _jgeom()
    s = random_state(jg, seed=28)
    truth = _jax_v2_steps(jg, s, 2)
    jstep = jfused.make_fused_matsuno_padded_v2(jg, DT, dtype=jnp.float32,
                                                interpret=True)
    j32 = tuple(ps.pad_state(x.astype(jnp.float32)) for x in as_jax(s))
    step = fused.make_fused_matsuno_v2(port_geom(jg).to(dtype=torch.float32),
                                       DT)
    out = tuple(x.float() for x in as_torch(s))
    for _ in range(2):
        j32 = jstep(*j32)
        out = step(*out)
    for name, a, b32, b64 in zip(FIELDS, out, j32, truth):
        assert a.dtype == torch.float32
        err = _scaled_err(a, b64)
        jax_err = _scaled_err(ps.core(b32), b64)
        assert err <= 4 * jax_err + 1e-7, (name, err, jax_err)


def test_pgf_rest_on_cpu_run_the_plain_versions():
    jg = _jgeom(hill=True)
    tg = port_geom(jg)
    base, seval, filt, pg_phiv = (as_torch(x) if isinstance(x, tuple)
                                  else as_torch([x])[0]
                                  for x in _k4_inputs(jg, seed=29))
    before = (pr.pgf_parts.launches, pr.rest_parts.launches)
    sp, su, _, st, _ = seval
    for a, b in zip(pr.pgf_parts(sp, su, st, tg),
                    pr.pgf_parts_ref(sp, su, st, tg)):
        assert torch.equal(a, b)
    args = (*base, *seval, filt, pg_phiv, DT, tg)
    for a, b in zip(pr.rest_parts(*args, coriolis=True, q_limiter=True),
                    pr.rest_parts_ref(*args, coriolis=True, q_limiter=True)):
        assert torch.equal(a, b)
    # no kernel launched on the CPU
    assert (pr.pgf_parts.launches, pr.rest_parts.launches) == before


def test_pgf_rest_refuse_other_devices():
    jg = _jgeom()
    tg = port_geom(jg)
    sp, su, _, st, _ = as_torch(random_state(jg))
    with pytest.raises(ValueError, match="mixed devices"):
        pr.pgf_parts(sp, su, st.to("meta"), tg)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pr.pgf_parts(sp.to("meta"), su.to("meta"), st.to("meta"), tg)
    stack, pg_phiv = pr.pgf_parts_ref(sp, su, st, tg)
    s = as_torch(random_state(jg))
    with pytest.raises(ValueError, match="mixed devices"):
        pr.rest_parts(*s, *s, stack, pg_phiv.to("meta"), DT, tg)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pr.rest_parts(*[x.to("meta") for x in (*s, *s, stack, pg_phiv)],
                      DT, tg)


def _rest_args(jg):
    base, seval, filt, pg_phiv = _k4_inputs(jg, seed=30)
    return list(as_torch(base + seval + (filt, pg_phiv)))


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity",
                                   "geom_dtype", "stack_shape", "layers"])
def test_pgf_rest_check_their_arguments(fault):
    jg = _jgeom()
    geom = port_geom(jg)
    args = _rest_args(jg)
    if fault == "dtype":
        args = [x.to(torch.float16) for x in args]
    elif fault == "shape":
        args[8] = args[8][:, :8]
    elif fault == "contiguity":
        args[6] = args[6].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "geom_dtype":
        geom = geom.to(dtype=torch.float32)
    elif fault == "stack_shape":
        args[10] = args[10][:jg.layers].contiguous()
    else:
        geom = port_geom(_jgeom(L=40))
    with pytest.raises((TypeError, ValueError)):
        pr._check_rest(args, geom)
    if fault != "stack_shape":
        with pytest.raises((TypeError, ValueError)):
            pr._check_pgf([args[5], args[6], args[8]], geom)


def test_pgf_rest_checks_accept_valid_arguments():
    jg = _jgeom()
    geom = port_geom(jg)
    args = _rest_args(jg)
    pr._check_rest(args, geom)
    pr._check_pgf([args[5], args[6], args[8]], geom)


def test_step_profile_drives_the_v2_step():
    """``step_profile --backend v2`` steps through make_fused_matsuno_v2
    (here with the plain versions on the CPU)."""
    from gcmiipy_tpu_torch.grid import geometry
    geom = geometry.gen_geometry(16, 128, 3, sig_func=geometry.manabe_sig,
                                 dtype=torch.float64, device="cpu")
    config = ModelConfig(backend="fused", dt=DT, dtype="float64")
    before = pr.pgf_parts.launches
    advance = step_profile._stepper("v2", geom, config, 2)
    advance()
    assert pr.pgf_parts.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-5)])
@pytest.mark.parametrize("coriolis,q_limiter,hill", [
    (False, False, False), (True, True, True)])
def test_kernels_match_plain_versions_on_gpu(cuda_device, dtype, bound,
                                             coriolis, q_limiter, hill):
    jg = _jgeom(hill=hill)
    geom = port_geom(jg).to(dtype=dtype, device=cuda_device)
    args = [x.to(dtype=dtype, device=cuda_device) for x in _rest_args(jg)]
    sp, su, st = args[5], args[6], args[8]
    before = (pr.pgf_parts.launches, pr.rest_parts.launches)
    k3 = pr.pgf_parts(sp, su, st, geom)
    k4 = pr.rest_parts(*args, DT, geom, coriolis=coriolis,
                       q_limiter=q_limiter)
    torch.cuda.synchronize()
    assert (pr.pgf_parts.launches, pr.rest_parts.launches) == (
        before[0] + 1, before[1] + 1)
    pairs = list(zip(k3, pr.pgf_parts_ref(sp, su, st, geom)))
    pairs += list(zip(k4, pr.rest_parts_ref(*args, DT, geom,
                                            coriolis=coriolis,
                                            q_limiter=q_limiter)))
    for n, (a, b) in enumerate(pairs):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= bound, (n, err)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(9, 24, 36), (3, 16, 128)])
def test_v2_step_on_gpu_launches_k3_k4_twice(cuda_device, shape):
    L, H, W = shape
    jg = jgeometry.gen_geometry(H, W, L)
    tg = port_geom(jg)
    s = as_torch(random_state(jg, seed=31))
    before = (pr.pgf_parts.launches, pr.rest_parts.launches)
    out = fused.make_fused_matsuno_v2(tg.to(device=cuda_device), DT)(
        *[x.to(cuda_device) for x in s])
    torch.cuda.synchronize()
    assert (pr.pgf_parts.launches, pr.rest_parts.launches) == (
        before[0] + 2, before[1] + 2)
    ref = fused.make_fused_matsuno_v2(tg, DT)(*s)
    assert_close(out, [x.numpy() for x in ref], 1e-12, 1e-12, FIELDS)


# Grids off every tile multiple of the rest tile (32 columns, 8 rows a
# tile), smaller than one tile, and kMaxLayers
EDGE_GRIDS = [(9, 24, 36), (3, 20, 100), (1, 2, 36), (32, 16, 128)]


def edge_geom(shape):
    """The port's float64 CPU geometry of ``shape`` with a hill."""
    L, H, W = shape
    hm = np.zeros((H, W))
    hm[H // 4:H // 2 + 1, W // 8:W // 3] = 1500.0
    return geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=torch.float64,
                                 device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 512, 1024)] + EDGE_GRIDS)
def test_rest_parts_tiles_equal_plain_version_on_gpu(cuda_device, dtype,
                                                     shape):
    """K4, one launch of the rest tile (aflux in its prologue), equals its
    plain version bit for bit on the main path's grid and the edge grids,
    with Coriolis, the q limiter and terrain on."""
    geom = edge_geom(shape)
    base, seval = random_prognostics(geom, 41), random_prognostics(geom, 42)
    stack, pg_phiv = pr.pgf_parts_ref(seval[0], seval[1], seval[3], geom)
    args = [x.to(device=cuda_device, dtype=dtype) for x in (
        *base, *seval, tpolar.arakawa_1977(stack, geom), pg_phiv)]
    geom = geom.to(dtype=dtype, device=cuda_device)
    before = pr.rest_parts.launches, pr.rest_stencil.launches
    out = pr.rest_parts(*args, DT, geom, coriolis=True, q_limiter=True)
    torch.cuda.synchronize()
    assert (pr.rest_parts.launches, pr.rest_stencil.launches) == (
        before[0] + 1, before[1] + 1)
    ref = pr.rest_parts_ref(*args, DT, geom, coriolis=True, q_limiter=True)
    for name, a, b in zip(FIELDS, out, ref):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-4),
                                         (torch.float64, 1e-11)])
def test_mega4_step_on_an_edge_grid_matches_plain_version_on_gpu(
        cuda_device, dtype, bound):
    """One step of backend='mega4' (K6: the tiled rest stencil twice) on a
    grid off the tiles, against mega_step_ref with the kernel's FFT plan."""
    geom = edge_geom((9, 24, 36)).to(dtype=dtype, device=cuda_device)
    state = random_prognostics(geom, 43)
    step = ms.MegaStep(geom, DT, coriolis=True, q_limiter=True)
    before = (ms.mega_step.launches, pr.rest_stencil.launches,
              pr.pgf_tile.launches)
    out = step(*state)
    torch.cuda.synchronize()
    assert (ms.mega_step.launches, pr.rest_stencil.launches,
            pr.pgf_tile.launches) == (before[0] + 1, before[1] + 2,
                                      before[2] + 2)
    fc = step.consts
    ref = ms.mega_step_ref(*state, DT, geom, fc, coriolis=True,
                           q_limiter=True,
                           filter_ref=lambda X: fft_filter_ref(X, fc))
    for name, a, b in zip(FIELDS, out, ref):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= bound, (name, err)


def _pgf_on_gpu(device, dtype, shape, hill):
    """K3 on the card and its plain version, counting the launches."""
    L, H, W = shape
    geom = edge_geom(shape) if hill else geometry.gen_geometry(
        H, W, L, sig_func=geometry.manabe_sig, dtype=torch.float64,
        device="cpu")
    seval = random_prognostics(geom, 48)
    sp, su, st = (x.to(device=device, dtype=dtype)
                  for x in (seval[0], seval[1], seval[3]))
    geom = geom.to(dtype=dtype, device=device)
    before = pr.pgf_parts.launches, pr.pgf_tile.launches
    out = pr.pgf_parts(sp, su, st, geom)
    torch.cuda.synchronize()
    assert (pr.pgf_parts.launches, pr.pgf_tile.launches) == (
        before[0] + 1, before[1] + 1)
    return out, pr.pgf_parts_ref(sp, su, st, geom)


@pytest.mark.gpu
@pytest.mark.parametrize("hill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 512, 1024)] + EDGE_GRIDS)
def test_pgf_tile_equals_plain_version_on_gpu(cuda_device, dtype, shape,
                                              hill):
    """K3, one launch of the pgf tile, equals pgf_parts_ref bit for bit on
    the main path's grid and the edge grids (at float64 through the
    library whose double pow rounds as PyTorch's), and counts its launch
    where its C entry makes it."""
    out, ref = _pgf_on_gpu(cuda_device, dtype, shape, hill)
    for name, a, b in zip(("stack", "pg_phiv"), out, ref):
        assert torch.equal(a, b), (name, int((a != b).sum()))
