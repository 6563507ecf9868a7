"""PyTorch port: the polar filter's FFT stage (``ops/fft_filter.py``), the
filter of K5, K6 and K7 on the card.

On the CPU the wrapper runs its plain version, which runs the kernel's
radix plan and row pairing in complex128 PyTorch ops.  It is held at
float64 against the TPU kernels' banded DFT form (``banded_filter_ref``,
banded and unbanded) within 1e-13 of the field's scale, and against the
JAX package's ``arakawa_1977_dft`` within 1e-12, on the JAX geometries.
The CUDA kernel itself is held against both plain forms by the ``gpu``
tests (skipped without a card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.ops import polar_filter as jpolar
from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model.state import random_prognostics
from gcmiipy_tpu_torch.ops import fft_filter as ff
from gcmiipy_tpu_torch.ops import mega_step as ms

from torch_port_helpers import BANDED_REL64, port_geom

torch.set_num_threads(1)

GRIDS = [(3, 24, 36), (2, 16, 37), (3, 20, 100), (2, 128, 384)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(grid, planes=None, seed=0):
    """The port's geometry of the JAX geometry ``grid`` (L, H, W) and
    stacked fields (2L or ``planes``, H, W) from a numpy seed."""
    L, H, W = grid
    jg = jgeometry.gen_geometry(H, W, L)
    P = 2 * L if planes is None else planes
    x = np.random.default_rng(seed + W).standard_normal((P, H, W))
    return jg, port_geom(jg), x


def _scaled(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("width", [1, 2, 36, 37, 100, 128, 384, 1024, 2048])
def test_radix_plan_multiplies_to_the_width(width):
    plan = ff.radix_plan(width)
    assert int(np.prod(plan, dtype=np.int64)) == width
    assert all(r >= 2 for r in plan)
    assert len(plan) <= ff.MAX_STAGES


def test_radix_plan_puts_fours_first_and_other_primes_last():
    """The register-tiled widths run 16s, then the rest; any other width
    4s, a 2, 3s and 5s, then other primes."""
    assert ff.radix_plan(512) == (16, 16, 2)
    assert ff.radix_plan(1024) == (16, 16, 4)
    assert ff.radix_plan(2048) == (16, 16, 8)
    assert ff.radix_plan(4096) == (16, 16, 16)
    assert ff.radix_plan(256) == (4, 4, 4, 4)
    assert ff.radix_plan(8192) == (4, 4, 4, 4, 4, 4, 2)
    assert ff.radix_plan(36) == (4, 3, 3)
    assert ff.radix_plan(100) == (4, 5, 5)
    assert ff.radix_plan(37) == (37,)
    assert ff.radix_plan(462) == (2, 3, 7, 11)
    with pytest.raises(ValueError):
        ff.radix_plan(0)


@pytest.mark.parametrize("width", [2, 3, 7, 36, 37, 100, 384, 462, 512, 1024,
                                   2048, 4096])
def test_stockham_stages_are_the_dft(width):
    """The plan's Stockham stages give the DFT (numpy's, in float64)."""
    tw = torch.as_tensor(ff.twiddles(width))
    z = np.random.default_rng(width).standard_normal((2, 3, width, 2))
    z = z[..., 0] + 1j * z[..., 1]
    out = ff.stockham(torch.as_tensor(z), ff.radix_plan(width),
                      torch.complex(tw[:, 0], tw[:, 1]))
    ref = np.fft.fft(z, axis=-1)
    assert _scaled(out.real.numpy(), ref.real) < 1e-14
    assert _scaled(out.imag.numpy(), ref.imag) < 1e-14


def test_twiddles_are_the_roots_of_unity():
    for W in (36, 37, 1024):
        tw = ff.twiddles(W)
        ref = np.exp(-2j * np.pi * np.arange(W) / W)
        np.testing.assert_allclose(tw[:, 0], ref.real, rtol=0, atol=2e-15)
        np.testing.assert_allclose(tw[:, 1], ref.imag, rtol=0, atol=2e-15)
        assert tw[0].tolist() == [1.0, 0.0]
        # from angles reduced to [-pi, pi]: w^(W-n) is conj(w^n) exactly
        assert np.array_equal(tw[1:][::-1], tw[1:] * [1.0, -1.0])


def test_consts_list_the_damped_latitudes_and_cast_the_mask_in_float64():
    g32 = geometry.gen_geometry(24, 36, 2, dtype=torch.float32,
                                device="cpu")
    fc = ff.build_fft_consts(g32)
    mask = g32.polar_mask.double() - 1.0
    assert fc.mask.dtype == torch.float64 and torch.equal(fc.mask, mask)
    damped = (mask != 0).any(dim=1).nonzero().flatten()
    assert fc.lats.dtype == torch.int32 and fc.lats.tolist() == damped.tolist()
    assert fc.lats.numel() == 12
    assert bool((fc.mask[:, 0] == 0).all())    # n = 0 is never damped
    assert tuple(fc.twiddle.shape) == (36, 2)


@pytest.mark.parametrize("band_limit", [True, False])
@pytest.mark.parametrize("grid", GRIDS)
def test_fft_filter_ref_equals_the_banded_dft(grid, band_limit):
    _, tg, x = _inputs(grid)
    X = torch.as_tensor(x)
    out = ff.fft_filter_ref(X, ff.build_fft_consts(tg))
    ref = ms.banded_filter_ref(X, ms.build_banded_consts(tg, band_limit))
    assert out.dtype == torch.float64
    assert _scaled(out.numpy(), ref.numpy()) <= 1e-13
    assert not torch.equal(out, X)


@pytest.mark.parametrize("grid", GRIDS)
def test_fft_filter_ref_matches_jax_dft(grid):
    jg, tg, x = _inputs(grid, seed=1)
    mats = jpolar.build_dft_matrices(jg.width, dtype=np.float64)
    ref = np.asarray(jpolar.arakawa_1977_dft(jnp.asarray(x), jg, mats,
                                             precision="highest"))
    out = ff.fft_filter_ref(torch.as_tensor(x), ff.build_fft_consts(tg))
    assert _scaled(out.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("grid,planes", [((3, 24, 36), 3),
                                         ((2, 16, 37), 5)])
def test_an_odd_plane_count_pairs_the_last_plane_with_zero(grid, planes):
    _, tg, x = _inputs(grid, planes=planes, seed=2)
    fc = ff.build_fft_consts(tg)
    X = torch.as_tensor(x)
    out = ff.fft_filter_ref(X, fc)
    ref = ms.banded_filter_ref(X, ms.build_banded_consts(tg))
    assert _scaled(out.numpy(), ref.numpy()) <= 1e-13
    # the last plane alone gives the same result as with its partner
    last = ff.fft_filter_ref(X[-1:], fc)
    assert _scaled(out[-1:].numpy(), last.numpy()) <= 1e-15


def _long_double_filter(X, fc):
    """The filter as a DFT in long double: the truth to float64's scale."""
    P, H, W = X.shape
    x = X.numpy().astype(np.longdouble).reshape(P * H, W)
    n = np.arange(W)
    ang = 8 * np.arctan(np.longdouble(1)) * (np.outer(n, n) % W) / W
    C, S = np.cos(ang), np.sin(ang)
    g = np.tile(fc.mask.numpy().astype(np.longdouble)[:, np.minimum(n, W - n)],
                (P, 1))
    re, im = (x @ C) * g, -(x @ S) * g
    return torch.as_tensor((x + (re @ C - im @ S) / W).astype(np.float64)
                           .reshape(P, H, W))


def test_on_the_forces_the_fft_plan_is_nearer_the_truth_than_the_banded_dft():
    """On the stacked forces, whose polar rows the filter cancels, the
    float64 banded DFT's own rounding reaches 1e-12 of the filtered field's
    scale, while the FFT plan stays within 1e-13 of a long-double DFT: why
    chip_smoke.py holds the kernels at float64 to the plain version with
    the FFT plan at the tight bound, and to the banded one at a bound above
    the banded DFT's own rounding."""
    L = 9
    g = geometry.gen_geometry(64, 256, L, sig_func=geometry.manabe_sig,
                              dtype=torch.float64, device="cpu")
    s = random_prognostics(g, 2, torch.float64)
    X = torch.cat(core25d.pgf_forces(s[0], s[1], s[3], g)[:2])
    fc = ff.build_fft_consts(g)
    truth = _long_double_filter(X, fc)

    def err(y):
        return max(_scaled(y[:L], truth[:L]), _scaled(y[L:], truth[L:]))

    fft_err = err(ff.fft_filter_ref(X, fc))
    banded_err = err(ms.banded_filter_ref(X, ms.build_banded_consts(g)))
    assert fft_err <= 1e-13
    assert banded_err > 10 * fft_err


def test_rows_without_damping_are_left_as_they_are():
    _, tg, x = _inputs((2, 24, 36), seed=3)
    fc = ff.build_fft_consts(tg)
    X = torch.as_tensor(x)
    out = ff.fft_filter_ref(X, fc)
    undamped = sorted(set(range(24)) - set(fc.lats.tolist()))
    assert undamped
    assert torch.equal(out[:, undamped], X[:, undamped])


@pytest.mark.parametrize("grid", [(2, 32, 384), (2, 128, 1024)])
def test_float32_fft_filter_rounds_once_unlike_jax_float32(grid):
    """At float32 the result is the float64 result rounded once: within one
    float32 ulp of the field's scale, and several times closer to the
    float64 truth than the JAX package's float32 'dft' filter."""
    L, H, W = grid
    jg = jgeometry.gen_geometry(H, W, 3)
    tg = port_geom(jg)
    fc = ff.build_fft_consts(tg)
    x = np.random.default_rng(W).standard_normal((L, H, W)).astype(np.float32)
    x32 = torch.as_tensor(x)
    port = ff.fft_filter_ref(x32, fc)
    assert port.dtype == torch.float32
    assert torch.equal(port, ff.fft_filter_ref(x32.double(), fc).float())
    mats = jpolar.build_dft_matrices(W, dtype=np.float64)
    truth = np.asarray(jpolar.arakawa_1977_dft(
        jnp.asarray(x, jnp.float64), jg, mats, precision="highest"))
    jax32 = np.asarray(jpolar.arakawa_1977_dft(
        jnp.asarray(x), jg, jpolar.build_dft_matrices(W, dtype=np.float32)))
    assert jax32.dtype == np.float32
    scale = np.abs(truth).max()
    port_err = np.abs(port.numpy() - truth).max() / scale
    jax_err = np.abs(jax32 - truth).max() / scale
    assert port_err <= 2.0 ** -23
    assert 5 * port_err < jax_err


def test_fft_filter_on_cpu_filters_in_place_with_the_plain_version():
    _, tg, x = _inputs((3, 24, 36), seed=4)
    fc = ff.build_fft_consts(tg)
    X = torch.as_tensor(x.copy())
    ref = ff.fft_filter_ref(X, fc)
    before = ff.fft_filter.launches
    assert ff.fft_filter(X, fc) is X
    assert torch.equal(X, ref)
    assert ff.fft_filter.launches == before  # no kernel launched on the CPU


def test_fft_filter_refuses_other_devices():
    _, tg, x = _inputs((3, 24, 36))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ff.fft_filter(torch.as_tensor(x).to("meta"), ff.build_fft_consts(tg))


@pytest.mark.parametrize("fault", ["mask_dtype", "mask_shape",
                                   "twiddle_length", "lats_dtype",
                                   "too_wide"])
def test_fft_filter_checks_its_buffers(fault):
    _, tg, _ = _inputs((3, 24, 36))
    fc = ff.build_fft_consts(tg)
    H, W = 24, 36
    if fault == "mask_dtype":
        fc = fc._replace(mask=fc.mask.float())
    elif fault == "mask_shape":
        fc = fc._replace(mask=fc.mask[:, :-1].contiguous())
    elif fault == "twiddle_length":
        fc = fc._replace(twiddle=fc.twiddle[:-1])
    elif fault == "lats_dtype":
        fc = fc._replace(lats=fc.lats.long())
    else:
        W = 8192
        fc = fc._replace(mask=torch.zeros((H, W // 2 + 1),
                                          dtype=torch.float64),
                         twiddle=torch.as_tensor(ff.twiddles(W)))
    with pytest.raises(ValueError):
        ff.check_consts("fft_filter", fc, torch.device("cpu"), H, W)
    ff.check_consts("fft_filter", ff.build_fft_consts(tg),
                    torch.device("cpu"), 24, 36)


def test_operation_count_of_the_main_round():
    """The count chip_smoke.py bounds the stage by: at 9x512x1024 every
    latitude is damped, 4608 row pairs of two 1024-point transforms of
    stages of radix 16, 16 and 4 (twiddles only where they are not 1),
    about 0.36 GFLOP a round."""
    fwd = (64 * 176) + (64 * 176 + (64 - 4) * 6 * 15) + (256 * 16 + 255 * 6 * 3)
    assert ff.transform_ops(1024) == fwd
    assert ff.transform_ops(36) == (9 * 16) + (12 * 16 + 9 * 12) + (12 * 16 + 11 * 12)
    assert ff.transform_ops(37) == 37 * 37 * 8
    assert ff.round_ops(18, 1024, 512) == 512 * 9 * (2 * fwd + 5 * 1024)
    assert 0.35e9 < ff.round_ops(18, 1024, 512) < 0.37e9
    jg = jgeometry.gen_geometry(512, 1024, 3)
    assert ff.build_fft_consts(port_geom(jg)).lats.numel() == 512


def _stack(shape, dtype, device, seed=2):
    """[spu_raw; pg_phi] of a random state: the stage's real input."""
    L, H, W = shape
    g = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                              dtype=dtype, device=device)
    s = random_prognostics(g, seed, dtype)
    return g, torch.cat(core25d.pgf_forces(s[0], s[1], s[3], g)[:2])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,planes,bound", [
    ((9, 512, 1024), torch.float32, None, 2e-7),
    ((9, 512, 1024), torch.float64, None, 1e-13),
    ((3, 24, 36), torch.float64, None, 1e-13),
    ((3, 20, 100), torch.float64, None, 1e-13),
    ((2, 16, 37), torch.float64, None, 1e-13),
    ((3, 24, 36), torch.float64, 5, 1e-13),
    ((2, 8, 512), torch.float64, None, 1e-13),
    ((2, 8, 2048), torch.float32, None, 2e-7),
    ((2, 8, 4096), torch.float32, 3, 2e-7),
    ((3, 128, 384), torch.float32, None, 2e-7),     # the general path
    ((3, 128, 384), torch.float64, None, 1e-13),
])
def test_kernel_matches_plain_versions_on_gpu(cuda_device, shape, dtype,
                                              planes, bound):
    """The kernel against its plain version over the result's scale, on the
    stacked forces and on standard-normal planes, and against the banded
    DFT: within the bound at float32, and at float64 on the normal planes
    over the input's scale (its own float64 rounding grows with the input,
    which the polar rows cancel); on the forces at float64 within
    BANDED_REL64, above the banded DFT's own rounding there
    (test_on_the_forces_the_fft_plan_is_nearer_the_truth_than_the_banded_dft:
    1.64e-11 of the field's scale at 9x512x1024 on the card)."""
    g, forces = _stack(shape, dtype, cuda_device)
    if planes is not None:
        forces = forces[:planes].contiguous()
    normal = torch.as_tensor(np.random.default_rng(5).standard_normal(
        tuple(forces.shape))).to(device=cuda_device, dtype=dtype)
    fc = ms.build_filter_consts(g)
    bc = ms.build_banded_consts(g)
    for name, X in (("forces", forces), ("normal", normal)):
        before = ff.fft_filter.launches
        out = ff.fft_filter(X.clone(), fc)
        torch.cuda.synchronize()
        assert ff.fft_filter.launches == before + 1
        ref = ff.fft_filter_ref(X, fc)
        err = float((out - ref).abs().max() / ref.abs().max())
        assert err <= bound, (name, err)
        ref = ms.banded_filter_ref(X, bc)
        if dtype == torch.float32:
            err = float((out - ref).abs().max() / ref.abs().max())
            assert err <= bound, (name, "banded", err)
        elif name == "normal":
            err = float((out - ref).abs().max() / X.abs().max())
            assert err <= bound, (name, "banded", err)
        else:
            err = float((out - ref).abs().max() / ref.abs().max())
            assert err <= BANDED_REL64, (name, "banded", err)

