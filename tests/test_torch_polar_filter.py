"""PyTorch port: the polar filter's builders and its 'matmul', 'dft' and
'avrx' forms against the JAX package (``gcmiipy_tpu/ops/polar_filter.py``),
at float64 on the CPU.  The JAX builders are numpy, so the builders are held
to them exactly; the filters at 1e-12, and ``run_model`` with each filter at
the 1e-10 bound of tests/test_parity.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.model import driver as jdriver
from gcmiipy_tpu.model.config import ModelConfig as JModelConfig
from gcmiipy_tpu.ops import polar_filter as jpolar
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.ops import mega_step, polar_filter

from torch_port_helpers import FIELDS, assert_close, port_geom

torch.set_num_threads(1)

WIDTHS = (36, 37, 128, 384, 1024)


def _geom(width, height=8):
    return jgeometry.gen_geometry(height, width, 3)


def _builder_outputs(pf, jg, mask):
    """Every builder's output on ``jg``: the JAX package's with ``pf`` the
    JAX module, the port's with ``pf`` the port's module (``mask`` the
    damping mask in that package's form)."""
    W = jg.width
    _, _, _, _, nb = pf.build_dft_matrices_banded(W, dtype=np.float64)
    out = {
        "build_dft_matrices": pf.build_dft_matrices(W, dtype=np.float64),
        "build_dft_matrices_banded": pf.build_dft_matrices_banded(
            W, dtype=np.float64),
        "banded_pair_matrices": pf.banded_pair_matrices(W, dtype=np.float64),
        "banded_correction_mask": pf.banded_correction_mask(
            mask, nb, dtype=np.float64),
        "banded_correction_mask_pair": pf.banded_correction_mask_pair(
            mask, nb, dtype=np.float64),
        "band_chunk_counts": pf.band_chunk_counts(mask),
        "band_chunk_counts_above": pf.band_chunk_counts_above(mask, 0.125),
        "float32 casts": (pf.build_dft_matrices(W, dtype=np.float32)
                          + pf.banded_pair_matrices(W, dtype=np.float32)[:2]),
    }
    if W <= 384:  # (J, W, W) matrices: kept to the smaller widths
        out["build_filter_matrices"] = pf.build_filter_matrices(
            jg if pf is jpolar else port_geom(jg), dtype=np.float64)
    return out


@pytest.mark.parametrize("width", WIDTHS)
def test_builders_equal_jax_exactly(width):
    jg = _geom(width)
    ref = _builder_outputs(jpolar, jg, jg.polar_mask)
    out = _builder_outputs(polar_filter, jg, port_geom(jg).polar_mask)
    assert out.keys() == ref.keys()
    for name in ref:
        a = out[name] if isinstance(out[name], tuple) else (out[name],)
        b = ref[name] if isinstance(ref[name], tuple) else (ref[name],)
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_banded_columns_descend_so_each_band_is_a_prefix():
    """Each row's damped band is a column prefix covered by its count, and
    at 9x512x1024 the rows need 1, 2, 3 and 4 chunks, 128 rows each."""
    jg = jgeometry.gen_geometry(512, 1024, 3)
    mask = port_geom(jg).polar_mask
    _, _, _, _, nb = polar_filter.build_dft_matrices_banded(1024)
    mc = polar_filter.banded_correction_mask(mask, nb, dtype=np.float64)
    counts = polar_filter.band_chunk_counts(mask)
    for j in range(512):
        assert (mc[j, counts[j] * polar_filter.FILTER_CHUNK:] == 0).all()
        assert (mc[j, :counts[j] * polar_filter.FILTER_CHUNK - 127] != 0).all()
    assert np.bincount(counts).tolist() == [0, 128, 128, 128, 128]


def _jax_filter(name, jg, x):
    if name == "dft":
        mats = jpolar.build_dft_matrices(jg.width, dtype=np.float64)
        return jpolar.arakawa_1977_dft(jnp.asarray(x), jg, mats)
    if name == "matmul":
        F = jpolar.build_filter_matrices(jg, dtype=np.float64)
        return jpolar.arakawa_1977_matmul(jnp.asarray(x), F)
    return jpolar.avrx(jnp.asarray(x), jg)


def _port_filter(name, tg, x):
    x = torch.as_tensor(x)
    if name == "dft":
        mats = polar_filter.build_dft_matrices(tg.width, dtype=np.float64)
        return polar_filter.arakawa_1977_dft(x, tg, mats)
    if name == "matmul":
        F = polar_filter.build_filter_matrices(tg, dtype=np.float64)
        return polar_filter.arakawa_1977_matmul(x, F)
    return polar_filter.avrx(x, tg)


@pytest.mark.parametrize("name", ["dft", "matmul", "avrx"])
@pytest.mark.parametrize("grid", [(3, 24, 36), (2, 16, 37)])
def test_filters_match_jax(name, grid):
    L, H, W = grid
    jg = jgeometry.gen_geometry(H, W, L)
    x = np.random.default_rng(W).standard_normal((L, H, W))
    out = _port_filter(name, port_geom(jg), x)
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax_filter(name, jg, x)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("band_limit", [True, False])
@pytest.mark.parametrize("grid", [(2, 24, 36), (2, 16, 37), (1, 32, 384)])
def test_banded_pair_form_equals_fft_filter(grid, band_limit):
    """``x + ((x @ CS) * mcc) @ CwSw``, chunk by chunk, with per-row trip
    counts or with every chunk, is the rFFT filter."""
    P, H, W = grid
    tg = port_geom(jgeometry.gen_geometry(H, W, 3))
    bc = mega_step.build_banded_consts(tg, band_limit=band_limit)
    x = torch.as_tensor(np.random.default_rng(H).standard_normal((P, H, W)))
    np.testing.assert_allclose(
        mega_step.banded_filter_ref(x, bc).numpy(),
        polar_filter.arakawa_1977(x, tg).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("polar", ["dft", "matmul"])
@pytest.mark.parametrize("grid", [(8, 8, 3), (16, 128, 3)])
def test_run_model_with_filter_matches_jax(polar, grid):
    args = (*grid, 300.0, 10)
    cfg = dict(polar_filter=polar, dtype="float64")
    port = driver.run_model(*args, config=ModelConfig(**cfg), device="cpu")
    ref = jdriver.run_model(*args, config=JModelConfig(**cfg))
    assert_close(port[:5], ref[:5], 1e-10, 1e-10, FIELDS)
    assert_close(port[7], ref[7], 1e-10, 1e-10, port[7]._fields)


@pytest.mark.parametrize("grid", [(2, 32, 384), (2, 128, 1024)])
def test_float32_dft_filter_rounds_once_unlike_jax_float32(grid):
    """The port's float32 'dft' filter sums in float64 (its factors' dtype),
    so it is the float64 result rounded once: within one float32 ulp of the
    field's scale.  The JAX package's float32 'dft' filter on the CPU sums
    in float32 and lands several times further off."""
    L, H, W = grid
    jg = jgeometry.gen_geometry(H, W, 3)
    tg = port_geom(jg)
    x = np.random.default_rng(W).standard_normal((L, H, W)).astype(np.float32)
    mats = polar_filter.build_dft_matrices(W, dtype=np.float64)
    truth = polar_filter.arakawa_1977_dft(torch.as_tensor(x).double(), tg,
                                          mats).numpy()
    port = polar_filter.arakawa_1977_dft(torch.as_tensor(x), tg, mats)
    jax32 = np.asarray(jpolar.arakawa_1977_dft(
        jnp.asarray(x), jg, jpolar.build_dft_matrices(W, dtype=np.float32)))
    assert port.dtype == torch.float32 and jax32.dtype == np.float32
    scale = np.abs(truth).max()
    port_err = np.abs(port.numpy() - truth).max() / scale
    jax_err = np.abs(jax32 - truth).max() / scale
    assert port_err <= 2.0 ** -23
    assert 5 * port_err < jax_err
