"""PyTorch port: the CUDA sources' own code paths on the CPU.

``torch_host_emulation`` (beside this file) builds ``csrc/*.cu`` with the host
compiler (skipped without ``g++``) against an emulation of the CUDA subset
they use, and the wrappers take CPU tensors down their kernel paths.  K1,
K4 and the rest stencil alone (the tiled stencil in both of its forms) and
K6 (a whole step's ten launches, the FFT filter among them) are held
against their plain versions at float64 on grids off the tiles and smaller
than one: K4 and the rest stencil to the bit where no ``sin`` enters, and
otherwise within 1e-12 of each field's scale, since the host's ``pow`` and
``sin`` round apart from PyTorch's.  The rest stencil's launches are
counted where the C entries make them.
"""

import shutil

import numpy as np
import pytest
import torch

from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model.state import random_prognostics
from gcmiipy_tpu_torch.ops import fused_parts as fp
from gcmiipy_tpu_torch.ops import mega_step as ms
from gcmiipy_tpu_torch.ops import pgf_rest as pr
from gcmiipy_tpu_torch.ops import polar_filter
from gcmiipy_tpu_torch.ops.fft_filter import fft_filter_ref
from torch_host_emulation import kernels_on_cpu, rewrite_launches

torch.set_num_threads(1)

DT = 300.0
GRIDS = [(3, 20, 36), (1, 2, 36), (4, 13, 70)]


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host emulation")
    return str(tmp_path_factory.mktemp("host_emulation"))


def _geom(shape, hill):
    L, H, W = shape
    hm = None
    if hill:
        hm = np.zeros((H, W))
        hm[H // 4:H // 2 + 1, W // 8:W // 3] = 1500.0
    return geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=torch.float64,
                                 device="cpu")


def _scaled_err(out, ref):
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(out, ref))


def test_rewrite_launches_turns_each_launch_into_a_call():
    src = ("  k<T><<<dim3(f(a), (b + 1) / 2), n, bytes, s>>>(x, g(y, z));\n"
           "  m<<<grid, 128>>>(a);\n")
    out = rewrite_launches(src)
    assert out == ("  emu_launch(dim3(f(a), (b + 1) / 2), n, bytes, s, [&]() "
                   "{ k<T>(x, g(y, z)); });\n"
                   "  emu_launch(grid, 128, 0, 0, [&]() { m(a); });\n")


@pytest.mark.parametrize("coriolis,q_limiter,hill", [
    (False, False, False), (True, True, True)])
@pytest.mark.parametrize("shape", GRIDS)
def test_rest_parts_source_matches_plain_version(build_dir, shape, coriolis,
                                                 q_limiter, hill):
    geom = _geom(shape, hill)
    base, seval = random_prognostics(geom, 51), random_prognostics(geom, 52)
    stack, pg_phiv = pr.pgf_parts_ref(seval[0], seval[1], seval[3], geom)
    args = (*base, *seval, polar_filter.arakawa_1977(stack, geom), pg_phiv,
            DT, geom)
    before = pr.rest_parts.launches, pr.rest_stencil.launches
    with kernels_on_cpu(build_dir):
        out = pr.rest_parts(*args, coriolis=coriolis, q_limiter=q_limiter)
    assert (pr.rest_parts.launches, pr.rest_stencil.launches) == (
        before[0] + 1, before[1] + 1)
    ref = pr.rest_parts_ref(*args, coriolis=coriolis, q_limiter=q_limiter)
    if coriolis:
        assert _scaled_err(out, ref) <= 1e-12
    else:
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("coriolis,q_limiter,hill", [
    (False, False, False), (True, True, True)])
@pytest.mark.parametrize("shape", GRIDS)
def test_rest_stencil_source_matches_plain_version(build_dir, shape, coriolis,
                                                   q_limiter, hill):
    geom = _geom(shape, hill)
    base, seval = random_prognostics(geom, 56), random_prognostics(geom, 57)
    stack, pg_phiv = pr.pgf_parts_ref(seval[0], seval[1], seval[3], geom)
    filt = polar_filter.arakawa_1977(stack, geom)
    p_n, sd = pr.rest_column_ref(base[0], seval[0], seval[2], filt, DT, geom)
    args = (*base, *seval, filt, pg_phiv, p_n, sd, DT, geom)
    before = pr.rest_stencil.launches
    with kernels_on_cpu(build_dir):
        out = pr.rest_stencil(*args, coriolis=coriolis, q_limiter=q_limiter)
    assert pr.rest_stencil.launches == before + 1
    ref = pr.rest_stencil_ref(*args, coriolis=coriolis, q_limiter=q_limiter)
    if coriolis:
        assert _scaled_err(out, ref) <= 1e-12
    else:
        assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("coriolis,q_limiter,hill", [
    (False, False, False), (True, True, True)])
@pytest.mark.parametrize("shape", GRIDS)
def test_fused_parts_source_matches_plain_version(build_dir, shape, coriolis,
                                                  q_limiter, hill):
    geom = _geom(shape, hill)
    base, seval = random_prognostics(geom, 53), random_prognostics(geom, 54)
    spu = polar_filter.arakawa_1977(core25d.calc_pu(seval[0], seval[1]),
                                    geom)
    args = (*base, *seval, spu, DT, geom)
    before = fp.fused_parts.launches
    with kernels_on_cpu(build_dir):
        out = fp.fused_parts(*args, coriolis=coriolis, q_limiter=q_limiter)
    assert fp.fused_parts.launches == before + 1
    ref = fp.fused_parts_ref(*args, coriolis=coriolis, q_limiter=q_limiter)
    assert _scaled_err(out, ref) <= 1e-12


def test_mega_step_source_matches_plain_version(build_dir):
    geom = _geom((3, 20, 36), True)
    state = random_prognostics(geom, 55)
    step = ms.MegaStep(geom, DT, coriolis=True, q_limiter=True)
    before = ms.mega_step.launches, pr.rest_stencil.launches
    with kernels_on_cpu(build_dir):
        out = step(*state)
    assert (ms.mega_step.launches, pr.rest_stencil.launches) == (
        before[0] + 1, before[1] + 2)
    fc = step.consts
    ref = ms.mega_step_ref(*state, DT, geom, fc, coriolis=True,
                           q_limiter=True,
                           filter_ref=lambda X: fft_filter_ref(X, fc))
    assert _scaled_err(out, ref) <= 1e-11
    assert bool((out[2][:, -1] == 0).all())
