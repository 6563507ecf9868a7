"""PyTorch port: K1 (``ops/fused_parts.py``) and the 'fused' Matsuno step.

On the CPU the wrapper runs its plain version, which is held against the
JAX package's K1 (``pallas_stencil.make_fused_parts_padded``) in interpret
mode, as tests/test_pallas_fused.py runs it, at float64.  The CUDA kernel
itself is held against the plain version by the ``gpu`` tests (skipped
without a card) and by chip_smoke.py.
"""

import os
import shutil
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu.dynamics import core25d as jcore
from gcmiipy_tpu.dynamics import fused as jfused
from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu.ops import pallas_stencil as ps
from gcmiipy_tpu_torch.dynamics import core25d, fused
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model.state import random_prognostics
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops import polar_filter as tpolar
from gcmiipy_tpu_torch.ops.fused_parts import (
    MAX_LAYERS, _check, column_pass, fused_parts, fused_parts_ref,
    parts_stencil, pgf_column)

from torch_port_helpers import (
    FIELDS, as_jax, as_torch, assert_close, port_geom, random_state)

torch.set_num_threads(1)

OUTS = ("p_n", "v_n", "t_n", "q_n", "pu_partial", "pg_phi")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _geom(hill=False, layers=3):
    hm = None
    if hill:  # tests/test_pallas_fused.py:46-60
        hm = np.zeros((16, 128))
        hm[4:8, 10:40] = 1500.0
    return jgeometry.gen_geometry(16, 128, layers,
                                  sig_func=jgeometry.manabe_sig, heightmap=hm)


def _k1_args(jg, seed=0):
    base, seval = random_state(jg, seed), random_state(jg, seed + 1)
    spu = np.asarray(jcore.calc_pu(*as_jax(seval[:2])))
    return base + seval + (spu,)


@pytest.mark.parametrize("coriolis,q_limiter,hill", [
    (False, False, False), (True, False, True), (False, True, False)])
def test_fused_parts_ref_matches_jax_k1_interpret(coriolis, q_limiter, hill):
    jg = _geom(hill)
    args = _k1_args(jg)
    k1 = ps.make_fused_parts_padded(jg, 300.0, coriolis=coriolis,
                                    dtype=jnp.float64, interpret=True,
                                    q_limiter=q_limiter)
    ref = k1(*(ps.pad_state(x) for x in as_jax(args)))
    ref = tuple(ps.core(x) for x in ref[:4]) + tuple(ref[4:])
    out = fused_parts_ref(*as_torch(args), 300.0, port_geom(jg),
                          coriolis=coriolis, q_limiter=q_limiter)
    assert_close(out, ref, 1e-11, 1e-11, OUTS)


def test_fused_parts_on_cpu_runs_the_plain_version():
    jg = _geom(hill=True)
    args = as_torch(_k1_args(jg, seed=4))
    before = fused_parts.launches
    out = fused_parts(*args, 300.0, port_geom(jg), coriolis=True,
                      q_limiter=True)
    ref = core25d.half_timestep_parts(*args, 300.0, port_geom(jg),
                                      coriolis=True, q_limiter=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert fused_parts.launches == before  # no kernel launched on the CPU


def test_fused_parts_refuses_other_devices():
    jg = _geom()
    args = list(as_torch(_k1_args(jg)))
    with pytest.raises(ValueError, match="mixed devices"):
        fused_parts(*args[:-1], args[-1].to("meta"), 300.0, port_geom(jg))
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_parts(*meta, 300.0, port_geom(jg))


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguity",
                                   "geom_dtype", "layers"])
def test_fused_parts_checks_its_arguments(fault):
    jg = _geom()
    geom = port_geom(jg)
    args = list(as_torch(_k1_args(jg)))
    if fault == "dtype":
        args = [x.to(torch.float16) for x in args]
    elif fault == "shape":
        args[3] = args[3][:, :8]
    elif fault == "contiguity":
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "geom_dtype":
        geom = geom.to(dtype=torch.float32)
    else:
        geom = port_geom(jgeometry.gen_geometry(16, 128, MAX_LAYERS + 1))
    with pytest.raises((TypeError, ValueError)):
        _check(args, geom)


def test_fused_parts_checks_accept_valid_arguments():
    jg = _geom()
    _check(as_torch(_k1_args(jg)), port_geom(jg))


def test_fused_step_matches_jax_fused_and_port_core():
    jg = _geom(hill=True)
    tg = port_geom(jg)
    s = random_state(jg, seed=7)
    jstep = jfused.make_fused_step(jg, 300.0, coriolis=True,
                                   dtype=jnp.float64, interpret=True)
    tstep = fused.make_fused_step(tg, 300.0, coriolis=True)
    sj, st, sc = as_jax(s), as_torch(s), as_torch(s)
    for _ in range(2):
        sj, st = jstep(*sj), tstep(*st)
        sc = core25d.matsuno_timestep(*sc, 300.0, tg, coriolis=True)
    assert_close(st, sj, 1e-11, 1e-11, FIELDS)
    assert_close(st, [x.numpy() for x in sc], 1e-12, 1e-12, FIELDS)
    assert torch.all(st[2][:, -1, :] == 0)  # polar wall


@pytest.mark.parametrize("coriolis,hill", [(False, False), (True, True)])
def test_fused_matsuno_matches_jax_k2_interpret(coriolis, hill):
    """The K2 path: JAX ``make_fused_matsuno`` (its kernel pads unpadded
    fields inside) against the port's, which runs K1 on them."""
    jg = _geom(hill)
    s = random_state(jg, seed=8)
    jstep = jfused.make_fused_matsuno(jg, 300.0, coriolis=coriolis,
                                      dtype=jnp.float64, interpret=True)
    tstep = fused.make_fused_matsuno(port_geom(jg), 300.0, coriolis=coriolis)
    sj, st = as_jax(s), as_torch(s)
    for _ in range(2):
        sj, st = jstep(*sj), tstep(*st)
    assert_close(st, sj, 1e-10, 1e-10, FIELDS)


@pytest.mark.parametrize("shape", [(9, 24, 36), (3, 8, 8)])
def test_fused_step_runs_k1_on_an_off_tile_grid(shape):
    """Unlike the JAX package (which takes its plain core on grids that are
    not 8 | height and 128 | width), the port runs K1 on every grid."""
    L, H, W = shape
    jg = jgeometry.gen_geometry(H, W, L)
    tg = port_geom(jg)
    s = random_state(jg, seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tstep = fused.make_fused_step(tg, 300.0)
    sc = as_torch(s)
    st = tstep(*as_torch(s))
    sc = core25d.matsuno_timestep(*sc, 300.0, tg)
    sj = jcore.matsuno_timestep(*as_jax(s), 300.0, jg)
    assert_close(st, [x.numpy() for x in sc], 1e-12, 1e-12, FIELDS)
    assert_close(st, sj, 1e-11, 1e-11, FIELDS)


def test_kernel_library_is_named_by_source_and_flags(tmp_path, monkeypatch):
    src, lib = cuda_lib.library_path("fused_parts")
    assert src.endswith("csrc/fused_parts.cu") and lib.endswith(".so")
    assert lib.startswith(cuda_lib.BUILD_DIR)
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS", cuda_lib.NVCC_FLAGS + ("-g",))
    assert cuda_lib.library_path("fused_parts")[1] != lib
    text = open(src).read()
    assert "torch/extension.h" not in text and "extern \"C\"" in text
    header = os.path.join(cuda_lib.CSRC_DIR, "gcm_stencil.cuh")
    assert '#include "gcm_stencil.cuh"' in text and os.path.exists(header)
    assert "--use_fast_math" not in cuda_lib.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    for name in ("fused_parts.cu", "gcm_stencil.cuh"):
        shutil.copy(os.path.join(cuda_lib.CSRC_DIR, name), tmp_path / name)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(tmp_path))
    lib = cuda_lib.library_path("fused_parts")[1]
    with open(tmp_path / "gcm_stencil.cuh", "a") as f:
        f.write("// edited\n")
    assert cuda_lib.library_path("fused_parts")[1] != lib


def test_float64_library_links_the_contracted_pow(tmp_path, monkeypatch):
    """Each source's float64 library is its own build, relocatable device
    code with csrc/gcm_pow.cu's double pow, named by that source too."""
    assert cuda_lib.library_name("fused_parts", False) == "fused_parts"
    name = cuda_lib.library_name("fused_parts", True)
    src, lib = cuda_lib.library_path(name)
    assert src == cuda_lib.library_path("fused_parts")[0]
    assert lib != cuda_lib.library_path("fused_parts")[1]
    assert "-rdc=true" in cuda_lib.FLOAT64_FLAGS
    assert "-fmad=false" not in cuda_lib.POW_FLAGS
    for fname in ("fused_parts.cu", "gcm_stencil.cuh", "gcm_pow.cu"):
        shutil.copy(os.path.join(cuda_lib.CSRC_DIR, fname), tmp_path / fname)
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(tmp_path))
    before = [cuda_lib.library_path(n)[1] for n in ("fused_parts", name)]
    with open(tmp_path / "gcm_pow.cu", "a") as f:
        f.write("// edited\n")
    after = [cuda_lib.library_path(n)[1] for n in ("fused_parts", name)]
    assert after[0] == before[0] and after[1] != before[1]


def test_only_sources_that_call_power_get_a_float64_library(tmp_path,
                                                            monkeypatch):
    """The float64 library is worked out from the sources: a source whose
    code (or an included header's) calls power has one, the FFT filter,
    which does not, launches both types from its one library."""
    for source in ("fused_parts", "mega_step", "stream_steps", "pgf_rest",
                   "mega_half"):
        assert cuda_lib.calls_power(source)
        assert cuda_lib.library_name(source, True) == source + "-f64"
    assert not cuda_lib.calls_power("fft_filter")
    assert cuda_lib.library_name("fft_filter", True) == "fft_filter"
    defines, calls = tmp_path / "defines", tmp_path / "calls"
    for d in (defines, calls):
        d.mkdir()
        (d / "a.cu").write_text('#include "b.cuh"\n// power(x, y)\n')
    (defines / "b.cuh").write_text(
        "__device__ float power(float x, float y) { return powf(x, y); }\n")
    (calls / "b.cuh").write_text('#include "c.cuh"\n#include <math.h>\n')
    (calls / "c.cuh").write_text("float f(float x) { return power(x, 2.f); }")
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(defines))
    assert cuda_lib.library_name("a", True) == "a"
    monkeypatch.setattr(cuda_lib, "CSRC_DIR", str(calls))
    assert cuda_lib.library_name("a", True) == "a-f64"
    assert cuda_lib.library_name("a", False) == "a"


def test_build_keeps_the_compiler_log_beside_the_library(tmp_path,
                                                         monkeypatch):
    """nvcc's log (ptxas' report) is moved into place with the library, so
    a library found built still has its report."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_lib, "nvcc_path", lambda: "nvcc")

    def run(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("library")
        return types.SimpleNamespace(returncode=0, stdout="ptxas info: log")

    monkeypatch.setattr(cuda_lib.subprocess, "run", run)
    assert cuda_lib.build_log("fft_filter") is None
    assert cuda_lib.build("fft_filter") == "ptxas info: log"
    assert cuda_lib.build("fft_filter") is None  # found built
    assert cuda_lib.build_log("fft_filter") == "ptxas info: log"
    assert sorted(os.listdir(tmp_path)) == [
        os.path.basename(cuda_lib.library_path("fft_filter")[1]) + ext
        for ext in ("", ".log")]


def test_build_many_builds_every_source(monkeypatch):
    seen = []
    monkeypatch.setattr(cuda_lib, "build",
                        lambda name: seen.append(name) or f"log {name}")
    out = cuda_lib.build_many(["fused_parts", "mega_step"])
    assert sorted(seen) == ["fused_parts", "mega_step"]
    assert {k: v[0] for k, v in out.items()} == {
        "fused_parts": "log fused_parts", "mega_step": "log mega_step"}


def test_nvcc_missing_raises(monkeypatch):
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "isfile", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.nvcc_path()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12),
                                         (torch.float32, 1e-5)])
@pytest.mark.parametrize("coriolis,q_limiter,hill", [
    (False, False, False), (True, True, True)])
def test_kernel_matches_plain_version_on_gpu(cuda_device, dtype, bound,
                                             coriolis, q_limiter, hill):
    jg = _geom(hill)
    geom = port_geom(jg).to(dtype=dtype, device=cuda_device)
    args = [x.to(dtype=dtype, device=cuda_device)
            for x in as_torch(_k1_args(jg, seed=3))]
    before = fused_parts.launches
    out = fused_parts(*args, 900.0, geom, coriolis=coriolis,
                      q_limiter=q_limiter)
    torch.cuda.synchronize()
    assert fused_parts.launches == before + 1
    ref = fused_parts_ref(*args, 900.0, geom, coriolis=coriolis,
                          q_limiter=q_limiter)
    for name, a, b in zip(OUTS, out, ref):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= bound, (name, err)


@pytest.mark.gpu
def test_fused_step_on_gpu_launches_k1_on_an_off_tile_grid(cuda_device):
    jg = jgeometry.gen_geometry(24, 36, 9)
    tg = port_geom(jg)
    s = as_torch(random_state(jg, seed=2))
    before = fused_parts.launches
    out = fused.make_fused_step(tg.to(device=cuda_device), 300.0)(
        *[x.to(cuda_device) for x in s])
    torch.cuda.synchronize()
    assert fused_parts.launches == before + 2
    ref = core25d.matsuno_timestep(*s, 300.0, tg)
    assert_close(out, [x.numpy() for x in ref], 1e-12, 1e-12, FIELDS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 512, 1024), (9, 24, 36), (3, 20, 100),
                                   (1, 2, 36), (32, 16, 128)])
def test_kernel_tiles_equal_plain_version_on_gpu(cuda_device, dtype, shape):
    """K1 (its pgf column pass and its tiled launch with the aflux
    prologue) equals its plain version bit for bit on the main path's grid
    and on grids off every tile multiple (32 columns, 8 rows a tile),
    smaller than one tile and at kMaxLayers, with Coriolis, the q limiter
    and a hill, and counts each stage's launch."""
    L, H, W = shape
    hm = np.zeros((H, W))
    hm[H // 4:H // 2 + 1, W // 8:W // 3] = 1500.0
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=torch.float64,
                                 device="cpu")
    base, seval = random_prognostics(geom, 44), random_prognostics(geom, 45)
    spu = tpolar.arakawa_1977(core25d.calc_pu(seval[0], seval[1]), geom)
    args = [x.to(device=cuda_device, dtype=dtype)
            for x in (*base, *seval, spu)]
    geom = geom.to(dtype=dtype, device=cuda_device)
    counts = (fused_parts, column_pass, parts_stencil)
    before = [c.launches for c in counts]
    out = fused_parts(*args, 300.0, geom, coriolis=True, q_limiter=True)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counts, before)] == [1, 1, 1]
    ref = fused_parts_ref(*args, 300.0, geom, coriolis=True, q_limiter=True)
    for name, a, b in zip(OUTS, out, ref):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


def test_pgf_column_on_cpu_runs_its_plain_version():
    """K1's column pass alone on CPU tensors is core25d.pgf_column, whose
    rho and phi give core25d.pgf's forces; nothing is launched."""
    jg = _geom(hill=True)
    geom = port_geom(jg)
    sp, _, _, st, _ = as_torch(random_state(jg, seed=7))
    before = column_pass.launches
    rho, phi = pgf_column(sp, st, geom)
    assert column_pass.launches == before
    ref = core25d.pgf_column(sp, st, geom)
    assert torch.equal(rho, ref[0]) and torch.equal(phi, ref[1])
    assert rho.shape == phi.shape == st.shape


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 512, 1024), (9, 24, 36), (3, 20, 100),
                                   (1, 2, 36), (32, 16, 128)])
def test_pgf_column_equals_plain_version_on_gpu(cuda_device, dtype, shape):
    """K1's column pass alone equals core25d.pgf_column bit for bit (at
    float64 through the library whose double pow rounds as PyTorch's) and
    counts its launch."""
    L, H, W = shape
    hm = np.zeros((H, W))
    hm[H // 4:H // 2 + 1, W // 8:W // 3] = 1500.0
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=torch.float64,
                                 device="cpu")
    sp, _, _, st, _ = random_prognostics(geom, 49)
    sp, st = (x.to(device=cuda_device, dtype=dtype) for x in (sp, st))
    geom = geom.to(dtype=dtype, device=cuda_device)
    before = column_pass.launches
    out = pgf_column(sp, st, geom)
    torch.cuda.synchronize()
    assert column_pass.launches == before + 1
    for name, a, b in zip(("rho", "phi"), out,
                          core25d.pgf_column(sp, st, geom)):
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
