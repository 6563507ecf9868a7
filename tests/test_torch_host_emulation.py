"""PyTorch port: the CUDA sources' own code paths on the CPU.

``torch_host_emulation`` (beside this file) builds ``csrc/*.cu`` with the host
compiler (skipped without ``g++``) against an emulation of the CUDA subset
they use, and the wrappers take CPU tensors down their kernel paths.  K1
and K4 (the rest tile in both of its forms, each with its aflux prologue),
K5 (a half step's three launches), K6 (a whole step's six, the FFT filter
among them) and K7 with its physics are held against their plain versions
at float64 on grids off the tiles and smaller than one: K4 to the bit
where no ``sin`` enters, and otherwise within 1e-12 of each field's scale
(1e-11 after a K5 half, a K6 step or a K7 call), since the host's ``pow``
and ``sin`` round apart from PyTorch's.  Without Coriolis (no ``sin``) K4,
and K1 and its column pass alone with the plain version's ``pow`` made
the host's (``host_pow``), are held to the bit at float32 and float64,
flat and with a hill, on these grids, at kMaxLayers and off the tiles.  K3, the pgf tile, is held
to the bit at float32 and float64 against its plain version with the
host's ``pow``, its one library function.  The column-physics epilogue alone is held
within 1e-14 (float64) and 1e-6 (float32) of each field's scale: its
``pow``, ``log``, ``sin`` and ``cos`` are the host's.  The launches of the
pgf tile, the rest stencil and the epilogue are counted where the C
entries make them.  The adaptive convection's kernel equals its plain
loop to the bit at both types, with the plain version's ``x / c`` made
the card's ``x * (1/c)`` (``card_division``), and keeps its largest
sweep count where the plain loop's host reads count its sweeps.  Each
column kernel's held and deep forms, forced in copies of ``csrc/``, agree
to the bit at 9 and 40 layers.  The four-band radiation's kernel with its
update is held to the plain function and the update within
``RADIATION_REL`` of each field's scale at 9 and 40 layers, with opaque
and night-side columns, and its wrapper refuses what the kernel does not
take.
"""

import shutil

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model.state import random_prognostics
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops import fused_parts as fp
from gcmiipy_tpu_torch.ops import mega_step as ms
from gcmiipy_tpu_torch.ops import pgf_rest as pr
from gcmiipy_tpu_torch.ops import convection as cv
from gcmiipy_tpu_torch.ops import polar_filter
from gcmiipy_tpu_torch.ops import radiation as rop
from gcmiipy_tpu_torch.ops import stream_steps as ss
from gcmiipy_tpu_torch.ops.fft_filter import fft_filter_ref
from gcmiipy_tpu_torch.physics import convection, radiation
from torch_host_emulation import (card_division, host_pow, kernels_on_cpu,
                                  rewrite_launches)

torch.set_num_threads(1)

DT = 300.0
GRIDS = [(3, 20, 36), (1, 2, 36), (4, 13, 70)]
# and 32 layers, and a grid off the tiles (19 rows: 8 does not divide it;
# 45 columns)
PGF_GRIDS = GRIDS + [(32, 20, 36), (5, 19, 45)]
# the deep forms: 40 layers, and kMaxLayers off the tiles
DEEP_GRIDS = [(40, 20, 36), (64, 19, 45)]


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host emulation")
    return str(tmp_path_factory.mktemp("host_emulation"))


def _geom(shape, hill, dtype=torch.float64):
    L, H, W = shape
    hm = None
    if hill:
        hm = np.zeros((H, W))
        hm[H // 4:H // 2 + 1, W // 8:W // 3] = 1500.0
    return geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 heightmap=hm, dtype=torch.float64,
                                 device="cpu").to(dtype=dtype)


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


def _k4_args(shape, hill, dtype):
    """K4's arguments in ``dtype``: random base and evaluated states, the
    evaluated state's filtered stack and pg_phiv, made at float64."""
    geom = _geom(shape, hill)
    base, seval = random_prognostics(geom, 63), random_prognostics(geom, 64)
    stack, pg_phiv = pr.pgf_parts_ref(seval[0], seval[1], seval[3], geom)
    fields = (*base, *seval, polar_filter.arakawa_1977(stack, geom), pg_phiv)
    return (*(x.to(dtype) for x in fields), DT, _geom(shape, hill, dtype))


@pytest.mark.parametrize("hill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PGF_GRIDS + DEEP_GRIDS)
def test_rest_parts_source_equals_plain_version_to_the_bit(build_dir, shape,
                                                          dtype, hill):
    """K4, one launch of the rest tile (aflux in its prologue, sd in shared
    memory only), equals rest_parts_ref bit for bit with the q limiter, at
    both types, and counts its launch."""
    args = _k4_args(shape, hill, dtype)
    before = pr.rest_parts.launches, pr.rest_stencil.launches
    with kernels_on_cpu(build_dir):
        out = pr.rest_parts(*args, q_limiter=True)
    assert (pr.rest_parts.launches, pr.rest_stencil.launches) == (
        before[0] + 1, before[1] + 1)
    ref = pr.rest_parts_ref(*args, q_limiter=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("hill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PGF_GRIDS + DEEP_GRIDS)
def test_fused_parts_source_equals_plain_version_to_the_bit(build_dir, shape,
                                                           dtype, hill):
    """K1 (the pgf column pass, then the tiled launch with the aflux
    prologue) equals fused_parts_ref bit for bit with the q limiter when
    both take the host's pow, at both types, and counts each launch."""
    geom = _geom(shape, hill)
    base, seval = random_prognostics(geom, 65), random_prognostics(geom, 66)
    spu = polar_filter.arakawa_1977(core25d.calc_pu(seval[0], seval[1]),
                                    geom)
    args = (*(x.to(dtype) for x in (*base, *seval, spu)), DT,
            _geom(shape, hill, dtype))
    counts = (fp.fused_parts, fp.column_pass, fp.parts_stencil)
    before = [c.launches for c in counts]
    with kernels_on_cpu(build_dir):
        out = fp.fused_parts(*args, q_limiter=True)
    assert [c.launches - b for c, b in zip(counts, before)] == [1, 1, 1]
    with host_pow():
        ref = fp.fused_parts_ref(*args, q_limiter=True)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("hill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PGF_GRIDS + DEEP_GRIDS)
def test_pgf_column_source_equals_plain_version_to_the_bit(build_dir, shape,
                                                          dtype, hill):
    """K1's column pass alone (C entry gcm_pgf_column: one pass over k
    and the ladder in place, no per-layer array) equals core25d.pgf_column
    bit for bit with the host's pow, and counts its launch."""
    geom = _geom(shape, hill, dtype)
    sp, _, _, st, _ = (x.to(dtype) for x in
                       random_prognostics(_geom(shape, hill), 67))
    before = fp.column_pass.launches
    with kernels_on_cpu(build_dir):
        out = fp.pgf_column(sp, st, geom)
    assert fp.column_pass.launches == before + 1
    with host_pow():
        ref = core25d.pgf_column(sp, st, geom)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), float((a - b).abs().max() / b.abs().max())


def test_mega_step_source_matches_plain_version(build_dir):
    geom = _geom((3, 20, 36), True)
    state = random_prognostics(geom, 55)
    step = ms.MegaStep(geom, DT, coriolis=True, q_limiter=True)
    before = (ms.mega_step.launches, pr.rest_stencil.launches,
              pr.pgf_tile.launches)
    with kernels_on_cpu(build_dir):
        out = step(*state)
    assert (ms.mega_step.launches, pr.rest_stencil.launches,
            pr.pgf_tile.launches) == (before[0] + 1, before[1] + 2,
                                      before[2] + 2)
    fc = step.consts
    ref = ms.mega_step_ref(*state, DT, geom, fc, coriolis=True,
                           q_limiter=True,
                           filter_ref=lambda X: fft_filter_ref(X, fc))
    assert _scaled_err(out, ref) <= 1e-11
    assert bool((out[2][:, -1] == 0).all())


def test_mega_half_source_matches_plain_version(build_dir):
    """K5, a corrector half (the pgf tile, the filter and the rest tile once
    each), against mega_half_ref with the kernel's FFT plan."""
    from gcmiipy_tpu_torch.ops import mega_half as mh
    geom = _geom((3, 20, 36), True)
    base, seval = random_prognostics(geom, 61), random_prognostics(geom, 62)
    half = mh.MegaHalf(geom, DT, coriolis=True, q_limiter=True)
    before = (mh.mega_half.launches, pr.pgf_tile.launches,
              pr.rest_stencil.launches)
    with kernels_on_cpu(build_dir):
        out = half(base, seval)
    assert (mh.mega_half.launches, pr.pgf_tile.launches,
            pr.rest_stencil.launches) == (before[0] + 1, before[1] + 1,
                                          before[2] + 1)
    fc = half.consts
    ref = mh.mega_half_ref(base, seval, DT, geom, fc, coriolis=True,
                           q_limiter=True,
                           filter_ref=lambda X: fft_filter_ref(X, fc))
    assert _scaled_err(out, ref) <= 1e-11
    assert bool((out[2][:, -1] == 0).all())


@pytest.mark.parametrize("hill", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", PGF_GRIDS + DEEP_GRIDS)
def test_pgf_parts_source_equals_plain_version_to_the_bit(build_dir, shape,
                                                         dtype, hill):
    """K3, one launch of the pgf tile, equals pgf_parts_ref bit for bit
    when both take the host's pow, and counts its launch."""
    geom = _geom(shape, hill, dtype)
    sp, su, _, st, _ = (x.to(dtype) for x in
                        random_prognostics(_geom(shape, hill), 58))
    before = pr.pgf_parts.launches, pr.pgf_tile.launches
    with kernels_on_cpu(build_dir):
        out = pr.pgf_parts(sp, su, st, geom)
    assert (pr.pgf_parts.launches, pr.pgf_tile.launches) == (
        before[0] + 1, before[1] + 1)
    with host_pow():
        ref = pr.pgf_parts_ref(sp, su, st, geom)
    for a, b in zip(out, ref):
        assert torch.equal(a, b), float((a - b).abs().max() / b.abs().max())


def _physics_args(shape, dtype, **kw):
    """The epilogue's arguments: a random state's p, u, v, t, a ground
    temperature, the clock, the geometry, dt and the parameters."""
    L, H, W = shape
    geom = _geom(shape, False)
    p, u, v, t, _ = random_prognostics(geom, 59)
    gt = torch.as_tensor(290.0 + 20.0 * np.random.default_rng(59).random(
        (H, W)))
    geom = geom.to(dtype=dtype)
    return (*(x.to(dtype) for x in (p, u, v, t, gt)),
            torch.tensor(3.1e4, dtype=dtype), geom, DT,
            ss.make_physics(geom, **kw))


@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-14),
                                         (torch.float32, 1e-6)])
@pytest.mark.parametrize("shape,kw", [
    ((9, 13, 140), {}),
    ((9, 13, 140), {"convection": True}),
    ((9, 13, 140), {"drag_tau": 7200.0}),
    ((9, 13, 140), {"convection": True, "drag_tau": 86400.0,
                    "seasonal": True}),
    ((32, 4, 36), {"convection": True, "drag_tau": 86400.0}),
    ((40, 4, 140), {"convection": True, "drag_tau": 86400.0,
                    "seasonal": True}),
    ((64, 3, 36), {"convection": True, "drag_tau": 86400.0})])
def test_column_physics_source_matches_plain_version(build_dir, shape, kw,
                                                     dtype, bound):
    """The epilogue alone (C entry gcm_column_physics) against
    physics_epilogue_ref, with and without the sweeps and the drag, at a
    width of two blocks (140), at 32 layers, and in its deep form at 40
    layers and at kMaxLayers, whose float64 block is within the card's
    shared memory: within ``bound`` of each field's scale, the host's pow,
    log, sin and cos rounding apart from PyTorch's.  The inputs are not
    changed."""
    args = _physics_args(shape, dtype, **kw)
    kept = [x.clone() for x in args[:5]]
    before = ss.column_physics.launches
    with kernels_on_cpu(build_dir):
        out = ss.column_physics(*args)
    assert ss.column_physics.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(args[:5], kept))
    ref = ss.physics_epilogue_ref(*args)
    assert _scaled_err(out, ref) <= bound
    moved = float((ref[2] - args[3]).abs().max() / args[3].abs().max())
    assert moved > 1e-5  # the epilogue did work


@pytest.mark.parametrize("L", [3, 40])
def test_stream_steps_source_matches_plain_version(build_dir, L):
    """K7 with the physics (4 steps: the pgf tile, the filter and the rest
    tile twice a step, the epilogue once) against stream_steps_ref with the
    kernel's FFT plan; at 40 layers every stage in its deep form."""
    H, W = 20, 36
    geom = _geom((L, H, W), True)
    gt = torch.as_tensor(290.0 + 20.0 * np.random.default_rng(60).random(
        (H, W)))
    packed = ss.pack_state(*random_prognostics(geom, 60), gt=gt)
    S = torch.stack([packed, torch.zeros_like(packed)])
    ph = ss.make_physics(geom, drag_tau=86400.0, convection=True,
                         seasonal=True)
    fc = ms.build_filter_consts(geom)
    utc0 = torch.tensor(7200.0, dtype=torch.float64)
    counts = (pr.pgf_tile, pr.rest_stencil, ss.column_physics)
    before = [c.launches for c in counts]
    with kernels_on_cpu(build_dir):
        out = ss.stream_steps(S.clone(), utc0, 4, DT, geom, fc,
                              coriolis=True, physics=ph)
    assert [c.launches - b for c, b in zip(counts, before)] == [8, 8, 4]
    ref = ss.stream_steps_ref(S.clone(), utc0, 4, DT, geom, fc,
                              coriolis=True, physics=ph,
                              filter_ref=lambda X: fft_filter_ref(X, fc))
    assert _scaled_err(list(out[0]), list(ref[0])) <= 1e-11


@pytest.mark.parametrize("shard", [0, 3])
def test_mega_step_shard_source_matches_plain_version(build_dir, shard):
    """K6's shard form on one rank's block of a ring of 4 (8 core rows and
    PHJ = 8 halo rows a side, the block's row tables, the wall from the
    global row: in the halo of shard 0, in the core of shard 3), against
    its plain version on the block, and its core rows against K6 on the
    whole globe to the bit."""
    from gcmiipy_tpu_torch.parallel.mesh import block_rows
    geom = _geom((3, 32, 36), True)
    state = random_prognostics(geom, 71)
    rows = block_rows(32, 4, shard, 8)
    step = ms.MegaStep(geom, DT, coriolis=True, rows=rows)
    block = [x[..., rows, :].contiguous() for x in state]
    before = ms.mega_step_shard.launches
    with kernels_on_cpu(build_dir):
        out = step(*block)
        whole = ms.MegaStep(geom, DT, coriolis=True)(*state)
    assert ms.mega_step_shard.launches == before + 1
    fc = step.consts
    ref = ms.mega_step_ref(*block, DT, step.geom, fc, coriolis=True,
                           filter_ref=lambda X: fft_filter_ref(X, fc))
    assert _scaled_err(out, ref) <= 1e-11
    core = slice(8, 16)
    for a, b in zip(out, whole):
        assert torch.equal(a[..., core, :],
                           b[..., shard * 8:(shard + 1) * 8, :])
    assert bool((out[2][:, rows == 31] == 0).all())


@pytest.mark.parametrize("shard", [0, 3])
def test_stream_steps_shard_source_matches_plain_version(build_dir, shard):
    """K7's shard form (2 steps, no physics) on one rank's block of a ring
    of 4 (16 core rows and 2*PHJ halo rows a side), against its plain
    version on the block, and its core rows against K7 on the whole globe
    to the bit."""
    from gcmiipy_tpu_torch.parallel.mesh import block_rows
    L, H, W = 3, 64, 36
    geom = _geom((L, H, W), True)
    packed = ss.pack_state(*random_prognostics(geom, 72))
    S = torch.stack([packed, torch.zeros_like(packed)])
    rows = block_rows(H, 4, shard, 16)
    multi = ss.StreamSteps(geom, DT, coriolis=True, rows=rows)
    block = S[:, :, rows].contiguous()
    before = ss.stream_steps_shard.launches
    utc0 = torch.zeros((), dtype=torch.float64)
    with kernels_on_cpu(build_dir):
        out = multi(block.clone(), None, 2)
        whole = ss.StreamSteps(geom, DT, coriolis=True)(S.clone(), utc0, 2)
    assert ss.stream_steps_shard.launches == before + 1
    fc = multi.consts
    ref = ss.stream_steps_ref(block.clone(), utc0, 2, DT, multi.geom, fc,
                              coriolis=True,
                              filter_ref=lambda X: fft_filter_ref(X, fc))
    assert _scaled_err(list(out[0]), list(ref[0])) <= 1e-11
    assert torch.equal(out[0][:, 16:32],
                       whole[0][:, shard * 16:(shard + 1) * 16])


@pytest.mark.parametrize("block", [(0, 0), (1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pgf_rest_shard_sources_match_plain_version(build_dir, block, dtype):
    """K3's and K4's shard forms on one rank's block of a 2x2 mesh (its 8 x
    18 core and a halo of EX = 3 on both axes, the block's take_block
    geometry; the first and the last block), against their plain versions
    on the block to the bit (the host's pow, no Coriolis), and their cores
    against K3 and K4 on the whole globe to the bit: the kernels read the
    block alone."""
    from gcmiipy_tpu_torch.parallel.mesh import block_cols, block_rows
    L, H, W = 3, 16, 36
    geom = _geom((L, H, W), True, dtype)
    base = [x.to(dtype) for x in random_prognostics(_geom((L, H, W), True),
                                                    81)]
    seval = [x.to(dtype) for x in random_prognostics(_geom((L, H, W), True),
                                                     82)]
    y, x = block
    rows, cols = block_rows(H, 2, y, 3), block_cols(W, 2, x, 3)
    bgeom = geom.take_block(rows, cols)

    def blk(a):
        return a[..., rows, :][..., cols].contiguous()

    core = (Ellipsis, slice(3, 11), slice(3, 21))
    whole = (Ellipsis, slice(y * 8, y * 8 + 8), slice(x * 18, x * 18 + 18))
    before = (pr.pgf_parts_shard.launches, pr.rest_parts_shard.launches)
    with kernels_on_cpu(build_dir):
        stack, pgv = pr.pgf_parts_shard(blk(seval[0]), blk(seval[1]),
                                        blk(seval[3]), bgeom)
        wstack, wpgv = pr.pgf_parts(seval[0], seval[1], seval[3], geom)
        filt = polar_filter.arakawa_1977(wstack, geom)
        args = (*map(blk, base), *map(blk, seval), blk(filt), blk(wpgv), DT,
                bgeom)
        out = pr.rest_parts_shard(*args, q_limiter=True)
        wout = pr.rest_parts(*base, *seval, filt, wpgv, DT, geom,
                             q_limiter=True)
    assert (pr.pgf_parts_shard.launches, pr.rest_parts_shard.launches) == (
        before[0] + 1, before[1] + 1)
    with host_pow():
        ref = pr.pgf_parts_ref(blk(seval[0]), blk(seval[1]), blk(seval[3]),
                               bgeom)
        rref = pr.rest_parts_ref(*args, q_limiter=True)
    for a, b, w in zip((stack, pgv), ref, (wstack, wpgv)):
        assert torch.equal(a, b)
        assert torch.equal(a[core], w[whole])
    for a, b, w in zip(out, rref, wout):
        assert torch.equal(a, b)
        assert torch.equal(a[core], w[whole])


@pytest.mark.parametrize("shard", [0, 3])
def test_mega_half_shard_source_matches_plain_version(build_dir, shard):
    """K5's shard form on one rank's block of a ring of 4 (8 core rows and
    PHJ = 8 halo rows a side, the block's row tables, the wall from the
    global row), against its plain version on the block, and its core rows
    against K5 on the whole globe to the bit."""
    from gcmiipy_tpu_torch.ops import mega_half as mh
    from gcmiipy_tpu_torch.parallel.mesh import block_rows
    geom = _geom((3, 32, 36), True)
    base, seval = random_prognostics(geom, 83), random_prognostics(geom, 84)
    rows = block_rows(32, 4, shard, 8)
    half = mh.MegaHalf(geom, DT, coriolis=True, rows=rows)
    bb = [x[..., rows, :].contiguous() for x in base]
    bs = [x[..., rows, :].contiguous() for x in seval]
    before = mh.mega_half_shard.launches
    with kernels_on_cpu(build_dir):
        out = half(bb, bs)
        whole = mh.MegaHalf(geom, DT, coriolis=True)(base, seval)
    assert mh.mega_half_shard.launches == before + 1
    fc = half.consts
    ref = mh.mega_half_ref(bb, bs, DT, half.geom, fc, coriolis=True,
                           filter_ref=lambda X: fft_filter_ref(X, fc))
    assert _scaled_err(out, ref) <= 1e-11
    for a, b in zip(out, whole):
        assert torch.equal(a[..., 8:16, :],
                           b[..., shard * 8:(shard + 1) * 8, :])
    assert bool((out[2][:, rows == 31] == 0).all())


def _convection_field(kind, L=9):
    """(tt, tp, dp) float64 of one kind: ``unstable`` is
    tests/test_torch_physics.py's _unstable_column(3) (a warm, noisy lower
    column: many superadiabatic pairs); ``stable`` is isothermal with
    noise well below any pair's critical difference; ``mixed`` alternates
    columns that run the full 2L sweeps (a lapse of 15 K a layer) with
    isothermal ones that need none, over two blocks of columns (140);
    ``warm_base`` is isothermal but for the unstable one's warm, noisy
    lowest three layers, for the deep columns (few sweeps of the plain
    loop)."""
    L, H, W = (L, 3, 140) if kind == "mixed" else (L, 4, 5)
    geom = _geom((L, H, W), False)
    sig, dsig = geom.sig.reshape(L, 1, 1), geom.dsig.reshape(L, 1, 1)
    rng = np.random.default_rng(3)
    p = torch.as_tensor(1e5 * (1 + 0.01 * rng.standard_normal((H, W))))
    tt = 280.0 + 8.0 * rng.standard_normal((L, H, W))
    if kind == "unstable":
        tt[:3] += np.array([40.0, 20.0, 8.0])[:, None, None]
    elif kind == "stable":
        tt = 250.0 + 0.05 * rng.standard_normal((L, H, W))
    elif kind == "warm_base":
        tt = np.full((L, H, W), 250.0)
        tt[:3] += (np.array([40.0, 20.0, 8.0])[:, None, None]
                   + rng.standard_normal((3, H, W)))
    else:
        tt = np.full((L, H, W), 250.0)
        tt[:, :, ::3] = (300.0 - 15.0 * np.arange(L))[:, None, None]
    return torch.as_tensor(tt), p * sig + geom.ptop, p * dsig


def _plain_adaptive(tt, tp, dp):
    """The plain adaptive loop's field and its sweeps (its host reads,
    one a sweep)."""
    with _HostReads() as reads:
        out = convection.convective_adjustment(tt, tp, dp)
    return out, reads.count


class _HostReads(TorchDispatchMode):
    """Counts the host reads (``aten::_local_scalar_dense``) of the code run
    under it."""

    count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["unstable", "stable", "mixed"])
def test_convection_source_equals_plain_adaptive_version_to_the_bit(
        build_dir, kind, dtype):
    """The adaptive convection's kernel (one launch, each column stopping
    after its own first stable sweep) against the plain loop (stopping
    after the first sweep that changed no column): the same field to the
    bit, its largest sweep count the plain loop's sweeps; a stable field
    comes back unchanged, and in the mixed one the steep columns run all
    2L sweeps while the isothermal ones keep their values."""
    tt, tp, dp = (x.to(dtype) for x in _convection_field(kind))
    with card_division():
        ref, sweeps = _plain_adaptive(tt, tp, dp)
        cv.sweeps_max("cpu", reset=True)
        before = cv.column_adjustment.launches
        with kernels_on_cpu(build_dir):
            out = convection.convective_adjustment(tt, tp, dp)
    assert cv.column_adjustment.launches == before + 1
    assert torch.equal(out, ref)
    assert cv.sweeps_max("cpu", reset=True) == sweeps
    if kind == "stable":
        assert sweeps == 1 and torch.equal(out, tt)
    else:
        assert not torch.equal(out, tt)
    if kind == "mixed":
        assert sweeps == 2 * tt.shape[0]
        keep = torch.ones(tt.shape[-1], dtype=torch.bool)
        keep[::3] = False
        assert torch.equal(out[..., keep], tt[..., keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [40, 64])
def test_deep_convection_source_equals_plain_adaptive_version_to_the_bit(
        build_dir, L, dtype):
    """The adaptive convection against the plain loop at 40 layers and at
    kMaxLayers, where float64 launches its deep form (the temperatures in
    shared memory, the masses and the tables read from device memory): the
    same field to the bit and the plain loop's sweep count."""
    tt, tp, dp = (x.to(dtype) for x in _convection_field("warm_base", L))
    with card_division():
        ref, sweeps = _plain_adaptive(tt, tp, dp)
        cv.sweeps_max("cpu", reset=True)
        with kernels_on_cpu(build_dir):
            out = convection.convective_adjustment(tt, tp, dp)
    assert torch.equal(out, ref)
    assert cv.sweeps_max("cpu", reset=True) == sweeps > 1
    assert not torch.equal(out, tt)


@pytest.fixture(scope="module")
def form_sources(tmp_path_factory):
    """{form: directory}: copies of csrc/ in which every column kernel
    launches its held or its deep form at any L."""
    root = tmp_path_factory.mktemp("forms")
    return {form: cuda_lib.forced_form_sources(form, str(root / form))
            for form in ("held", "deep")}


def _form_call(kernel, shape, dtype):
    """One call of a column kernel's op on CPU tensors of ``shape``: the
    pgf tile (K3), the rest tile (K4), the epilogue or the adaptive
    convection."""
    if kernel == "pgf_tile":
        sp, su, _, st, _ = (x.to(dtype) for x in
                            random_prognostics(_geom(shape, True), 58))
        geom = _geom(shape, True, dtype)
        return lambda: pr.pgf_parts(sp, su, st, geom)
    if kernel == "rest_tile":
        args = _k4_args(shape, True, dtype)
        return lambda: pr.rest_parts(*args, q_limiter=True)
    if kernel == "column_physics":
        args = _physics_args(shape, dtype, convection=True,
                             drag_tau=86400.0)
        return lambda: ss.column_physics(*args)
    tt, tp, dp = (x.to(dtype) for x in
                  _convection_field("unstable", shape[0]))
    return lambda: (convection.convective_adjustment(tt, tp, dp),)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [9, 40])
@pytest.mark.parametrize("kernel", ["pgf_tile", "rest_tile", "column_physics",
                                    "column_convection"])
def test_held_and_deep_forms_agree_to_the_bit(build_dir, form_sources, kernel,
                                              L, dtype):
    """Each column kernel's held and deep forms, forced at the same L
    (cuda_lib.forced_form_sources), give the same outputs to the bit, on
    a grid off the tiles with a hill; at 40 layers in float64 the held
    epilogue's block (6 arrays of L for 128 threads) exceeds the card's
    shared memory and its launch fails, which is why the deep form
    exists."""
    call = _form_call(kernel, (L, 19, 45), dtype)
    outs = {}
    with card_division():
        for form, csrc in form_sources.items():
            with cuda_lib.sources_from(csrc), kernels_on_cpu(build_dir):
                if (form, kernel, L, dtype) == ("held", "column_physics", 40,
                                                torch.float64):
                    with pytest.raises(RuntimeError, match="launch failed"):
                        call()
                    continue
                outs[form] = call()
    for form, out in outs.items():
        assert all(torch.isfinite(x).all() for x in out), form
    if "held" in outs:
        for a, b in zip(outs["held"], outs["deep"]):
            assert torch.equal(a, b), float((a - b).abs().max())


# The four-band radiation's kernel with its update against the plain
# function and the update, over each field's scale: the kernel keeps the
# plain operand order, so what is left is the host's exp and pow against
# PyTorch's (an ulp each, as EPILOGUE_REL) and the order of the sums over
# the bands and the ground's layers; float32 read 1.0e-7 here, float64
# 1.9e-16
RADIATION_REL = {torch.float32: 1e-6, torch.float64: 1e-12}
# the increments tt_n - tt and gt_n - gt at float64, over their scale:
# the field's bound above cannot see a heating off by a part in 1e4
RADIATION_STEP_REL64 = 1e-12


def _four_band_args(shape, dtype, tensors):
    """(p, tt, q, gt, albedo, utc, dt, geom, t_sw, declination) of a call:
    a noisy column of 200-300 K over a 1% pressure field, q of up to
    0.01 with the first 20 columns at 0.5 (the strong water-vapour band
    opaque: exp underflows to 0), a clock that leaves about half the
    longitudes in the night.  ``tensors``: the clock, the albedo (a land
    blend) and a seasonal declination as tensors, else the clock and the
    albedo as numbers and no declination."""
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 ptop=10.0 if L > 9 else 0.0,
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(L)
    p = torch.as_tensor(1e5 * (1 + 0.01 * rng.standard_normal((H, W))))
    tt = torch.as_tensor(200.0 + 100.0 * rng.random((L, H, W)))
    q = torch.as_tensor(0.01 * rng.random((L, H, W)))
    q[:, :, :20] = 0.5
    gt = torch.as_tensor(280.0 + 30.0 * rng.random((H, W)))
    p, tt, q, gt = (x.to(dtype) for x in (p, tt, q, gt))
    geom = geom.to(dtype=dtype)
    if tensors:
        albedo = torch.as_tensor(0.3 + 0.05 * rng.random((H, W)), dtype=dtype)
        utc = torch.tensor(3.1e4, dtype=dtype)
        declination = radiation.solar_declination(
            torch.tensor(1.2e7, dtype=dtype))
    else:
        albedo, utc, declination = 0.3, 5.0e4, 0.0
    return p, tt, q, gt, albedo, utc, 600.0, geom, 0.9, declination


def _four_band_plain(p, tt, q, gt, albedo, utc, dt, geom, t_sw, declination):
    dt_air, dt_ground = radiation.four_band_radiation(
        p, None, tt, q, gt, t_sw, albedo, utc, geom, declination=declination)
    return tt + dt_air * dt, gt + dt_ground * dt


@pytest.mark.parametrize("tensors", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 5, 140), (40, 3, 45)])
def test_four_band_source_matches_plain_version(build_dir, shape, dtype,
                                                tensors):
    """One launch gives the plain function's update within
    ``RADIATION_REL`` of each field's scale (float64: the increments too),
    over two blocks of columns with opaque ones and night-side ones, at 9
    layers and at 40 under a 10 Pa top; the inputs are not changed and the
    update moves both fields."""
    args = _four_band_args(shape, dtype, tensors)
    p, tt, q, gt, albedo, utc, dt, geom, t_sw, declination = args
    kept = [x.clone() for x in (p, tt, q, gt)]
    assert bool((radiation.four_band_transmittances(p, q, geom)[0] == 0)
                .any())
    sza = radiation.zenith_angle(geom.long, geom.lat, utc,
                                 declination=declination)
    assert 0.2 < float((sza == 0).double().mean()) < 0.8
    with card_division():
        ref = _four_band_plain(*args)
        before = rop.four_band_column.launches
        with kernels_on_cpu(build_dir):
            out = rop.four_band_column(*args[:-1], declination=declination)
    assert rop.four_band_column.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip((p, tt, q, gt), kept))
    assert _scaled_err(out, ref) <= RADIATION_REL[dtype]
    steps = [(a - x, b - x) for a, b, x in zip(out, ref, (tt, gt))]
    for _, step in steps:
        assert float(step.abs().max()) > 0.02
    if dtype == torch.float64:
        assert _scaled_err(*zip(*steps)) <= RADIATION_STEP_REL64


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("too many layers", ValueError),
    ("not contiguous", ValueError), ("albedo shape", ValueError),
    ("q dtype", ValueError), ("clock dtype", ValueError),
    ("geometry", ValueError)])
def test_four_band_kernel_refuses_what_it_does_not_take(case, error):
    """Checked before any launch, so CPU tensors show it."""
    p, tt, q, gt, albedo, utc, dt, geom, t_sw, _ = _four_band_args(
        (4, 3, 5), torch.float32, True)
    if case == "float16":
        p, tt, q, gt, albedo = (x.half() for x in (p, tt, q, gt, albedo))
    elif case == "too many layers":
        tt = q = torch.full((rop.MAX_LAYERS + 1, 3, 5), 250.0)
    elif case == "not contiguous":
        tt = tt.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "albedo shape":
        albedo = albedo[:, :2]
    elif case == "q dtype":
        q = q.double()
    elif case == "clock dtype":
        utc = utc.double()
    else:
        geom = _geom((5, 3, 5), False, torch.float32)
    with pytest.raises(error):
        rop.four_band_column(p, tt, q, gt, albedo, utc, dt, geom, t_sw)
