"""PyTorch port: the adaptive convective adjustment's kernel
(``ops/convection.py``, ``csrc/convection.cu``) and where it runs.

On the CPU: ``convective_adjustment`` runs its plain loop for CPU tensors
and, on every device, for ``adaptive=False`` (the plain twin of K7's
epilogue), even where the wrappers take their kernel paths; the wrapper
refuses what the kernel does not take.  The kernel's own arithmetic is
held to the plain loop in ``test_torch_host_emulation.py``.

On the card (``gpu``): the kernel equals the plain adaptive loop (run on
the card by turning :func:`ops.convection.on_card` off) to the bit at
9x512x1024 and 9x24x36, float32 and float64; a profiled call reads
nothing on the host; its largest sweep count is the plain loop's sweeps.
"""

import shutil

import numpy as np
import pytest
import torch

from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.ops import convection as cv
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.physics import convection
from torch_host_emulation import kernels_on_cpu

torch.set_num_threads(1)

READ = "aten::_local_scalar_dense"


def _field(shape, dtype, device, seed=3):
    """(tt, tp, dp) in ``dtype`` on ``device``: a warm, noisy lower column
    with many superadiabatic pairs (tests/test_torch_physics.py's
    _unstable_column recipe) on the Manabe sigma ladder."""
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(1e5 * (1 + 0.01 * rng.standard_normal((H, W))))
    tt = 280.0 + 8.0 * rng.standard_normal((L, H, W))
    tt[:3] += np.array([40.0, 20.0, 8.0])[:, None, None]
    tp = p * geom.sig.reshape(L, 1, 1) + geom.ptop
    dp = p * geom.dsig.reshape(L, 1, 1)
    return tuple(x.to(dtype=dtype, device=device)
                 for x in (torch.as_tensor(tt), tp, dp))


def _reads(fn):
    """``fn()`` and the host reads it made."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    return out, sum(e.name == READ for e in prof.events())


def test_fixed_sweeps_and_cpu_tensors_run_the_plain_loop(tmp_path):
    """``adaptive=False`` runs the plain loop even where the wrappers take
    their kernel paths; CPU tensors take it too; neither launches."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host emulation")
    tt, tp, dp = _field((9, 4, 5), torch.float64, "cpu")
    before = cv.column_adjustment.launches
    plain = convection.convective_adjustment(tt, tp, dp, adaptive=False,
                                             sweeps=4)
    with kernels_on_cpu(str(tmp_path)):
        fixed, reads = _reads(lambda: convection.convective_adjustment(
            tt, tp, dp, adaptive=False, sweeps=4))
    assert cv.column_adjustment.launches == before
    assert torch.equal(fixed, plain) and reads == 0
    adaptive, reads = _reads(
        lambda: convection.convective_adjustment(tt, tp, dp))
    assert cv.column_adjustment.launches == before
    assert reads >= 2 and not torch.equal(adaptive, tt)


def test_both_types_launch_from_one_library():
    """``convection.cu`` calls no ``power``, so no float64 library of its
    own is built: its float64 kernel is the one whose ptxas report
    chip_smoke.py checks."""
    assert not cuda_lib.calls_power("convection")
    assert cuda_lib.library_name("convection", True) == "convection"


def test_a_single_layer_comes_back_as_it_is():
    tt = torch.ones(1, 3, 4)
    assert convection.convective_adjustment(tt, tt, tt) is tt


@pytest.mark.parametrize("case,error", [
    ("float16", TypeError), ("one layer", ValueError),
    ("too many layers", ValueError), ("table shape", ValueError),
    ("table dtype", ValueError), ("dp shape", ValueError),
    ("table layout", ValueError)])
def test_the_kernel_refuses_what_it_does_not_take(case, error):
    """Checked before any launch, so CPU tensors show it."""
    L, H, W = 4, 3, 5
    tt = torch.zeros(L, H, W)
    dp = torch.ones(L, H, W)
    lr = torch.zeros(L - 1, H, W)
    im = torch.zeros(L - 1, H, W)
    if case == "float16":
        tt = tt.half()
    elif case == "one layer":
        tt = tt[:1]
    elif case == "too many layers":
        tt = torch.zeros(33, H, W)
    elif case == "table shape":
        lr = torch.zeros(L, H, W)
    elif case == "table dtype":
        im = im.double()
    elif case == "dp shape":
        dp = dp[:, :, :2]
    else:
        lr = torch.zeros(L - 1, W, H).transpose(1, 2)
    with pytest.raises(error):
        cv.column_adjustment(tt, dp, lr, im, convection.CRITICAL_LAPSE,
                             2 * L)


# ---------------------------------------------------------------------------
# on the card

def _plain_on_card(monkeypatch, tt, tp, dp):
    """The plain adaptive loop on the card and its sweeps (one host read
    a sweep)."""
    with monkeypatch.context() as m:
        m.setattr(cv, "on_card", lambda tt: False)
        out, reads = _reads(
            lambda: convection.convective_adjustment(tt, tp, dp))
    return out, reads


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 512, 1024), (9, 24, 36)])
def test_kernel_equals_plain_adaptive_loop_on_the_card(monkeypatch, shape,
                                                       dtype):
    """One launch, no host read, the plain loop's field to the bit, and
    the plain loop's sweep count as the largest a column ran; the mixed
    field's isothermal columns keep their values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tt, tp, dp = _field(shape, dtype, "cuda")
    tt[:, :, 1::2] = 250.0  # stable columns among the unstable ones
    ref, sweeps = _plain_on_card(monkeypatch, tt, tp, dp)
    assert sweeps >= 2
    convection.convective_adjustment(tt, tp, dp)  # warm: build and load
    torch.cuda.synchronize()
    cv.sweeps_max("cuda", reset=True)
    before = cv.column_adjustment.launches
    out, reads = _reads(lambda: convection.convective_adjustment(tt, tp, dp))
    torch.cuda.synchronize()
    assert cv.column_adjustment.launches == before + 1
    assert reads == 0
    assert torch.equal(out, ref)
    assert torch.equal(out[:, :, 1::2], tt[:, :, 1::2])
    assert cv.sweeps_max("cuda") == sweeps


@pytest.mark.gpu
def test_step_profile_reports_the_most_sweeps_a_column_ran():
    """``step_profile --surface`` on GCM-II's grid: its line's
    ``convection_sweeps_max`` is read once after the timed steps, between
    one and 2L; the only host read of the run is the step counter's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gcmiipy_tpu_torch import step_profile
    line = step_profile.profile_backend("mega4", 24, 36, 9, 225.0, 4,
                                        torch.device("cuda", 0),
                                        surface=True)
    assert 1 <= line["convection_sweeps_max"] <= 18
    assert line["spans"]["gcm.sync"]["calls"] == 1 / 4
