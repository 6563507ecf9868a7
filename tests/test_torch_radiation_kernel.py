"""PyTorch port: the four-band radiation's kernel (``ops/radiation.py``,
``csrc/radiation.cu``) and where it runs.

On the CPU: ``solar_timestep`` runs the plain :func:`four_band_radiation`
and its update for CPU tensors, and the kernel where the wrappers take
their kernel paths (the host emulation), one launch a call, within
``RADIATION_REL`` of the plain path.  The kernel's own arithmetic is held
to the plain function in ``test_torch_host_emulation.py``.

On the card (``gpu``): the kernel against the plain function and update
run on the card (:func:`ops.radiation.on_card` turned off) at 9x512x1024,
9x24x36 and 40x64x128, float32 and float64, within ``RADIATION_REL``; a
profiled call reads nothing on the host and makes one launch; a
``make_run_fn`` interval of the four-band surface physics on 'stream'
launches it once a physics call.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from gcmiipy_tpu_torch.grid import geometry
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.model.state import GroundVars, moist_start
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops import radiation as rop
from gcmiipy_tpu_torch.physics import radiation
from torch_host_emulation import card_division, kernels_on_cpu

torch.set_num_threads(1)

READ = "aten::_local_scalar_dense"
# the kernel against the plain function, over each field's scale (as
# test_torch_host_emulation.py's, whose reason holds on the card: the
# card's exp and pow are PyTorch's, the sums' order is not)
RADIATION_REL = {torch.float32: 1e-6, torch.float64: 1e-12}
# Config S's radiation (gcmbench's gcm2-surface), at any grid
SURFACE = dict(topography="hansen", land_cover="hansen", physics=True,
               physics_every=2, convection=True, radiation="4band",
               evaporation=True, gw0=0.05, precipitation=True, rh_crit=0.8,
               drag_tau=86400.0, shapiro_every=4, shapiro_fields="pt",
               shapiro_slp=True, backend="stream", stream_steps=20,
               guard=True, stats=True, guard_p_max=115000.0)


def _column(shape, dtype, device, seed=5):
    """(p, t, q, gt, geom): a noisy potential temperature column over a
    1% pressure field, humid enough that the strong water-vapour band is
    opaque in some columns, the ground 280-310 K, and a land fraction
    that runs from 0 to 1 along each row."""
    L, H, W = shape
    geom = geometry.gen_geometry(H, W, L, sig_func=geometry.manabe_sig,
                                 ptop=10.0 if L > 9 else 0.0,
                                 dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(seed)
    p = torch.as_tensor(1e5 * (1 + 0.01 * rng.standard_normal((H, W))))
    t = torch.as_tensor(260.0 + 40.0 * rng.random((L, H, W)))
    q = torch.as_tensor(0.02 * rng.random((L, H, W)) ** 2)
    gt = torch.as_tensor(280.0 + 30.0 * rng.random((H, W)))
    geom = dataclasses.replace(geom, land_fraction=torch.linspace(
        0, 1, W, dtype=torch.float64).expand(H, W).contiguous())
    return (*(x.to(dtype=dtype, device=device) for x in (p, t, q, gt)),
            geom.to(dtype=dtype, device=device))


def _config(**kw):
    return ModelConfig(**dict(dict(SURFACE, backend="mega4"), **kw))


def _solar(p, t, q, gt, geom, config, utc):
    """``solar_timestep`` without the convection: (t, gt)."""
    g = GroundVars(gt, torch.zeros_like(gt), torch.zeros_like(gt),
                   torch.zeros_like(gt))
    t_n, g_n = driver.solar_timestep(t, p, g, 60.0, utc, geom,
                                     config, q=q)
    return t_n, g_n.gt


def _err(out, ref):
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(out, ref))


def test_the_float64_kernel_has_a_library_of_its_own():
    """The kernel calls ``power``, so its float64 tensors launch the
    library that links the double ``pow`` PyTorch's kernels round as."""
    assert cuda_lib.calls_power("radiation")
    assert cuda_lib.library_name("radiation", True) == "radiation-f64"


@pytest.mark.parametrize("land", [True, False])
def test_solar_timestep_takes_the_kernel_where_the_wrappers_do(tmp_path,
                                                               land):
    """CPU tensors run the plain function (no launch); where the wrappers
    take their kernel paths, ``solar_timestep`` launches the kernel once,
    and the result is the plain path's within ``RADIATION_REL``; with and
    without the land cover's albedo field."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host emulation")
    p, t, q, gt, geom = _column((9, 4, 36), torch.float64, "cpu")
    config = _config(convection=False,
                     land_cover="hansen" if land else "none")
    utc = torch.tensor(2.0e4, dtype=torch.float64)
    before = rop.four_band_column.launches
    with card_division():
        plain = _solar(p, t, q, gt, geom, config, utc)
        assert rop.four_band_column.launches == before
        with kernels_on_cpu(str(tmp_path)):
            out = _solar(p, t, q, gt, geom, config, utc)
    assert rop.four_band_column.launches == before + 1
    assert _err(out, plain) <= RADIATION_REL[torch.float64]
    assert not torch.equal(out[1], gt)


def test_the_table_is_formed_once_per_geometry_type_and_t_sw():
    """A second call with the same geometry, type and ``t_sw`` reuses the
    table; another ``t_sw`` or another geometry of the same values forms
    its own."""
    *_, geom = _column((3, 2, 8), torch.float64, "cpu")
    table = rop.radiation_table(geom, torch.float64, "cpu", 0.9)
    assert rop.radiation_table(geom, torch.float64, "cpu", 0.9) is table
    assert rop.radiation_table(geom, torch.float64, "cpu", 0.8) is not table
    other = dataclasses.replace(geom, dsig=geom.dsig.clone(),
                                lat=geom.lat.clone(), long=geom.long.clone())
    again = rop.radiation_table(other, torch.float64, "cpu", 0.9)
    assert again is not table and torch.equal(again, table)
    assert table.numel() == 1 + 2 * 3 + 2 * 2 + 8


# ---------------------------------------------------------------------------
# on the card

def _reads(fn):
    """``fn()`` and the host reads it made."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    return out, sum(e.name == READ for e in prof.events())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(9, 512, 1024), (9, 24, 36),
                                   (40, 64, 128)])
def test_kernel_matches_plain_function_on_the_card(monkeypatch, shape,
                                                   dtype):
    """One launch, no host read, the plain function and update within
    ``RADIATION_REL`` of each field's scale, and the update moves both
    fields; the albedo is the land cover's blend, a field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, t, q, gt, geom = _column(shape, dtype, "cuda")
    config = _config(convection=False)
    utc = torch.tensor(3.1e4, dtype=dtype, device="cuda")
    with monkeypatch.context() as m:
        m.setattr(rop, "on_card", lambda tt: False)
        ref = _solar(p, t, q, gt, geom, config, utc)
    _solar(p, t, q, gt, geom, config, utc)  # warm: build and load
    torch.cuda.synchronize()
    before = rop.four_band_column.launches
    out, reads = _reads(lambda: _solar(p, t, q, gt, geom, config, utc))
    torch.cuda.synchronize()
    assert rop.four_band_column.launches == before + 1
    assert reads == 0
    assert _err(out, ref) <= RADIATION_REL[dtype]
    assert not torch.equal(out[0], t) and not torch.equal(out[1], gt)


@pytest.mark.gpu
def test_a_surface_interval_on_stream_launches_it_once_a_physics_call():
    """Config S through ``make_run_fn`` on 'stream' (K7 calls of 2 steps,
    the extras between): 8 steps make 4 physics calls and 4 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    config = ModelConfig(height=64, width=128, layers=9, dt=30.0, **SURFACE)
    geom = driver.gen_model_geometry(config, "cuda")
    state = moist_start(driver.gen_model_state(geom, config), geom)
    run = driver.make_run_fn(geom, config, 8)
    before = rop.four_band_column.launches
    out = run(state)
    torch.cuda.synchronize()
    assert rop.four_band_column.launches == before + 4
    assert bool(torch.isfinite(out[0].prog.t).all())
