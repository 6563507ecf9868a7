"""The four-band radiation and its update as one CUDA kernel.

:func:`four_band_column` launches ``csrc/radiation.cu`` on CUDA tensors
(built at first use, see :mod:`gcmiipy_tpu_torch.ops.cuda_lib`) or raises.
Its plain version is :func:`gcmiipy_tpu_torch.physics.radiation.
four_band_radiation` followed by the updates ``gt + dt_ground * dt`` and
``tt + dt_air * dt``, which :func:`gcmiipy_tpu_torch.model.driver.
solar_timestep` runs for CPU tensors and replaces by this where
:func:`on_card` says the tensors are on a card.

A call is one launch: the column-independent table (``cum_sw_top[0]``,
``dsig``, the shortwave factor of each layer, the rows' sin and cos of
latitude, the longitudes) is formed once with PyTorch per geometry, type
and ``t_sw`` and kept (:func:`radiation_table`), so that it rounds as the
plain version's; the scalars, the band polynomials' coefficients among
them, go in the launch's parameters.
``four_band_column.launches`` counts the launches, where the C entry makes
them.  Its bound is bytes: 0.019 ms a call at 9x512x1024 float32 on an
H100's 3.35 TB/s; the launch takes 0.09 ms there, held back by
instruction issue (the source's header works the numbers out).
"""

import ctypes
import math
import weakref

import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.ops import cuda_lib
from gcmiipy_tpu_torch.ops.fused_parts import MAX_LAYERS, on_cpu
from gcmiipy_tpu_torch.physics import radiation

_VP = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int] + [_VP] * 10 + [
    ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int), _VP]
# (dsig, lat, long, dtype, device, t_sw) by their ids -> (weak references
# to the three tensors, the table); an entry serves only while those very
# tensors live
_TABLES = {}
_TABLES_MAX = 64
# the scalars after dt, as csrc/radiation.cu's RadScalar orders them
_CONSTANTS = (constants.sb_constant, constants.solar_constant,
              1.0 / constants.Cg, constants.Cp, constants.G,
              -radiation._LW_DIFFUSIVITY, radiation.ABLWV2, radiation.ABLCO2,
              radiation.ABLWIN, radiation.ABLWV1,
              *radiation._BAND_POLYS.reshape(-1).tolist())


def _function(double):
    lib = cuda_lib.load(cuda_lib.library_name("radiation", double))
    fn = lib.gcm_four_band
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def on_card(tt):
    """Whether ``solar_timestep`` launches the kernel for ``tt``: True on a
    card, False for a CPU tensor (the plain version)."""
    return not on_cpu("four-band radiation", (tt,))


def radiation_table(geom, dtype, device, t_sw):
    """The kernel's column-independent table in ``dtype`` on ``device``,
    formed with PyTorch as :func:`four_band_radiation` forms its pieces:
    ``cum_sw_top[0]``, then ``dsig`` (L), ``(1 - sw_t) * cum_sw_top /
    sw_t`` (L), ``sin(lat)`` and ``cos(lat)`` (H) and ``long`` (W).  Kept
    per geometry, type and ``t_sw``."""
    keys = (geom.dsig, geom.lat, geom.long)
    key = (*map(id, keys), dtype, torch.device(device), float(t_sw))
    hit = _TABLES.get(key)
    if hit is not None and all(r() is x for r, x in zip(hit[0], keys)):
        return hit[1]
    dsig = geom.dsig.to(dtype=dtype, device=device).reshape(-1)
    sw_t = t_sw ** dsig
    cum_sw_top = torch.flip(torch.cumprod(torch.flip(sw_t, (0,)), dim=0),
                            (0,))
    sn = (1 - sw_t) * cum_sw_top / sw_t
    lat = geom.lat.to(dtype=dtype, device=device).reshape(-1)
    table = torch.cat([cum_sw_top[:1], dsig, sn,
                       torch.sin(lat), torch.cos(lat),
                       geom.long.to(dtype=dtype, device=device).reshape(-1)])
    if len(_TABLES) >= _TABLES_MAX:
        _TABLES.clear()
    _TABLES[key] = (tuple(map(weakref.ref, keys)), table)
    return table


def _device_scalar(name, x, like):
    """``x`` as the kernel takes it: (its pointer, None) for a 0-dim tensor
    of ``like``'s type and device, (None, the float) for a number."""
    if not torch.is_tensor(x):
        return None, float(x)
    if x.dim() != 0 or x.dtype != like.dtype or x.device != like.device:
        raise ValueError(f"four-band radiation kernel: {name} must be a "
                         f"number or a 0-dim {like.dtype} tensor on "
                         f"{like.device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x, None


def four_band_column(p, tt, q, gt, albedo, utc, dt, geom, t_sw,
                     declination=0.0):
    """The four-band radiation of the true temperature ``tt`` (L,H,W) and
    the ground temperature ``gt`` (H,W) with the humidity ``q`` (L,H,W)
    and the surface pressure ``p`` (H,W), integrated over ``dt``: new
    tensors ``(tt + dt_air * dt, gt + dt_ground * dt)``, the plain
    version's within a few ulps.  ``albedo``: a number or (H,W); ``utc``
    and ``declination``: numbers or 0-dim tensors of ``tt``'s type on its
    device.  Every tensor contiguous, in ``tt``'s type, on its card.
    Raises on what the kernel does not take."""
    L, H, W = tt.shape
    if tt.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"four-band radiation kernel takes float32 or "
                        f"float64, got {tt.dtype}")
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"four-band radiation kernel takes 1..{MAX_LAYERS} "
                         f"layers, got {L}")
    if (geom.layers, geom.height, geom.width) != (L, H, W):
        raise ValueError(f"four-band radiation kernel: fields of shape "
                         f"{(L, H, W)} on a geometry of "
                         f"{(geom.layers, geom.height, geom.width)}")
    device = tt.device
    fields = [("tt", tt, (L, H, W)), ("q", q, (L, H, W)), ("p", p, (H, W)),
              ("gt", gt, (H, W))]
    if torch.is_tensor(albedo):
        fields.append(("albedo", albedo, (H, W)))
    for name, x, shape in fields:
        if x.device != device or x.dtype != tt.dtype:
            raise ValueError(f"four-band radiation kernel: {name} is "
                             f"{x.dtype} on {x.device}, expected {tt.dtype} "
                             f"on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"four-band radiation kernel: {name} of shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"four-band radiation kernel: {name} must be "
                             "contiguous")
    utc_t, utc_f = _device_scalar("utc", utc, tt)
    decl_t, decl_f = _device_scalar("declination", declination, tt)
    albedo_t = albedo if torch.is_tensor(albedo) else None
    scalars = (
        0.0 if albedo_t is not None else 1 - albedo,
        # the plain version's hour angle of a Python clock
        0.0 if utc_t is not None else utc_f / (-24.0 * 3600.0) * 2 * math.pi,
        0.0 if decl_t is not None else math.sin(decl_f),
        0.0 if decl_t is not None else math.cos(decl_f),
        float(dt), *_CONSTANTS)
    table = radiation_table(geom, tt.dtype, device, t_sw)
    tt_out = torch.empty_like(tt)
    gt_out = torch.empty_like(gt)
    count = ctypes.c_int(0)
    double = tt.dtype == torch.float64
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(device):
        err = _function(double)(
            int(double), p.data_ptr(), tt.data_ptr(), q.data_ptr(),
            gt.data_ptr(), ptr(albedo_t), ptr(utc_t), ptr(decl_t),
            table.data_ptr(), tt_out.data_ptr(), gt_out.data_ptr(),
            (ctypes.c_double * len(scalars))(*scalars), L, H, W,
            ctypes.byref(count),
            torch.cuda.current_stream(device).cuda_stream)
    four_band_column.launches += count.value
    if err != 0:
        raise RuntimeError(f"four-band radiation kernel launch failed: CUDA "
                           f"error {err}")
    return tt_out, gt_out


# every launch of the kernel, counted where the C entry makes it
four_band_column.launches = 0
