"""Run configuration.

Port of ``gcmiipy_tpu/model/config.py:ModelConfig``.  Every field of the JAX
dataclass is accepted with the same default, so a configuration written for
one package reads in the other; the fields this slice of the port runs are
listed in :data:`PORTED`.  A non-default value of any other field names a
feature the port does not have yet and raises ``NotImplementedError``
(:func:`check_ported`); nothing is ignored silently.
"""

import dataclasses
from typing import Callable, Optional

from gcmiipy_tpu_torch.grid import geometry


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration of a 2.5D model run (see the JAX twin for each field)."""

    height: int = 24
    width: int = 36
    layers: int = 9
    sig_func: Callable = geometry.manabe_sig
    giss_sige: bool = False
    ptop: float = 0.0

    topography: str = "flat"
    sea_level_temp: float = 288.0
    land_cover: str = "none"
    albedo_land: float = 0.35

    dt: float = 1800.0

    physics: bool = False
    physics_every: int = 1
    seasonal: bool = False
    obliquity: float = 23.44
    year_days: float = 365.0
    coriolis: bool = False
    convection: bool = False
    evaporation: bool = False
    gw0: float = 0.0
    precipitation: bool = False
    rh_crit: float = 1.0
    drag_tau: float = 0.0
    shapiro_every: int = 0
    shapiro_order: int = 8
    shapiro_fields: str = "p"
    shapiro_slp: Optional[bool] = None
    t_lw: float = 0.1
    t_sw: float = 0.9
    albedo: float = 0.3
    radiation: str = "grey"

    dtype: str = "float32"
    # 'fft' (torch.fft), 'matmul' (per-row circulant) or 'dft' (shared DFT
    # factors): the filter of the 'xla' and 'fused' backends
    polar_filter: str = "fft"
    # 'xla' (the plain PyTorch core; the name is the JAX package's),
    # 'fused' (K1, csrc/fused_parts.cu, twice per step), 'mega' (K5,
    # csrc/mega_half.cu, twice per step: each half step with the polar
    # filter, a float64 FFT, inside), 'mega4' (K6, csrc/mega_step.cu, the
    # whole step with its filter) or 'stream' (K7, csrc/stream_steps.cu,
    # stream_steps whole steps a call with the per-step column physics
    # inside)
    backend: str = "xla"
    # The JAX kernel's paired-block schedule.  K7 runs unchanged (its
    # stages are separate launches already); as in the JAX package the
    # flag keeps the physics out of the kernel, between its calls
    stream_pipeline: bool = False
    stream_steps: int = 20
    # 'stream' with extras on a grid wider than 2048 and taller than 64:
    # False runs the per-step 'mega4' path with JAX's warning (the JAX
    # package leaves its tall-wide streaming kernel there for its v1
    # pipeline), True streams K7 natively with the extras between calls
    stream_wide_native: bool = False
    q_limiter: bool = False
    # Precision of the 'mega', 'mega4' and 'stream' filters.  'high' and
    # 'highest' both run them at full precision: no TF32, no bf16 split, as
    # the JAX package does off the TPU; their sums run in float64 for
    # float32 fields too (float32 sums lose 1e-4 of the field on the polar
    # rows, see ops/mega_step.py), in the kernels as a float64 FFT
    # (ops/fft_filter.py).  The bf16 modes 'fwd_high' and 'default' were
    # measured unsound and are not ported.
    filter_precision: str = "high"
    # Accepted for compatibility; no effect: the port's filter has no
    # split-precision tail (its kernels' FFT runs every wavenumber in
    # float64, at a cost the split would not lower).
    filter_split_tau: float = 0.125

    stats: bool = True
    guard: bool = False
    guard_p_max: float = 115000.0
    guard_p_min: float = 0.0
    guard_t_max: float = 0.0
    guard_t_min: float = 0.0

    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    metrics_path: Optional[str] = None


# Fields the ported path reads; any other field must keep its default.
PORTED = frozenset((
    "height", "width", "layers", "sig_func", "giss_sige", "ptop", "dt",
    "coriolis", "dtype", "polar_filter", "backend", "q_limiter", "stats",
    "guard", "guard_p_max", "guard_p_min", "guard_t_max", "guard_t_min",
    "filter_precision", "filter_split_tau",
    "physics", "physics_every", "seasonal", "obliquity", "year_days",
    "convection", "drag_tau", "t_lw", "t_sw", "albedo", "radiation",
    "stream_steps", "stream_pipeline", "stream_wide_native",
    "topography", "sea_level_temp", "land_cover", "albedo_land",
    "evaporation", "gw0", "precipitation", "rh_crit",
    "shapiro_every", "shapiro_order", "shapiro_fields", "shapiro_slp",
    "checkpoint_dir", "checkpoint_every", "metrics_path",
))
BACKENDS = ("xla", "fused", "mega", "mega4", "stream")
POLAR_FILTERS = ("fft", "matmul", "dft")
FILTER_PRECISIONS = ("high", "highest")


def check_ported(config):
    """Raise ``NotImplementedError`` naming the first feature of ``config``
    that the port does not run, ``ValueError`` on an unknown dtype."""
    for f in dataclasses.fields(config):
        if f.name not in PORTED and getattr(config, f.name) != f.default:
            raise NotImplementedError(
                f"ModelConfig.{f.name}={getattr(config, f.name)!r}: not "
                "ported to gcmiipy_tpu_torch yet")
    if config.backend not in BACKENDS:
        raise NotImplementedError(
            f"ModelConfig.backend={config.backend!r}: the port runs "
            f"{BACKENDS} so far")
    if config.polar_filter not in POLAR_FILTERS:
        raise NotImplementedError(
            f"ModelConfig.polar_filter={config.polar_filter!r}: the port "
            f"runs {POLAR_FILTERS} so far")
    if config.filter_precision in ("fwd_high", "default"):
        raise NotImplementedError(
            f"ModelConfig.filter_precision={config.filter_precision!r}: the "
            "bf16 filter modes are not ported (measured unsound); the port "
            f"runs {FILTER_PRECISIONS}, both at full precision")
    if config.filter_precision not in FILTER_PRECISIONS:
        raise ValueError(
            f"bad filter_precision {config.filter_precision!r}")
    if config.dtype not in ("float32", "float64"):
        raise ValueError(f"dtype must be 'float32' or 'float64', got "
                         f"{config.dtype!r}")
    return config
