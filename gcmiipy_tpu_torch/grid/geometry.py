"""Static grid geometry descriptor.

Port of ``gcmiipy_tpu/grid/geometry.py``: :class:`Geom` carries the sigma
ladder, the per-latitude grid spacings, cell areas, the surface heightmap
and the polar-filter damping mask of a lat-lon C-grid with sigma vertical
coordinates (reference ``geometry.py:9-27``).

Geometry is generated host-side in float64 NumPy exactly as the JAX package
builds it, then turned into tensors of the working dtype on the working
device.  Shapes follow the JAX package so the two compare like with like:
``area`` is ``(J, 1)``, ``dx_j``/``dx_h`` are ``(1, J, 1)``, the sigma arrays
``(L, 1, 1)`` and the damping mask ``(J, I//2+1)``.
"""

import dataclasses
import math

import numpy as np
import torch

from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.device import resolve_device

STATIC_FIELDS = ("height", "width", "layers")


@dataclasses.dataclass(frozen=True)
class Geom:
    """Static descriptor of the model grid (reference geometry.py:9-27)."""

    height: int   # J: latitudes
    width: int    # I: longitudes
    layers: int   # K: sigma layers

    sige: torch.Tensor   # (L+1,1,1) layer edges, 1 at surface -> 0 at top
    sigt: torch.Tensor   # (L,1,1) top edge of each layer
    sigb: torch.Tensor   # (L,1,1) bottom edge of each layer
    dsig: torch.Tensor   # (L,1,1) sigb - sigt
    sig: torch.Tensor    # (L,1,1) layer midpoint
    dsigv: torch.Tensor  # (L,1,1) midpoint-to-midpoint spacing

    lat: torch.Tensor    # (J,1) cell-center latitude [rad]
    lat_h: torch.Tensor  # (J,1) southern-edge latitude [rad]
    long: torch.Tensor   # (I,) cell-center longitude [rad]
    dx_j: torch.Tensor   # (1,J,1) zonal spacing at cell rows
    dx_h: torch.Tensor   # (1,J,1) zonal spacing at v rows
    dy: torch.Tensor     # () meridional spacing
    area: torch.Tensor   # (J,1) trapezoid cell area

    ptop: torch.Tensor           # () pressure at sigma=0
    heightmap: torch.Tensor      # (J,I) surface elevation [m]
    land_fraction: torch.Tensor  # (J,I) land fraction in [0, 1]
    polar_mask: torch.Tensor     # (J,I//2+1) Arakawa-Lamb damping mask

    @property
    def device(self):
        return self.sig.device

    def take_rows(self, rows):
        """The geometry of the latitude rows ``rows`` (global indices, in
        order, repeats allowed): a lat-ring shard's block or band.  Every
        per-row field is indexed, the sigma ladder, ``long`` and the
        scalars are shared; ``height`` becomes ``len(rows)``.  The kernels
        take the block's rows as their whole grid and wrap them modulo its
        height (JAX ``make_mega_step_kernel(geom_as_args=True)``)."""
        idx = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        per_row = dict(lat=-2, lat_h=-2, dx_j=-2, dx_h=-2, area=-2,
                       heightmap=-2, land_fraction=-2, polar_mask=-2)
        return dataclasses.replace(self, height=int(idx.numel()), **{
            name: getattr(self, name).index_select(dim, idx).contiguous()
            for name, dim in per_row.items()})

    def take_block(self, rows, cols):
        """The geometry of the block ``rows`` x ``cols`` (global indices, in
        order, repeats allowed): a rank's block of a 2D (lat x lon) mesh.
        :meth:`take_rows`, then ``heightmap``, ``land_fraction`` and
        ``long`` indexed by ``cols`` too; ``width`` becomes ``len(cols)``.
        ``polar_mask`` keeps the global width's wavenumbers: the 2D path's
        filter is spectral over the whole row (JAX ``_spectral_psum_filter``).
        The kernels wrap the block modulo its extents, which spoils only
        halo outputs."""
        geom = self.take_rows(rows)
        idx = torch.as_tensor(np.asarray(cols, np.int64), device=self.device)
        per_col = dict(heightmap=-1, land_fraction=-1, long=-1)
        return dataclasses.replace(geom, width=int(idx.numel()), **{
            name: getattr(geom, name).index_select(dim, idx).contiguous()
            for name, dim in per_col.items()})

    def to(self, dtype=None, device=None):
        """Copy with every tensor field cast to ``dtype`` / moved to ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dtype=dtype, device=device)
            for f in dataclasses.fields(self) if f.name not in STATIC_FIELDS})


def manabe_sig(s):
    """Manabe sigma spacing: sigma^2 (3 - 2 sigma) (reference geometry.py:30)."""
    return s ** 2 * (3 - 2 * s)


def equal_sig(s):
    """Uniform sigma spacing (reference geometry.py:34)."""
    return s


# The GISS GCM-II 9-layer SIGE table (reference geometry.py:45)
GISS_SIGE = np.asarray(
    [1., .948665, .866530, .728953, .554415, .390144, .251540, .143737, .061602, 0.]
)


def _sigma_ladder(layers, sig_func, sige_table=None):
    """The (L+1,) edge ladder and the derived (L,1,1) arrays, float64."""
    if sige_table is not None:
        mysig = np.asarray(sige_table, dtype=np.float64)
        if mysig.shape != (layers + 1,):
            raise ValueError(
                f"sige_table must have {layers + 1} edges, got {mysig.shape}")
        if mysig[0] != 1.0 or mysig[-1] != 0.0 or (np.diff(mysig) >= 0).any():
            raise ValueError("sige_table must decrease from 1 to 0")
    else:
        mysig = np.asarray(
            [sig_func(1 - i / layers) for i in range(layers + 1)],
            dtype=np.float64)

    def rs(arr):
        return np.reshape(arr, (arr.shape[0], 1, 1))

    sige = rs(mysig)
    sigt = rs(mysig[1:])
    sigb = rs(mysig[:-1])
    dsig = sigb - sigt
    sig = (sigb + sigt) / 2
    dsigv = np.roll(sig, -1, axis=0) - sig
    return sige, sigt, sigb, dsig, sig, dsigv


def _polar_mask(width, dy, dx_j):
    """Arakawa & Lamb 1977 zonal damping mask (reference low_pass.py:61-73),
    shape (J, width//2+1), float64: wavenumber n is damped wherever
    1/sin(pi n / I) exceeds dy/dx_j."""
    height = dx_j.shape[0]
    nfreq = width // 2 + 1
    if width == 1:
        return np.ones((height, 1), dtype=np.float64)
    n = np.arange(1, nfreq)
    bysn = 1.0 / np.sin(np.pi * n / width)
    drat = (dy / dx_j)[:, None]
    sm = 1.0 - bysn[None, :] / drat
    smmz = 1.0 - np.maximum(sm, 0.0)
    return np.concatenate([np.ones((height, 1)), smmz], axis=1)


def gen_geometry(height, width, layers, sig_func=equal_sig,
                 north_edge=90.0, south_edge=-90.0,
                 west_edge=-180.0, east_edge=180.0,
                 heightmap=None, ptop=0.0, sige_table=None,
                 land_fraction=None, dtype=torch.float64, device="cuda"):
    """Spherical lat-lon geometry (reference geometry.py:38-151), as tensors
    of ``dtype`` on ``device``.

    Latitude rows run from north to south: ``lat[j] = north - (j+.5) dlat``.
    ``sige_table`` builds the vertical ladder from explicit edges instead of
    ``sig_func`` (pass :data:`GISS_SIGE` with ``layers=9``, ``ptop=1000.0``
    for the historical GCM-II grid).
    """
    device = resolve_device(device)
    sige, sigt, sigb, dsig, sig, dsigv = _sigma_ladder(layers, sig_func,
                                                       sige_table)
    circumference = 2 * math.pi * constants.radius
    dlat = (north_edge - south_edge) / height
    dlong = (east_edge - west_edge) / width

    j = np.arange(height, dtype=np.float64)
    lat_j = north_edge - (j + 0.5) * dlat
    lat_h = north_edge - (j + 1.0) * dlat
    long_k = west_edge + (np.arange(width, dtype=np.float64) + 0.5) * dlong

    dx_j_row = np.cos(np.deg2rad(lat_j)) * circumference / width
    dx_h_row = np.cos(np.deg2rad(lat_h)) * circumference / width
    dy = circumference / 2 / height
    area = (np.roll(dx_h_row, 1) + dx_h_row) * dy * 0.5

    if heightmap is None:
        heightmap = np.zeros((height, width), dtype=np.float64)
    if land_fraction is None:
        land_fraction = np.zeros((height, width), dtype=np.float64)

    arrays = dict(
        sige=sige, sigt=sigt, sigb=sigb, dsig=dsig, sig=sig, dsigv=dsigv,
        lat=np.deg2rad(lat_j).reshape(height, 1),
        lat_h=np.deg2rad(lat_h).reshape(height, 1),
        long=np.deg2rad(long_k),
        dx_j=dx_j_row.reshape(1, height, 1),
        dx_h=dx_h_row.reshape(1, height, 1),
        dy=np.float64(dy),
        area=area.reshape(height, 1),
        ptop=np.float64(ptop),
        heightmap=np.asarray(heightmap, dtype=np.float64),
        land_fraction=np.asarray(land_fraction, dtype=np.float64),
        polar_mask=_polar_mask(width, dy, dx_j_row),
    )
    return _geom(height, width, layers, arrays, dtype, device)


def _geom(height, width, layers, arrays, dtype, device):
    """:class:`Geom` from float64 numpy arrays, as contiguous tensors of
    ``dtype`` on ``device`` (the kernels take contiguous tensors only;
    a resampled map comes in Fortran order)."""
    return Geom(height=height, width=width, layers=layers, **{
        k: torch.as_tensor(np.array(v, np.float64, order="C")).to(
            dtype=dtype, device=device)
        for k, v in arrays.items()})


def gen_square_geometry(height, width, layers, dx, dy, sig_func=equal_sig,
                        ptop=0.0, dtype=torch.float64, device="cuda"):
    """Cartesian doubly-periodic geometry (reference geometry.py:154-182):
    uniform ``dx``/``dy`` spacing, zero latitudes and longitudes, flat
    ground, as tensors of ``dtype`` on ``device``."""
    device = resolve_device(device)
    sige, sigt, sigb, dsig, sig, dsigv = _sigma_ladder(layers, sig_func)
    dx_j = np.full((1, height, 1), float(dx), dtype=np.float64)
    arrays = dict(
        sige=sige, sigt=sigt, sigb=sigb, dsig=dsig, sig=sig, dsigv=dsigv,
        lat=np.zeros((height, 1)),
        lat_h=np.zeros((height, 1)),
        long=np.zeros((width,)),
        dx_j=dx_j,
        dx_h=dx_j.copy(),
        dy=np.float64(dy),
        area=np.full((height, 1), float(dx) * float(dy), dtype=np.float64),
        ptop=np.float64(ptop),
        heightmap=np.zeros((height, width), dtype=np.float64),
        land_fraction=np.zeros((height, width), dtype=np.float64),
        polar_mask=_polar_mask(width, float(dy), dx_j[0, :, 0]),
    )
    return _geom(height, width, layers, arrays, dtype, device)


def pressure_from_heightmap(height, sea_level_pressure, sea_level_temp):
    """Barometric surface pressure [Pa] over the elevation ``height`` [m], a
    tensor (reference geometry.py:185-233): the isothermal barometric
    formula, the variant the reference returns (``geometry.py:228,233``)."""
    return sea_level_pressure * torch.exp(
        (-constants.G * constants.Md * height)
        / (constants.R * sea_level_temp))
