"""The dimension audit of the port's own core (JAX tests/test_dimensions.py,
run on the port).

``gcmiipy_tpu_torch.utils.dimensions.Q`` tags tensors with their physical
dimension; its ``__torch_function__`` protocol lets the port's plain
``dynamics/core25d.matsuno_timestep`` run unchanged on tagged CPU tensors,
so that any dimensionally inconsistent term anywhere in the Matsuno step
raises ``DimensionError``.  The step runs with the polar filter as a
product with dimensionless DFT factor matrices
(``polar_filter.arakawa_1977_dft``, the numpy oracle's form), since
``torch.fft`` has no dimension rule.  The tagged run must give the same
floats as the untagged one: ``torch.equal`` on every magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gcmiipy_tpu.grid import geometry as jgeometry
from gcmiipy_tpu_torch import constants
from gcmiipy_tpu_torch.dynamics import core25d
from gcmiipy_tpu_torch.ops import polar_filter
from gcmiipy_tpu_torch.physics import thermo
from gcmiipy_tpu_torch.utils import dimensions as dm
from gcmiipy_tpu_torch.utils.dimensions import (
    DIMENSIONLESS, J_PER_KG_K, K, KG_PER_M3, M, M_PER_S, M_PER_S2, PA, Q,
    DimensionError)

from torch_port_helpers import port_geom

torch.set_num_threads(1)
H, W, L = 8, 16, 3


def _geom():
    return port_geom(jgeometry.gen_geometry(H, W, L,
                                            sig_func=jgeometry.manabe_sig))


def _tagged_geom(geom):
    """The geometry's lengths in m and its top pressure in Pa; the sigma
    ladder and the polar mask are dimensionless ratios (plain tensors)."""
    return dataclasses.replace(
        geom, dx_j=Q(geom.dx_j, M), dx_h=Q(geom.dx_h, M), dy=Q(geom.dy, M),
        heightmap=Q(geom.heightmap, M), ptop=Q(geom.ptop, PA))


def _tag_constants(mp):
    mp.setattr(constants, "P0", Q(constants.P0, PA))
    mp.setattr(constants, "Rd", Q(constants.Rd, J_PER_KG_K))
    mp.setattr(constants, "Cp", Q(constants.Cp, J_PER_KG_K))
    mp.setattr(constants, "G", Q(constants.G, M_PER_S2))
    # kappa = Rd/Cp is a dimensionless exponent: a plain float


@pytest.fixture()
def tagged_constants(monkeypatch):
    """The physical constants the core reads at call time, tagged."""
    _tag_constants(monkeypatch)


def _state(geom):
    """Tagged (p, u, v, t, q) from a numpy seed."""
    rng = np.random.default_rng(0)
    p = 1e5 * (1 + 1e-3 * rng.standard_normal((H, W)))
    u = 0.5 * rng.standard_normal((L, H, W))
    v = 0.5 * rng.standard_normal((L, H, W))
    tp = 1e5 * geom.sig.numpy() + float(geom.ptop) * np.ones((L, H, W))
    t = (300.0 + rng.standard_normal((L, H, W))) * (
        dm.mag(constants.P0) / tp) ** constants.kappa
    q = 1e-5 * (1 + 0.1 * rng.random((L, H, W)))
    return (Q(torch.as_tensor(p), PA), Q(torch.as_tensor(u), M_PER_S),
            Q(torch.as_tensor(v), M_PER_S), Q(torch.as_tensor(t), K),
            Q(torch.as_tensor(q), DIMENSIONLESS))


def _dft_filter(width):
    mats = polar_filter.build_dft_matrices(width, dtype=np.float64)
    return lambda q, g: polar_filter.arakawa_1977_dft(q, g, mats)


def test_matsuno_step_dimensions():
    """The port's whole Matsuno step (core25d.matsuno_timestep with the DFT
    filter) is dimensionally consistent: p in Pa, u and v in m/s, t in K,
    q dimensionless, and the tagged run's floats equal the plain run's."""
    geom = _geom()
    fields = _state(geom)
    filt = _dft_filter(W)
    with pytest.MonkeyPatch.context() as mp:
        _tag_constants(mp)
        out = core25d.matsuno_timestep(*fields, Q(300.0, dm.S),
                                       _tagged_geom(geom), filter_fn=filt)
    want = (PA, M_PER_S, M_PER_S, K, DIMENSIONLESS)
    plain = core25d.matsuno_timestep(*(f.mag.clone() for f in _state(geom)),
                                     300.0, geom, filter_fn=filt)
    for name, field, dim, ref in zip("puvtq", out, want, plain):
        assert isinstance(field, Q), f"{name} lost its dimension tag"
        assert field.dim == dim, (
            f"{name}: got {dm.fmt(field.dim)}, want {dm.fmt(dim)}")
        assert torch.isfinite(field.mag).all()
        assert torch.equal(field.mag, ref), name


def test_intermediate_dimensions(tagged_constants):
    """The tendencies' dimensions: the column mass convergence in Pa/s, the
    geopotential in m^2/s^2, the pressure-gradient and momentum-flux
    tendencies in Pa m/s^2."""
    plain = _geom()
    geom = _tagged_geom(plain)
    p, u, v, t, q = _state(plain)
    pu = core25d.calc_pu(p, u)
    pv = core25d.calc_pv(p, v)
    pit, sd = core25d.aflux(pu, pv, geom)
    assert pit.dim == dm._combine(PA, dm.S, sign=-1)
    assert sd.dim == pit.dim
    for phi in (core25d.compute_geopotential(p, t, geom),
                core25d.compute_geopotential_hydrostatic(p, t, geom)):
        assert phi.dim == dm.M2_PER_S2
    want = dm._combine(PA, M_PER_S2)
    for f in core25d.pgf(p, t, geom):
        assert f.dim == want
    dut, dvt = core25d.advec_m_pu(p, u, v, pu, pv, geom)
    assert dut.dim == want and dvt.dim == want
    assert core25d.advec_t(pu, pv, t, geom).dim == dm._combine(
        dm._combine(PA, K), dm.S, sign=-1)


def test_dimension_errors_raise(tagged_constants):
    """The tags reject inconsistency (they are not a pass-through)."""
    a = Q(torch.ones(4, dtype=torch.float64), PA)
    b = Q(torch.ones(4, dtype=torch.float64), M_PER_S)
    with pytest.raises(DimensionError):
        a + b
    with pytest.raises(DimensionError):
        torch.maximum(a, b)
    with pytest.raises(DimensionError):
        a ** 0.5 + b  # Pa^(1/2) is a non-integer dimension
    with pytest.raises(DimensionError):
        torch.exp(a)  # transcendental of a dimensional quantity
    with pytest.raises(DimensionError):
        torch.cat([a, b])
    with pytest.raises(DimensionError):
        torch.where(a > a, a, b)
    with pytest.raises(DimensionError):
        a + torch.ones(4, dtype=torch.float64)  # a plain tensor is 1
    with pytest.raises(DimensionError):
        torch.fft.rfft(a)  # no rule: never passed through untagged
    # a deliberately broken physics expression: adding p to phi
    plain = _geom()
    p, u, v, t, q = _state(plain)
    phi = core25d.compute_geopotential(p, t, _tagged_geom(plain))
    with pytest.raises(DimensionError):
        phi + p


def test_thermo_dimensions(tagged_constants):
    """The port's thermodynamics carry their dimensions on tagged input."""
    tp = Q(torch.full((3, 4, 4), 9e4, dtype=torch.float64), PA)
    t_pot = Q(torch.full((3, 4, 4), 300.0, dtype=torch.float64), K)
    tt = thermo.to_true_temp(t_pot, tp)
    assert tt.dim == K
    assert thermo.to_potential_temp(tt, tp).dim == K
    assert thermo.to_density(tt, tp).dim == KG_PER_M3
    assert (tp / (constants.Rd * tt)).dim == KG_PER_M3
    assert thermo.exbyk(tp / constants.P0).dim == DIMENSIONLESS
