"""PyTorch port: the side-band operators, limiters and scheme zoo, against the
JAX package at float64 on the CPU.

Every function of ``ops/stencil.py``'s 1D operators, ``ops/limiters.py``,
``diagnostics.py``, ``dynamics/viscosity.py``,
``dynamics/advection_schemes.py`` and ``dynamics/gcm_sequence.py`` runs on
the same numpy inputs (from a seed) in both packages; the port must agree
within ``REL`` = 1e-12 of each output's scale (the largest magnitude of the
JAX result), and within ``RUN_REL`` = 1e-10 after 10 steps.  Then the
behaviours of JAX's tests/test_schemes.py, run on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu import constants
from gcmiipy_tpu import diagnostics as jdiagnostics
from gcmiipy_tpu.dynamics import advection_schemes as jsch
from gcmiipy_tpu.dynamics import gcm_sequence as jgcm
from gcmiipy_tpu.dynamics import viscosity as jviscosity
from gcmiipy_tpu.ops import limiters as jlimiters
from gcmiipy_tpu.ops import stencil as jstencil
from gcmiipy_tpu_torch import diagnostics
from gcmiipy_tpu_torch.dynamics import advection_schemes as sch
from gcmiipy_tpu_torch.dynamics import gcm_sequence, viscosity
from gcmiipy_tpu_torch.ops import limiters, stencil

torch.set_num_threads(1)
REL = 1e-12
RUN_REL = 1e-10
N = 37            # 1D length
SHAPE = (12, 20)  # 2D (j, i)
SC = (1.0e4, 2.5e4)  # spatial_change (dx along axis 0, dy along axis 1)


def _close(got, ref, rel=REL, what=""):
    got = [got] if torch.is_tensor(got) else list(got)
    ref = [ref] if not isinstance(ref, (tuple, list)) else list(ref)
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        assert np.isfinite(a).all() == np.isfinite(b).all(), (what, k)
        scale = max(float(np.abs(b).max()), 1e-300)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (what, k, err, scale)


def _conv(args, to):
    return tuple(to(a) if isinstance(a, np.ndarray) else a for a in args)


def _both(jfn, fn, args):
    jout = jfn(*_conv(args, jnp.asarray))
    out = fn(*_conv(args, torch.as_tensor))
    return out, jout


# the inputs: numpy arrays from a seed, plus plain floats
def _q(rng):
    return 1.0 + rng.standard_normal(N)


def _v(rng):
    return 3.0 * rng.standard_normal(N)   # both signs: both upwind branches


def _q2(rng):
    return 1.0 + rng.standard_normal(SHAPE)


def _V2(rng):
    return 3.0 * rng.standard_normal((2,) + SHAPE)


def _p2(rng):
    return 1e5 * (1 + 1e-2 * rng.standard_normal(SHAPE))


def _t2(rng):
    return 300.0 + 5.0 * rng.standard_normal(SHAPE)


def _dyn1d(rng):
    """(u, p, t, q) of the GCM-II sequence, near a standard atmosphere."""
    u = 10.0 + rng.standard_normal(N)
    p = constants.standard_pressure * (1 + 1e-3 * rng.standard_normal(N))
    t = constants.standard_temperature + rng.standard_normal(N)
    q = 1e-3 * rng.random(N)
    return u, p, t, q


DT, DX = 0.5, 10.0
CASES = {
    # ops/stencil.py, the 1D operators and imjp
    "iph_1d": (jstencil.iph_1d, stencil.iph_1d, lambda r: (_q(r),)),
    "imh_1d": (jstencil.imh_1d, stencil.imh_1d, lambda r: (_q(r),)),
    "div_1d": (jstencil.div_1d, stencil.div_1d, lambda r: (_q(r), DX)),
    "divu_1d": (jstencil.divu_1d, stencil.divu_1d, lambda r: (_q(r), DX)),
    "gradh_1d": (jstencil.gradh_1d, stencil.gradh_1d, lambda r: (_q(r), DX)),
    "imjp": (jstencil.imjp, stencil.imjp,
             lambda r: (r.standard_normal((3,) + SHAPE),)),
    # ops/limiters.py
    "van_leer": (jlimiters.van_leer, limiters.van_leer,
                 lambda r: (3.0 * r.standard_normal(N),)),
    "calc_r": (jlimiters.calc_r, limiters.calc_r,
               lambda r: (np.round(_q(r), 1),)),   # some zero denominators
    "donor_cell_flux": (jlimiters.donor_cell_flux, limiters.donor_cell_flux,
                        lambda r: (_q(r), _v(r))),
    "donor_cell_advection": (jlimiters.donor_cell_advection,
                             limiters.donor_cell_advection,
                             lambda r: (_q(r), _v(r), DX, DT)),
    "limit_flux": (jlimiters.limit_flux, limiters.limit_flux,
                   lambda r: (_q(r), _v(r))),
    "gcm2_limit_flux": (jlimiters.gcm2_limit_flux, limiters.gcm2_limit_flux,
                        lambda r: (5.0 * r.standard_normal(N),
                                   4.0 * r.random(N))),
    # diagnostics.py
    "get_total_variation": (jdiagnostics.get_total_variation,
                            diagnostics.get_total_variation,
                            lambda r: (_q2(r),)),
    "courant_number": (jdiagnostics.courant_number,
                       diagnostics.courant_number,
                       lambda r: (8000.0 + r.random(SHAPE), _q2(r), 3e5,
                                  300.0)),
    "safe_div": (jdiagnostics.safe_div, diagnostics.safe_div,
                 lambda r: (_q(r), np.where(r.random(N) < 0.3, 0.0, _q(r)))),
    "potential_temp_to_temp": (jdiagnostics.potential_temp_to_temp,
                               diagnostics.potential_temp_to_temp,
                               lambda r: (_p2(r), _t2(r))),
    # dynamics/viscosity.py
    "finite_laplacian_2d": (jviscosity.finite_laplacian_2d,
                            viscosity.finite_laplacian_2d,
                            lambda r: (_q2(r), 3e5)),
    "incompressible_viscosity_2d": (jviscosity.incompressible_viscosity_2d,
                                    viscosity.incompressible_viscosity_2d,
                                    lambda r: (_q2(r), constants.mu_air,
                                               3e5)),
}
for _name in ("upwind_spatial", "central_spatial"):
    CASES[_name] = (getattr(jsch, _name), getattr(sch, _name),
                    lambda r: (DX, _v(r), _q(r)))
for _name in ("ftcs", "ft_upwind", "upwind_second_order",
              "upwind_third_order", "lax_friedrichs"):
    CASES[_name] = (getattr(jsch, _name), getattr(sch, _name),
                    lambda r: (DT, DX, _v(r), _q(r)))
CASES["leapfrog"] = (jsch.leapfrog, sch.leapfrog,
                     lambda r: (DT, DX, _v(r), _q(r), _q(r)))
for _name in ("sw_g_center_space", "sw_g_c_grid"):
    CASES[_name] = (getattr(jsch, _name), getattr(sch, _name),
                    lambda r: (DT, DX, _q(r)))
for _name in ("sw_h_center_space", "sw_h_c_grid"):
    CASES[_name] = (getattr(jsch, _name), getattr(sch, _name),
                    lambda r: (DT, DX, _v(r), 10.0))
for _axis in (0, 1):
    for _name in ("upwind_axis", "fv_advect_axis_upwind",
                  "fv_advect_axis_plain"):
        CASES[f"{_name}[{_axis}]"] = (
            getattr(jsch, _name), getattr(sch, _name),
            lambda r, a=_axis: (30.0, SC, _V2(r), _q2(r), a))
    CASES[f"gradient[{_axis}]"] = (jsch.gradient, sch.gradient,
                                   lambda r, a=_axis: (_p2(r), SC, a))
    CASES[f"pgf_c_grid_axis[{_axis}]"] = (
        jsch.pgf_c_grid_axis, sch.pgf_c_grid_axis,
        lambda r, a=_axis: (_p2(r), SC, a))
    CASES[f"pgf_one_d[{_axis}]"] = (jsch.pgf_one_d, sch.pgf_one_d,
                                    lambda r, a=_axis: (30.0, 1e4, _p2(r), a))
for _name in ("corner_transport_2d", "finite_volume_advection"):
    CASES[_name] = (getattr(jsch, _name), getattr(sch, _name),
                    lambda r: (30.0, SC, _V2(r), _q2(r)))
CASES["advect_with_momentum"] = (jsch.advect_with_momentum,
                                 sch.advect_with_momentum,
                                 lambda r: (30.0, SC, 1e-4 * _V2(r), _p2(r)))
for _name in ("pressure_gradient", "pgf_c_grid"):
    CASES[_name] = (getattr(jsch, _name), getattr(sch, _name),
                    lambda r: (30.0, SC, _p2(r), _t2(r)))
CASES["pressure_at_edge"] = (jsch.pressure_at_edge, sch.pressure_at_edge,
                             lambda r: (_p2(r),))
CASES["pgf_templess"] = (jsch.pgf_templess, sch.pgf_templess,
                         lambda r: (30.0, SC, _p2(r)))


def _gcm(name, build):
    CASES[f"gcm_sequence.{name}"] = (getattr(jgcm, name),
                                     getattr(gcm_sequence, name), build)


_gcm("aflux", lambda r: _dyn1d(r)[:2] + (1e5,))
_gcm("advecm", lambda r: (_dyn1d(r)[1], 1e4 * r.standard_normal(N), 10.0,
                          1e10))
_gcm("scaling", lambda r: (_dyn1d(r)[1], _q(r), 1e5))
_gcm("unscaling", lambda r: (_dyn1d(r)[1], 1e15 * _q(r), 1e5))
_gcm("advecv", lambda r: (_v(r), 1e10 * _v(r), _dyn1d(r)[1], _dyn1d(r)[1],
                          _v(r), 10.0, 1e5))
_gcm("pgf", lambda r: (_v(r), _dyn1d(r)[1], _dyn1d(r)[1], _dyn1d(r)[2],
                       10.0, 1e5))
_gcm("advect", lambda r: (1e10 * _v(r), _dyn1d(r)[1], _dyn1d(r)[2],
                          _dyn1d(r)[1], _dyn1d(r)[2], 10.0, 1e5))
_gcm("advecq", lambda r: (1e10 * _v(r), _dyn1d(r)[1], _dyn1d(r)[3],
                          _dyn1d(r)[1], _dyn1d(r)[3], 10.0, 1e5))
_gcm("dynam_matsuno", lambda r: _dyn1d(r) + (10.0, 1e5))


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(name):
    """One function of the side band, on the same random inputs in both
    packages: within REL of each output's scale."""
    jfn, fn, build = CASES[name]
    out, ref = _both(jfn, fn, build(np.random.default_rng(len(name))))
    _close(out, ref, what=name)


def test_dynam_matsuno_matches_jax_after_10_steps():
    """The GCM-II DYNAM sequence, 10 steps from a perturbed standard
    atmosphere (the test_schemes.py loop's dt and dx): within RUN_REL."""
    u, p, t, q = _dyn1d(np.random.default_rng(10))
    js = tuple(jnp.asarray(x) for x in (u, p, t, q))
    s = tuple(torch.as_tensor(x) for x in (u, p, t, q))
    for _ in range(10):
        js = jgcm.dynam_matsuno(*js, 10.0, 100e3)
        s = gcm_sequence.dynam_matsuno(*s, 10.0, 100e3)
    _close(s, js, RUN_REL)


# ------------------------------------------ JAX's tests/test_schemes.py

def _loop(step, state, steps):
    for _ in range(steps):
        state = step(state)
    return state


def test_upwind_transports_square_wave():
    """The reference 1D advection config (161 cells, dx=10 m, dt=1 s):
    mass conserved, the wave moved v t / dx = 50 cells in 250 steps."""
    side = 161
    q0 = torch.zeros(side, dtype=torch.float64)
    q0[40:80] = 1.0
    v = torch.full((side,), 2.0, dtype=torch.float64)
    q = _loop(lambda q: sch.ft_upwind(1.0, 10.0, v, q), q0, 250)
    np.testing.assert_allclose(float(q.sum()), 40.0, rtol=1e-10)
    x = torch.arange(side, dtype=torch.float64)
    com0 = float((x * q0).sum() / q0.sum())
    com1 = float((x * q).sum() / q.sum())
    np.testing.assert_allclose(com1 - com0, 50.0, atol=1.0)


def test_upwind_exact_at_cfl_one():
    """At CFL 1 donor-cell advection is the exact shift."""
    q0 = torch.zeros(64, dtype=torch.float64)
    q0[10:20] = 1.0
    v = torch.full((64,), 5.0, dtype=torch.float64)
    q = sch.ft_upwind(1.0, 5.0, v, q0)
    np.testing.assert_allclose(q.numpy(), np.roll(q0.numpy(), 1), atol=1e-12)


def test_higher_order_upwind_less_diffusive():
    q0 = torch.zeros(200, dtype=torch.float64)
    q0[40:80] = 1.0
    v = torch.full((200,), 2.0, dtype=torch.float64)

    def peak_after(scheme):
        return float(_loop(lambda q: scheme(1.0, 10.0, v, q), q0, 200).max())

    assert peak_after(sch.upwind_third_order) > peak_after(sch.ft_upwind)


def test_leapfrog_second_order_neutral():
    """Leapfrog on a smooth wave keeps its amplitude to ~1% over 500 steps."""
    side = 128
    q0 = torch.sin(2 * np.pi * torch.arange(side, dtype=torch.float64) / side)
    v = torch.ones(side, dtype=torch.float64)
    q, q_prev = sch.ft_upwind(0.5, 1.0, v, q0), q0
    for _ in range(500):
        q, q_prev = sch.leapfrog(0.5, 1.0, v, q, q_prev), q
    assert 0.98 < float(q.abs().max()) < 1.02


def test_convergence_rate_upwind_first_order():
    """Donor-cell upwind converges at O(dx) on an exact advection solution
    (the reference's verification method, test_primitive_1d.py:420-434)."""
    errors, dxs = [], []
    for n in (64, 128, 256, 512):
        dx = 1.0 / n
        dt = 0.5 * dx
        steps = int(round(0.25 / dt))
        x = (np.arange(n) + 0.5) * dx
        q0 = torch.as_tensor(np.sin(2 * np.pi * x))
        v = torch.ones(n, dtype=torch.float64)
        q = _loop(lambda q: sch.ft_upwind(dt, dx, v, q), q0, steps)
        exact = np.sin(2 * np.pi * (x - steps * dt))
        errors.append(float(np.abs(q.numpy() - exact).mean()))
        dxs.append(dx)
    rates = np.diff(np.log(errors)) / np.diff(np.log(dxs))
    assert np.all(rates > 0.8) and np.all(rates < 1.5), rates


def test_ctu_2d_diagonal_transport():
    """CTU moves a square 20 cells along each axis in 40 steps of CFL 1/2,
    conserving its mass."""
    n = 64
    q0 = torch.zeros((n, n), dtype=torch.float64)
    q0[10:20, 10:20] = 1.0
    V = torch.ones((2, n, n), dtype=torch.float64)
    q = _loop(lambda q: sch.corner_transport_2d(0.5, (1.0, 1.0), V, q), q0,
              40).numpy()
    np.testing.assert_allclose(q.sum(), 100.0, rtol=1e-10)
    iy = (q.sum(1) * np.arange(n)).sum() / q.sum()
    ix = (q.sum(0) * np.arange(n)).sum() / q.sum()
    np.testing.assert_allclose([iy, ix], [34.5, 34.5], atol=0.5)


def test_fv_advection_conserves():
    rng = np.random.default_rng(0)
    q = torch.as_tensor(1.0 + 0.5 * rng.random((32, 32)))
    V = torch.as_tensor(rng.standard_normal((2, 32, 32)))
    total0 = float(q.sum())
    q = _loop(lambda q: sch.finite_volume_advection(0.1, (1.0, 1.0), V, q),
              q, 50)
    np.testing.assert_allclose(float(q.sum()), total0, rtol=1e-10)


def test_van_leer_limiter_properties():
    """psi(1) = 1, psi(0) = 0, 0 <= psi <= 2, and psi = 0 at extrema."""
    assert float(limiters.van_leer(torch.tensor(1.0))) == 1.0
    assert float(limiters.van_leer(torch.tensor(0.0))) == 0.0
    psi = limiters.van_leer(torch.tensor(
        [-2.0, -0.5, 0.0, 0.5, 1.0, 2.0, 10.0], dtype=torch.float64)).numpy()
    assert np.all(psi >= 0) and np.all(psi <= 2)
    assert np.all(psi[:2] == 0)


def test_calc_r_zero_denominator_has_no_nan():
    """Flat neighbours give r = 0, with no NaN in the value or, through
    the inner select, in its gradient."""
    q = torch.tensor([1.0, 1.0, 2.0, 2.0, 1.0], dtype=torch.float64,
                     requires_grad=True)
    r = limiters.calc_r(q)
    assert torch.isfinite(r).all()
    assert float(r[0].detach()) == 0.0 and float(r[2].detach()) == 0.0
    r.sum().backward()
    assert torch.isfinite(q.grad).all()


def test_donor_cell_flux_directions():
    q = torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64)
    np.testing.assert_allclose(
        limiters.donor_cell_flux(q, torch.ones(4, dtype=torch.float64)),
        [1, 2, 3, 4])
    np.testing.assert_allclose(
        limiters.donor_cell_flux(q, -torch.ones(4, dtype=torch.float64)),
        [-2, -3, -4, -1])


def test_gcm2_flux_clamp():
    """|flux| limited to half the upstream scaled tracer (port_one_d.py:246-251)."""
    qt = torch.full((4,), 10.0, dtype=torch.float64)
    flux = torch.tensor([100.0, -100.0, 3.0, -3.0], dtype=torch.float64)
    np.testing.assert_allclose(limiters.gcm2_limit_flux(flux, qt),
                               [5.0, -5.0, 3.0, -3.0])


def test_gcm_sequence_dynam_fixed_point_and_loop():
    """A uniform atmosphere is a fixed point of dynam_matsuno, the clamped
    humidity total is conserved, and 50 steps at dt = 10 s stay finite
    (JAX's test_gcm_sequence_dynam)."""
    side = 64
    u = torch.full((side,), 10.0, dtype=torch.float64)
    p = torch.full((side,), constants.standard_pressure, dtype=torch.float64)
    t = torch.full((side,), constants.standard_temperature,
                   dtype=torch.float64)
    q = torch.zeros(side, dtype=torch.float64)
    q[16:32] = 1e-3
    u2, p2, t2, q2 = gcm_sequence.dynam_matsuno(u, p, t, q, 300.0, 100e3)
    np.testing.assert_allclose(p2, p, rtol=1e-12)
    np.testing.assert_allclose(t2, t, rtol=1e-12)
    np.testing.assert_allclose(float(q2.sum()), float(q.sum()), rtol=1e-12)
    state = _loop(lambda s: gcm_sequence.dynam_matsuno(*s, 10.0, 100e3),
                  (u, p, t, q), 50)
    assert all(torch.isfinite(x).all() for x in state)


def test_new_side_band_modules_import_no_jax():
    """The side-band modules import nothing of JAX."""
    import os
    import re
    here = os.path.dirname(os.path.abspath(__file__))
    pkg = os.path.join(os.path.dirname(here), "gcmiipy_tpu_torch")
    pattern = re.compile(r"^\s*(import|from)\s+(jax|gcmiipy_tpu)\b", re.M)
    for rel in ("dynamics/advection_schemes.py", "dynamics/shallow_water_1d.py",
                "dynamics/shallow_water_2d.py", "dynamics/gcm_sequence.py",
                "dynamics/viscosity.py", "model/ctu_model.py",
                "model/harness.py", "utils/dimensions.py",
                "utils/plotting.py", "parallel/ensemble.py"):
        with open(os.path.join(pkg, rel)) as f:
            assert not pattern.search(f.read()), rel
