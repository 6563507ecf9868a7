"""PyTorch port: the 1D and 2D shallow-water cores, the CTU sketch and the
guarded harness, against the JAX package at float64 on the CPU.

The reference's own configurations (JAX tests/test_shallow_water.py and
tests/test_schemes.py): the 1D advection config (161 cells, dx = 10 m,
dt = 1 s), the canonical dam break (100 cells, dx = 300 km, dt = 900 s),
the upwind dam break and the hump bed (dx = 1/100, dt = 1e-4), the 2D
C-grid benchmark (64x64, dx = 300 km, dt = 300 s), the A-grid (16x16,
dt = 900 s) and the temperature-viscosity (31x31, dt = 300 s) configs.
Bounds: ``REL`` = 1e-12 of each output's scale for one call, ``RUN_REL`` =
1e-10 after 10-50 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gcmiipy_tpu import constants
from gcmiipy_tpu.dynamics import advection_schemes as jsch
from gcmiipy_tpu.dynamics import shallow_water_1d as jsw1
from gcmiipy_tpu.dynamics import shallow_water_2d as jsw2
from gcmiipy_tpu.model import ctu_model as jctu
from gcmiipy_tpu.model import harness as jharness
from gcmiipy_tpu_torch.dynamics import advection_schemes as sch
from gcmiipy_tpu_torch.dynamics import shallow_water_1d as sw1
from gcmiipy_tpu_torch.dynamics import shallow_water_2d as sw2
from gcmiipy_tpu_torch.model import ctu_model, harness

torch.set_num_threads(1)
REL = 1e-12
RUN_REL = 1e-10
F64 = torch.float64


def _close(got, ref, rel, what=""):
    got = [got] if torch.is_tensor(got) else list(got)
    ref = [ref] if not isinstance(ref, (tuple, list)) else list(ref)
    assert len(got) == len(ref), what
    for k, (a, b) in enumerate(zip(got, ref)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, (what, k)
        assert np.isfinite(a).all() and np.isfinite(b).all(), (what, k)
        scale = max(float(np.abs(b).max()), 1e-300)
        err = float(np.abs(a - b).max())
        assert err <= rel * scale, (what, k, err, scale)


def _run_both(jstep, step, fields, steps, *args):
    """``steps`` steps of ``jstep`` (under jit) and of ``step`` from the
    numpy ``fields``; (port, JAX) results."""
    jfn = jax.jit(lambda *s: jstep(*s, *args))
    js = tuple(jnp.asarray(x) for x in fields)
    s = tuple(torch.as_tensor(np.array(x)) for x in fields)
    for _ in range(steps):
        js = jfn(*js)
        s = step(*s, *args)
    return s, js


# ------------------------------------------------------------- the configs

def _advection_1d():
    """The reference 1D advection config: 161 cells, a square wave, 2 m/s."""
    rho = np.zeros(161)
    rho[40:80] = 1.0
    return rho + 1.0, np.full(161, 2.0)


def _dam_break():
    """The canonical 1D SW dam break (test_primitive_1d.py:227-259)."""
    h = np.full(100, 10.0)
    h[:50] = 20.0
    return h, np.zeros(100)


def _unit_dam():
    h = np.full(100, 0.5)
    h[:50] = 1.0
    return h, np.zeros(100)


def _hump():
    b = np.zeros(100)
    b[20:40] = 0.5
    return 1.0 - b, np.zeros(100), b


def _gcm_1d(side=128, seed=0):
    rng = np.random.default_rng(seed)
    t0 = constants.standard_temperature * (
        constants.P0 / constants.standard_pressure) ** constants.kappa
    p = constants.standard_pressure * (1 + 1e-4 * rng.standard_normal(side))
    u = 1.0 + 0.1 * rng.standard_normal(side)
    t = t0 + 0.1 * rng.standard_normal(side)
    q = np.zeros(side)
    q[side // 4: side // 2] = 1.0
    return p, u, t, q


def _c_grid_64():
    """The 2D C-grid benchmark (matsuno_c_grid.py:145-196): a 30 m/s
    impulse on an 8000 m layer."""
    u = np.zeros((64, 64))
    u[32, 32] = 30.0
    return u, np.zeros((64, 64)), np.full((64, 64), 8000.0)


def _a_grid_16():
    p = np.full((16, 16), 1000.0)
    p[8:11, 8:11] += 1.0
    p[1, 2] += 1.0
    return np.zeros((16, 16)), np.zeros((16, 16)), p


def _temp_31():
    u = np.zeros((31, 31))
    u[15, 15] = 1.5
    return (u, np.zeros((31, 31)), np.full((31, 31), constants.standard_pressure),
            np.full((31, 31), constants.standard_temperature))


def _gcm_2d(seed=0):
    rng = np.random.default_rng(seed)
    shape = (24, 36)
    t0 = constants.standard_temperature * (
        constants.P0 / constants.standard_pressure) ** constants.kappa
    return (constants.standard_pressure * (1 + 1e-4 * rng.standard_normal(shape)),
            1.0 + 0.1 * rng.standard_normal(shape),
            0.1 * rng.standard_normal(shape),
            t0 + 0.1 * rng.standard_normal(shape),
            0.1 + 0.01 * rng.random(shape))


RUNS = {
    # name: (jax step, port step, fields, steps, extra args)
    "advect_forward_euler": (
        lambda r, u, dt, dx: jsw1.advect_forward_euler(r, u, dx, dt),
        lambda r, u, dt, dx: sw1.advect_forward_euler(r, u, dx, dt),
        _advection_1d(), 50, (1.0, 10.0)),
    "advect_matsumo": (jsw1.advect_matsumo, sw1.advect_matsumo,
                       _advection_1d(), 50, (1.0, 10.0)),
    "advect_maccormack": (jsw1.advect_maccormack, sw1.advect_maccormack,
                          _advection_1d(), 50, (1.0, 10.0)),
    "advect_lax_friedrichs": (jsw1.advect_lax_friedrichs,
                              sw1.advect_lax_friedrichs,
                              _advection_1d(), 50, (1.0, 10.0)),
    "advect_upwind": (jsw1.advect_upwind, sw1.advect_upwind,
                      _advection_1d(), 50, (1.0, 10.0)),
    "shallow_water_matsuno": (jsw1.shallow_water_matsuno,
                              sw1.shallow_water_matsuno, _dam_break(), 10,
                              (900.0, 300e3)),
    "shallow_water_upwind": (jsw1.shallow_water_upwind,
                             sw1.shallow_water_upwind, _unit_dam(), 50,
                             (1e-4, 0.01)),
    "shallow_water_upwind_boundary": (
        jsw1.shallow_water_upwind_boundary, sw1.shallow_water_upwind_boundary,
        _unit_dam(), 50, (1e-4, 0.01)),
    "shallow_water_bed_upwind_boundary": (
        lambda h, u, b, dt, dx: jsw1.shallow_water_bed_upwind_boundary(
            h, u, b, dt, dx) + (b,),
        lambda h, u, b, dt, dx: sw1.shallow_water_bed_upwind_boundary(
            h, u, b, dt, dx) + (b,),
        _hump(), 50, (1e-4, 0.01)),
    "matsuno_timestep": (jsw1.matsuno_timestep, sw1.matsuno_timestep,
                         _gcm_1d(), 50, (0.1, 100.0)),
    "momentum_matsuno_timestep": (jsw1.momentum_matsuno_timestep,
                                  sw1.momentum_matsuno_timestep,
                                  _gcm_1d(8, 1), 50, (0.1, 100.0)),
    "matsuno_scheme_c_grid": (jsw2.matsuno_scheme_c_grid,
                              sw2.matsuno_scheme_c_grid, _c_grid_64(), 50,
                              (300e3, 300.0)),
    "matsuno_scheme_a_grid": (jsw2.matsuno_scheme_a_grid,
                              sw2.matsuno_scheme_a_grid, _a_grid_16(), 50,
                              (300e3, 900.0)),
    "matsuno_scheme_temp": (jsw2.matsuno_scheme_temp, sw2.matsuno_scheme_temp,
                            _temp_31(), 50, (300e3, 300.0)),
    "matsuno_timestep_2d": (jsw2.matsuno_timestep_2d, sw2.matsuno_timestep_2d,
                            _gcm_2d(), 10, (0.1, 100.0)),
    "ctu_step": (jctu.ctu_step, ctu_model.ctu_step,
                 tuple(np.asarray(x) for x in jctu.get_initial_conditions(
                     (16, 32))), 20, (0.5, (1.0, 1.0))),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_core_matches_jax_after_steps(name):
    """One core on its reference configuration: within RUN_REL of JAX
    after its steps."""
    jstep, step, fields, steps, args = RUNS[name]
    s, js = _run_both(jstep, step, fields, steps, *args)
    _close(s, js, RUN_REL, name)


def _rand(shape, seed, loc=0.0, scale=1.0):
    return loc + scale * np.random.default_rng(seed).standard_normal(shape)


P2 = lambda s: _rand((12, 20), s, 1e5, 1e2)  # noqa: E731
T2 = lambda s: _rand((12, 20), s, 300.0, 1.0)  # noqa: E731
U2 = lambda s: _rand((12, 20), s, 0.0, 3.0)  # noqa: E731
P1 = lambda s: _rand(33, s, 1e5, 1e2)  # noqa: E731
T1 = lambda s: _rand(33, s, 300.0, 1.0)  # noqa: E731
U1 = lambda s: _rand(33, s, 0.0, 3.0)  # noqa: E731
PARTS = {
    "sw1.advect_v_u": ("advect_v_u", 1, (U1(0), 10.0)),
    "sw1.advect_rho": ("advect_rho", 1, (P1(0), U1(1), 10.0)),
    "sw1.advect_u_scaled": ("advect_u_scaled", 1,
                            (U1(0), U1(1), P1(2), P1(3), 1.0, 10.0)),
    "sw1.lf_flux": ("lf_flux", 1, (P1(0), U1(1), 1.0, 10.0)),
    "sw1.advec_q": ("advec_q", 1, (U1(0), U1(1), 10.0)),
    "sw1.calc_pu": ("calc_pu", 1, (U1(0), P1(1))),
    "sw1.un_pu": ("un_pu", 1, (U1(0), P1(1))),
    "sw1.advec_p": ("advec_p", 1, (U1(0), 10.0)),
    "sw1.advec_pu": ("advec_pu", 1, (P1(0), U1(1), U1(2), 10.0)),
    "sw1.advec_t": ("advec_t", 1, (U1(0), T1(1), 10.0)),
    "sw1.pgf": ("pgf", 1, (P1(0), T1(1), 10.0)),
    "sw1.half_timestep": ("half_timestep", 1,
                          (P1(0), U1(1), T1(2), U1(3), P1(4), U1(5), T1(6),
                           U1(7), 1.0, 100.0)),
    "sw1.advect_q_momentum": ("advect_q_momentum", 1, (T1(0), U1(1), 10.0)),
    "sw1.advect_u_momentum": ("advect_u_momentum", 1, (U1(0), U1(1), 10.0)),
    "sw1.momentum_half_timestep": ("momentum_half_timestep", 1,
                                   (P1(0), U1(1), T1(2), U1(3), P1(4), U1(5),
                                    T1(6), U1(7), 1.0, 100.0)),
    "sw2.advection_of_velocity_u": ("advection_of_velocity_u", 2,
                                    (U2(0), U2(1), 3e5)),
    "sw2.advection_of_velocity_v": ("advection_of_velocity_v", 2,
                                    (U2(0), U2(1), 3e5)),
    "sw2.geopotential_gradient_u": ("geopotential_gradient_u", 2,
                                    (P2(0), 3e5)),
    "sw2.geopotential_gradient_v": ("geopotential_gradient_v", 2,
                                    (P2(0), 3e5)),
    "sw2.advection_of_geopotential": ("advection_of_geopotential", 2,
                                      (U2(0), U2(1), P2(2), 3e5)),
    "sw2.a_grid_advection_u": ("a_grid_advection_u", 2, (U2(0), U2(1), 3e5)),
    "sw2.a_grid_advection_v": ("a_grid_advection_v", 2, (U2(0), U2(1), 3e5)),
    "sw2.a_grid_geopotential_gradient_u": ("a_grid_geopotential_gradient_u",
                                           2, (P2(0), 3e5)),
    "sw2.a_grid_geopotential_gradient_v": ("a_grid_geopotential_gradient_v",
                                           2, (P2(0), 3e5)),
    "sw2.a_grid_advection_of_geopotential": (
        "a_grid_advection_of_geopotential", 2, (U2(0), U2(1), P2(2), 3e5)),
    "sw2.density_from": ("density_from", 2, (P2(0), T2(1))),
    "sw2.geopotential_from": ("geopotential_from", 2, (T2(0), P2(1))),
    "sw2.advec_p_2d": ("advec_p_2d", 2, (U2(0), U2(1), 3e5)),
    "sw2.advec_m_2d": ("advec_m_2d", 2, (P2(0), U2(1), U2(2), 3e5)),
    "sw2.pgf_2d": ("pgf_2d", 2, (P2(0), T2(1), 3e5)),
    "sw2.advec_t_2d": ("advec_t_2d", 2, (U2(0), U2(1), T2(2), 3e5)),
    "sw2.half_timestep_2d": ("half_timestep_2d", 2,
                             (P2(0), U2(1), U2(2), T2(3), U2(4), P2(5), U2(6),
                              U2(7), T2(8), U2(9), 0.1, 100.0)),
}


@pytest.mark.parametrize("name", sorted(PARTS))
def test_part_matches_jax(name):
    """One function of the shallow-water modules on random inputs: within
    REL of each output's scale."""
    fn, dim, args = PARTS[name]
    jmod, mod = (jsw1, sw1) if dim == 1 else (jsw2, sw2)
    jout = getattr(jmod, fn)(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                               else a for a in args))
    out = getattr(mod, fn)(*(torch.as_tensor(a) if isinstance(a, np.ndarray)
                             else a for a in args))
    _close(out, jout, REL, name)


def test_ctu_initial_conditions_match_jax():
    got = ctu_model.get_initial_conditions((16, 32), device="cpu")
    ref = jctu.get_initial_conditions((16, 32))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_steppers_leave_their_inputs_alone():
    """The hard wall is set on a new tensor: the caller's u keeps its last
    cell (the harness keeps the previous state for its freeze)."""
    h, u = (torch.as_tensor(x) for x in _dam_break())
    u = u + 1.0
    before = u.clone()
    sw1.shallow_water_matsuno(h, u, 900.0, 300e3)
    sw1.shallow_water_upwind_boundary(h, u, 900.0, 300e3)
    torch.testing.assert_close(u, before, rtol=0, atol=0)


# -------------------------------------------------------------- the harness

def test_run_guarded_matches_jax():
    """The 2D C-grid benchmark through run_guarded for 40 steps with a
    collected history: the same final state, stable flag and history as
    JAX's harness."""
    fields = _c_grid_64()

    def collect(s):
        return s[2].mean()

    js, jok, jhist = jharness.run_guarded(
        lambda s: jsw2.matsuno_scheme_c_grid(*s, 300e3, 300.0),
        tuple(jnp.asarray(x) for x in fields), 40, collect=collect)
    s, ok, hist = harness.run_guarded(
        lambda s: sw2.matsuno_scheme_c_grid(*s, 300e3, 300.0),
        tuple(torch.as_tensor(x) for x in fields), 40, collect=collect)
    assert ok.dtype == torch.bool and ok.dim() == 0
    assert bool(ok) == bool(jok) is True
    _close(s, js, RUN_REL)
    _close(hist, jhist, RUN_REL)


@pytest.mark.parametrize("scheme", ["ftcs", "ft_upwind"])
def test_run_guarded_detects_blowup(scheme):
    """FTCS on the 1D advection config blows up and freezes at the same
    step as JAX's harness; upwind stays stable (JAX
    test_run_guarded_detects_blowup)."""
    q = np.zeros(161)
    q[40:80] = 1.0
    v = np.full(161, 10.0)
    jstep = getattr(jsch, scheme)
    step = getattr(sch, scheme)
    js, jok, jhist = jharness.run_guarded(
        lambda q: jstep(1.0, 10.0, jnp.asarray(v), q), jnp.asarray(q), 400,
        variation_slack=1e-3, collect=lambda q: q)
    s, ok, hist = harness.run_guarded(
        lambda q: step(1.0, 10.0, torch.as_tensor(v), q), torch.as_tensor(q),
        400, variation_slack=1e-3, collect=lambda q: q)
    assert bool(ok) == bool(jok) == (scheme == "ft_upwind")

    def first_frozen(h):
        h = np.asarray(h)
        same = np.all(h[1:] == h[:-1], axis=1)
        return int(np.argmax(same)) + 1 if same.any() else None

    assert first_frozen(hist.numpy()) == first_frozen(jhist)
    if scheme == "ftcs":
        assert first_frozen(jhist) is not None
    _close(s, js, RUN_REL)


def test_run_shallow_with_bed_matches_jax():
    """The hump bed (test_shallow_with_hump_bed) for 1000 steps: the same
    h, u, stable flag and largest Courant number as JAX, the lake at rest
    staying near 1 m."""
    h, u, b = _hump()
    jh, ju, jstable, jc = jharness.run_shallow_with_bed(
        1000, jsw1.shallow_water_bed_upwind_boundary, jnp.asarray(h),
        jnp.asarray(u), jnp.asarray(b), 1e-4, 0.01)
    th, tu, stable, c = harness.run_shallow_with_bed(
        1000, sw1.shallow_water_bed_upwind_boundary, torch.as_tensor(h),
        torch.as_tensor(u), torch.as_tensor(b), 1e-4, 0.01)
    assert all(torch.is_tensor(x) for x in (th, tu, stable, c))
    assert bool(stable) and bool(jstable)
    _close((th, c), (jh, jc), RUN_REL)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0,
                               atol=RUN_REL)
    assert abs(float((th + torch.as_tensor(b)).mean()) - 1.0) < 1e-6


def test_run_guarded_freezes_namedtuples_and_nested_states():
    """The freeze keeps the state's structure: a namedtuple of a tensor and
    a nested tuple comes back as one, frozen at the last good step."""
    from collections import namedtuple
    State = namedtuple("State", "q rest")
    q = torch.zeros(16, dtype=F64)
    q[4:8] = 1.0
    v = torch.full((16,), 10.0, dtype=F64)

    def step(s):
        q = sch.ftcs(0.1, 10.0, v, s.q)
        return State(q, (s.rest[0] + 1.0, s.rest[1] * 2.0))

    s, ok, hist = harness.run_guarded(
        step, State(q, (torch.zeros((), dtype=F64), torch.ones(2, dtype=F64))),
        200, variation_slack=0.5)
    assert isinstance(s, State) and isinstance(s.rest, tuple)
    assert not bool(ok) and hist is None
    n = int(s.rest[0])          # the steps taken before the freeze
    assert 0 < n < 200
    torch.testing.assert_close(s.rest[1], torch.full((2,), 2.0 ** n,
                                                      dtype=F64))


def test_run_guarded_makes_no_host_read(monkeypatch):
    """With a tensor's item, bool, float, int and tolist made to raise, a
    20-step run_guarded of the 2D C-grid benchmark with a history runs to
    its end: the guard stays on the device."""
    fields = tuple(torch.as_tensor(x) for x in _c_grid_64())

    def refuse(*args, **kwargs):
        raise AssertionError("a host read in run_guarded's loop")

    for name in ("item", "__bool__", "__float__", "__int__", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    s, ok, hist = harness.run_guarded(
        lambda s: sw2.matsuno_scheme_c_grid(*s, 300e3, 300.0), fields, 20,
        collect=lambda s: s[2].max())
    monkeypatch.undo()
    assert bool(ok) and hist.shape == (20,)


def _pytree_cases():
    """A 16-cell float64 state of three fields and the 1D FTCS/upwind step
    over each: numpy fields, the JAX and the port steps of one field."""
    rng = np.random.default_rng(16)
    fields = [rng.uniform(0.0, 1.0, 16) for _ in range(3)]
    v = np.full(16, 10.0)

    def jfield(q, scheme="ft_upwind"):
        return getattr(jsch, scheme)(0.1, 10.0, jnp.asarray(v), q)

    def field(q, scheme="ft_upwind"):
        return getattr(sch, scheme)(0.1, 10.0, torch.as_tensor(v), q)

    return fields, jfield, field


def _tree_close(got, ref, rel):
    """The same structure (types, dict keys) and leaves within ``rel``."""
    if isinstance(ref, dict):
        assert type(got) is dict and list(got) == list(ref)
        for key in ref:
            _tree_close(got[key], ref[key], rel)
    elif isinstance(ref, (tuple, list)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for a, b in zip(got, ref):
            _tree_close(a, b, rel)
    else:
        _close(got, ref, rel)


@pytest.mark.parametrize("case", ["list_state", "dict_state",
                                  "tuple_collect"])
def test_run_guarded_takes_any_pytree_like_jax(case):
    """A list state, a dict state (keys out of sorted order, so that the
    default guarded leaf is the first in sorted order, as
    ``jax.tree.leaves`` picks it) and a ``collect`` that returns a tuple
    and a dict: 3 steps at float64, the same final state, flag and stacked
    history as JAX's ``run_guarded`` (1e-12)."""
    fields, jfield, field = _pytree_cases()
    if case == "dict_state":
        def wrap(xs, arr):
            return {"z": arr(xs[0]), "b": arr(xs[1]), "m": arr(xs[2])}

        def jstep(s):
            return {k: jfield(x) for k, x in s.items()}

        def step(s):
            return {k: field(x) for k, x in s.items()}

        collect = None
    else:
        def wrap(xs, arr):
            return [arr(xs[0]), (arr(xs[1]), arr(xs[2]))]

        def jstep(s):
            return [jfield(s[0]), (jfield(s[1][0]), jfield(s[1][1]) * 0.5)]

        def step(s):
            return [field(s[0]), (field(s[1][0]), field(s[1][1]) * 0.5)]

        collect = None
        if case == "tuple_collect":
            def collect(s):
                return (s[0].sum(), {"y": s[1][1], "x": s[1][0].max()})

    js, jok, jhist = jharness.run_guarded(
        jstep, wrap(fields, jnp.asarray), 3, collect=collect)
    s, ok, hist = harness.run_guarded(
        step, wrap(fields, torch.as_tensor), 3, collect=collect)
    assert ok.dtype == torch.bool and ok.dim() == 0
    assert bool(ok) == bool(jok) is True
    _tree_close(s, js, REL)
    if collect is None:
        assert hist is None and jhist is None
    else:
        assert hist[1]["y"].shape == (3, 16) and hist[0].shape == (3,)
        _tree_close(hist, jhist, REL)


def test_run_guarded_dict_state_freezes_at_jax_step():
    """A dict state whose first key in sorted order ('b') blows up under
    FTCS while the first inserted ('z') stays smooth: the guard watches
    'b', as JAX's does, trips, and freezes at JAX's step (the collected
    history), with the same final state (1e-12)."""
    fields, jfield, field = _pytree_cases()

    def jstep(s):
        return {"z": jfield(s["z"]), "b": jfield(s["b"], "ftcs")}

    def step(s):
        return {"z": field(s["z"]), "b": field(s["b"], "ftcs")}

    def collect(s):
        return {"b": s["b"], "z": s["z"].sum()}

    steps = 80
    js, jok, jhist = jharness.run_guarded(
        jstep, {"z": jnp.asarray(fields[0]), "b": jnp.asarray(fields[1])},
        steps, variation_slack=0.5, collect=collect)
    s, ok, hist = harness.run_guarded(
        step, {"z": torch.as_tensor(fields[0]),
               "b": torch.as_tensor(fields[1])},
        steps, variation_slack=0.5, collect=collect)

    def first_frozen(h):
        h = np.asarray(h)
        same = np.all(h[1:] == h[:-1], axis=1)
        return int(np.argmax(same)) + 1 if same.any() else None

    assert not bool(jok) and not bool(ok)
    frozen = first_frozen(jhist["b"])
    assert frozen is not None and 1 < frozen < steps
    assert first_frozen(hist["b"].numpy()) == frozen
    _tree_close(s, js, REL)
    _tree_close(hist, jhist, REL)
