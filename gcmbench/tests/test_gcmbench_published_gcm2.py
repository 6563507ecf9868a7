"""GCM-II as Hansen et al. 1983 publish it, in the benchmark's reference:
a rotating Earth (``coriolis``), Model II's 9 sigma edges under a 10 hPa
top (``sigma: "giss"``, ``ptop`` 1000) and a seasonal sun (``seasonal``
with ``obliquity`` and ``year_days``).  Each feature alone and all three
over the Hansen maps, with the grey and the four-band physics, against the
port's plain 'xla' path in float64 on the CPU; the sign of the Coriolis
terms by hand; the keys ``check_model`` takes and refuses; the program's
geometry under Model II's edges; and, with every new key off, the
reference's operations as they were before these features."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from gcmbench import bench, counts, members  # noqa: E402
from gcmbench.reference import model as ref_model  # noqa: E402

torch.set_num_threads(1)

SEASONAL = dict(seasonal=True, obliquity=23.44, year_days=365.0)
MODEL_II = dict(SEASONAL, coriolis=True, sigma="giss", ptop=1000.0)
VARIANTS = {
    "rotation": dict(coriolis=True),
    "giss": dict(sigma="giss", ptop=1000.0),
    "seasonal": SEASONAL,
    "model_ii": dict(MODEL_II, topography="hansen", land_cover="hansen"),
}
# the cell whose configuration gives each physics its base, and the steps
# and output interval that run every cadence it has
PHYSICS = {"grey": ("grey-flagship", 6, 2), "4band": ("surface-flagship", 8, 4)}
GRIDS = {(24, 36): 225.0, (16, 32): 30.0}


def _pool(config, traffic):
    return members.Pool(config["perturbation"], config["model"]["layers"],
                        traffic["height"], traffic["width"], "cpu")


def _setup(physics, variant, height, width):
    cell, steps, interval = PHYSICS[physics]
    loaded = bench.load_cell(cell, ROOT)
    config = dict(loaded["config"])
    config["model"] = dict(config["model"], backend="xla", dtype="float64",
                           **VARIANTS[variant])
    traffic = dict(loaded["traffic"], height=height, width=width,
                   dt=GRIDS[(height, width)], member_steps=steps,
                   interval_steps=interval)
    return config, traffic


def _reference(config, traffic, index):
    """The reference's member ``index``: its last state and the energy at
    the end of each output interval."""
    ref = ref_model.Reference(config["model"], traffic["height"],
                              traffic["width"], traffic["dt"])
    s = bench.perturbed_start(ref, ref.start(config["start"] == "moist"),
                              _pool(config, traffic), index)
    energies = []
    for n in range(traffic["member_steps"]):
        s = ref.step(s, n, n * traffic["dt"])
        if (n + 1) % traffic["interval_steps"] == 0:
            energies.append(float(ref.energy(s)))
    assert not ref.bad(s)
    return s, energies


@pytest.mark.parametrize("height,width", sorted(GRIDS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("physics", sorted(PHYSICS))
def test_published_features_equal_plain_port_float64(physics, variant,
                                                     height, width):
    config, traffic = _setup(physics, variant, height, width)
    program = bench.Program(config, traffic, _pool(config, traffic), "cpu")
    state = program.start(5)
    energies = []
    for _ in range(traffic["member_steps"] // traffic["interval_steps"]):
        state, ok, energy = program.read(program.run(state))
        assert ok
        energies.append(energy)
    s, ref_energies = _reference(config, traffic, 5)
    assert bench.field_gap(bench.program_fields(state), s) < 1e-11
    for a, b in zip(energies, ref_energies):
        assert abs(a - b) / abs(b) < 1e-12
    # the features moved the state far beyond that tolerance: the check
    # holds them, not a run that leaves them out on both sides
    plain = dict(config, model=dict(config["model"], coriolis=False,
                                    sigma="manabe", seasonal=False))
    without, _ = _reference(plain, traffic, 5)
    assert bench.field_gap(bench.reference_fields(s), without) > 1e-8


def _wind_tendencies(coriolis):
    """(dut, dvt) of a uniform eastward wind of 10 m/s at rest otherwise."""
    model = dict(bench.load_cell("grey-flagship", ROOT)["config"]["model"])
    geom = ref_model.make_geometry(model, 16, 32, torch.float64, "cpu")
    p = torch.full((16, 32), 1.0e5, dtype=torch.float64)
    u = torch.full((9, 16, 32), 10.0, dtype=torch.float64)
    v = torch.zeros_like(u)
    return geom, ref_model.advec_momentum(u, v, u * ref_model.iph(p),
                                          v * ref_model.jph(p), geom,
                                          coriolis)


def test_an_eastward_wind_turns_by_the_hemisphere():
    """With j southward a positive v is southward: the Coriolis part of the
    v tendency of an eastward wind is positive (southward) in the northern
    hemisphere and negative (northward) in the southern one, f at v's half
    row times the zonal mass flux; the u tendency has none, as v is 0."""
    geom, (dut, dvt) = _wind_tendencies(True)
    _, (dut0, dvt0) = _wind_tendencies(False)
    assert torch.equal(dut, dut0)
    turn = (dvt - dvt0)[:, :-1]  # the last half row is the southern wall
    lat_h = geom.lat[:, 0] - 0.5 * (geom.lat[0, 0] - geom.lat[1, 0])
    north, south = lat_h[:-1] > 0, lat_h[:-1] < 0
    assert bool((turn[:, north] > 0).all())
    assert bool((turn[:, south] < 0).all())
    f = 2 * 2 * torch.pi / 86400.0 * torch.sin(lat_h[:-1])
    torch.testing.assert_close(turn, (f * 1.0e6)[None, :, None].expand_as(
        turn), rtol=1e-12, atol=0.0)


def _model_ii():
    model = dict(bench.load_cell("surface-flagship", ROOT)["config"]["model"])
    return dict(model, **MODEL_II)


@pytest.mark.parametrize("change", [
    dict(q_limiter=True),
    dict(layers=40),
    dict(sigma="hybrid"),
    dict(obliquity=None),
    dict(year_days=None),
])
def test_check_model_refuses(change):
    model = _model_ii()
    model.update(change)
    model = {k: v for k, v in model.items() if v is not None}
    with pytest.raises(ValueError):
        ref_model.check_model(model)


def test_check_model_takes_model_ii_and_the_cells_as_they_are():
    ref_model.check_model(_model_ii())
    for cell in ("grey-flagship", "surface-flagship", "grey-l40-flagship"):
        model = bench.load_cell(cell, ROOT)["config"]["model"]
        assert not set(ref_model.SEASONAL) & set(model)
        ref_model.check_model(model)


def test_program_builds_model_ii_edges():
    config = dict(bench.load_cell("surface-flagship", ROOT)["config"])
    config["model"] = dict(config["model"], backend="xla", dtype="float64",
                           **MODEL_II)
    traffic = dict(bench.load_cell("surface-flagship", ROOT)["traffic"],
                   height=24, width=36, dt=225.0)
    program = bench.Program(config, traffic, _pool(config, traffic), "cpu")
    assert program.cfg.giss_sige and program.cfg.ptop == 1000.0
    ref = ref_model.make_geometry(config["model"], 24, 36, torch.float64,
                                  "cpu")
    edges = torch.tensor(ref_model.GISS_SIGE, dtype=torch.float64)
    assert torch.equal(program.geom.sige.flatten().cpu(), edges)
    for name in ("sig", "dsig", "sigt", "sigb"):
        assert torch.equal(getattr(program.geom, name).cpu(),
                           getattr(ref, name)), name
    assert float(program.geom.ptop) == float(ref.ptop) == 1000.0
    with pytest.raises(ValueError):
        bench.Program(dict(config, model=dict(config["model"],
                                              sigma="hybrid")),
                      traffic, _pool(config, traffic), "cpu")


# the reference's operations over one 4-step interval from member 3 of each
# cell's configuration (16 x 32; 24 x 36 for grey-modelii), as counted
# before rotation, Model II's edges and the seasonal sun were added
COUNTED = {"grey-flagship": 8680756.0, "surface-flagship": 10729220.0,
           "grey-modelii": 14753118.944897234,
           "grey-l40-flagship": 39641752.0}


@pytest.mark.parametrize("cell", sorted(COUNTED))
def test_features_off_run_the_same_operations(cell):
    loaded = bench.load_cell(cell, ROOT)
    config = loaded["config"]
    height, width = (24, 36) if cell == "grey-modelii" else (16, 32)
    traffic = dict(loaded["traffic"], height=height, width=width,
                   member_steps=4, interval_steps=4)
    ref = ref_model.Reference(config["model"], height, width, traffic["dt"])
    base = ref.start(config["start"] == "moist")
    start = bench.reference_fields(bench.perturbed_start(
        ref, base, _pool(config, traffic), 3))
    counter = counts.OpCounter()
    bench.reference_interval(ref, start, 0, traffic, counter)
    assert counter.ops == pytest.approx(COUNTED[cell], rel=1e-15)
