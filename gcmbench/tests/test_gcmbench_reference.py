"""The benchmark's reference against the port's plain 'xla' path, float64,
on the CPU at small grids: both configurations, a few steps each, over
every physics cadence they have.  The reference imports nothing of the
port; this test imports both."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from gcmbench import bench, members  # noqa: E402
from gcmbench.reference import model as ref_model  # noqa: E402

torch.set_num_threads(2)


def _pool(config, traffic):
    return members.Pool(config["perturbation"], config["model"]["layers"],
                        traffic["height"], traffic["width"], "cpu")


def _port_member(config, traffic, index):
    program = bench.Program(config, traffic, _pool(config, traffic), "cpu")
    state = program.start(index)
    energies = []
    for _ in range(traffic["member_steps"] // traffic["interval_steps"]):
        state, ok, energy = program.read(program.run(state))
        assert ok
        energies.append(energy)
    return state, energies


@pytest.mark.parametrize("cell,height,width,steps,interval", [
    ("grey-flagship", 16, 32, 6, 3),
    ("surface-flagship", 16, 32, 8, 4),
    ("grey-modelii", 24, 36, 6, 2),
])
def test_reference_equals_plain_port_float64(cell, height, width, steps,
                                             interval):
    loaded = bench.load_cell(cell, ROOT)
    config = dict(loaded["config"])
    config["model"] = dict(config["model"], backend="xla", dtype="float64")
    traffic = dict(loaded["traffic"], height=height, width=width,
                   member_steps=steps, interval_steps=interval)
    state, energies = _port_member(config, traffic, 5)
    ref = ref_model.Reference(config["model"], height, width, traffic["dt"])
    s = bench.perturbed_start(ref, ref.start(config["start"] == "moist"),
                              _pool(config, traffic), 5)
    ref_energies = []
    for n in range(steps):
        s = ref.step(s, n, n * traffic["dt"])
        if (n + 1) % interval == 0:
            ref_energies.append(float(ref.energy(s)))
    assert not ref.bad(s)
    fields = bench.program_fields(state)
    assert bench.field_gap(fields, s) < 1e-11
    for a, b in zip(energies, ref_energies):
        assert abs(a - b) / abs(b) < 1e-12
    # the physics moved the state: every configured cadence ran
    start = ref.start(config["start"] == "moist")
    assert float((s.gt - start.gt).abs().max()) > 1e-3


def test_reference_takes_nothing_of_the_port():
    with pytest.raises(ValueError):
        ref_model.check_model({"layers": 9})
    loaded = bench.load_cell("grey-flagship", ROOT)
    model = dict(loaded["config"]["model"], q_limiter=True)
    with pytest.raises(ValueError):
        ref_model.check_model(model)
