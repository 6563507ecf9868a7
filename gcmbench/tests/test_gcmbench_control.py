"""The comparison that decides ``correct`` fails what it must, at a size a
CPU test run holds (GCM-II's 24 x 36 grid, members of 32 steps): the
control (the reference computed in bfloat16 in the program's place), and
runs of the harness whose timed path returns its state unchanged or alters
its answer where it is produced, each read by the calibration and run
through the harness.  A sound run passes."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from gcmbench import bench, calibrate, faults  # noqa: E402

torch.set_num_threads(2)
SEEDS = (3141592653, 2718281828, 1414213562)


def _cell():
    loaded = bench.load_cell("grey-modelii", ROOT)
    loaded["traffic"] = dict(loaded["traffic"], member_steps=32,
                             interval_steps=16, check_intervals=2)
    return loaded


def test_control_fails_a_limit_on_every_seed():
    """The control, on three pool members, reads above a limit; the
    program's own readings on a member read below every limit."""
    loaded = _cell()
    limits = loaded["limits"]
    records = calibrate.calibrate(loaded, device="cpu", sound=[0],
                                  broken=[0, 1, 2])
    controls = [r for r in records if r["kind"] == "control"]
    assert len(controls) == 3
    for r in controls:
        assert r["worst"]["state_gap"] > limits["state_gap"], r
    for name in faults.FAULTS:
        for r in records:
            if r["kind"] == name:
                assert any(r["worst"][k] > limits[k] for k in r["worst"]), r
    sound = [r for r in records if r["kind"] == "program"]
    assert all(r["worst"][k] <= limits[k] for r in sound for k in r["worst"])


def _run(wrap=None, seed=SEEDS[0]):
    result, found = bench.run_cell(_cell(), seed, 0.5, device="cpu",
                                   fault=wrap)
    assert not found
    return result


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"] is True
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_timed_path_is_not_correct(fault):
    result = _run(faults.FAULTS[fault])
    assert result["correct"] is False
