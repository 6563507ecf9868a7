"""The operation and byte counters and the peak table."""

import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from gcmbench import bench, counts, members  # noqa: E402
from gcmbench.reference import model as ref_model  # noqa: E402

torch.set_num_threads(2)


def test_fft_formula():
    assert counts.fft_ops(8) == 2.5 * 8 * 3
    assert counts.fft_ops(1024) == 2.5 * 1024 * 10
    assert counts.fft_ops(1) == 0.0


def test_state_bytes_by_hand():
    # 2 layers: p + 4 * 2 fields + 4 ground planes = 13 planes of 4 x 8
    assert counts.state_bytes(2, 4, 8, "float32") == 2 * 13 * 32 * 4
    assert counts.state_bytes(9, 512, 1024, "float64") == \
        2 * 41 * 512 * 1024 * 8


def test_counter_small_cases():
    x = torch.ones(10, dtype=torch.float64)
    with counts.OpCounter() as c:
        y = x * 2.0 + x
    assert c.ops == 20
    with counts.OpCounter() as c:
        y.sum()
        torch.roll(y, 1).clone()
    assert c.ops == 10
    rows = torch.ones(3, 8, dtype=torch.float64)
    with counts.OpCounter() as c:
        f = torch.fft.rfft(rows, dim=-1)
    assert c.ops == 3 * counts.fft_ops(8)
    with counts.OpCounter() as c:
        torch.fft.irfft(f * 0.5, n=8, dim=-1)
    # the complex product counts 2 an element, the inverse 3 FFTs of 8
    assert c.ops == 2 * 3 * 5 + 3 * counts.fft_ops(8)


def _count(cell, backend):
    loaded = bench.load_cell(cell, ROOT)
    config = dict(loaded["config"])
    config["model"] = dict(config["model"], backend=backend)
    traffic = dict(loaded["traffic"], height=16, width=32, member_steps=4,
                   interval_steps=2)
    ref = ref_model.Reference(config["model"], 16, 32, traffic["dt"])
    pool = members.Pool(config["perturbation"], config["model"]["layers"],
                        16, 32, "cpu")
    base = ref.start(config["start"] == "moist")
    start = bench.reference_fields(bench.perturbed_start(ref, base, pool, 0))
    counter = counts.OpCounter()
    bench.reference_interval(ref, start, 0, traffic, counter)
    bench.reference_interval(ref, start, 2, traffic, counter)
    return counter.ops


@pytest.mark.parametrize("cell", ["grey-flagship", "surface-flagship"])
def test_count_repeats_and_ignores_backend(cell):
    a = _count(cell, "stream")
    assert a == _count(cell, "stream")
    assert a == _count(cell, "xla")
    assert a > 0 and math.isfinite(a)


def test_peaks_and_least_time():
    assert counts.PEAK_OPS_PER_S["float32"] == 67e12
    assert counts.PEAK_OPS_PER_S["float64"] == 34e12
    assert counts.PEAK_BYTES_PER_S == 3.35e12
    t, bound = counts.least_seconds(67e12, 1.0, "float32")
    assert (t, bound) == (1.0, "operations")
    t, bound = counts.least_seconds(1.0, 3.35e12, "float32")
    assert (t, bound) == (1.0, "bytes")
