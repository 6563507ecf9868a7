"""PyTorch port: the benchmark's ``gcm2-modelii`` configuration (Model II's
setup: a rotating Earth, Model II's 9 sigma edges under a 10 hPa top and a
seasonal sun over the Hansen surface) against the benchmark's float64
reference (``gcmbench/reference/model.py``).

The configuration is read from ``gcmbench/configs/gcm2-modelii.json``
itself, so that this test and the ``modelii-flagship`` cell cannot drift
apart:

* on the CPU, the port's run function with that ``model`` in float64 at
  16 x 32 ('stream' runs its per-step fall-back there: 32 columns are off
  K7's envelope) from a member of the configuration's pool, over 8 steps in
  intervals of 4 (the physics every 2nd step, the Shapiro filter every
  4th), equals the reference to 1e-11 in the fields and 1e-12 in the
  energy, and the three features move the state far beyond that;
* on the card (``gpu``), K7 at the smallest grid its envelope takes
  (16 x 128) in float32 stays within the cell's limits
  (``gcmbench/limits/modelii-flagship.json``) of the float64 reference,
  interval by interval, as the cell's check holds it.
"""

import json
import os
import sys
import warnings

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gcmbench import bench, members  # noqa: E402
from gcmbench.reference import model as ref_model  # noqa: E402

torch.set_num_threads(1)

CONFIG = os.path.join(ROOT, "gcmbench", "configs", "gcm2-modelii.json")
LIMITS = os.path.join(ROOT, "gcmbench", "limits", "modelii-flagship.json")
MEMBER = 5


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def _setup(height, width, steps, interval, device, **model):
    config = _load(CONFIG)
    config = dict(config, model=dict(config["model"], **model))
    traffic = dict(_load(os.path.join(ROOT, "gcmbench", "traffic",
                                      "flagship-512x1024.json")),
                   height=height, width=width, member_steps=steps,
                   interval_steps=interval)
    pool = members.Pool(config["perturbation"], config["model"]["layers"],
                        height, width, device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        program = bench.Program(config, traffic, pool, device)
    return config, traffic, pool, program, [str(w.message) for w in caught]


def _reference(config, traffic, pool):
    """The reference's member on the CPU: its last state and the energy
    at the end of each output interval."""
    ref = ref_model.Reference(config["model"], traffic["height"],
                              traffic["width"], traffic["dt"])
    s = bench.perturbed_start(ref, ref.start(config["start"] == "moist"),
                              pool, MEMBER)
    energies = []
    for n in range(traffic["member_steps"]):
        s = ref.step(s, n, n * traffic["dt"])
        if (n + 1) % traffic["interval_steps"] == 0:
            energies.append(float(ref.energy(s)))
    assert not ref.bad(s)
    return s, energies


def test_configuration_is_model_ii_on_gcm2_surface():
    """gcm2-surface's model key for key, but for rotation, Model II's
    edges and top and the seasonal sun; the reference takes it."""
    model = _load(CONFIG)["model"]
    surface = _load(os.path.join(ROOT, "gcmbench", "configs",
                                 "gcm2-surface.json"))["model"]
    ref_model.check_model(model)
    changed = {k: v for k, v in model.items() if surface.get(k) != v}
    assert changed == dict(coriolis=True, sigma="giss", ptop=1000.0,
                           seasonal=True, obliquity=23.44, year_days=365.0)
    assert set(surface) <= set(model)


def test_model_ii_equals_the_reference_float64():
    config, traffic, pool, program, _ = _setup(16, 32, 8, 4, "cpu",
                                               dtype="float64")
    assert program.cfg.coriolis and program.cfg.giss_sige
    assert program.cfg.seasonal and program.cfg.ptop == 1000.0
    state = program.start(MEMBER)
    energies = []
    for _ in range(2):
        state, ok, energy = program.read(program.run(state))
        assert ok
        energies.append(energy)
    assert int(state.step) == 8
    s, ref_energies = _reference(config, traffic, pool)
    assert bench.field_gap(bench.program_fields(state), s) < 1e-11
    for a, b in zip(energies, ref_energies):
        assert abs(a - b) / abs(b) < 1e-12
    # the three features move the state far beyond that tolerance: the
    # check holds them, not a run that leaves them out on both sides
    plain = dict(config, model=dict(config["model"], coriolis=False,
                                    sigma="manabe", ptop=0.0,
                                    seasonal=False))
    without, _ = _reference(plain, traffic, pool)
    assert bench.field_gap(bench.reference_fields(s), without) > 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_k7_stays_within_the_cells_limits_on_gpu(cuda_device):
    """K7's 2-step calls with the extras between, at 16 x 128 in float32,
    over two 20-step intervals: each interval's output against the float64
    reference run from the program's own input, and the start against the
    reference's, within the limits of ``modelii-flagship``."""
    config, traffic, pool, program, caught = _setup(16, 128, 40, 20,
                                                    cuda_device)
    assert not any("falls back" in w for w in caught), caught
    assert program.run.chunk_steps == 2
    limits = _load(LIMITS)
    ref = ref_model.Reference(config["model"], 16, 128, traffic["dt"],
                              dtype=torch.float64, device=cuda_device)
    base = ref.start(True)
    state = program.start(MEMBER)
    start_gap = bench.field_gap(bench.program_fields(state),
                                bench.perturbed_start(ref, base, pool,
                                                      MEMBER))
    assert start_gap <= limits["start_gap"], start_gap
    for k in range(2):
        kept = dict(step=20 * k, input={
            f: x.clone() for f, x in bench.program_fields(state).items()})
        state, ok, energy = program.read(program.run(state))
        assert ok
        kept.update(output=bench.program_fields(state), energy=energy)
        gaps, bad = bench.interval_gaps(ref, kept, traffic)
        assert not bad
        assert gaps["state_gap"] <= limits["state_gap"], gaps
        assert gaps["energy_gap"] <= limits["energy_gap"], gaps
