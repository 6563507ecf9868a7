"""The port's CLI, ``python -m gcmiipy_tpu_torch`` (tests/test_cli.py's
cases against the JAX package's CLI), on the CPU.

Every ``ModelConfig`` knob has a flag that reaches the config; the flags
are the JAX CLI's plus ``--device``; a run prints the JAX summary, writes
the same metrics (1e-10 at float64) and exits 3 when the guard trips.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gcmiipy_tpu.__main__ import main as jmain
from gcmiipy_tpu_torch.__main__ import main
from gcmiipy_tpu_torch.model.config import ModelConfig

torch.set_num_threads(1)
SMALL = ["run", "--height", "8", "--width", "16", "--layers", "3", "--dt",
         "900", "--steps", "3"]
CPU = ["--device", "cpu"]


def test_cli_run_matches_jax_metrics(tmp_path, capsys):
    """The same run through both CLIs: exit 0, finite fields, and one
    metrics line a step, the JAX package's at 1e-10."""
    port, ref = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert main(SMALL + CPU + ["--guard", "--dtype", "float64", "--metrics",
                               str(port)]) == 0
    assert "finite: True" in capsys.readouterr().out
    assert jmain(SMALL + ["--guard", "--dtype", "float64", "--metrics",
                          str(ref)]) == 0
    lines = [[json.loads(ln) for ln in path.read_text().splitlines()]
             for path in (port, ref)]
    assert len(lines[0]) == len(lines[1]) == 3
    for a, b in zip(*lines):
        for k in a:
            if k != "time":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-10,
                                           atol=1e-12, err_msg=k)


def test_cli_blown_run_exit_code(capsys):
    """A guard-tripped run exits 3, as the JAX CLI's (the reference's
    360 K potential temperature trips guard_t_max=200)."""
    args = SMALL + ["--guard", "--guard-t-max", "200"]
    assert main(args + CPU) == 3
    assert "BLOWN UP" in capsys.readouterr().err
    assert jmain(args) == 3


def test_cli_metrics_requires_stats():
    args = ["run", "--steps", "1", "--metrics", "m.jsonl", "--no-stats"]
    assert main(args + CPU) == jmain(args) == 2


def test_cli_ring_needs_its_ranks(capsys):
    """--mesh-shape 2 in a single process: exit 2 naming the ranks it
    needs; --mesh-shape 1 is a ring of one rank."""
    assert main(SMALL + CPU + ["--mesh-shape", "2"]) == 2
    assert "needs 2 ranks" in capsys.readouterr().err
    assert main(["run", "--height", "16", "--width", "128", "--layers",
                 "2", "--dt", "300", "--steps", "2", "--backend", "mega4",
                 "--mesh-shape", "1"] + CPU) == 0
    assert "ring of 1" in capsys.readouterr().out


def test_cli_process_flags_reach_initialize(monkeypatch):
    """--coordinator, --num-processes and --process-id reach
    parallel.distributed.initialize, with the device."""
    seen = {}

    def fake_initialize(coordinator_address=None, num_processes=None,
                        process_id=None, device="cuda"):
        seen.update(coordinator_address=coordinator_address,
                    num_processes=num_processes, process_id=process_id,
                    device=device)
        raise _Captured

    monkeypatch.setattr(
        "gcmiipy_tpu_torch.parallel.distributed.initialize", fake_initialize)
    with pytest.raises(_Captured):
        main(SMALL + CPU + ["--coordinator", "10.0.0.1:29500",
                            "--num-processes", "4", "--process-id", "2"])
    assert seen == dict(coordinator_address="10.0.0.1:29500",
                        num_processes=4, process_id=2, device="cpu")


def test_cli_info_and_module_entry():
    assert main(["info"]) == 0
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "gcmiipy_tpu_torch", "run"]
                         + SMALL[1:] + CPU, capture_output=True, text=True,
                         timeout=300, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "finite: True" in out.stdout


def test_cli_defaults_to_the_card():
    """Without a card the default device is an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        main(SMALL)


# Every ModelConfig knob must be settable from the CLI and land in the
# config run_model receives (JAX tests/test_cli.py's flag matrix).
_BASE = ["run", "--steps", "1"]
FLAG_CASES = {
    "giss_sige": (["--giss-sige", "--layers", "9"], True),
    "ptop": (["--ptop", "500"], 500.0),
    "topography": (["--topography", "hansen"], "hansen"),
    "sea_level_temp": (["--sea-level-temp", "290"], 290.0),
    "land_cover": (["--land-cover", "hansen"], "hansen"),
    "albedo_land": (["--albedo-land", "0.4"], 0.4),
    "dt": (["--dt", "450"], 450.0),
    "physics": (["--physics"], True),
    "physics_every": (["--physics-every", "4"], 4),
    "seasonal": (["--seasonal"], True),
    "obliquity": (["--obliquity", "20"], 20.0),
    "year_days": (["--year-days", "360"], 360.0),
    "coriolis": (["--coriolis"], True),
    "convection": (["--convection"], True),
    "evaporation": (["--evaporation", "--physics"], True),
    "gw0": (["--gw0", "0.1"], 0.1),
    "precipitation": (["--precipitation", "--physics"], True),
    "rh_crit": (["--rh-crit", "0.9"], 0.9),
    "drag_tau": (["--drag-tau", "3600"], 3600.0),
    "shapiro_every": (["--shapiro-every", "4"], 4),
    "shapiro_order": (["--shapiro-every", "4", "--shapiro-order", "4"], 4),
    "shapiro_fields": (["--shapiro-fields", "pt"], "pt"),
    "shapiro_slp": (["--shapiro-slp"], True),
    "t_lw": (["--t-lw", "0.2"], 0.2),
    "t_sw": (["--t-sw", "0.8"], 0.8),
    "albedo": (["--albedo", "0.25"], 0.25),
    "radiation": (["--radiation", "4band"], "4band"),
    "dtype": (["--dtype", "float64"], "float64"),
    "polar_filter": (["--polar-filter", "dft"], "dft"),
    "backend": (["--backend", "mega4"], "mega4"),
    "stream_pipeline": (["--stream-pipeline"], True),
    "stream_wide_native": (["--stream-wide-native"], True),
    "stream_steps": (["--stream-steps", "10"], 10),
    "q_limiter": (["--q-limiter"], True),
    "filter_precision": (["--filter-precision", "highest"], "highest"),
    "filter_split_tau": (["--filter-split-tau", "0.25"], 0.25),
    "stats": (["--no-stats"], False),
    "guard": (["--guard"], True),
    "guard_p_max": (["--guard-p-max", "120000"], 120000.0),
    "guard_p_min": (["--guard-p-min", "100"], 100.0),
    "guard_t_max": (["--guard-t-max", "1000"], 1000.0),
    "guard_t_min": (["--guard-t-min", "10"], 10.0),
    "checkpoint_dir": (["--checkpoint-dir", "ckpt_x"], "ckpt_x"),
    "checkpoint_every": (["--checkpoint-every", "7"], 7),
    "metrics_path": (["--metrics", "m.jsonl"], "m.jsonl"),
}
# grid dims ride as separate run_model arguments; sig_func is a callable
_EXCLUDED = {"height", "width", "layers", "sig_func"}


def test_flag_matrix_is_complete():
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    assert fields - _EXCLUDED == set(FLAG_CASES), (
        "ModelConfig fields without a CLI flag case: "
        f"{fields - _EXCLUDED - set(FLAG_CASES)}; stale cases: "
        f"{set(FLAG_CASES) - fields}")


def _flags(parser_main):
    """The option strings of a CLI's 'run' subcommand."""
    import argparse
    seen = {}

    class Stop(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Stop):
            parser_main(["run"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return {s for a in sub.choices["run"]._actions
            for s in a.option_strings}


def test_flags_are_the_jax_cli_flags_and_device():
    assert _flags(main) == _flags(jmain) | {"--device"}


class _Captured(Exception):
    pass


@pytest.mark.parametrize("field", sorted(FLAG_CASES))
def test_cli_flag_reaches_config(field, monkeypatch):
    args, expected = FLAG_CASES[field]
    seen = {}

    def fake_run_model(height, width, layers, dt, steps, callback=None,
                       config=None, device="cuda", mesh=None):
        seen["config"] = config
        seen["dims"] = (height, width, layers)
        seen["device"] = device
        raise _Captured

    monkeypatch.setattr("gcmiipy_tpu_torch.model.driver.run_model",
                        fake_run_model)
    with pytest.raises(_Captured):
        main(_BASE + ["--height", "6", "--width", "10"] + args + CPU)
    assert getattr(seen["config"], field) == expected
    assert seen["dims"][:2] == (6, 10)
    assert seen["device"] == "cpu"
