"""The port's plots (``utils/plotting.py``) and the CLI's ``--plot-dir``, on
the CPU (JAX tests/test_harness_extras.py's plotting cases, run on the
port).  matplotlib is installed here; the card's machine has none, which
the last test stands in for."""

import os
import sys

import torch

from gcmiipy_tpu_torch.__main__ import main
from gcmiipy_tpu_torch.model import driver
from gcmiipy_tpu_torch.model.config import ModelConfig
from gcmiipy_tpu_torch.utils import plotting

torch.set_num_threads(1)
SMALL = ["run", "--height", "8", "--width", "16", "--layers", "3", "--dt",
         "900", "--steps", "3", "--device", "cpu"]


def test_field_and_energy_plots(tmp_path):
    """A field and the energy traces of a 3-step run_model, each a PNG."""
    out = driver.run_model(8, 8, 3, 900.0, 3, device="cpu",
                           config=ModelConfig(dtype="float64"))
    p, stats = out[0], out[7]
    f1 = plotting.save_field_plot(p, str(tmp_path / "p.png"), title="p")
    f2 = plotting.save_field_plot(out[1], str(tmp_path / "u.png"))
    f3 = plotting.save_energy_plot(stats, str(tmp_path / "energy.png"))
    for f in (f1, f2, f3):
        assert os.path.getsize(f) > 1000


def test_plot_callback_via_run_model(tmp_path):
    """make_field_plot_callback through run_model(callback=): a PNG every
    second step of four."""
    cb = plotting.make_field_plot_callback(str(tmp_path), every=2)
    driver.run_model(8, 8, 3, 900.0, 4, callback=cb, device="cpu",
                     config=ModelConfig(dtype="float64", stats=False))
    pngs = sorted(p.name for p in tmp_path.glob("*.png"))
    assert pngs == ["step_000000_p.png", "step_000002_p.png"]


def test_cli_plot_dir_writes_the_six_plots(tmp_path, capsys):
    """--plot-dir writes the final p, u, v, t and q and the energy trace."""
    out = tmp_path / "plots"
    assert main(SMALL + ["--plot-dir", str(out)]) == 0
    want = ["energy.png"] + [f"final_{k}.png" for k in "puvtq"]
    assert sorted(os.listdir(out)) == sorted(want)
    assert "plots: " in capsys.readouterr().out
    for name in want:
        assert os.path.getsize(out / name) > 1000


def test_cli_plot_dir_without_matplotlib_exits_2(tmp_path, monkeypatch,
                                                  capsys):
    """Without matplotlib --plot-dir exits 2 before the run starts (no
    summary printed, no directory made), naming matplotlib."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    ran = []
    monkeypatch.setattr(driver, "run_model",
                        lambda *a, **k: ran.append(1))
    out = tmp_path / "plots"
    assert main(SMALL + ["--plot-dir", str(out)]) == 2
    captured = capsys.readouterr()
    assert "matplotlib" in captured.err
    assert not ran and "run:" not in captured.out and not out.exists()
