"""The harness: BENCHMARK.json resolves by name, its names and units keep
to their characters, nothing the benchmark runs imports JAX or the JAX
package, the reference imports nothing of the port, the members' pool
and order, the per-layer readers and the trace reduction, and no
measurement without a card."""

import ast
import itertools
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BENCH = os.path.join(ROOT, "gcmbench")
sys.path.insert(0, ROOT)

from gcmbench import bench, members, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _sources(under):
    for dirpath, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_every_workload_resolves_by_name():
    spec = _spec()
    for w in spec["workloads"]:
        loaded = bench.load_cell(w["name"], ROOT)
        assert loaded["config"]["name"] == w["config"]
        assert loaded["traffic"]["name"] == w["traffic"]
        assert loaded["limits"] is not None, w["name"]
        for m in loaded["per_layer"]:
            assert callable(bench.metric_reader(m["name"], ROOT))
        # every cell reports setup_s, another end-to-end metric and a
        # per-layer metric that moves one of them
        e2e = {m["name"] for m in loaded["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert loaded["per_layer"]
        assert all(m["moves"] in e2e for m in loaded["per_layer"])
    for c in spec["configs"]:
        assert c["file"].startswith("gcmbench/configs/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_names_and_units_keep_to_their_characters():
    spec = _spec()
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [w["config"] for w in spec["workloads"]]
    names += [w["traffic"] for w in spec["workloads"]]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    layers = {m["moves"] for m in spec["per_layer"]}
    assert layers <= {m["name"] for m in spec["end_to_end"]}
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        tops = set(_imported_tops(path))
        assert not tops & {"jax", "jaxlib", "flax", "gcmiipy_tpu"}, path


def test_reference_imports_nothing_of_the_port():
    for path in _sources(os.path.join(BENCH, "reference")):
        tops = set(_imported_tops(path))
        assert "gcmiipy_tpu_torch" not in tops, path
        assert tops <= {"math", "typing", "numpy", "torch"}, (path, tops)


def test_forbidden_modules_compares_whole_names():
    assert "gcmiipy_tpu_torch" not in bench.FORBIDDEN
    found = bench.forbidden_modules()
    assert found == sorted({m.split(".")[0] for m in sys.modules}
                           & {"jax", "jaxlib", "flax", "gcmiipy_tpu"})


def test_every_seed_runs_the_same_pool_in_its_own_order():
    a = list(itertools.islice(members.order(2 ** 31 + 11, 8), 24))
    b = list(itertools.islice(members.order(7, 8), 24))
    for run in (a, b):
        for k in range(0, 24, 8):
            assert sorted(run[k:k + 8]) == list(range(8))
    assert a != b
    assert a == list(itertools.islice(members.order(2 ** 31 + 11, 8), 24))
    spec = dict(_spec_config("gcm2-grey")["perturbation"])
    one = members.Pool(spec, 3, 8, 16, "cpu").delta(5)
    two = members.Pool(spec, 3, 8, 16, "cpu").delta(5)
    for f in members.FIELDS:
        assert torch.equal(one[f], two[f])
    assert float(one["t"].abs().max()) == pytest.approx(spec["t_K"])
    assert float(one["u"].abs().max()) == pytest.approx(spec["uv_m_s"])
    assert float(one["v"][:, -1].abs().max()) == 0.0
    other = members.Pool(spec, 3, 8, 16, "cpu").delta(4)
    assert not torch.equal(one["t"], other["t"])


def _spec_config(name):
    files = {c["name"]: c["file"] for c in _spec()["configs"]}
    with open(os.path.join(ROOT, files[name])) as fh:
        return json.load(fh)


def test_readers_and_trace_reduction():
    device = [(0.0, 1.0, "k1"), (0.5, 2.0, "k1"), (3.0, 4.0, "k2")]
    spans = [(0.0, 2.5, "interval.run"), (2.5, 5.0, "interval.read")]
    host = [(2.0, 2.9, "aten::item")]
    r = trace.reduce(device, spans, host)
    assert r["busy_s"] == 3.0 and r["window_s"] == 5.0
    assert r["device_events"] == 3
    assert r["device_ops"] == [["k1", 2.5], ["k2", 1.0]]
    assert r["idle_gaps"] == [["interval.read", 1.0],
                              ["interval.run/aten::item", 1.0]]
    assert trace.reduce(device, [], host) is None
    ctx = dict(trace=r, steps_traced=10, ops_per_step=67e12 * 1e-3,
               bytes_per_step=1.0, dtype="float32")
    values = {m["name"]: bench.metric_reader(m["name"], ROOT)(ctx)
              for m in _spec()["per_layer"]}
    assert values["launches_per_step"] == 0.3
    assert values["device_idle_share"] == pytest.approx(40.0)
    # 10 steps of 1e-3 s at the peak over 5 s of wall, over 3 s busy
    assert values["step_mfu"] == pytest.approx(100 * 1e-2 / 5.0)
    assert values["kernel_roofline_share"] == pytest.approx(100 * 1e-2 / 3.0)
    for m in _spec()["per_layer"]:
        assert bench.metric_reader(m["name"], ROOT)({}) is None


def test_no_card_no_measurement(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "grey-modelii", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_alone_the_benchmark_does_not_run(tmp_path):
    """In a directory that holds only BENCHMARK.json and gcmbench/ (no
    program), a run exits non-zero with no result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "gcmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "gcmbench/run.py", "--workload", "grey-modelii",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=600, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "grey-modelii", "--seed", "2718281828", "--seconds", "2"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"sypd.hostbound", "setup_s"}
