"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found by name, and one added as new files and a new entry needs no edit to
the harness."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from port_bench import harness

from .conftest import REPO, TINY


def test_every_entry_finds_its_files():
    man = harness.manifest()
    for conf in man["configs"]:
        assert (REPO / conf["file"]).is_file()
        assert harness.config_file(conf["name"])["name"] == conf["name"]
    for cell in man["workloads"]:
        traffic = harness.traffic_file(cell["traffic"])
        assert hasattr(harness.driver_module(traffic["driver"]), "Driver")
        assert harness.find_cell(man, cell["name"]) is cell
        from port_bench import checks

        assert checks.load_limits(cell["name"])
    for metric in man["per_layer"]:
        assert callable(harness.reader_module(metric["name"]).read)
        assert metric["moves"] in {m["name"] for m in man["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer_metric():
    man = harness.manifest()
    for cell in man["workloads"]:
        e2e = [m["name"] for m in man["end_to_end"] if harness.applies(m, cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in man["per_layer"] if harness.applies(m, cell["name"])]
        assert layers and all(m["moves"] in e2e for m in layers)


def test_a_missing_cell_is_an_error():
    with pytest.raises(harness.CellError):
        harness.find_cell(harness.manifest(), "no_such.cell")


def test_a_dummy_metric_is_read_by_name(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dummy.ratio.py").write_text("def read(ctx):\n    return ctx.run['x'] / 2\n")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    assert harness.reader_module("dummy.ratio").read(SimpleNamespace(run={"x": 3.0})) == 1.5


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    metric reader and limits as new files and a manifest entry, and runs
    the new cell at a small size on the CPU with no harness file changed."""
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    root = tmp_path / "port_bench"
    conf = json.loads((root / "configs" / "p128_6q.json").read_text())
    conf["name"] = "dummy_conf"
    (root / "configs" / "dummy_conf.json").write_text(json.dumps(conf))
    traffic = json.loads((root / "traffic" / "hdce_train.json").read_text())
    traffic["grid_rows"] = 64
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (root / "metrics" / "dummy_steps.py").write_text("def read(ctx):\n    return ctx.run['steps']\n")
    (root / "limits" / "dummy_mix.dummy_conf.json").write_text(
        json.dumps({"limits": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3}}))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "dummy_mix.dummy_conf", "config": "dummy_conf", "traffic": "dummy_mix",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("dummy_mix.dummy_conf")
    man["per_layer"].append({"name": "dummy_steps", "unit": "steps", "better": "higher", "source": "host_clock",
                             "layer": "K-step dispatch", "moves": "train_samples_per_s",
                             "workloads": ["dummy_mix.dummy_conf"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    script = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]\n"
        "from port_bench import harness\n"
        "assert harness.ROOT.parent == __import__('pathlib').Path(sys.path[0])\n"
        "out, _ = harness.run_cell('dummy_mix.dummy_conf', 5, 0.2, False, time.perf_counter(), device='cpu',\n"
        f"                         extra={TINY!r}, log=lambda m: None)\n"
        "print(json.dumps(out))\n"
        "reader = harness.reader_module('dummy_steps')\n"
        "print(reader.read(type('C', (), {'run': {'steps': 4}})))\n"
    )
    got = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    lines = got.stdout.strip().splitlines()
    out = json.loads(lines[-2])
    assert out["correct"] is True
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert lines[-1] == "4"


def test_every_reader_loads():
    for path in sorted((harness.ROOT / "metrics").glob("*.py")):
        assert callable(harness.reader_module(path.stem).read)
