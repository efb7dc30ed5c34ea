"""``python -m qdml_tpu_torch.bench`` on the CPU, one step a row.

The run emits one JSON line with every row (HDCE per dispatch and K a
dispatch, in float32 and bfloat16, the bfloat16 scan with bfloat16 Adam
moments, QSC at each fixed impl and K a dispatch, the scenario-scaling
points, the qubit-scaling points at n = 4 and 14, serving), names its
platform and leaves the MFU out off the card; a failed row makes it exit 1. The FLOP models equal the root ``bench.py``'s
for the default config. The cell batch is cut from 256 to 8 rows for time
(the module's ``CELL_BATCH``, as the microbench's test patches its batch).
"""

import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu_torch import bench  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.ops import dispatch_autotune  # noqa: E402
from qdml_tpu_torch.quantum import autotune  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.ENV_TABLE, str(tmp_path / "qsc.json"))
    monkeypatch.setenv(dispatch_autotune.ENV_TABLE, str(tmp_path / "routing.json"))
    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    for mod in (autotune, dispatch_autotune, batching_autotune):
        mod.invalidate_cache()
    monkeypatch.setattr(bench, "CELL_BATCH", 8)
    yield
    for mod in (autotune, dispatch_autotune, batching_autotune):
        mod.invalidate_cache()


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flop_models_equal_the_root_bench_s():
    root = _root_bench()
    jcfg, tcfg = jconfig.ExperimentConfig(), tconfig.ExperimentConfig()
    assert bench.hdce_fwd_flops_per_sample(tcfg) == root.hdce_fwd_flops_per_sample(jcfg)
    assert bench.qsc_fwd_flops_per_sample(tcfg) == root.qsc_fwd_flops_per_sample(jcfg)


def test_bench_emits_every_row_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "bench.json"
    assert bench.main(["--device=cpu", "--steps=1", "--scan-steps=2", "--qubits=4,14", f"--out={out}"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert json.loads(out.read_text()) == rec
    assert rec["device"] == {"platform": "cpu"} and rec["peak"] is None and not bench.errors(rec)
    for row in ("hdce_train", "hdce_train_scan", "hdce_bf16", "hdce_bf16_scan", "hdce_bf16_scan_bf16m",
                "qsc_train_scan", "serve_infer"):
        assert rec[row]["samples_per_sec"] > 0, row
        assert "mfu_fp32" not in rec[row] and "mfu_bf16" not in rec[row] and "peak" not in rec[row]
    assert rec["hdce_bf16"]["dtype"] == rec["hdce_bf16_scan"]["dtype"] == "bfloat16"
    assert rec["hdce_bf16_scan_bf16m"]["moments_dtype"] == "bfloat16" and "synthesis" in rec["hdce_bf16_scan_bf16m"]
    assert "rbg" in rec["hdce_bf16_scan_bf16m"]["left_out"]
    scaling = rec["qsc_scaling"]
    assert [p["n_qubits"] for p in scaling["points"]] == [4, 14] and "XLA" in scaling["cost"]
    for p in scaling["points"]:
        assert p["quantum_impl"] in p["candidates_raced"] and p["samples_per_sec"] > 0 and p["train_ms"] > 0
        assert set(p["candidates"]) == set(p["candidates_raced"]) == set(autotune.eligible_impls(p["n_qubits"]))
        assert "cost" not in p and "roofline" not in p
    n4, n14 = scaling["points"]
    assert n4["agreement"]["reference"] == "dense" and n4["agreement"]["max_abs_delta"] <= 1e-5
    # chi on the point when mps won, else on the raced mps candidate
    chi = n14["mps_chi"] if n14["quantum_impl"] == "mps" else n14["candidates"]["mps"]["mps_chi"]
    assert chi == 16 and n14["agreement"]["reference"] is not None
    assert ("mps_chi" in n14) == (n14["quantum_impl"] == "mps") and "mps_chi" not in n4
    assert rec["hdce_train"]["rows"] == 72 and rec["hdce_train_scan"]["scan_steps"] == 2
    assert rec["hdce_train_scan"]["synthesis"] == "gather" and rec["hdce_train_scan"]["graphs"] == 0
    assert set(rec["qsc_train"]) == set(bench.QSC_IMPLS)
    assert all(r["samples_per_sec"] > 0 and r["quantum_impl"] == impl for impl, r in rec["qsc_train"].items())
    points = rec["scenario_scaling"]["points"]
    assert [p["n_scenarios"] for p in points] == [3, 4, 8, 16, 32, 64]
    for p in points:
        assert p["dispatch"] in p["candidates_raced"] and p["samples_per_sec"] > 0
        assert p["agreement"]["max_abs_delta"] <= 1e-5 and p["agreement"]["overflow_balanced"] == 0
        assert ("sparse" in p["candidates"]) == (p["n_scenarios"] >= 6)
    assert rec["serve_infer"]["request_path_work"] == {"measure": 0, "table_write": 0, "kernel_build": 0}


def test_a_failed_row_is_recorded_and_exits_nonzero(monkeypatch, capsys):
    def broken(dev, steps):
        raise RuntimeError("planted")

    monkeypatch.setattr(bench, "bench_serve_infer", broken)
    monkeypatch.setattr(bench, "bench_hdce", lambda dev, steps, k: {"hdce_train": {}, "hdce_train_scan": {}})
    monkeypatch.setattr(bench, "bench_qsc", lambda dev, steps, k: {"qsc_train": {"dense": {"error": "x"}}})
    monkeypatch.setattr(bench, "bench_hdce_bf16", lambda dev, steps, k: {})
    monkeypatch.setattr(bench, "bench_scenario_scaling", lambda dev: {"points": [{"n_scenarios": 8, "error": "y"}]})
    monkeypatch.setattr(bench, "bench_qsc_scaling", lambda dev, n_values: {"points": [{"n_qubits": 16, "error": "z"}]})
    assert bench.main(["--device=cpu", "--steps=1"]) == 1
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["serve_infer"] == {"error": "RuntimeError: planted"}
    assert bench.errors(rec) == ["serve_infer", "qsc_train.dense", "scenario_scaling.S8", "qsc_scaling.n16"]
    assert bench.main(["--nope=1"]) == 2


def test_new_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """Without a card the bench and the agreement check raise; they never
    fall to the CPU unasked."""
    from qdml_tpu_torch.eval.sweep import dispatch_agreement

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: bench.run(), lambda: bench.main([]), lambda: dispatch_agreement(3)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
