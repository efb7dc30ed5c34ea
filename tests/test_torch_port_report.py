"""The port's ``report`` gate against the JAX package's, on the CPU.

``qdml_tpu_torch.telemetry.report`` is a copy of ``qdml_tpu/telemetry/report.py``
whose manifest line also reads the port's ``torch`` block. On the same
artifacts (the committed ``results/bench_tpu_*.json``, the driver's
``BENCH_r0*.json``, ``results/chaos_dryrun/*.jsonl`` and
``results/fleet_router/*``) the two give the same report data and exit code;
each package reads a metrics JSONL written by the other's trainer; a halved
throughput exits 3 in both.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.telemetry import Telemetry as JTelemetry  # noqa: E402
from qdml_tpu.telemetry import report as jreport  # noqa: E402
from qdml_tpu.telemetry import run_manifest as jrun_manifest  # noqa: E402
from qdml_tpu.telemetry import set_sink as jset_sink  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.telemetry import report as treport  # noqa: E402
from qdml_tpu_torch.telemetry import run_manifest, set_sink  # noqa: E402
from qdml_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RES = ROOT / "results"

PAIRS = [
    ("results/bench_tpu_v5e_r5.json", "results/bench_tpu_v5e_r3.json"),
    ("results/bench_tpu_v5e_r3b.json", "results/bench_tpu_v5e_r2.json"),
    ("BENCH_r05.json", "BENCH_r01.json"),
    ("BENCH_r03.json", "results/bench_tpu_v5e_r3.json"),
    ("results/chaos_dryrun/autotune_corrupt_fault.jsonl", "results/chaos_dryrun/baseline.jsonl"),
    ("results/chaos_dryrun/autotune_corrupt_recovery_t0.jsonl", "results/chaos_dryrun/autotune_corrupt_base_t0.jsonl"),
    ("results/fleet_router/backend_kill_recovery_t0.jsonl", "results/fleet_router/backend_kill_base_t0.jsonl"),
    ("results/fleet_router/backend_stall_base_t1.jsonl", "results/fleet_router/backend_kill_base_t1.jsonl"),
]


def _norm(data: dict) -> dict:
    return json.loads(json.dumps(data, sort_keys=True, default=str))


@pytest.mark.parametrize("current,baseline", PAIRS)
def test_report_data_and_exit_code_equal_jaxs_on_committed_artifacts(current, baseline, capsys):
    cur, base = str(ROOT / current), str(ROOT / baseline)
    assert _norm(treport.build_report_data([cur], base)) == _norm(jreport.build_report_data([cur], base))
    argv = [f"--current={cur}", f"--baseline={base}", "--threshold=10"]
    assert treport.report_main(argv) == jreport.report_main(argv)


def test_every_committed_fleet_and_chaos_window_reads_alike():
    for path in sorted((RES / "fleet_router").glob("*.jsonl")) + sorted((RES / "chaos_dryrun").glob("*.jsonl")):
        assert _norm(treport.extract(str(path))) == _norm(jreport.extract(str(path))), path.name


def test_a_halved_throughput_exits_3_in_both(tmp_path):
    base = RES / "bench_tpu_v5e_r5.json"
    rec = json.loads(base.read_text())

    def halve(node):
        if isinstance(node, dict):
            return {k: (v / 2 if k == "samples_per_sec" and isinstance(v, (int, float)) else halve(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [halve(v) for v in node]
        return node

    cur = tmp_path / "halved.json"
    cur.write_text(json.dumps(halve(rec)))
    argv = [f"--current={cur}", f"--baseline={base}"]
    assert treport.report_main(argv) == jreport.report_main(argv) == treport.EXIT_REGRESSION == 3
    argv = [f"--current={base}", f"--baseline={base}"]
    assert treport.report_main(argv) == jreport.report_main(argv) == 0
    assert treport.report_main(["--current=x"]) == jreport.report_main(["--current=x"]) == 2


def _port_jsonl(tmp_path) -> str:
    from qdml_tpu_torch.train.hdce import train_hdce

    cfg = tconfig.from_args(["--data.n_ant=16", "--data.n_sub=8", "--data.n_beam=4", "--data.data_len=40",
                             "--model.features=8", "--train.batch_size=8", "--train.n_epochs=1",
                             f"--eval.results_dir={tmp_path}"])
    path = tmp_path / "port.jsonl"
    log = MetricsLogger(str(path), echo=False, manifest=run_manifest(cfg, argv=["train-hdce"]))
    set_sink(log)
    try:
        train_hdce(cfg, device="cpu", logger=log)
    finally:
        set_sink(None)
        log.close()
    return str(path)


def _jax_jsonl(tmp_path) -> str:
    from qdml_tpu.train.hdce import train_hdce

    cfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(n_ant=16, n_sub=8, n_beam=4, data_len=40),
        model=jconfig.ModelConfig(features=8),
        train=jconfig.TrainConfig(batch_size=8, n_epochs=1),
        eval=jconfig.EvalConfig(results_dir=str(tmp_path)),
    )
    path = tmp_path / "jax.jsonl"
    tele = JTelemetry(str(path), manifest=jrun_manifest(cfg, argv=["train-hdce"]))
    jset_sink(tele)
    try:
        train_hdce(cfg)
    finally:
        jset_sink(None)
        tele.close()
    return str(path)


def test_each_package_reads_the_others_trainer_jsonl(tmp_path, capsys):
    port, jax_ = _port_jsonl(tmp_path), _jax_jsonl(tmp_path)
    kinds = {json.loads(ln).get("kind") for ln in open(port)}
    assert {"manifest", "numerics", "counters", "cost", "span", "scan_dispatch"} <= kinds
    for cur, base in ((port, jax_), (jax_, port), (port, port)):
        want = _norm(jreport.build_report_data([cur], base))
        got = _norm(treport.build_report_data([cur], base))
        if cur == port or base == port:
            # the port's manifest line reads its torch block where JAX's reads a null jax block
            assert "cpu (1 proc)" in got["markdown"]
            got.pop("markdown"), want.pop("markdown")
        assert got == want
        argv = [f"--current={cur}", f"--baseline={base}"]
        assert treport.report_main(argv) == jreport.report_main(argv) == 0
    man = treport.extract(port)["manifest"]
    assert man["jax"] is None and man["torch"]["backend"] == "cpu"
    assert treport.extract(port)["cost"] == jreport.extract(port)["cost"]
