"""The classifier trainer's set-up spans and the circuit impl race's span,
on the CPU; on the card, the circuit kernels' launches in one replay of
the quantum classifier's K-step graph.

The card test needs a CUDA GPU and nvcc and skips without one (the check
is made inside the fixture, never at import). Run it on the card with

    python -m pytest -m cuda tests/test_torch_port_qsc_setup.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qdml_tpu_torch.config import DataConfig, ExperimentConfig, QuantumConfig, TrainConfig  # noqa: E402
from qdml_tpu_torch.quantum import autotune  # noqa: E402
from qdml_tpu_torch.telemetry.spans import set_sink  # noqa: E402
from qdml_tpu_torch.train import qsc  # noqa: E402


class _Spans:
    active = True

    def __init__(self):
        self.records = []

    def write_raw(self, rec):
        if rec.get("kind") == "span":
            self.records.append(rec)


def _cfg(n: int = 2, **quantum) -> ExperimentConfig:
    return ExperimentConfig(
        data=DataConfig(n_ant=4, data_len=24),
        quantum=QuantumConfig(n_qubits=n, n_layers=2, **quantum),
        train=TrainConfig(batch_size=2),
    )


@pytest.mark.parametrize("quantum,tag", [(True, "qsc"), (False, "sc")])
def test_make_trainer_writes_its_span_with_the_three_children(quantum, tag):
    sink = _Spans()
    set_sink(sink)
    try:
        qsc.make_trainer(_cfg(), quantum, "cpu", steps_per_epoch=4)
    finally:
        set_sink(None)
    children = [f"{tag}_init", f"{tag}_to_device", "optimizer_init"]
    assert [r["name"] for r in sink.records] == [*children, f"{tag}_make_trainer"]
    top = sink.records[-1]
    assert (top["path"], top["depth"]) == (f"{tag}_make_trainer", 0)
    for rec in sink.records[:-1]:
        assert rec["path"] == f"{tag}_make_trainer/{rec['name']}" and rec["depth"] == 1
        assert top["t0_ns"] <= rec["t0_ns"] <= rec["t1_ns"] <= top["t1_ns"]


def test_the_impl_race_writes_its_span_raced_then_read_from_the_table(tmp_path):
    """The first prewarm of a shape measures; the second reads the entry
    the first saved. Each writes one ``circuit_impl_race`` record with the
    shape, the winner and whether it raced."""
    cfg = _cfg(autotune="on", autotune_table=str(tmp_path / "impl.json"))
    sink = _Spans()
    set_sink(sink)
    try:
        first = autotune.prewarm(cfg, batch=6, device="cpu")
        autotune.invalidate_cache()
        second = autotune.prewarm(cfg, batch=6, device="cpu")
    finally:
        set_sink(None)
        autotune.invalidate_cache()
    races = [r for r in sink.records if r["name"] == "circuit_impl_race"]
    assert len(races) == 2
    for rec, entry, raced in zip(races, (first, second), (True, False)):
        assert (rec["n"], rec["L"], rec["batch"]) == (2, 2, 6)
        assert rec["impl"] == entry["best_train"] and rec["raced"] is raced
        assert rec["depth"] == 0


@pytest.mark.parametrize("impl,tuning", [("pallas_circuit", "on"), ("auto", "auto")])
def test_no_race_no_span(impl, tuning):
    """A pinned impl, or the CPU with tuning left at auto, races nothing and
    writes no race span."""
    sink = _Spans()
    set_sink(sink)
    try:
        got = autotune.prewarm(_cfg(impl=impl, autotune=tuning), batch=6, device="cpu")
    finally:
        set_sink(None)
    assert got is None and sink.records == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the circuit kernels are CUDA C++ with no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_qsc_k_step_replay_launches_each_circuit_kernel_once_a_step(card):
    """At the benchmark's 8 qubits and K = 16: a replay of the captured
    graph adds 16 forward and 16 adjoint launches to the counters, one of
    each a step, and no launch of another circuit kernel."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.quantum import kernels

    k = 16
    cfg = ExperimentConfig(
        data=DataConfig(data_len=64),
        quantum=QuantumConfig(n_qubits=8, n_layers=3, impl="pallas_circuit"),
        train=TrainConfig(batch_size=16, scan_steps=k),
    )
    data = GridData.synthesize(cfg.data, card)
    model, opt = qsc.make_trainer(cfg, True, card, steps_per_epoch=10**6)
    run = qsc.make_sc_scan_steps(model, opt, data, k, probes=True)
    rng = np.random.default_rng(0)
    snrs = np.full(k, cfg.data.snr_db, np.float32)
    for _ in range(2):  # the eager warm-up, then the capture and its first replay
        run(rng.integers(0, 48, (k, 3, 3, 16)), snrs)
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    run(rng.integers(0, 48, (k, 3, 3, 16)), snrs)
    torch.cuda.synchronize()
    added = {name: kernels.launches[name] - before[name] for name in kernels.COUNTERS}
    assert added.pop("circuit_expvals") == k and added.pop("circuit_adjoint") == k
    assert not any(added.values()), added
