"""The port's measured circuit dispatch against the JAX package's, on the CPU.

``qdml_tpu_torch.quantum.autotune`` and ``qdml_tpu.quantum.autotune`` hold
the same inputs to the same answers: buckets and keys exactly, eligibility
exactly but for the stated difference (the port adds ``pallas_circuit``
at 2 <= n <= 6, where its CUDA kernel runs for real; ``sharded_statevector``
follows JAX's topology rule on the model line of the port's ranks), and one
table file written
once gives the same ``lookup_reason`` and ``resolve_impl`` in both packages
for every shape and mode, pathologies included. Then the port's own
behaviour: the tuner round-trips a manifest-headed table and re-reads it
without measuring, ``prewarm`` gates, fallbacks print once, a checkpoint pin
past a cap raises ``ImplIneligibleError``, the presets match JAX's, and no
tuning run writes under ``results/``. Tolerances: none; every comparison
here is exact.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.quantum import autotune as jat  # noqa: E402
from qdml_tpu.quantum import circuits as jcirc  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.quantum import autotune as tat  # noqa: E402
from qdml_tpu_torch.quantum import circuits as tcirc  # noqa: E402
from qdml_tpu_torch.utils import tune_table  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    """Each test reads and writes its own table, with cold caches in both packages."""
    monkeypatch.setenv(jat.ENV_TABLE, str(tmp_path / "jax_qsc_impl.json"))
    monkeypatch.setenv(tat.ENV_TABLE, str(tmp_path / "qsc_impl.json"))
    jat.invalidate_cache()
    tat.invalidate_cache()
    yield
    jat.invalidate_cache()
    tat.invalidate_cache()


def test_batch_bucket_and_table_key_match_jax():
    for batch in (0, 1, 2, 3, 7, 8, 9, 63, 64, 65, 200, 2304, 4096, 4097):
        assert tat.batch_bucket(batch) == jat.batch_bucket(batch), batch
        for n, layers, dtype in ((4, 2, "float32"), (6, 3, "float32"), (8, 3, "bfloat16")):
            b = tat.batch_bucket(batch)
            assert tat.table_key("cpu", n, layers, b, dtype) == jat.table_key("cpu", n, layers, b, dtype)
    assert tat.table_key("cuda", 6, 3, 4096) == "cuda/n6/L3/b4096/float32"


@pytest.mark.parametrize("n", range(2, 21))
def test_eligible_impls_match_jax_but_for_the_stated_differences(n):
    for devices in (None, 1, 2, 4):
        want = list(jat.eligible_impls(n, "cpu", devices))
        if 2 <= n <= 6:  # the port's circuit kernel runs below JAX's 128-lane floor
            want.insert(want.index("pallas") + 1, "pallas_circuit")
        assert tat.eligible_impls(n, devices) == want
    assert ("sharded_statevector" in tat.eligible_impls(n, 2)) == (n >= tat.SHARDED_MIN_QUBITS)
    assert tat.UNPORTED_IMPLS == ()


def test_impl_eligible_matches_jax_on_ported_impls():
    for impl in ("dense", "dense_fused", "pallas", "pallas_circuit", "pallas_tensor", "tensor", "mps"):
        for n in (2, 6, 8, 12, 13, 14, 15, 20):
            assert tat.impl_eligible(impl, n)[0] == jat.impl_eligible(impl, n)[0], (impl, n)
    for impl in ("sharded", "sharded_statevector"):
        for devices in (1, 2, 4):  # JAX's topology rule, its reason word for word
            assert tat.impl_eligible(impl, 6, devices) == jat.impl_eligible(impl, 6, devices)
        ok, why = tat.impl_eligible(impl, 6)  # no mesh: a model line of one
        assert not ok and why == jat.impl_eligible(impl, 6, 1)[1]
    assert tat.model_axis_devices() == 1
    assert tcirc.impl_eligible is tat.impl_eligible  # circuits re-exports it
    with pytest.raises(ValueError):
        tat.impl_eligible("nope", 6)


def _write(path, payload):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(payload if isinstance(payload, str) else json.dumps(payload))


GOOD = {
    "schema": 1,
    "kind": "qsc_autotune_table",
    "entries": {
        "cpu/n6/L3/b64/float32": {"best_train": "pallas", "best_fwd": "pallas_circuit"},
        "cpu/n4/L2/b8/float32": {"best_train": "dense_fused", "best_fwd": "pallas_tensor"},
        "cpu/n10/L3/b64/float32": {"best_train": "tensor", "best_fwd": "dense"},
        # an alien winner in one mode, a missing one in the other
        "cpu/n5/L2/b16/float32": {"best_train": "not-an-impl", "best_fwd": "auto"},
        # a winner past its capacity cap: dense at n = 13
        "cpu/n13/L1/b8/float32": {"best_train": "dense", "best_fwd": "dense_fused"},
        # not an entry at all
        "cpu/n7/L3/b64/float32": ["pallas"],
        "cuda/n6/L3/b64/float32": {"best_train": "tensor", "best_fwd": "tensor"},
    },
}
SHAPES = [(6, 3, 64), (6, 3, 50), (6, 3, 65), (4, 2, 5), (10, 3, 64), (5, 2, 16), (13, 1, 8), (7, 3, 64), (8, 3, 1)]
TABLES = {
    "good": GOOD,
    "corrupt": "{definitely not json",
    "alien": [1, 2, 3],
    "alien-dict": {"winners": {}},
    "missing": None,
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_one_table_two_readers(tmp_path, monkeypatch, capsys, table):
    """One file, written once, read by both packages: the same selection and
    the same fallback reason for every shape and mode, and the same impl
    out of ``resolve_impl``."""
    path = tmp_path / "shared" / "qsc_impl.json"
    if TABLES[table] is not None:
        _write(path, TABLES[table])
    monkeypatch.setenv(jat.ENV_TABLE, str(path))
    monkeypatch.setenv(tat.ENV_TABLE, str(path))
    jat.invalidate_cache()
    tat.invalidate_cache()
    for n, layers, batch in SHAPES:
        for mode in ("train", "infer"):
            want = jat.lookup_reason(n, layers, batch, mode=mode)
            assert tat.lookup_reason(n, layers, batch, mode=mode, platform="cpu") == want, (n, layers, batch, mode)
            assert tat.lookup(n, layers, batch, mode=mode, platform="cpu") == want[0]
            assert tcirc.resolve_impl("auto", "auto", n, layers, batch, mode, platform="cpu") == (
                jcirc.resolve_impl("auto", "auto", n, layers, batch, mode)
            )
    assert tat.table_status() == jat.table_status()
    if table == "good":  # the entries exercised the paths they were written for
        assert tat.lookup_reason(6, 3, 64, platform="cpu") == ("pallas", None)
        assert tat.lookup_reason(4, 2, 5, mode="infer", platform="cpu") == ("pallas_circuit", None)
        assert tat.lookup_reason(5, 2, 16, platform="cpu") == (None, "entry-alien")
        assert tat.lookup_reason(13, 1, 8, platform="cpu") == (None, "entry-ineligible")
        assert tat.lookup_reason(6, 3, 64, platform="cuda") == ("tensor", None)
    elif table == "missing":  # the cold start is not a pathology
        assert tat.lookup_reason(6, 3, 64, platform="cpu") == (None, None)
        assert "autotune_fallback" not in capsys.readouterr().out
    else:
        assert tat.lookup_reason(6, 3, 64, platform="cpu")[1] == f"table-{tat.table_status()}"


def test_ensure_round_trips_a_manifest_headed_table(tmp_path):
    path = tmp_path / "t.json"
    before = tune_table.activity["measure"]
    entry = tat.ensure(3, 2, 7, path=str(path), budget_s=0.01, device="cpu")
    assert tune_table.activity["measure"] == before + 1
    assert (entry["key"], entry["batch_bucket"], entry["platform"]) == ("cpu/n3/L2/b8/float32", 8, "cpu")
    assert set(entry["candidates"]) == set(tat.eligible_impls(3))
    for rec in entry["candidates"].values():
        assert "error" not in rec and rec["fwd_ms"] > 0 and rec["train_ms"] > 0
    assert entry["best_train"] in entry["candidates"] and entry["best_fwd"] in entry["candidates"]
    data = json.loads(path.read_text())
    assert data["kind"] == "qsc_autotune_table" and data["schema"] == tat.SCHEMA
    man = data["manifest"]
    assert man["kind"] == "manifest" and man["torch"] == torch.__version__ and man["device"] == "cpu"
    assert "jax" not in json.dumps(man)
    tat.invalidate_cache()
    assert tat.lookup(3, 2, 7, path=str(path), platform="cpu") == entry["best_train"]
    assert tat.lookup(3, 2, 5, mode="infer", path=str(path), platform="cpu") == entry["best_fwd"]
    # the JAX package reads the port's file (the platform word is the key's)
    assert jat.lookup(3, 2, 7, path=str(path)) == entry["best_train"]
    again = tat.ensure(3, 2, 8, path=str(path), budget_s=0.01, device="cpu")
    assert again["ts"] == entry["ts"] and tune_table.activity["measure"] == before + 1
    forced = tat.ensure(3, 2, 8, path=str(path), budget_s=0.01, device="cpu", force=True)
    assert forced["ts"] >= entry["ts"] and tune_table.activity["measure"] == before + 2


def test_a_failing_candidate_is_recorded_and_left_out(tmp_path):
    # sharded_statevector without a model line of two ranks: refused by eligibility
    entry = tat.ensure(3, 1, 4, path=str(tmp_path / "t.json"), impls=["dense", "sharded_statevector"],
                       budget_s=0.01, device="cpu")
    assert "ImplIneligibleError" in entry["candidates"]["sharded_statevector"]["error"]
    assert entry["best_train"] == entry["best_fwd"] == "dense"


@pytest.mark.parametrize("entry", ["ensure", "prewarm"])
@pytest.mark.parametrize("impl,kernel", [("pallas", "fused_qsc_expvals"), ("pallas_circuit", "fused_circuit_expvals")])
def test_a_kernel_that_fails_to_build_stops_the_race(tmp_path, monkeypatch, impl, kernel, entry):
    """A kernel candidate whose build fails raises out of the race: no
    winner is picked among the plain versions and no table is saved that
    would keep ``impl=auto`` off the kernel in later runs."""
    from qdml_tpu_torch.quantum import kernels

    def broken(*args, **kw):
        raise RuntimeError(f"kernel build failed: {kernel} (nvcc exit 1)")

    monkeypatch.setattr(kernels, kernel, broken)
    path = tmp_path / "t.json"
    before = tune_table.activity["save"]
    with pytest.raises(RuntimeError, match="kernel build failed"):
        if entry == "ensure":
            tat.ensure(4, 1, 8, path=str(path), impls=["dense", impl], budget_s=0.01, device="cpu")
        else:
            q = tconfig.QuantumConfig(n_qubits=4, n_layers=1, autotune="on", autotune_table=str(path))
            tat.prewarm(tconfig.ExperimentConfig(quantum=q), batch=8, device="cpu")
    assert not path.exists() and tune_table.activity["save"] == before


def test_prewarm_gating(tmp_path):
    q = tconfig.QuantumConfig(n_qubits=3, n_layers=1)
    cfg = tconfig.ExperimentConfig(quantum=q)
    before = dict(tune_table.activity)
    assert tat.prewarm(cfg, batch=8, device="cpu") is None  # autotune="auto" on the CPU
    for pinned in (dataclasses.replace(q, impl="dense", autotune="on"),
                   dataclasses.replace(q, backend="tensor", autotune="on"),
                   dataclasses.replace(q, autotune="off")):
        assert tat.prewarm(dataclasses.replace(cfg, quantum=pinned), batch=8, device="cpu") is None
    assert tune_table.activity == before
    path = tmp_path / "custom" / "qsc.json"
    on = dataclasses.replace(cfg, quantum=dataclasses.replace(q, autotune="on", autotune_table=str(path)))
    entry = tat.prewarm(on, batch=8, device="cpu")
    assert entry is not None and entry["key"] == "cpu/n3/L1/b8/float32" and path.exists()
    # the configured table is now the process's: the per-call lookup reads it
    assert tat.table_path() == str(path.resolve())
    assert tat.lookup(3, 1, 8, platform="cpu") == entry["best_train"]
    assert tat.autotune_enabled("auto", "cuda") and not tat.autotune_enabled("auto", "cpu")
    assert tat.autotune_enabled("on", "cpu") and not tat.autotune_enabled("off", "cuda")


def test_impl_override_wins_over_table():
    tat.save_table({tat.table_key("cpu", 6, 3, 64): {"best_train": "pallas", "best_fwd": "pallas"}})
    assert tcirc.resolve_impl("auto", "auto", 6, 3, 64, platform="cpu") == "pallas"
    assert tcirc.resolve_impl("tensor", "auto", 6, 3, 64, platform="cpu") == "tensor"
    assert tcirc.resolve_impl("dense", "pallas", 6, 3, 64, platform="cpu") == "dense"
    assert tcirc.resolve_impl("auto", "tensor", 6, 3, 64, platform="cpu") == "tensor"


def test_run_circuit_dispatches_the_table_winner_per_batch_and_mode(monkeypatch):
    """``run_circuit`` resolves with its own batch (leading axes flattened) and
    mode; the model passes ``train`` in train mode and ``infer`` in eval."""
    from qdml_tpu_torch.models.qsc import QSCP128

    tat.save_table({
        tat.table_key("cpu", 4, 2, 8): {"best_train": "tensor", "best_fwd": "dense_fused"},
    })
    seen = []
    real = tcirc.resolve_impl

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args[4], kw.get("mode"), out))
        return out

    monkeypatch.setattr(tcirc, "resolve_impl", spy)
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(-1, 1, (2, 3, 4)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0, 6, (2, 4, 2)), dtype=torch.float32)
    got = tcirc.run_circuit(a, w, 4, 2, backend="auto", mode="infer")
    want = tcirc.run_circuit(a, w, 4, 2, backend="dense")
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert seen[0] == (6, "infer", "dense_fused")
    model = QSCP128(n_qubits=4, n_layers=2)
    x = torch.tensor(rng.standard_normal((5, 2, 16, 8)), dtype=torch.float32)
    seen.clear()
    model.train()(x)
    model.eval()(x)
    model.eval()(x, impl="pallas")
    assert [s[1:] for s in seen] == [("train", "tensor"), ("infer", "dense_fused"), ("infer", "pallas")]


def test_fallback_prints_once_per_pathology(tmp_path, capsys):
    path = Path(tat.table_path())
    _write(path, "{definitely not json")
    tat.invalidate_cache()
    for _ in range(3):
        assert tcirc.resolve_impl("auto", "auto", 6, 3, 256, platform="cpu") == "dense"
    out = capsys.readouterr().out.splitlines()
    assert out == [f"autotune_fallback: table-corrupt table={path} key=cpu/n6/L3/b256/float32 -> dense"]
    # another pathology at the same shape is its own line; the reported set survives a reload
    _write(path, {"entries": {tat.table_key("cpu", 6, 3, 256): {"best_train": "nope"}}})
    tat._STORE.invalidate()
    tat.set_table_path(str(path))
    for _ in range(2):
        assert tcirc.resolve_impl("auto", "auto", 6, 3, 256, platform="cpu") == "dense"
    assert capsys.readouterr().out.splitlines() == [
        f"autotune_fallback: entry-alien table={path} key=cpu/n6/L3/b256/float32 -> dense"
    ]
    # the cold start is not a pathology
    tat.invalidate_cache()
    tat.set_table_path(str(tmp_path / "absent.json"))
    assert tcirc.resolve_impl("auto", "auto", 6, 3, 256, platform="cpu") == "dense"
    assert capsys.readouterr().out == ""


def test_lookup_after_the_first_read_touches_no_file(tmp_path, monkeypatch):
    tat.save_table({tat.table_key("cpu", 6, 3, 64): {"best_train": "pallas", "best_fwd": "dense"}})
    tat.invalidate_cache()
    assert tat.lookup(6, 3, 64, platform="cpu") == "pallas"

    def no_io(*a, **k):
        raise AssertionError("file I/O on the lookup path")

    monkeypatch.setattr("builtins.open", no_io)
    for batch in (33, 64, 40):
        assert tat.lookup_reason(6, 3, batch, platform="cpu") == ("pallas", None)


def test_reconcile_raises_impl_ineligible(monkeypatch):
    from qdml_tpu.train.checkpoint import reconcile_quantum_cfg as jreconcile
    from qdml_tpu_torch.train.checkpoint import reconcile_quantum_cfg

    assert issubclass(tat.ImplIneligibleError, ValueError)
    assert tcirc.ImplIneligibleError is tat.ImplIneligibleError
    meta = {"quantum": {"n_qubits": 13, "n_layers": 1}}
    for impl in ("dense", "pallas", "pallas_circuit"):
        cfg = tconfig.ExperimentConfig(quantum=tconfig.QuantumConfig(impl=impl))
        with pytest.raises(tat.ImplIneligibleError, match="capped"):
            reconcile_quantum_cfg(cfg, meta)
        jcfg = jconfig.ExperimentConfig(quantum=jconfig.QuantumConfig(impl=impl))
        with pytest.raises(jat.ImplIneligibleError):
            jreconcile(jcfg, meta)
    # a sharded_statevector pin restored on one rank: JAX's typed error, word for word
    monkeypatch.setattr(jat, "model_axis_devices", lambda: 1)  # JAX on one device
    cfg = tconfig.ExperimentConfig(quantum=tconfig.QuantumConfig(impl="sharded_statevector"))
    jcfg = jconfig.ExperimentConfig(quantum=jconfig.QuantumConfig(impl="sharded_statevector"))
    with pytest.raises(tat.ImplIneligibleError) as terr:
        reconcile_quantum_cfg(cfg, {"quantum": {"n_qubits": 16}})
    with pytest.raises(jat.ImplIneligibleError) as jerr:
        jreconcile(jcfg, {"quantum": {"n_qubits": 16}})
    assert str(terr.value) == str(jerr.value)
    # a checkpoint trained on mps (its chi dropped, as JAX drops it) reconciles
    mps = tconfig.ExperimentConfig(quantum=tconfig.QuantumConfig(impl="mps", mps_chi=4))
    got = reconcile_quantum_cfg(mps, {"quantum": {"n_qubits": 16, "impl": "mps", "mps_chi": 16}})
    assert (got.quantum.n_qubits, got.quantum.impl, got.quantum.mps_chi) == (16, "mps", 4)
    out = reconcile_quantum_cfg(tconfig.ExperimentConfig(), meta)  # auto re-resolves: no raise
    assert out.quantum.n_qubits == 13


def _common_fields(t, j, prefix=""):
    """(dotted name, port value, JAX value) for every field the port has."""
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            yield from _common_fields(tv, jv, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", tv, jv


@pytest.mark.parametrize("name", ["single_4q", "dp_8q", "sharded_16q", "federated", "nat_sweep", "robust_qsc"])
def test_runnable_presets_match_jax(name):
    t = tconfig.preset(name)
    j = jconfig.presets()[name]
    for dotted, tv, jv in _common_fields(t, j):
        if dotted == "eval.results_dir":  # the port's own (results/ is the JAX package's)
            continue
        assert tv == jv, dotted
    cfg = tconfig.from_args(["--train.lr=0.5", f"--preset={name}"])  # the preset applies first
    assert cfg.name == name and cfg.train.lr == 0.5
    assert cfg.quantum == t.quantum and cfg.data == t.data


def test_mesh_presets_raise_and_unknown_presets_are_refused():
    assert tconfig.UNPORTED_PRESETS == () and set(tconfig.presets()) == set(jconfig.presets())
    for name in ("dp_8q", "sharded_16q", "federated"):  # the mesh presets, field for field
        assert tconfig.from_args([f"--preset={name}"]).mesh == tconfig.MeshConfig(
            **dataclasses.asdict(jconfig.presets()[name].mesh))
    with pytest.raises(KeyError, match="unknown preset"):
        tconfig.preset("nope")


def test_new_config_fields_match_jax_defaults():
    for cls, names in ((("QuantumConfig"), ("autotune", "autotune_table")),
                       (("ServeConfig"), ("dispatch", "capacity_factor", "batching"))):
        t, j = getattr(tconfig, cls)(), getattr(jconfig, cls)()
        for n in names:
            assert getattr(t, n) == getattr(j, n), (cls, n)
    cfg = tconfig.from_args(["--serve.capacity_factor=2", "--quantum.autotune=on", "--serve.dispatch=sparse"])
    assert (cfg.serve.capacity_factor, cfg.quantum.autotune, cfg.serve.dispatch) == (2.0, "on", "sparse")


def _hashes(folder: Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(folder.glob("*.json"))}


def test_tuning_writes_nothing_under_results(tmp_path, monkeypatch):
    """Every default table path of the port lies under ``results_torch/``:
    a tuning run from a working directory writes there and leaves the JAX
    package's ``results/autotune/*.json`` byte for byte as they were."""
    committed = ROOT / "results" / "autotune"
    before = _hashes(committed)
    assert before  # the JAX package's tables are there to protect
    monkeypatch.delenv(tat.ENV_TABLE)
    monkeypatch.chdir(tmp_path)
    tat.invalidate_cache()
    assert Path(tat.table_path()).resolve().is_relative_to((tmp_path / "results_torch" / "autotune").resolve())
    cfg = tconfig.ExperimentConfig(quantum=tconfig.QuantumConfig(n_qubits=3, n_layers=1, autotune="on"))
    tat.prewarm(cfg, batch=4, device="cpu")
    written = sorted(p.name for p in (tmp_path / "results_torch" / "autotune").iterdir())
    assert written == ["qsc_impl.json"]
    assert _hashes(committed) == before


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import qdml_tpu_torch.utils.tune_table, qdml_tpu_torch.quantum.autotune\n"
        "import qdml_tpu_torch.ops.routing, qdml_tpu_torch.serve.engine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'qdml_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr


def test_qsc_trainer_tunes_before_its_first_step_and_logs_the_entry(tmp_path):
    """``train_classifier`` at ``impl=auto`` tunes at the flattened grid batch
    (S * U * batch_size) before its first step and logs ``quantum_autotune``;
    on a second run the table answers and nothing is measured."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train.qsc import train_classifier

    class Recorder:
        def __init__(self):
            self.records = []

        def log(self, step=None, **values):
            self.records.append(values)

    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16, data_len=16),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=3, n_layers=1, autotune="on",
                                      autotune_table=str(tmp_path / "t.json")),
        train=tconfig.TrainConfig(batch_size=4, n_epochs=1, print_freq=1000),
    )
    data = GridData.synthesize(cfg.data, "cpu")
    for run in range(2):
        rec = Recorder()
        before = tune_table.activity["measure"]
        train_classifier(cfg, True, data=data, logger=rec)
        tuned = [r for r in rec.records if r.get("kind") == "quantum_autotune"]
        assert len(tuned) == 1 and tuned[0]["key"] == "cpu/n3/L1/b64/float32"  # 3 * 3 * 4 = 36 rows
        assert tuned[0]["impl"] in tuned[0]["candidates"]
        assert tune_table.activity["measure"] == before + (1 if run == 0 else 0)
    pinned = dataclasses.replace(cfg, quantum=dataclasses.replace(cfg.quantum, impl="dense"))
    rec = Recorder()
    train_classifier(pinned, True, data=data, logger=rec)
    assert not [r for r in rec.records if r.get("kind") == "quantum_autotune"]
