"""The port's runtime sanitizer (``train.checkify``, ``serve.checkify``)
against the JAX package's checkify contract, on the CPU (the five checkify
tests of ``tests/test_analysis.py:613-770``, and more):

- off wraps nothing: the step makers return the plain step, no sanitizer is
  built, and the K-step path is unaffected;
- on equals off bit for bit (losses, probes, parameters: the checks only
  read values), for the DCE, HDCE and QSC steps; the K-step path declines
  with JAX's reason;
- a trip goes through the flight recorder (dump, ``DivergenceError`` with
  a ``checkify: `` reason naming the op);
- the classifier's NLL gather: checked and unchecked steps agree, and an
  out-of-range label trips as an index error, clamped, after which a clean
  step runs;
- ``serve.checkify``: the checked engine's answers equal the unchecked one's
  and JAX's checked engine's, a poisoned batch raises and the next serves,
  NaN in ragged pad rows does not trip, a pool fails only the poisoned
  request's future;
- a NaN generated in the backward, an integer division by zero and
  out-of-range indices each trip with the op named; a hand kernel's
  boundary is checked under the kernel's name;
- in a 2-rank gloo world, a NaN that one rank's rows alone generate trips
  the flight recorder on both ranks with the same reason, and neither is
  left waiting in a collective.
"""

import dataclasses
import json
import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.config import ExperimentConfig as JConfig  # noqa: E402
from qdml_tpu.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from qdml_tpu.telemetry import DivergenceError as JDivergenceError  # noqa: E402
from qdml_tpu.train import scan as jscan  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.telemetry import DivergenceError, FlightRecorder  # noqa: E402
from qdml_tpu_torch.telemetry import sanitizer as san_mod  # noqa: E402
from qdml_tpu_torch.telemetry.sanitizer import Sanitizer, checkify_step, error_message  # noqa: E402
from qdml_tpu_torch.train import dce as tdce  # noqa: E402
from qdml_tpu_torch.train import hdce as thdce  # noqa: E402
from qdml_tpu_torch.train import qsc as tqsc  # noqa: E402
from qdml_tpu_torch.train import scan as tscan  # noqa: E402

DATA = dict(n_ant=16, n_sub=8, n_beam=4, data_len=40)
CLF_DATA = dict(DATA, n_sub=16, n_beam=8)


def _cfg(data=DATA, **over):
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**data),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=4, n_layers=2, impl="pallas_circuit"),
        train=tconfig.TrainConfig(batch_size=8, n_epochs=1, print_freq=1000),
    )
    return tconfig.from_args([f"--{k}={v}" for k, v in over.items()], base=cfg)


class _Log:
    def __init__(self):
        self.records = []

    def log(self, step=None, **values):
        self.records.append(values)


def _batch(cfg, seed=0):
    data = GridData.synthesize(cfg.data, "cpu")
    return next(iter(DMLGridLoader(data, cfg.train.batch_size, "train").epoch(seed)))


def _trainer(family, cfg):
    if family == "hdce":
        model, opt = thdce.make_trainer(cfg, "cpu", 4)
        return model, opt, lambda ck: thdce._step_fn(model, opt, True, ck)
    if family == "dce":
        model, opt = tdce.make_trainer(cfg, "cpu", 4)
        return model, opt, lambda ck: tdce._step_fn(model, opt, True, ck)
    model, opt = tqsc.make_trainer(cfg, family == "qsc", "cpu", 4)
    model.train()
    gen = torch.Generator().manual_seed(3)
    return model, opt, lambda ck: tqsc._step_fn(model, opt, gen, probes=True, checkify_errors=ck)


# ---------------------------------------------------------------------------
# train.checkify
# ---------------------------------------------------------------------------


def test_checkify_off_wraps_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a sanitizer was built with checkify off")

    monkeypatch.setattr(san_mod.Sanitizer, "__init__", refuse)
    cfg = _cfg()
    model, opt, make = _trainer("dce", cfg)
    m = make(False)(_batch(cfg), None)
    assert "checkify_err" not in m and "probe" in m
    _, hist = tdce.train_dce(cfg, device="cpu")  # the default loop builds none either
    assert np.isfinite(hist["train_loss"]).all()


@pytest.mark.parametrize("family", ["dce", "hdce", "sc", "qsc"])
def test_checkify_on_equals_off_bit_for_bit(family):
    cfg = _cfg(DATA if family in ("hdce", "dce") else CLF_DATA,
               **{"quantum.use_quantumnat": True, "quantum.noise_level": 0.05})
    m_off, opt_off, make_off = _trainer(family, cfg)
    m_on, opt_on, make_on = _trainer(family, cfg)
    step_off, step_on = make_off(False), make_on(True)
    for seed in range(2):
        batch = _batch(cfg, seed)
        a, b = step_off(batch, None), step_on(batch, None)
        assert error_message(b["checkify_err"]) is None
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["probe"]["grad_norm"], b["probe"]["grad_norm"])
    for (name, p), q in zip(m_off.state_dict().items(), m_on.state_dict().values()):
        assert torch.equal(p, q), name


def test_checkify_declines_the_k_step_path_with_jaxs_reason():
    from qdml_tpu.config import ExperimentConfig as JExp
    from qdml_tpu.config import TrainConfig as JTrain

    log, jlog = _Log(), _Log()
    assert tscan.scan_eligible(_cfg(**{"train.checkify": True, "train.scan_steps": 4}), log) is False
    assert jscan.scan_eligible(JExp(train=JTrain(checkify=True, scan_steps=4)), None, None, jlog) is False
    assert log.records == jlog.records
    assert log.records[0]["reason"].startswith("checkify:") and "warning" in log.records[1]


def test_a_trip_goes_through_the_flight_recorder(tmp_path):
    cfg = _cfg(**{"train.checkify": True, "eval.results_dir": tmp_path})
    model, opt, make = _trainer("dce", cfg)
    bad = dict(_batch(cfg))
    bad["yp_img"] = torch.full_like(bad["yp_img"], float("inf"))
    rec = FlightRecorder("unit", cfg)
    rec.note_good(model.state_dict)
    m = make(True)(bad, None)
    with pytest.raises(DivergenceError, match="checkify") as ei:
        rec.on_step(0, m, loss=float(m["loss"]), params=model.state_dict)
    assert ei.value.reason.startswith("checkify: nan generated by primitive: aten.")
    bundle = json.load(open(os.path.join(ei.value.dump_dir, "bundle.json")))
    assert bundle["reason"] == ei.value.reason and bundle["last_good"]["step"] == 0


def test_the_classifier_nll_gather_is_checked_and_an_out_of_range_label_trips():
    cfg = _cfg(CLF_DATA)
    _, _, make_on = _trainer("sc", cfg)
    _, _, make_off = _trainer("sc", cfg)
    batch = _batch(cfg)
    a, b = make_off(False)(batch, None), make_on(True)(batch, None)
    assert error_message(b["checkify_err"]) is None and torch.equal(a["loss"], b["loss"])
    bad = dict(batch)
    bad["indicator"] = bad["indicator"].clone()
    bad["indicator"].view(-1)[5] = 7  # 3 classes
    step = make_on(True)
    m = step(bad, None)
    msg = error_message(m["checkify_err"])
    assert msg.startswith("out-of-bounds indexing for array of shape") and "index 7" in msg and "aten.gather" in msg
    assert torch.isfinite(m["loss"])  # the index was clamped: the step ran
    clean = step(batch, None)
    assert error_message(clean["checkify_err"]) is None and torch.isfinite(clean["loss"])


def test_the_trainer_raises_a_typed_trip(tmp_path):
    cfg = _cfg(CLF_DATA, **{"train.checkify": True, "quantum.use_quantumnat": True, "quantum.noise_level": "inf",
                            "eval.results_dir": tmp_path})
    with pytest.raises(DivergenceError) as ei:
        tqsc.train_classifier(cfg, quantum=True, device="cpu", logger=_Log())
    # the CPU runs the circuit's plain version: its ops are checked by aten name
    assert ei.value.reason.startswith("checkify: nan generated by primitive: aten.")


# ---------------------------------------------------------------------------
# the three error classes, the backward, the kernels' boundary
# ---------------------------------------------------------------------------


def test_a_nan_generated_in_the_backward_is_caught_and_named():
    x = torch.zeros(3, requires_grad=True)
    fwd = Sanitizer()
    with fwd:
        y = (torch.sqrt(x) * 0.0).sum()
    assert error_message(fwd) is None  # the forward is clean: sqrt(0) = 0
    bwd = Sanitizer()
    with bwd:
        y.backward()  # d sqrt at 0 is 1/0, times the zero cotangent: NaN
    assert error_message(bwd) == "nan generated by primitive: aten.div." and torch.isnan(x.grad).all()


def test_an_inf_input_alone_does_not_trip_and_inf_minus_inf_does():
    x = torch.tensor([1.0, float("inf")])
    s = Sanitizer()
    with s:
        torch.log(x)
    assert error_message(s) is None
    s = Sanitizer()
    with s:
        x - x
    assert error_message(s) == "nan generated by primitive: aten.sub."


@pytest.mark.parametrize("op,name", [(lambda a, b: a // b, "aten.floor_divide"),
                                     (torch.remainder, "aten.remainder"),
                                     (lambda a, b: torch.div(a, b, rounding_mode="trunc"), "aten.div")])
def test_integer_division_by_zero_trips_and_runs(op, name):
    a, b = torch.tensor([4, 5, 6]), torch.tensor([2, 0, 3])
    s = Sanitizer()
    with s:
        out = op(a, b)
    assert error_message(s) == f"division by zero (primitive: {name})"
    assert out[0] == op(a[:1], b[:1])[0] and out[2] == op(a[2:], b[2:])[0]
    s = Sanitizer()
    with s:
        op(a, b + 1)
    assert error_message(s) is None


@pytest.mark.parametrize("case", ["gather", "index_select", "index", "take", "embedding"])
def test_an_out_of_range_index_trips_with_jaxs_message(case):
    src = torch.arange(12.0).reshape(4, 3)
    s = Sanitizer()
    with s:
        if case == "gather":
            out = torch.gather(src, 1, torch.tensor([[0], [5], [1], [2]]))
        elif case == "index_select":
            out = torch.index_select(src, 0, torch.tensor([1, 9]))
        elif case == "index":
            out = src[torch.tensor([0, -9])]
        elif case == "take":
            out = torch.take(src, torch.tensor([3, 40]))
        else:
            out = torch.nn.functional.embedding(torch.tensor([1, 4]), src)
    msg = error_message(s)
    assert msg.startswith("out-of-bounds indexing for array of shape") and f"aten.{case}" in msg, msg
    assert torch.isfinite(out).all()  # clamped into range, not an error


def test_unreadable_outputs_are_listed_unchecked():
    s = Sanitizer()
    with s:
        torch.bincount(torch.tensor([0, 1, 1]))
        torch.ones(2) + 1
    assert s.unchecked == {"aten.bincount": "non-float output"} and error_message(s) is None


def test_a_hand_kernels_boundary_is_checked_under_its_name():
    a, w = torch.ones(2, 3), torch.full((1, 3, 2), float("inf"))
    s = Sanitizer()
    with s:
        with tk._observed("circuit_expvals", lambda: (0.0, 0.0)) as outs:
            ev = torch.cos(w).sum() * a  # inside the region no aten op is checked
            outs.append(ev)
    assert error_message(s) == "nan generated by primitive: circuit_expvals."
    assert tk._observers() == []


# ---------------------------------------------------------------------------
# serve.checkify
# ---------------------------------------------------------------------------


@pytest.fixture()
def _tables(tmp_path, monkeypatch):
    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    yield
    batching_autotune.invalidate_cache()


def _engines(checkify, batching="bucket"):
    jcfg = JConfig()
    jcfg = replace(jcfg, data=replace(jcfg.data, n_ant=16), model=replace(jcfg.model, features=8),
                   quantum=replace(jcfg.quantum, n_qubits=4, n_layers=2, impl="pallas_circuit"),
                   serve=replace(jcfg.serve, buckets=(4, 64), checkify=checkify, batching=batching))
    jeng = JServeEngine(jcfg, {}, {}, quantum=True)
    rng = np.random.default_rng(0)
    hdce_vars = jax.tree.map(lambda v: (0.2 * rng.standard_normal(np.shape(v))).astype(np.float32) + 0.0,
                             jax.device_get(jeng.hdce.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, 16, 8, 2)))))
    hdce_vars["batch_stats"] = jax.tree.map(lambda v: np.abs(v) + 1.0 if v.ndim else v, hdce_vars["batch_stats"])
    clf = jax.device_get(jeng.clf.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 8, 2))))["params"]
    clf = jax.tree.map(lambda v: (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32), clf)
    jeng = JServeEngine(jcfg, hdce_vars, {"params": clf}, quantum=True)
    tcfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16), model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=4, n_layers=2, impl="pallas_circuit"),
        serve=tconfig.ServeConfig(buckets=(4, 64), checkify=checkify, batching=batching))
    teng = ServeEngine(tcfg, interop.hdce_state_dict_from_flax(hdce_vars), interop.qsc_state_dict_from_flax(clf),
                       quantum=True, device="cpu")
    return jeng, teng


def test_serve_checkify_parity_trip_and_recovery(_tables, tmp_path):
    from qdml_tpu_torch.telemetry import set_sink
    from qdml_tpu_torch.utils.metrics import MetricsLogger

    jeng, eng = _engines(True)
    _, plain = _engines(False)
    logger = MetricsLogger(str(tmp_path / "serve.jsonl"), echo=False)
    set_sink(logger)  # the checked engine's warmup counts its buckets into it
    try:
        eng.warmup()
    finally:
        set_sink(None)
        logger.close()
    for e in (jeng, plain):
        e.warmup()
    assert eng.batching_race["4"] == {"forced": "bucket"}
    x = np.random.default_rng(5).standard_normal((3, 16, 8, 2)).astype(np.float32)
    h, pred, conf, _ = eng.infer(x)
    h0, pred0, conf0, _ = plain.infer(x)
    assert np.array_equal(h, h0) and np.array_equal(pred, pred0) and np.array_equal(conf, conf0)
    jh, jpred, _, _ = jeng.infer(x)
    same = pred == np.asarray(jpred)
    np.testing.assert_allclose(h[same], np.asarray(jh)[same], rtol=0, atol=1e-4 * np.abs(jh).max() + 1e-5)
    assert all(v == 0 for v in eng.request_path_work().values())
    bad = np.full((2, 16, 8, 2), np.inf, np.float32)
    with pytest.raises(DivergenceError, match="serve checkify tripped on bucket 4: nan generated by primitive"):
        eng.infer(bad)
    with pytest.raises(JDivergenceError, match="serve checkify"):
        jeng.infer(bad)
    h2, _, _, _ = eng.infer(x[:2])  # the engine keeps serving
    assert np.array_equal(h2, h0[:2])
    cost = eng.bucket_cost["64"]
    assert cost["available"] and cost["flops"] > 0 and cost["platform"] == "cpu"
    recs = [json.loads(line) for line in (tmp_path / "serve.jsonl").read_text().splitlines()]
    assert sorted(r["bucket"] for r in recs if r.get("kind") == "cost" and r.get("name") == "serve_bucket") == [4, 64]
    # without a sink the warmup counts nothing
    assert plain.bucket_cost["64"]["available"] is False and plain.bucket_cost["64"]["first_forward_s"] > 0


def test_serve_checkify_nan_ragged_pads_do_not_trip(_tables):
    _, eng = _engines(True, batching="ragged")
    eng.warmup()
    assert batching_autotune.table_key("cpu", 64, "dense", "float32", True).endswith("/ck")
    rng = np.random.default_rng(6)
    for fill in (3, 37):
        xp = rng.standard_normal((64, 16, 8, 2)).astype(np.float32)
        clean = eng.forward_tier(xp.copy(), fill)[0][:fill]
        xp[fill:] = np.nan
        xp[fill + 1:] = np.inf
        h = eng.forward_tier(xp, fill)[0]
        assert torch.equal(h[:fill], clean) and torch.isfinite(h).all()
    xp[:2] = np.inf  # a valid row poisoned does trip
    with pytest.raises(DivergenceError, match="bucket 64"):
        eng.forward_tier(xp, 37)


def test_serve_checkify_pool_fails_only_the_poisoned_future(_tables):
    from qdml_tpu_torch.serve.server import ReplicaPool

    _, eng = _engines(True)
    x = np.random.default_rng(7).standard_normal((8, 16, 8, 2)).astype(np.float32)
    pool = ReplicaPool(eng, replicas=2, workers=2, log_requests=False).start()
    try:
        first = [f.result(timeout=60) for f in [pool.submit(x[i], rid=i) for i in range(8)]]
        with pytest.raises(DivergenceError):
            pool.submit(np.full((16, 8, 2), np.inf, np.float32), rid="bad").result(timeout=60)
        later = [f.result(timeout=60) for f in [pool.submit(x[i], rid=100 + i) for i in range(8)]]
    finally:
        pool.stop()
    assert len(first) == len(later) == 8
    assert all(np.array_equal(a.h, b.h) for a, b in zip(first, later))


# one rank's rows poisoned at step 1; after each clean step, the collective
# the next training step would start with
_ONE_RANK_TRIP = """
import sys
import torch
import torch.distributed as dist
from qdml_tpu_torch import config
from qdml_tpu_torch.telemetry import DivergenceError, FlightRecorder
from qdml_tpu_torch.telemetry.sanitizer import Sanitizer

dist.init_process_group("gloo")
rank = dist.get_rank()
cfg = config.from_args(["--train.probe_every=0", "--eval.results_dir=" + sys.argv[1]])
rec = FlightRecorder("world_trip", cfg)
for step in range(3):
    san = Sanitizer()
    with san:
        y = torch.log(torch.full((4,), -1.0 if (rank == 1 and step == 1) else 1.0))
    try:
        rec.on_step(0, {"loss": y.sum(), "checkify_err": san}, loss=0.0)
    except DivergenceError as e:
        print("TRIP", step, e.reason, flush=True)
        dist.destroy_process_group()
        sys.exit(4)
    t = torch.ones(1)
    dist.all_reduce(t)
dist.destroy_process_group()
"""


def test_a_trip_on_one_rank_trips_every_rank(tmp_path):
    from qdml_tpu_torch.parallel.selfcheck import spawn_world

    rcs = spawn_world(2, ["-c", _ONE_RANK_TRIP, str(tmp_path / "res")], tmp_path / "logs", timeout_s=120)
    logs = [(tmp_path / "logs" / f"rank{r}.log").read_text() for r in range(2)]
    assert rcs == [4, 4], logs
    for text in logs:
        assert "TRIP 1 checkify: nan generated by primitive: aten.log." in text, text
    assert (tmp_path / "res" / "default" / "flightrec").is_dir()  # rank 0 wrote the bundle
