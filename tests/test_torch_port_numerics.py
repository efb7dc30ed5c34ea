"""The port's numerics flight recorder and cost records against the JAX package, on the CPU.

- ``probe_tree`` on JAX's own tree, and one train step's probe of the tiny
  HDCE, DCE, SC and QSC from the same weights (carried across by
  ``qdml_tpu_torch.interop``) and batch: the same keys (``branch_grad_norm``
  keyed by JAX's top-level parameter names) and values within rtol 1e-5;
  the fused nonfinite count;
- the K-step path's stacked (K,) probes equal the per-step path's record
  for record, and computing probes changes no loss and adds no graph;
- ``Watchdog``'s trip table, ``FlightRecorder``'s records, cadence and
  last-good refresh, the forced-NaN QSC run (QuantumNAT ``noise_level=inf``)
  raising ``DivergenceError`` with a dump that restores, the
  epoch-aggregate trip at ``probe_every=0``, and the watchdog off;
- the cost records: counted flops of a known product, ``achieved_roofline``
  math and degradation, and the classification table on the port's own
  peaks (no TPU row, ``unknown`` off the table);
- a 2-rank gloo world: rank 0's global ``grad_norm`` equals one rank's, and a
  forced NaN raises ``DivergenceError`` on both ranks within the timeout.
"""

import dataclasses
import json
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.telemetry import Watchdog as JWatchdog  # noqa: E402
from qdml_tpu.telemetry import probe_tree as jprobe_tree  # noqa: E402
from qdml_tpu.train import dce as jdce  # noqa: E402
from qdml_tpu.train import hdce as jhdce  # noqa: E402
from qdml_tpu.train import qsc as jqsc  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData  # noqa: E402
from qdml_tpu_torch.telemetry import (  # noqa: E402
    DivergenceError,
    FlightRecorder,
    Telemetry,
    Watchdog,
    cost,
    probe_tree,
)
from qdml_tpu_torch.telemetry.numerics import LAST_GOOD_FALLBACK_EVERY, fetch  # noqa: E402
from qdml_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from qdml_tpu_torch.train import dce as tdce  # noqa: E402
from qdml_tpu_torch.train import hdce as thdce  # noqa: E402
from qdml_tpu_torch.train import qsc as tqsc  # noqa: E402
from qdml_tpu_torch.train import scan as tscan  # noqa: E402

RTOL = 1e-5
DATA = dict(n_ant=16, n_sub=8, n_beam=4, data_len=40)
# the classifiers' flattened head reads the reference's 16 x 8 image
CLF_DATA = dict(DATA, n_sub=16, n_beam=8)


def _read(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def _tcfg(data=DATA, **over):
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**data),
        model=tconfig.ModelConfig(features=8),
        train=tconfig.TrainConfig(batch_size=8, n_epochs=1, print_freq=1000),
    )
    return tconfig.from_args([f"--{k}={v}" for k, v in over.items()], base=cfg)


def _jcfg(data=DATA, **quantum):
    return jconfig.ExperimentConfig(
        data=jconfig.DataConfig(**data),
        model=jconfig.ModelConfig(features=8),
        train=jconfig.TrainConfig(batch_size=8, n_epochs=1),
        quantum=jconfig.QuantumConfig(**quantum),
    )


_TREE = {
    "trunk": {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3) / 10, "b": np.ones(3, np.float32)},
    "head": {"w": -np.ones((3, 2), np.float32)},
}


def _torch_tree(tree, scale=1.0):
    return {k: [torch.tensor(v * scale) for v in sub.values()] for k, sub in tree.items()}


def _close(got: dict, want: dict, rtol=RTOL, what=""):
    """Probe dicts key for key (nested ``branch_grad_norm`` too)."""
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _close(g, w, rtol, f"{what}.{k}")
        else:
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64), rtol=rtol,
                                       err_msg=f"{what}.{k}")


# ---------------------------------------------------------------------------
# probe_tree
# ---------------------------------------------------------------------------


def test_probe_tree_matches_jax_on_its_tree():
    jtree = jax.tree.map(jnp.asarray, _TREE)
    want = jax.device_get(jprobe_tree(jtree, jax.tree.map(lambda x: 2 * x, jtree),
                                      jax.tree.map(lambda x: -0.01 * x, jtree)))
    got = fetch(probe_tree(_torch_tree(_TREE), _torch_tree(_TREE, 2.0), _torch_tree(_TREE, -0.01)))
    _close(got, want)
    assert got["nonfinite"].dtype.kind == "i" and int(got["nonfinite"]) == 0
    assert float(got["update_ratio"]) == pytest.approx(0.005, rel=1e-5)


def test_probe_tree_counts_nonfinite_fused_as_jax():
    bad = {"a": np.asarray([1.0, np.nan], np.float32), "b": np.asarray([np.inf], np.float32)}
    upd = {"a": np.asarray([np.nan, np.nan], np.float32), "b": np.asarray([0.0], np.float32)}
    want = int(jprobe_tree(jax.tree.map(jnp.asarray, bad), None, jax.tree.map(jnp.asarray, upd))["nonfinite"])
    got = probe_tree({k: torch.tensor(v) for k, v in bad.items()}, None,
                     {k: torch.tensor(v) for k, v in upd.items()})
    assert int(got["nonfinite"]) == want == 4 and got["nonfinite"].dtype == torch.int32


def test_member_probe_is_each_members_own():
    rng = np.random.default_rng(0)
    stacked = [torch.tensor(rng.standard_normal((3, 4, 2)).astype(np.float32)) for _ in range(2)]
    got = fetch(probe_tree({"x": stacked}, {"x": stacked}, {"x": stacked}, members=True))
    for m in range(3):
        one = fetch(probe_tree({"x": [t[m] for t in stacked]}, {"x": [t[m] for t in stacked]},
                               {"x": [t[m] for t in stacked]}))
        for k in ("grad_norm", "param_norm", "update_ratio"):
            assert float(got[k][m]) == pytest.approx(float(one[k]), rel=1e-6)


def _grid_batch(s, u, b, seed, h_dim, hw):
    rng = np.random.default_rng(seed)
    return {
        "yp_img": rng.standard_normal((s, u, b, *hw, 2)).astype(np.float32),
        "h_label": rng.standard_normal((s, u, b, 2 * h_dim)).astype(np.float32),
        "h_perf": rng.standard_normal((s, u, b, 2 * h_dim)).astype(np.float32),
        "indicator": np.broadcast_to(np.arange(s)[:, None, None], (s, u, b)).astype(np.int32),
    }


def _jax_probe(step_fn, state, batch, *extra):
    _, m = jax.jit(step_fn)(state, {k: jnp.asarray(v) for k, v in batch.items()}, *extra)
    return jax.device_get(m["probe"])


@pytest.mark.parametrize("family", ["hdce", "dce", "sc", "qsc"])
def test_one_step_probe_matches_jax(family):
    """The step's probe from the same weights and batch: gradients after the
    backward, parameters before the update, the optimizer's own updates."""
    data = DATA if family in ("hdce", "dce") else CLF_DATA
    jcfg = _jcfg(data, n_qubits=4, n_layers=2, impl="dense")
    tcfg = _tcfg(data, **{"quantum.n_qubits": 4, "quantum.n_layers": 2, "quantum.impl": "dense"})
    batch = _grid_batch(3, 3, 4, seed=len(family), h_dim=jcfg.data.h_dim, hw=tcfg.image_hw)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    if family == "hdce":
        jmodel, state = jhdce.init_hdce_state(jcfg, steps_per_epoch=4)
        want = _jax_probe(partial(jhdce._fused_step, jmodel, probes=True), state, batch)
        sd = interop.hdce_state_dict_from_flax(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}), tcfg.image_hw)
        model, opt = thdce.make_trainer(tcfg, "cpu", 4, init_state=sd)
        got = thdce.hdce_train_step(model, opt, tbatch, probes=True)["probe"]
    elif family == "dce":
        jmodel, state = jdce.init_dce_state(jcfg, steps_per_epoch=4)
        want = _jax_probe(partial(jdce._dce_step, jmodel, probes=True), state, batch)
        sd = interop.dce_state_dict_from_flax(jax.device_get(
            {"params": state.params, "batch_stats": state.batch_stats}), tcfg.image_hw)
        model, opt = tdce.make_trainer(tcfg, "cpu", 4, init_state=sd)
        got = tdce.dce_train_step(model, opt, tbatch, probes=True)["probe"]
    else:
        quantum = family == "qsc"
        jmodel, state = jqsc.init_sc_state(jcfg, quantum, steps_per_epoch=4)
        want = _jax_probe(partial(jqsc._sc_step, jmodel, False, probes=True), state, batch, jax.random.PRNGKey(0))
        convert = interop.qsc_state_dict_from_flax if quantum else interop.sc_state_dict_from_flax
        model, opt = tqsc.make_trainer(tcfg, quantum, "cpu", 4, init_state=convert(jax.device_get(state.params)))
        model.train()
        got = tqsc.classifier_train_step(model, opt, tbatch, probes=True)["probe"]
    got = fetch(got)
    if family == "qsc":
        # the last layer's RZ weights commute with the Z readout: their
        # gradient is rounding noise in both packages, which Adam turns into
        # an update of up to lr each (the trainers' 2-lr bound): the update
        # norm's square is held to n_qubits * lr^2, the rest at rtol 1e-5
        lr, n = tcfg.train.lr, tcfg.quantum.n_qubits
        gu, wu = float(got.pop("update_norm")), float(want.pop("update_norm"))
        assert abs(gu**2 - wu**2) <= n * lr**2, (gu, wu)
        gr, wr = float(got.pop("update_ratio")), float(want.pop("update_ratio"))
        assert gr == pytest.approx(gu / float(got["param_norm"]), rel=1e-6)
        assert wr == pytest.approx(wu / float(want["param_norm"]), rel=1e-6)
    _close(got, want, what=family)


# ---------------------------------------------------------------------------
# probes in the loops
# ---------------------------------------------------------------------------


def _run(train, cfg, tmp_path, tag):
    from qdml_tpu_torch.utils.metrics import MetricsLogger

    path = tmp_path / f"{tag}.jsonl"
    log = MetricsLogger(str(path), echo=False)
    from qdml_tpu_torch.telemetry import set_sink

    set_sink(log)
    try:
        out = train(cfg, device="cpu", logger=log)
    finally:
        set_sink(None)
        log.close()
    return out, _read(path)


def _flat_numerics(records, key="grad_norm"):
    out = []
    for r in records:
        if r.get("kind") == "numerics":
            v = r[key]
            out.extend(v if isinstance(v, list) else [v])
    return out


@pytest.mark.parametrize("family", ["hdce", "qsc"])
def test_k_step_probes_equal_the_per_step_path(tmp_path, family):
    over = {"train.probe_every": 1, "quantum.n_qubits": 4, "quantum.impl": "pallas_circuit",
            "eval.results_dir": tmp_path}
    train = thdce.train_hdce if family == "hdce" else partial(tqsc.train_classifier, quantum=True)
    data = DATA if family == "hdce" else CLF_DATA
    (_, h0), r0 = _run(train, _tcfg(data, **over, **{"train.scan_steps": 0}), tmp_path, "k0")
    (_, h4), r4 = _run(train, _tcfg(data, **over, **{"train.scan_steps": 2}), tmp_path, "k2")
    for key in ("grad_norm", "param_norm", "update_norm", "update_ratio", "nonfinite"):
        a, b = _flat_numerics(r0, key), _flat_numerics(r4, key)
        assert len(a) == len(b) == 4, (key, a, b)
        np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=key)
    branches = [r["branch_grad_norm"] for r in r0 if r.get("kind") == "numerics"]
    names = {"hdce": {"StackedConvP128_0", "FCP128_0"}, "qsc": {"QSCPreprocess_0", "qweights", "Dense_0"}}
    assert set(branches[0]) == names[family]
    np.testing.assert_allclose(h4["train_loss"], h0["train_loss"], rtol=RTOL)


def test_probes_change_no_loss_and_add_no_graph(tmp_path):
    base = {"eval.results_dir": tmp_path, "train.scan_steps": 2}
    before = dict(tscan.activity)
    (m_on, h_on), _ = _run(tdce.train_dce, _tcfg(**base, **{"train.probe_every": 1}), tmp_path, "on")
    (m_off, h_off), _ = _run(tdce.train_dce, _tcfg(**base, **{"train.probe_every": 0}), tmp_path, "off")
    assert h_on["train_loss"] == h_off["train_loss"] and h_on["val_nmse"] == h_off["val_nmse"]
    for a, b in zip(m_on.parameters(), m_off.parameters()):
        assert torch.equal(a, b)
    assert tscan.activity == before  # the CPU's K-step path is eager: nothing captured either way
    # the step without probes returns no probe at all
    data = GridData.synthesize(_tcfg().data, "cpu")
    model, opt = tdce.make_trainer(_tcfg(), "cpu", 4)
    batch = next(iter(DMLGridLoader(data, 8, "train").epoch(0)))
    assert "probe" not in tdce.dce_train_step(model, opt, batch)


# ---------------------------------------------------------------------------
# Watchdog and FlightRecorder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wd_cls", [Watchdog, JWatchdog], ids=["port", "jax"])
def test_watchdog_trip_table(wd_cls):
    wd = wd_cls(grad_norm_max=100.0)
    cases = [
        (dict(loss=0.5, probe={"nonfinite": 0, "grad_norm": 1.0}), None),
        (dict(loss=float("nan")), "loss"),
        (dict(loss=np.asarray([0.1, np.inf])), "loss"),
        (dict(loss=0.1, probe={"nonfinite": 3, "grad_norm": 1.0}), "nonfinite"),
        (dict(loss=0.1, probe={"nonfinite": 0, "grad_norm": 101.0}), "ceiling"),
        (dict(probe={"nonfinite": 0, "grad_norm": np.asarray([1.0, 400.0])}), "ceiling"),
        (dict(probe={"nonfinite": np.asarray([0, 2]), "grad_norm": np.asarray([1.0, 1.0])}), "nonfinite"),
    ]
    port = Watchdog(grad_norm_max=100.0)
    for kw, want in cases:
        got = wd.check(**kw)
        assert (got is None) if want is None else (want in got), (kw, got)
        assert got == port.check(**kw)
    assert wd_cls(grad_norm_max=0.0).check(probe={"nonfinite": 0, "grad_norm": 1e9}) is None


def test_flight_recorder_records_on_its_cadence(tmp_path):
    cfg = _tcfg(**{"train.probe_every": 2, "eval.results_dir": tmp_path})
    tele = Telemetry(str(tmp_path / "n.jsonl"))
    rec = FlightRecorder("unit", cfg, sink=tele)
    m = {"loss": torch.tensor(0.25), "probe": probe_tree(_torch_tree(_TREE), _torch_tree(_TREE), _torch_tree(_TREE))}
    fetched = []
    for _ in range(4):
        fetched.append(rec.should_fetch())
        rec.on_step(0, m, loss=0.25)
    tele.close()
    lines = [r for r in _read(tmp_path / "n.jsonl") if r.get("kind") == "numerics"]
    assert [r["step"] for r in lines] == [1, 2, 4] and fetched == [True, True, False, True]
    assert lines[0]["name"] == "unit" and lines[0]["branch_grad_norm"]["trunk"] > 0
    assert FlightRecorder("x", _tcfg(**{"train.probe_every": 0})).should_fetch() is False


def test_last_good_refreshes_without_probes(tmp_path):
    cfg = _tcfg(**{"train.probe_every": 0, "eval.results_dir": tmp_path})
    rec = FlightRecorder("unit", cfg)
    rec.note_good({"w": torch.zeros(3)})
    for i in range(1, LAST_GOOD_FALLBACK_EVERY + 1):
        rec.on_step(0, {}, loss=0.5, params={"w": torch.full((3,), float(i))})
    with pytest.raises(DivergenceError) as ei:
        rec.on_step(0, {}, loss=float("nan"))
    bundle = json.load(open(os.path.join(ei.value.dump_dir, "bundle.json")))
    assert bundle["last_good"]["step"] == LAST_GOOD_FALLBACK_EVERY
    restored, _ = tckpt.restore_checkpoint(ei.value.dump_dir, "last_good")
    assert torch.equal(restored["params"]["w"], torch.full((3,), float(LAST_GOOD_FALLBACK_EVERY)))


def _nan_qsc_cfg(tmp_path, **over):
    return _tcfg(CLF_DATA, **{"quantum.n_qubits": 4, "quantum.use_quantumnat": True, "quantum.noise_level": "inf",
                    "quantum.impl": "pallas_circuit", "train.n_epochs": 2,
                    "eval.results_dir": tmp_path / "results", **over})


def test_forced_nan_qsc_run_trips_with_a_restorable_dump(tmp_path):
    cfg = _nan_qsc_cfg(tmp_path, **{"train.probe_every": 1})
    with pytest.raises(DivergenceError) as ei:
        tqsc.train_classifier(cfg, quantum=True, device="cpu", workdir=str(tmp_path / "wd"))
    err = ei.value
    assert err.dump_dir and err.dump_dir in str(err) and "flightrec" in err.dump_dir
    bundle = json.load(open(os.path.join(err.dump_dir, "bundle.json")))
    assert bundle["reason"] == err.reason and bundle["name"] == "qsc_train"
    assert bundle["probe_history"] and bundle["batch_info"] is not None
    assert bundle["rng_key"]["seed"] == tqsc.noise_generator(cfg, 0, torch.device("cpu")).initial_seed()
    restored, meta = tckpt.restore_checkpoint(err.dump_dir, bundle["last_good"]["checkpoint"])
    assert meta["loop"] == "qsc_train"
    model = tqsc.build_classifier(cfg, True, "cpu")
    model.load_state_dict(restored["params"])
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_epoch_aggregate_trip_at_probe_every_zero(tmp_path):
    cfg = _nan_qsc_cfg(tmp_path, **{"train.probe_every": 0, "train.scan_steps": 2})
    with pytest.raises(DivergenceError) as ei:
        tqsc.train_classifier(cfg, quantum=True, device="cpu", workdir=str(tmp_path / "wd"))
    assert ei.value.reason.startswith("epoch-aggregate") and ei.value.dump_dir is not None
    assert json.load(open(os.path.join(ei.value.dump_dir, "bundle.json")))["reason"].startswith("epoch-aggregate")


def test_watchdog_off_lets_the_nan_run_continue(tmp_path):
    cfg = _nan_qsc_cfg(tmp_path, **{"train.probe_every": 0, "train.watchdog": False})
    _, hist = tqsc.train_classifier(cfg, quantum=True, device="cpu")
    assert not np.isfinite(hist["train_loss"]).all()


# ---------------------------------------------------------------------------
# cost
# ---------------------------------------------------------------------------


def test_counted_cost_of_a_known_product():
    lin = torch.nn.Linear(64, 32)
    x = torch.randn(16, 64)

    def step():
        lin.zero_grad()
        y = lin(x).square().mean()
        y.backward()
        return y

    _, rec = cost.analyze(step, device="cpu")
    # forward product and the weight gradient's (the input needs none)
    assert rec["available"] and rec["flops"] == 2 * (2 * 16 * 64 * 32) and rec["source"] == "counted"
    assert rec["bytes_accessed"] > x.numel() * 4 and rec["peak_temp_bytes"] is None  # no card
    assert rec["roofline"] in ("compute-bound", "memory-bound") and rec["platform"] == "cpu"


def test_hand_kernel_work_counts_in_the_cost_record():
    from qdml_tpu_torch.quantum import kernels

    counter = cost.cost_counter()
    with counter:
        counter.kernel("circuit_expvals", [], cost.kernel_work("circuit_expvals", 64, 6, 3))
    assert counter.flops == cost.circuit_work(64, 6, 3)[1] and counter.kernels == {"circuit_expvals": 1}
    assert kernels._observers() == []  # none active outside a mode


def test_cost_degrades_when_counting_fails(monkeypatch):
    from torch.utils import flop_counter

    def broken(*a, **k):
        raise NotImplementedError("no formula here")

    monkeypatch.setitem(flop_counter.flop_registry, torch.ops.aten.mm, broken)
    _, rec = cost.analyze(lambda: torch.randn(4, 4) @ torch.randn(4, 4), device="cpu")
    assert rec["available"] is False and "NotImplementedError" in rec["reason"] and rec["platform"] == "cpu"


def test_achieved_roofline_math_and_degradation():
    peak, bw = cost.PLATFORM_PEAKS["gpu-h100"]["float32"], cost.PLATFORM_PEAKS["gpu-h100"]["bytes_per_s"]
    c = {"available": True, "platform": "gpu-h100", "flops": 1e9, "bytes_accessed": 1e9}
    rec = cost.achieved_roofline(c, programs_per_sec=2.0)
    assert rec["bound"] == "memory" and rec["arithmetic_intensity"] == 1.0
    assert rec["ceiling_tflops_per_s"] == pytest.approx(bw / 1e12)
    assert rec["fraction"] == pytest.approx(2e9 / bw, rel=1e-4)
    c2 = {"available": True, "platform": "gpu-h100", "flops": 1e12, "bytes_accessed": 1e7}
    rec2 = cost.achieved_roofline(c2, programs_per_sec=0.01)
    assert rec2["bound"] == "compute" and rec2["ceiling_tflops_per_s"] == pytest.approx(peak / 1e12)
    # bfloat16 programs meet the tensor-core ceiling
    rec3 = cost.achieved_roofline({**c2, "dtype": "bfloat16"}, programs_per_sec=0.01)
    assert rec3["ceiling_tflops_per_s"] == pytest.approx(989.0)
    assert cost.achieved_roofline({"available": False}, 1.0) is None
    assert cost.achieved_roofline({"available": True, "flops": 1e9}, 1.0) is None
    assert cost.achieved_roofline(c, 0.0) is None and cost.achieved_roofline(None, 1.0) is None
    assert cost.achieved_roofline({**c, "platform": "gpu-a100"}, 1.0) is None  # off the table


def test_roofline_classification_on_the_ports_peaks():
    assert cost.ridge_intensity("gpu-h100") == pytest.approx(67e12 / 3.35e12)
    assert cost.ridge_intensity("gpu-h100", "bfloat16") == pytest.approx(989e12 / 3.35e12)
    assert not any(p.startswith("tpu") for p in cost.PLATFORM_PEAKS)
    assert cost.ridge_intensity("tpu-v5e") is None and cost.ridge_intensity("gpu-a100") is None
    hi = cost._record(1e15, 1e9, None, "gpu-h100", "float32", "counted")
    lo = cost._record(1e9, 1e9, None, "gpu-h100", "float32", "counted")
    off = cost._record(1e15, 1e9, None, "gpu-a100", "float32", "counted")
    assert hi["roofline"] == "compute-bound" and lo["roofline"] == "memory-bound"
    assert off["roofline"] == "unknown" and "ridge_intensity" not in off
    assert cost.detect_platform("cpu") == "cpu"


def test_maybe_emit_cost_is_inert_without_a_sink(tmp_path):
    with cost.maybe_emit_cost("x", "cpu") as rec:
        torch.randn(3) + 1
    assert rec is None
    tele = Telemetry(str(tmp_path / "c.jsonl"))
    with cost.maybe_emit_cost("x", "cpu", sink=tele) as rec:
        torch.randn(8, 8) @ torch.randn(8, 8)
    tele.close()
    line = _read(tmp_path / "c.jsonl")[0]
    assert line["kind"] == "cost" and line["name"] == "x" and line["flops"] == 2 * 8**3


# ---------------------------------------------------------------------------
# a world of ranks
# ---------------------------------------------------------------------------


def test_two_rank_world_probe_is_global_and_a_nan_trips_every_rank(tmp_path):
    """dp train-qsc on 2 gloo ranks: rank 0's numerics records equal one
    rank's (the gradients are averaged before the probe), and the forced
    NaN raises DivergenceError (exit 4) on both ranks, none hung."""
    from qdml_tpu_torch import cli
    from qdml_tpu_torch.parallel.selfcheck import spawn_world

    flags = ["--device=cpu", "--preset=dp_8q", "--quantum.n_qubits=4", "--data.n_ant=16", "--data.n_sub=16",
             "--data.n_beam=8",
             "--data.data_len=40", "--model.features=4", "--train.batch_size=8", "--train.n_epochs=1",
             "--train.probe_every=1", "--train.scan_steps=0", "--quantum.impl=pallas_circuit",
             "--quantum.autotune=off", f"--eval.results_dir={tmp_path / 'res'}"]
    argv = ["-m", "qdml_tpu_torch.cli", "train-qsc", *flags, f"--train.workdir={tmp_path / 'w2'}"]
    assert spawn_world(2, argv, tmp_path / "logs2", timeout_s=240) == [0, 0]
    assert cli.main(["train-qsc", *flags, f"--train.workdir={tmp_path / 'w1'}"]) == 0
    two = _read(next((tmp_path / "w2").rglob("train-qsc.metrics.jsonl")))
    one = _read(next((tmp_path / "w1").rglob("train-qsc.metrics.jsonl")))
    for key in ("grad_norm", "param_norm", "update_norm"):
        a, b = _flat_numerics(two, key), _flat_numerics(one, key)
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=key)
    nan = ["--quantum.use_quantumnat=true", "--quantum.noise_level=inf"]
    argv = ["-m", "qdml_tpu_torch.cli", "train-qsc", *flags, *nan, f"--train.workdir={tmp_path / 'w3'}"]
    assert spawn_world(2, argv, tmp_path / "logs3", timeout_s=240) == [4, 4]
    for r in range(2):
        assert "DIVERGED:" in (tmp_path / "logs3" / f"rank{r}.log").read_text()
