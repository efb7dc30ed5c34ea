"""The serving engine's measured impl dispatch, sparse and ragged tiers and hot-swap, on the CPU.

Small engines (features 8, n_ant 16 so the head is 512 wide, S=3 unless
stated) built from seeded weights. Held: a forced ``serve.dispatch=sparse``
engine against the dense one on balanced and skewed batches (every row
routed to one scenario, so it overflows) within 1e-5; a forced
``serve.batching=ragged`` engine against the bucket engine at every fill,
with NaN and Inf in the pad rows, bit for bit on the valid rows; a hot-swapped
engine against a fresh engine on the new weights, bit for bit; and, once
``warmup`` has run, no measurement, table write or kernel build in
``infer`` (the engine's work counters), with every choice pinned per bucket.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.models.qsc import build_classifier  # noqa: E402
from qdml_tpu_torch.ops import dispatch_autotune  # noqa: E402
from qdml_tpu_torch.quantum import autotune  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from qdml_tpu_torch.train.hdce import build_hdce  # noqa: E402
from qdml_tpu_torch.utils import tune_table  # noqa: E402

BUCKETS = (1, 4, 8)
HW = (16, 8)


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    monkeypatch.setenv(autotune.ENV_TABLE, str(tmp_path / "qsc.json"))
    monkeypatch.setenv(dispatch_autotune.ENV_TABLE, str(tmp_path / "routing.json"))
    autotune.invalidate_cache()
    dispatch_autotune.invalidate_cache()
    yield
    autotune.invalidate_cache()
    dispatch_autotune.invalidate_cache()


def _cfg(n_scenarios=3, quantum=None, **serve):
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16, n_scenarios=n_scenarios),
        model=tconfig.ModelConfig(features=8),
        quantum=quantum or tconfig.QuantumConfig(n_qubits=4, n_layers=2, n_classes=n_scenarios),
    )
    return dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, buckets=BUCKETS, **serve))


def _weights(cfg, quantum=False, seed=0, skew_to=None):
    gen = torch.Generator().manual_seed(seed)
    hdce = build_hdce(cfg, "cpu", generator=gen).state_dict()
    clf = build_classifier(cfg, quantum, "cpu", generator=gen).state_dict()
    if skew_to is not None:  # every row to one scenario
        bias = "classifier.bias" if quantum else "FC.bias"
        clf[bias] = torch.zeros_like(clf[bias])
        clf[bias][skew_to] = 50.0
    return hdce, clf


def _engine(cfg, weights, quantum=False):
    eng = ServeEngine(cfg, *weights, quantum=quantum, device="cpu")
    warm = eng.warmup()
    return eng, warm


def _requests(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, *HW, 2)).astype(np.float32)


@pytest.mark.parametrize("skew", [None, 2])
@pytest.mark.parametrize("quantum", [False, True])
def test_sparse_engine_matches_dense(quantum, skew):
    w = _weights(_cfg(), quantum, skew_to=skew)
    dense, _ = _engine(_cfg(dispatch="dense"), w, quantum)
    sparse, warm = _engine(_cfg(dispatch="sparse"), w, quantum)
    assert warm["dispatch"]["mode"] == {"1": "sparse", "4": "sparse", "8": "sparse"}
    total = 0
    for n in (1, 3, 8, 13):  # 13 > the largest bucket: two chunks
        x = _requests(n, seed=n)
        h, pred, conf, info = sparse.infer(x)
        hd, pd, cd, infod = dense.infer(x)
        np.testing.assert_array_equal(pred, pd)
        np.testing.assert_array_equal(conf, cd)
        np.testing.assert_allclose(h, hd, rtol=0, atol=1e-5)
        assert (info.bucket, info.rows, info.chunks) == (infod.bucket, infod.rows, infod.chunks)
        total += n
        if skew is not None:
            assert (pred == skew).all()
    summary = sparse.dispatch_summary()
    assert summary["mode"] == "sparse" and summary["routed_rows"] == total
    # capacity ceil(b * 1.25 / 3) per expert: a skewed batch overflows, and its
    # rows are served by the dense route, never dropped
    if skew is None:
        assert summary["overflow_rows"] <= total
    else:
        assert summary["overflow_rows"] > 0
    assert dense.dispatch_summary()["overflow_rate"] is None
    assert sparse.request_path_work() == {"measure": 0, "table_write": 0, "kernel_build": 0}


def test_ragged_engine_matches_bucket_at_every_fill_and_pad_rows_never_leak():
    w = _weights(_cfg(), seed=4)
    bucket, _ = _engine(_cfg(batching="bucket"), w)
    ragged, warm = _engine(_cfg(batching="ragged"), w)
    assert warm["batching"]["mode"] == {"1": "ragged", "4": "ragged", "8": "ragged"}
    assert ragged.batching_summary() == {"mode": "ragged", "per_tier": {"1": "ragged", "4": "ragged", "8": "ragged"}}
    assert bucket.batching_summary()["mode"] == "bucket"
    x = _requests(8, seed=9)
    for n in range(1, 9):
        hb, pb, cb, ib = bucket.infer(x[:n])
        hr, pr, cr, ir = ragged.infer(x[:n])
        assert ib.bucket == ir.bucket and (ib.mode, ir.mode) == ("bucket", "ragged")
        assert ir.padded == ir.rows - n
        np.testing.assert_array_equal(hr, hb)
        np.testing.assert_array_equal(pr, pb)
        np.testing.assert_array_equal(cr, cb)
        # garbage in the pad rows of the tier: masked to zeros before any compute
        b = ir.bucket
        xp = np.full((b, *HW, 2), np.nan, np.float32)
        xp[n:][::2] = np.inf
        xp[:n] = x[:n]
        h, pred, conf, ovf = ragged.forward_tier(xp, n)
        assert ovf is None
        np.testing.assert_array_equal(h[:n].numpy(), hb)
        np.testing.assert_array_equal(pred[:n].numpy(), pb)
        assert torch.isfinite(h).all() and torch.isfinite(conf).all()
    assert ragged.request_path_work() == {"measure": 0, "table_write": 0, "kernel_build": 0}


def test_sparse_ragged_tier_keeps_nan_pads_out_of_capacity_and_outputs():
    w = _weights(_cfg(), seed=5)
    dense, _ = _engine(_cfg(dispatch="dense"), w)
    both, _ = _engine(_cfg(dispatch="sparse", batching="ragged"), w)
    x = _requests(8, seed=6)
    for n in (1, 5, 8):
        xp = np.full((8, *HW, 2), np.nan, np.float32)
        xp[:n] = x[:n]
        h, pred, conf, ovf = both.forward_tier(xp, n)
        hd, pd, _, _ = dense.infer(x[:n])
        np.testing.assert_array_equal(pred[:n].numpy(), pd)
        np.testing.assert_allclose(h[:n].numpy(), hd, rtol=0, atol=1e-5)
        assert torch.isfinite(h).all() and ovf <= n


def test_hot_swap_matches_a_fresh_engine_and_refuses_a_mismatch(tmp_path):
    cfg = _cfg()
    old_w, new_w = _weights(cfg, True, seed=0), _weights(cfg, True, seed=1)
    eng, _ = _engine(cfg, old_w, quantum=True)
    fresh, _ = _engine(cfg, new_w, quantum=True)
    x = _requests(6, seed=2)
    before = eng.infer(x)
    in_flight = eng.live_vars()  # a batch that read the live pair before the flip
    assert eng.swap_epoch == 0
    rec = eng.swap_params(*new_w)
    assert rec == {"epoch": 1, "work": {"measure": 0, "table_write": 0, "kernel_build": 0}}
    assert eng.swap_epoch == 1 and eng.live_vars() is not in_flight
    for got, want in zip(eng.infer(x)[:3], fresh.infer(x)[:3]):
        np.testing.assert_array_equal(got, want)
    # the modules a running batch holds are the old ones, untouched by the swap
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        h_old = eng._forward(*in_flight, xt)[0]
    np.testing.assert_array_equal(h_old.numpy(), before[0])
    # a state dict of another shape (or another key set) raises and the live weights stay
    bad_h = dict(new_w[0])
    bad_h["head.FC.bias"] = torch.zeros(7)
    with pytest.raises(ValueError, match="does not match"):
        eng.swap_params(bad_h, new_w[1])
    bad_c = {k: v for k, v in new_w[1].items() if k != "classifier.bias"}
    with pytest.raises(ValueError, match="clf"):
        eng.swap_params(new_w[0], bad_c)
    assert eng.swap_epoch == 1
    # from a workdir: the newest tags (best > last), or the ones pinned
    ws = tmp_path / "ws"
    meta = {"quantum": {"n_qubits": 4, "n_layers": 2, "n_classes": 3, "input_norm": False}}
    save_checkpoint(str(ws), "hdce_best", {"params": old_w[0]})
    save_checkpoint(str(ws), "qsc_best", {"params": old_w[1]}, meta)
    save_checkpoint(str(ws), "qsc_last", {"params": new_w[1]}, meta)
    rec = eng.swap_from_workdir(str(ws))
    assert rec["tags"] == {"hdce": "hdce_best", "qsc": "qsc_best"} and rec["epoch"] == 2
    np.testing.assert_array_equal(eng.infer(x)[0], before[0])
    rec = eng.swap_from_workdir(str(ws), tags={"qsc": "qsc_last"})
    assert rec["tags"]["qsc"] == "qsc_last"
    with pytest.raises(FileNotFoundError, match="pinned"):
        eng.swap_from_workdir(str(ws), tags={"qsc": "qsc_nope"})
    other = {"quantum": {**meta["quantum"], "input_norm": True}}
    save_checkpoint(str(ws), "qsc_best", {"params": old_w[1]}, other)
    with pytest.raises(ValueError, match="another quantum config"):
        eng.swap_from_workdir(str(ws))
    cold = ServeEngine(cfg, *old_w, quantum=True, device="cpu")
    with pytest.raises(RuntimeError, match="warmup"):
        cold.swap_params(*new_w)


def test_no_measurement_write_or_build_after_warmup_and_choices_stay_pinned(monkeypatch):
    """``impl=auto`` with tuning on, at S=6: warmup measures and writes its
    table, then the request path does neither, and a table edited after
    warmup changes nothing the engine does."""
    from qdml_tpu_torch.quantum import circuits

    q = tconfig.QuantumConfig(n_qubits=4, n_layers=2, n_classes=6, autotune="on")
    cfg = _cfg(n_scenarios=6, quantum=q)
    w = _weights(cfg, True, seed=7)
    before = dict(tune_table.activity)
    eng, warm = _engine(cfg, w, quantum=True)
    assert tune_table.activity["measure"] > before["measure"] and tune_table.activity["save"] > before["save"]
    assert warm["work"]["measure"] == tune_table.activity["measure"] - before["measure"]
    for b in BUCKETS:
        rec = warm["quantum_impl"][str(b)]
        assert rec["autotuned"] is True and set(rec["candidates"]) == set(autotune.eligible_impls(4))
        assert rec["impl"] == autotune.lookup(4, 2, b, mode="infer", platform="cpu")
    pinned = {b: warm["quantum_impl"][str(b)]["impl"] for b in BUCKETS}
    # rewrite the circuit table under the warmed engine: it keeps its impls
    autotune.save_table({autotune.table_key("cpu", 4, 2, b): {"best_fwd": "tensor", "best_train": "tensor"}
                         for b in BUCKETS})
    seen = []
    real = circuits.resolve_impl

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(circuits, "resolve_impl", spy)
    work0 = dict(tune_table.activity)
    assert eng.request_path_work() == {"measure": 0, "table_write": 1, "kernel_build": 0}  # the edit above
    for n in (1, 2, 4, 7, 8, 17):
        h, pred, conf, info = eng.infer(_requests(n, seed=n))
        assert h.shape == (n, 512) and np.isfinite(h).all()
    assert tune_table.activity == work0
    assert eng.request_path_work() == {"measure": 0, "table_write": 1, "kernel_build": 0}
    assert set(seen) <= set(pinned.values()) and seen
    # the offline reference resolves through the (edited) table at its own batch
    seen.clear()
    eng.offline_forward(_requests(3))
    assert seen == ["tensor"]


def test_warmup_records_and_validation():
    cfg = _cfg()
    w = _weights(cfg, True, seed=8)
    eng, warm = _engine(cfg, w, quantum=True)
    # CPU, autotune="auto": nothing is tuned, the heuristic's impl is pinned
    assert warm["quantum_impl"] == {str(b): {"impl": "dense"} for b in BUCKETS}
    # serve.dispatch / serve.batching "auto": dense routing, bucket batching, nothing raced
    assert warm["dispatch"]["mode"] == {str(b): "dense" for b in BUCKETS}
    assert warm["batching"]["mode"] == {str(b): "bucket" for b in BUCKETS}
    assert warm["work"] == {"measure": 0, "table_write": 0, "kernel_build": 0}
    for field, value in (("dispatch", "both"), ("batching", "dense")):
        bad = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, **{field: value}))
        with pytest.raises(ValueError, match=f"serve.{field}"):
            ServeEngine(bad, *w, quantum=True, device="cpu")
    with pytest.raises(ValueError, match="not warmed"):
        eng.forward_tier(np.zeros((3, *HW, 2), np.float32), 3)


@pytest.mark.parametrize("field,mode", [("dispatch", "dense"), ("batching", "bucket")])
def test_auto_serve_modes_take_the_jax_fallback_without_a_race(field, mode):
    """``serve.{dispatch,batching}=auto`` (the default, as in JAX) at S = 3
    pins dense routing and bucket batching, and times and writes nothing:
    the routing race's window leaves dense alone below S = 6, and the
    batching race is not ported (ROADMAP A.11)."""
    cfg = _cfg()
    assert getattr(cfg.serve, field) == "auto"
    eng, warm = _engine(cfg, _weights(cfg))
    assert warm[field]["mode"] == {str(b): mode for b in BUCKETS}
    summary = eng.dispatch_summary() if field == "dispatch" else eng.batching_summary()
    assert summary["mode"] == mode
    assert warm["work"] == {"measure": 0, "table_write": 0, "kernel_build": 0}
