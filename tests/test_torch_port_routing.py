"""Capacity-bucketed sparse routing against the JAX package, on the CPU.

``expert_capacity`` and ``bucket_ranks`` equal ``qdml_tpu.ops.routing``'s
exactly over a grid of batch sizes, S, capacity factors and ``valid``
masks. ``sparse_dispatch`` takes the same ``x``, ``pred`` and stand-in
experts (one linear map per expert, seeded numpy) as JAX's for balanced,
skewed (overflowing), padded and out-of-range batches: outputs within 1e-6
and overflow counts equal. Through the port's real HDCE trunks sparse and
dense agree within 1e-5 (the trunks see batches of another size), and the
SNR sweep's curves with ``dispatch="sparse"`` are within rtol 1e-4 of dense.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.ops import routing as jrt  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.ops import routing as trt  # noqa: E402


def test_expert_capacity_matches_jax():
    for b in (1, 2, 5, 8, 13, 64, 200, 2304):
        for s in (1, 2, 3, 6, 8, 64):
            for f in (0.0, 0.5, 1.0, 1.25, 2.0, 100.0):
                assert trt.expert_capacity(b, s, f) == jrt.expert_capacity(b, s, f), (b, s, f)


@pytest.mark.parametrize("b,s", [(1, 3), (6, 3), (13, 7), (64, 8), (40, 2)])
def test_bucket_ranks_match_jax(b, s):
    rng = np.random.default_rng(b * 100 + s)
    pred = rng.integers(-2, s + 2, b).astype(np.int32)  # out-of-range ids clip
    for valid in (None, rng.random(b) < 0.7, np.arange(b) < b // 2, np.zeros(b, bool)):
        tv = None if valid is None else torch.tensor(valid)
        jv = None if valid is None else jnp.asarray(valid)
        ids, rank = trt.bucket_ranks(torch.tensor(pred), s, tv)
        jids, jrank = jrt.bucket_ranks(jnp.asarray(pred), s, jv)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))


def _toy(s, din, d, seed):
    """Per-expert linear maps in both frameworks, from one numpy draw."""
    w = np.random.default_rng(seed).standard_normal((s, din, d)).astype(np.float32)
    tw, jw = torch.tensor(w), jnp.asarray(w)
    port = (
        lambda buckets: torch.einsum("scd,sde->sce", buckets, tw),
        lambda x, pred: trt.select_expert(torch.einsum("bd,sde->sbe", x, tw), pred),
    )
    jax_ = (
        lambda buckets: jnp.einsum("scd,sde->sce", buckets, jw),
        lambda x, pred: jrt.select_expert(jnp.einsum("bd,sde->sbe", x, jw), pred),
    )
    return port, jax_


CASES = {
    # name: (S, B, Din, D, pred rule, capacity factor, capacity, padded rows)
    "balanced": (8, 64, 12, 7, "balanced", 1.25, None, 0),
    "random": (7, 13, 3, 2, "random", 1.25, None, 0),
    "skewed": (8, 16, 5, 3, "one", 1.25, None, 0),
    "skewed-cap1": (8, 16, 5, 3, "one", 1.25, 1, 0),
    "out-of-range": (4, 8, 3, 2, "wild", 1.25, None, 0),
    "padded": (8, 24, 5, 3, "random", 1.25, None, 9),
    "padded-skewed": (3, 20, 4, 6, "one", 1.0, None, 5),
    "s1": (1, 9, 3, 2, "random", 1.25, None, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_dispatch_matches_jax(case):
    s, b, din, d, rule, f, cap, pad = CASES[case]
    rng = np.random.default_rng(len(case))
    (t_run, t_dense), (j_run, j_dense) = _toy(s, din, d, seed=s * 7 + b)
    x = rng.standard_normal((b + pad, din)).astype(np.float32)
    pred = {
        "balanced": np.arange(b + pad) % s,
        "random": rng.integers(0, s, b + pad),
        "one": np.full(b + pad, s - 1),
        "wild": rng.integers(-5, s + 5, b + pad),
    }[rule].astype(np.int32)
    valid = (np.arange(b + pad) < b) if pad else None
    out, ovf = trt.sparse_dispatch(
        t_run, t_dense, torch.tensor(x), torch.tensor(pred), s, f,
        valid=None if valid is None else torch.tensor(valid), capacity=cap,
    )
    jout, jovf = jrt.sparse_dispatch(
        j_run, j_dense, jnp.asarray(x), jnp.asarray(pred), s, f,
        valid=None if valid is None else jnp.asarray(valid), capacity=cap,
    )
    assert ovf == int(jovf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-6)
    # and it is the dense route on every valid row
    dense = t_dense(torch.tensor(x), torch.tensor(pred)).numpy()
    np.testing.assert_allclose(out.numpy()[:b], dense[:b], rtol=0, atol=1e-6)
    if rule == "one":
        assert ovf > 0  # skewed traffic overflowed and was served, not dropped
    if rule == "balanced":
        assert ovf == 0


def test_balanced_batch_runs_no_dense_pass():
    calls = []
    (t_run, t_dense), _ = _toy(4, 3, 2, seed=0)

    def counted(x, pred):
        calls.append(x.shape[0])
        return t_dense(x, pred)

    x = torch.randn(16, 3)
    _, ovf = trt.sparse_dispatch(t_run, counted, x, torch.arange(16) % 4, 4, 1.25)
    assert ovf == 0 and calls == []
    _, ovf = trt.sparse_dispatch(t_run, counted, x, torch.zeros(16, dtype=torch.long), 4, 1.25)
    assert ovf == 16 - trt.expert_capacity(16, 4, 1.25) and calls == [16]


def test_sparse_matches_dense_through_the_port_hdce():
    from qdml_tpu_torch.train.hdce import build_hdce

    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16, n_scenarios=6), model=tconfig.ModelConfig(features=8)
    )
    hdce = build_hdce(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(23, 2, 16, 8, generator=torch.Generator().manual_seed(1))
    pred = torch.tensor(np.random.default_rng(2).integers(0, 6, 23))

    def dense(xb, pb):
        return trt.select_expert(hdce(xb.expand(6, *xb.shape)), pb)

    with torch.no_grad():
        ref = dense(x, pred)
        for f in (0.5, 1.25, 4.0):
            out, _ = trt.sparse_dispatch(hdce, dense, x, pred, 6, f)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_sweep_sparse_dispatch_matches_dense():
    """The whole sweep on small random models: every curve and accuracy with
    ``dispatch="sparse"`` within rtol 1e-4 of dense (capacity 1.0, so the
    random classifier's skew exercises the overflow fallback too)."""
    import dataclasses

    from qdml_tpu_torch.eval import sweep
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.hdce import build_hdce

    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=4, n_layers=2),
        eval=tconfig.EvalConfig(snr_grid=(5.0, 15.0), test_len=32, batch_size=16),
    )
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, capacity_factor=1.0))
    gen = torch.Generator().manual_seed(3)
    models = sweep.SweepModels(
        build_hdce(cfg, "cpu", generator=gen),
        build_classifier(cfg, False, "cpu", generator=gen),
        build_classifier(cfg, True, "cpu", generator=gen),
    )
    dense = sweep.run_snr_sweep(cfg, models, device="cpu")
    sparse = sweep.run_snr_sweep(cfg, models, device="cpu", dispatch="sparse")
    assert set(sparse["nmse_db"]) == set(dense["nmse_db"])
    for k in dense["nmse_db"]:
        np.testing.assert_allclose(sparse["nmse_db"][k], dense["nmse_db"][k], rtol=1e-4, err_msg=k)
    assert sparse["acc"] == dense["acc"]
