"""The port's serving engine against the JAX engine's forward, on the CPU.

The same Flax weights (carried across by ``qdml_tpu_torch.interop``) and the
same requests go through the JAX ``ServeEngine._forward`` under ``jax.jit``
(without ``warmup()``, so no autotune race runs) and through the port's
``ServeEngine(device="cpu").infer``, whose batches pad to buckets and chunk
past the largest. Small size: features 8, n_ant 16 (head 512 wide), S=3.
``h`` and ``conf`` are held within ``1e-4 * max|h| + 1e-5``; ``pred`` must
agree on every row whose top-two log-prob margin exceeds 1e-4.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.config import ExperimentConfig as JConfig  # noqa: E402
from qdml_tpu.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402

BUCKETS = (1, 4, 8)


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    # serve.batching=auto races at warmup: its table goes under tmp_path
    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    yield
    batching_autotune.invalidate_cache()


def _configs(n_qubits, impl):
    j = JConfig()
    j = replace(
        j,
        data=replace(j.data, n_ant=16),
        model=replace(j.model, features=8),
        quantum=replace(j.quantum, n_qubits=n_qubits, n_layers=2, impl=impl),
        serve=replace(j.serve, buckets=BUCKETS),
    )
    t = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=n_qubits, n_layers=2, impl=impl),
        serve=tconfig.ServeConfig(buckets=BUCKETS),
    )
    return j, t


def _randomize(tree, rng):
    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(a.shape[-4:-1]) if a.ndim >= 4 else a.shape[-2]
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _engines(n_qubits, impl):
    jcfg, tcfg = _configs(n_qubits, impl)
    jeng = JServeEngine(jcfg, {}, {}, quantum=True)
    rng = np.random.default_rng(n_qubits)
    x0 = jnp.zeros((1, 16, 8, 2))
    hdce_vars = _randomize(
        jax.device_get(jeng.hdce.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, 16, 8, 2)))), rng
    )
    clf_vars = {"params": _randomize(jax.device_get(jeng.clf.init(jax.random.PRNGKey(1), x0))["params"], rng)}
    teng = ServeEngine(
        tcfg,
        interop.hdce_state_dict_from_flax(hdce_vars),
        interop.qsc_state_dict_from_flax(clf_vars["params"]),
        quantum=True,
        device="cpu",
    )
    return jeng, hdce_vars, clf_vars, teng


@pytest.mark.parametrize("n_qubits,impl", [(4, "pallas"), (7, "pallas_circuit")])
def test_port_engine_matches_jax_forward(n_qubits, impl):
    jeng, hdce_vars, clf_vars, teng = _engines(n_qubits, impl)
    warm = teng.warmup()
    assert warm["quantum_impl"] == {str(b): {"impl": impl} for b in BUCKETS}
    fwd = jax.jit(jeng._forward)
    rng = np.random.default_rng(100 + n_qubits)
    tk.reset_launch_counts()
    for n in (1, 5, 13):  # 13 > the largest bucket: served in two chunks
        x = rng.standard_normal((n, 16, 8, 2)).astype(np.float32)
        h_ref, pred_ref, conf_ref = (np.asarray(v) for v in fwd(hdce_vars, clf_vars, jnp.asarray(x)))
        logp = np.asarray(jeng.clf.apply(clf_vars, jnp.asarray(x)))
        h, pred, conf, info = teng.infer(x)
        assert h.shape == (n, 512) and pred.shape == (n,) and conf.shape == (n,)
        top2 = np.sort(logp, axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 1e-4
        np.testing.assert_array_equal(pred[sure], pred_ref[sure])
        same = pred == pred_ref
        tol = 1e-4 * np.abs(h_ref).max() + 1e-5
        np.testing.assert_allclose(h[same], h_ref[same], rtol=0, atol=tol)
        np.testing.assert_allclose(conf, conf_ref, rtol=0, atol=1e-5)
        assert info.n == n and info.chunks == (2 if n > 8 else 1)
        assert info.rows == (16 if n > 8 else {1: 1, 5: 8}[n])
    assert set(tk.launches.values()) == {0}  # CPU: plain versions


def test_classical_engine_routes_like_select_expert():
    _, tcfg = _configs(4, "dense")
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.ops.routing import select_expert
    from qdml_tpu_torch.train.hdce import build_hdce

    gen = torch.Generator().manual_seed(0)
    hdce = build_hdce(tcfg, device="cpu", generator=gen)
    clf = build_classifier(tcfg, False, device="cpu", generator=gen)
    eng = ServeEngine(tcfg, hdce.state_dict(), clf.state_dict(), device="cpu")
    with pytest.raises(RuntimeError, match="warmup"):
        eng.infer(np.zeros((1, 16, 8, 2), np.float32))
    eng.warmup()
    x = np.random.default_rng(3).standard_normal((6, 16, 8, 2)).astype(np.float32)
    h, pred, conf, info = eng.infer(x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        logp = clf(xt)
        est = hdce(xt.expand(3, *xt.shape))
    np.testing.assert_array_equal(pred, logp.argmax(-1).numpy())
    np.testing.assert_allclose(h, select_expert(est, logp.argmax(-1)).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(conf, logp.max(-1).values.exp().numpy(), rtol=1e-6)
    assert (info.bucket, info.rows, info.fill) == (8, 8, 0.75)
    with pytest.raises(ValueError, match="empty"):
        eng.infer(np.zeros((0, 16, 8, 2), np.float32))


def test_select_expert_clips_ids():
    from qdml_tpu_torch.ops.routing import select_expert

    stacked = torch.arange(3 * 4 * 2, dtype=torch.float32).reshape(3, 4, 2)
    got = select_expert(stacked, torch.tensor([0, 2, -1, 7]))
    want = torch.stack([stacked[0, 0], stacked[2, 1], stacked[0, 2], stacked[2, 3]])
    assert torch.equal(got, want)


def test_buckets_match_jax_helpers():
    from qdml_tpu.serve.batcher import pick_bucket as jpick
    from qdml_tpu.serve.batcher import power_of_two_buckets as jpow
    from qdml_tpu_torch.serve.batcher import pick_bucket, power_of_two_buckets

    for m in (1, 5, 64, 100):
        assert power_of_two_buckets(m) == jpow(m)
        for n in (1, 3, 64, 200):
            assert pick_bucket(n, power_of_two_buckets(m)) == jpick(n, jpow(m))
    with pytest.raises(ValueError):
        power_of_two_buckets(0)
