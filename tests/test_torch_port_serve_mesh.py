"""The port's mesh serving (``serve_mesh``, the engine over a ``LocalMesh``) against the JAX package's, on the CPU.

JAX serves over the 8 virtual CPU devices of ``tests/conftest.py``; the
port over a ``make_local_mesh`` of 8 logical positions on the CPU, each
holding its own copy of the weights. Small size: features 8, n_ant 16
(head 512 wide), S=3, buckets (1, 4, 8), the QSC at n=4, L=2, impl
``dense``, the same Flax weights on both sides through
``qdml_tpu_torch.interop``. The cases mirror ``tests/test_serve_sharded.py``:

- ``serve_mesh``: its resolution, its errors and their text, against JAX's
  (the port's multi-card branch with ``torch.cuda.device_count`` stubbed);
- ``bucket_sharding`` and ``mesh_topology`` equal to JAX's engine's;
- ``h`` and ``pred`` from ``infer`` against JAX's mesh engine's for
  ``data=4`` and for ``fed=3 x data=2`` with expert sharding, dense and
  forced sparse, bucket and ragged: routed scenarios equal where the top-two
  log-prob margin exceeds 1e-4, ``h`` within ``1e-4 * max|h| + 1e-5`` on
  rows routed alike (the serving tolerance of the port's other serving
  tests);
- NaN/Inf in the pad tail of the expert-sharded sparse ragged tier: the
  valid rows equal the clean forward's and JAX's, every row finite;
- a hot-swap under traffic through a 2-replica pool, no request-path work,
  answers following the new weights within 1e-5 of the single-device
  engine's; a mismatched state dict rejected;
- ``run_loadgen`` over a 2-replica pool on the ``data=4`` engine: the
  summary's ``mesh`` block and ``bucket_sharding`` equal to JAX's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.parallel.mesh import serve_mesh as jserve_mesh  # noqa: E402
from qdml_tpu.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.serve.loadgen import run_loadgen  # noqa: E402
from qdml_tpu_torch.serve.server import ReplicaPool  # noqa: E402
from qdml_tpu_torch.serve.types import Prediction  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

BUCKETS = (1, 4, 8)
HW = (16, 8)
ZERO = {"measure": 0, "table_write": 0, "kernel_build": 0}
WAIT = 30.0
# (fed, data) of the two layouts, and the serve knobs of each case
LAYOUTS = {"data4": (1, 4, {}), "fed3_data2": (3, 2, {"expert_sharding": True})}
MODES = {"dense_bucket": {"dispatch": "dense", "batching": "bucket"},
         "sparse_ragged": {"dispatch": "sparse", "batching": "ragged"}}


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    yield
    batching_autotune.invalidate_cache()


def _knobs(fed: int, data: int, **serve) -> tuple[dict, dict]:
    quantum = {"n_qubits": 4, "n_layers": 2, "impl": "dense"}
    mesh = {"fed_axis": fed, "data_axis": data, "model_axis": 1}
    return {"quantum": quantum, "mesh": mesh}, {"buckets": BUCKETS, "max_batch": 8, "max_queue": 64, **serve}


def _tcfg(fed=1, data=4, **serve):
    k, s = _knobs(fed, data, **serve)
    cfg = tconfig.ExperimentConfig(data=tconfig.DataConfig(n_ant=16), model=tconfig.ModelConfig(features=8))
    return dataclasses.replace(
        cfg,
        quantum=dataclasses.replace(cfg.quantum, **k["quantum"]),
        mesh=dataclasses.replace(cfg.mesh, **k["mesh"]),
        serve=dataclasses.replace(cfg.serve, **s),
    )


def _jcfg(fed=1, data=4, **serve):
    k, s = _knobs(fed, data, **serve)
    j = jconfig.ExperimentConfig()
    return dataclasses.replace(
        j,
        data=dataclasses.replace(j.data, n_ant=16),
        model=dataclasses.replace(j.model, features=8),
        quantum=dataclasses.replace(j.quantum, **k["quantum"]),
        mesh=dataclasses.replace(j.mesh, **k["mesh"]),
        serve=dataclasses.replace(j.serve, **s),
    )


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


def _flax_weights(seed=0):
    jeng = JServeEngine(_jcfg(shard="off"), {}, {}, quantum=True)
    rng = np.random.default_rng(seed)
    hdce_vars = _randomize(
        jax.device_get(jeng.hdce.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, *HW, 2)))), rng
    )
    clf_vars = {"params": _randomize(
        jax.device_get(jeng.clf.init(jax.random.PRNGKey(1), jnp.zeros((1, *HW, 2))))["params"], rng
    )}
    return hdce_vars, clf_vars


def _port_sd(hdce_vars, clf_vars):
    return interop.hdce_state_dict_from_flax(hdce_vars), interop.qsc_state_dict_from_flax(clf_vars["params"])


@pytest.fixture(scope="module")
def weights():
    return _flax_weights(0)


def _local_mesh(cfg):
    return tmesh.make_local_mesh(cfg.mesh, [torch.device("cpu")] * 8)


def _port_engine(cfg, weights):
    eng = ServeEngine(cfg, *_port_sd(*weights), quantum=True, mesh=_local_mesh(cfg))
    return eng, eng.warmup()


def _jax_engine(jcfg, weights):
    mesh = jserve_mesh(jcfg)
    assert mesh is not None
    eng = JServeEngine(jcfg, *weights, quantum=True, mesh=mesh)
    return eng, eng.warmup()


@pytest.fixture(scope="module")
def pairs(weights):
    """Per (layout, mode): the port's warmed mesh engine and JAX's, lazily
    (each JAX bucket is an XLA compile)."""
    cache = {}

    def get(layout, mode):
        if (layout, mode) not in cache:
            fed, data, extra = LAYOUTS[layout]
            knobs = {**extra, **MODES[mode]}
            cache[layout, mode] = (_port_engine(_tcfg(fed, data, **knobs), weights),
                                   _jax_engine(_jcfg(fed, data, **knobs), weights))
        return cache[layout, mode]

    return get


def _requests(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, *HW, 2)).astype(np.float32)


def _close_where_routes_agree(h, pred, h_ref, pred_ref, logp):
    top2 = np.sort(logp, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(pred[sure], pred_ref[sure])
    same = pred == pred_ref
    tol = 1e-4 * np.abs(h_ref).max() + 1e-5
    np.testing.assert_allclose(h[same], h_ref[same], rtol=0, atol=tol)
    return int(same.sum())


# ---------------------------------------------------------------------------
# serve_mesh
# ---------------------------------------------------------------------------


def _visible(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_serve_mesh_lays_out_every_visible_card(monkeypatch):
    _visible(monkeypatch, 8)
    mesh = tmesh.serve_mesh(_tcfg(), "cuda")
    jmesh = jserve_mesh(_jcfg())
    assert mesh.shape == dict(jmesh.shape) == {"fed": 1, "data": 4, "model": 1}
    assert [d.index for d in mesh.devices.flat] == [d.id for d in jmesh.devices.flat] == [0, 1, 2, 3]
    auto = tmesh.serve_mesh(_tcfg(data=-1))
    assert auto.shape == dict(jserve_mesh(_jcfg(data=-1)).shape) == {"fed": 1, "data": 8, "model": 1}
    exp = tmesh.serve_mesh(_tcfg(fed=3, data=2, expert_sharding=True))
    assert exp.devices.shape == (3, 2, 1) and len(set(exp.devices.flat)) == 6


def test_serve_mesh_one_device_and_off_return_none(monkeypatch, capsys):
    _visible(monkeypatch, 8)
    assert tmesh.serve_mesh(_tcfg(shard="off")) is None and jserve_mesh(_jcfg(shard="off")) is None
    # the CPU, or a card named by index, is one device: unsharded, as JAX on one device
    assert tmesh.serve_mesh(_tcfg(), "cpu") is None
    assert tmesh.serve_mesh(_tcfg(), "cuda:1") is None
    _visible(monkeypatch, 1)
    assert tmesh.serve_mesh(_tcfg(fed=3, data=2, expert_sharding=True)) is None
    assert "experts unsharded" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["bad_shard", "off_with_experts", "fed_not_scenarios", "experts_fed_1", "too_many"])
def test_serve_mesh_errors_match_jax(monkeypatch, case):
    _visible(monkeypatch, 8)
    knobs = {
        "bad_shard": ({}, {"shard": "maybe"}),
        "off_with_experts": ({}, {"shard": "off", "expert_sharding": True}),
        "fed_not_scenarios": ({"fed": 2, "data": 4}, {"expert_sharding": True}),
        "experts_fed_1": ({"fed": 1, "data": 4}, {"expert_sharding": True}),
        "too_many": ({"fed": 3, "data": 4}, {}),
    }[case]
    with pytest.raises(ValueError) as jerr:
        jserve_mesh(_jcfg(**knobs[0], **knobs[1]))
    with pytest.raises(ValueError) as terr:
        tmesh.serve_mesh(_tcfg(**knobs[0], **knobs[1]))
    assert str(terr.value) == str(jerr.value)


def test_serve_mesh_under_a_world_of_ranks_raises(monkeypatch):
    _visible(monkeypatch, 8)
    monkeypatch.setattr(tmesh, "world_size", lambda: 4)
    with pytest.raises(NotImplementedError, match="one process serves over the cards it sees"):
        tmesh.serve_mesh(_tcfg())
    assert tmesh.serve_mesh(_tcfg(shard="off")) is None


def test_make_local_mesh_repeats_a_device_only_when_asked():
    mesh = tmesh.make_local_mesh(tconfig.MeshConfig(fed_axis=3, data_axis=2), [torch.device("cpu")] * 8)
    assert mesh.shape == {"fed": 3, "data": 2, "model": 1} and mesh.size == 6
    assert mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="needs 12 devices, have 8"):
        tmesh.make_local_mesh(tconfig.MeshConfig(fed_axis=3, data_axis=4), [torch.device("cpu")] * 8)


def test_engine_rejects_expert_sharding_off_the_scenario_count(weights):
    cfg = _tcfg(fed=1, data=4, expert_sharding=True)
    with pytest.raises(ValueError, match="mesh.fed_axis == data.n_scenarios"):
        ServeEngine(cfg, *_port_sd(*weights), quantum=True, mesh=_local_mesh(cfg))


# ---------------------------------------------------------------------------
# the engine on the mesh against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharding_and_topology_match_jax(pairs, layout, mode):
    (eng, warm), (jeng, jwarm) = pairs(layout, mode)
    assert eng.bucket_sharding == jeng.bucket_sharding == {"1": "replicated", "4": "data", "8": "data"}
    assert warm["sharding"] == jwarm["sharding"]
    assert eng.mesh_topology() == jeng.mesh_topology() == warm["mesh"] == jwarm["mesh"]
    assert warm["dispatch"]["mode"] == jwarm["dispatch"]["mode"]
    assert warm["batching"]["mode"] == jwarm["batching"]["mode"]
    d = LAYOUTS[layout][1]
    assert {b: r["slice_batch"] for b, r in warm["quantum_impl"].items()} == {"1": 1, "4": 4 // d, "8": 8 // d}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_infer_matches_jax_mesh_engine(pairs, weights, layout, mode):
    (eng, _), (jeng, _) = pairs(layout, mode)
    x = _requests(13, seed=7)
    logp = np.asarray(jeng.clf.apply(weights[1], jnp.asarray(x)))
    agreed = 0
    for n in (1, 3, 4, 5, 8, 13):  # 13: two chunks, the last in bucket 8
        h, pred, conf, info = eng.infer(x[:n])
        hj, pj, cj, infoj = jeng.infer(x[:n])
        assert h.shape == (n, eng.cfg.h_out_dim) and np.isfinite(h).all() and np.isfinite(conf).all()
        assert (info.bucket, info.rows, info.chunks, info.mode) == (infoj.bucket, infoj.rows, infoj.chunks,
                                                                      infoj.mode)
        agreed += _close_where_routes_agree(h, pred, np.asarray(hj), np.asarray(pj), logp[:n])
        np.testing.assert_allclose(conf, cj, rtol=0, atol=1e-5)
    assert agreed >= 34 - 2
    assert eng.request_path_work() == ZERO


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_engine_matches_the_single_device_engine(weights, layout):
    """Each layout's slices and gathers change nothing: against the port's own
    single-device engine within 1e-5, routes equal."""
    fed, data, extra = LAYOUTS[layout]
    eng, _ = _port_engine(_tcfg(fed, data, batching="bucket", **extra), weights)
    one = ServeEngine(_tcfg(batching="bucket"), *_port_sd(*weights), quantum=True, device="cpu")
    one.warmup()
    x = _requests(8, seed=3)
    for n in (1, 4, 6, 8):
        h, pred, conf, _ = eng.infer(x[:n])
        h1, p1, c1, _ = one.infer(x[:n])
        np.testing.assert_array_equal(pred, p1)
        np.testing.assert_allclose(h, h1, rtol=0, atol=1e-5)


def test_expert_sharded_positions_hold_one_trunk_and_the_head(pairs):
    (eng, _), _ = pairs("fed3_data2", "dense_bucket")
    live = eng._live_all()
    assert len(live.slices) == 2
    hdce_sd = live.hdce.state_dict()
    for d, (clf_d, line) in enumerate(live.slices):
        assert [dev for dev, _ in line.experts] == [eng.mesh.device(s, d, 0) for s in range(3)]
        for s, (_, expert) in enumerate(line.experts):
            sd = expert.state_dict()
            assert {k.split(".")[0] for k in sd} == {"trunks", "head"} and not any(k.startswith("trunks.1") for k in sd)
            for k, v in sd.items():
                src = k.replace("trunks.0.", f"trunks.{s}.")
                assert torch.equal(v, hdce_sd[src]) and v.data_ptr() != hdce_sd[src].data_ptr()
        assert d == 0 or clf_d is not live.clf  # each position its own copy


def test_ragged_sparse_expert_pad_tail_never_leaks(pairs):
    (eng, _), (jeng, _) = pairs("fed3_data2", "sparse_ragged")
    x = _requests(8, seed=11)
    xz = np.zeros((8, *HW, 2), np.float32)
    xz[:3] = x[:3]
    clean = eng.forward_tier(xz, 3)[0][:3].numpy()  # the same tier, zero pads
    xp = np.full((8, *HW, 2), np.nan, np.float32)
    xp[6] = np.inf
    xp[:3] = x[:3]
    h, pred, conf, overflow = eng.forward_tier(xp, 3)
    h = h.numpy()
    assert np.isfinite(h).all() and torch.isfinite(conf).all()
    np.testing.assert_array_equal(h[:3], clean)
    out = jeng._compiled[8](*jeng.live_vars(), xp, np.int32(3))
    hj = np.asarray(jax.device_get(out[0]))
    np.testing.assert_allclose(h[:3], hj[:3], rtol=0, atol=1e-4 * np.abs(hj[:3]).max() + 1e-5)
    assert eng.request_path_work() == ZERO


# ---------------------------------------------------------------------------
# hot-swap and the replica pool on the mesh
# ---------------------------------------------------------------------------


def test_hot_swap_under_traffic_does_no_request_path_work(weights):
    cfg = _tcfg(batching="bucket")
    old_sd, new_sd = _port_sd(*weights), _port_sd(*_flax_weights(5))
    eng = ServeEngine(cfg, *old_sd, quantum=True, mesh=_local_mesh(cfg))
    eng.warmup()
    ref_old = ServeEngine(cfg, *old_sd, quantum=True, device="cpu").offline_forward(_requests(16, 2))[0]
    ref_new = ServeEngine(cfg, *new_sd, quantum=True, device="cpu").offline_forward(_requests(16, 2))[0]
    x = _requests(16, 2)
    pool = ReplicaPool(eng, replicas=2).start()
    try:
        pre = [f.result(timeout=WAIT) for f in [pool.submit(x[i], rid=i) for i in range(12)]]
        rec = eng.swap_params(*new_sd)
        post = [f.result(timeout=WAIT) for f in [pool.submit(x[i], rid=100 + i) for i in range(12)]]
    finally:
        pool.stop()
    assert rec["epoch"] == 1 and rec["work"] == ZERO and eng.swap_epoch == 1
    assert all(isinstance(r, Prediction) for r in pre + post)
    for r in pre:
        np.testing.assert_allclose(r.h, ref_old[r.rid], rtol=0, atol=1e-5)
    for r in post:
        np.testing.assert_allclose(r.h, ref_new[r.rid - 100], rtol=0, atol=1e-5)
    # every position took the new weights
    new_clf = new_sd[1]
    for clf_d, hdce_d in eng._live_all().slices:
        for k, v in clf_d.state_dict().items():
            assert torch.equal(v, new_clf[k])
        for k, v in hdce_d.state_dict().items():
            assert torch.equal(v, new_sd[0][k])
    assert eng.request_path_work() == ZERO


def test_swap_rejects_a_mismatched_state_dict(pairs):
    (eng, _), _ = pairs("data4", "dense_bucket")
    x = _requests(4, seed=9)
    before = eng.infer(x)[0]
    wrong_cfg = dataclasses.replace(_tcfg(), model=tconfig.ModelConfig(features=16))
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.hdce import build_hdce

    wrong = (build_hdce(wrong_cfg, "cpu").state_dict(), build_classifier(wrong_cfg, True, "cpu").state_dict())
    with pytest.raises(ValueError, match="hot-swap"):
        eng.swap_params(*wrong)
    np.testing.assert_array_equal(eng.infer(x)[0], before)


def test_multi_replica_loadgen_summary_carries_the_mesh(weights):
    cfg = _tcfg(batching="bucket", replicas=2)
    eng = ServeEngine(cfg, *_port_sd(*weights), quantum=True, mesh=_local_mesh(cfg))
    sm = run_loadgen(cfg, eng, rate=2000.0, n=48, deadline_ms=30000.0)
    jeng = JServeEngine(_jcfg(batching="bucket", replicas=2), *weights, quantum=True, mesh=jserve_mesh(_jcfg()))
    assert sm["completed"] == 48 and sm["n_shed"] == 0 and sm["stranded_futures"] == 0
    assert sm["compile_cache_after_warmup"] == ZERO
    assert sm["parity_max_abs_err"] < 1e-4
    assert sm["replicas"] == 2 and sm["workers"] == 2
    assert sm["mesh"] == jeng.mesh_topology() == {
        "devices": 4, "axes": {"fed": 1, "data": 4, "model": 1}, "expert_sharding": False,
    }
    assert sm["bucket_sharding"] == {"1": "replicated", "4": "data", "8": "data"}
    assert sm["warmup"]["sharding"] == sm["bucket_sharding"] and sm["warmup"]["mesh"] == sm["mesh"]
    assert sum(sm["server_metrics"]["replica_completed"]) == 48
