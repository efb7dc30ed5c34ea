"""The port's control plane (``qdml_tpu_torch.control``) against the JAX package's, on the CPU.

Held against ``qdml_tpu.control``:

- ``ControlConfig``: every field and default, and the ``--control.*`` flags;
- ``PageHinkley``, ``DriftMonitor`` and ``Autoscaler`` step for step on the
  same scripted streams: every return, record and state, exactly (pure host
  arithmetic in float64 on both sides); ``counter_delta`` likewise;
- the fine-tune step: the port's one-trunk model with Adam on the trunk
  alone against JAX's 1-scenario HDCE under ``optax.multi_transform`` (the
  head ``set_to_zero``), built as ``finetune_trunk`` builds it, on the same
  numpy batches: 4 steps of losses within rtol 1e-5 (JAX's own HDCE
  tolerance in the port's tests);
- the reassembly: the head and the other trunks of ``hdce_last`` bit for bit
  the base's (float32 compared as int32 bits), the very tensors before the
  save; the fine-tuned trunk moved;
- ``_served_nmse_db`` on the same numpy probes and the same Flax weights,
  within 1e-3 dB;
- the ``Deployer``'s watch: rollback and confirmation records equal to
  JAX's on a scripted watch; its canary on the CPU passes a relaxed gate and
  fails an impossible one;
- ``FleetController.tick``: the events of every tick equal to JAX's on the
  same scripted metric payloads (dry run, autoscaling, overflow, a counter
  reset);
- the in-process adapt pipeline on a tiny port engine (as
  ``tests/test_control.py:629``): finetune -> canary -> explicit-tag swap
  with no request-path work -> watch -> confirm;
- JAX's dry-run ``FleetController`` over its ``SocketPoller`` against the
  port's serve endpoint decides as it does against JAX's, on the same
  traffic; the port's ``control`` command prints JAX's header line and
  exits 0. One socket server runs at a time, each on an ephemeral port.
"""

import asyncio
import dataclasses
import json
import threading
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.control import autoscale as jautoscale  # noqa: E402
from qdml_tpu.control import deploy as jdeploy  # noqa: E402
from qdml_tpu.control import drift as jdrift  # noqa: E402
from qdml_tpu.control import loop as jloop  # noqa: E402
from qdml_tpu.telemetry.timeseries import counter_delta as jcounter_delta  # noqa: E402
from qdml_tpu_torch import cli  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.control import autoscale as tautoscale  # noqa: E402
from qdml_tpu_torch.control import deploy as tdeploy  # noqa: E402
from qdml_tpu_torch.control import drift as tdrift  # noqa: E402
from qdml_tpu_torch.control import finetune as tfinetune  # noqa: E402
from qdml_tpu_torch.control import loop as tloop  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.serve.server import ReplicaPool  # noqa: E402
from qdml_tpu_torch.serve.types import Prediction  # noqa: E402
from qdml_tpu_torch.train.checkpoint import restore_params, save_checkpoint  # noqa: E402
from qdml_tpu_torch.train.hdce import hdce_train_step  # noqa: E402
from qdml_tpu_torch.train.torch_interop import qsc_meta_from_state  # noqa: E402

HW = (16, 8)
ZERO = {"measure": 0, "table_write": 0, "kernel_build": 0}
WAIT = 30.0


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    yield
    batching_autotune.invalidate_cache()


def _control(**kw):
    base = {"ft_steps": 4, "ft_batch": 16, "probe_n": 12, "min_window": 4, "interval_s": 0.01, "watch_ticks": 2}
    return {**base, **kw}


def _tcfg(quantum=False, **control):
    cfg = tconfig.ExperimentConfig(
        name="control_test",
        data=tconfig.DataConfig(n_ant=16, data_len=96),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=4, n_layers=2, impl="dense"),
        train=tconfig.TrainConfig(batch_size=16, n_epochs=1),
        serve=tconfig.ServeConfig(max_batch=8, buckets=(1, 4, 8), max_wait_ms=1.0, max_queue=64, batching="bucket"),
    )
    return dataclasses.replace(cfg, control=tconfig.ControlConfig(**_control(**control)))


def _jcfg(**control):
    j = jconfig.ExperimentConfig()
    return dataclasses.replace(
        j,
        name="control_test",
        data=dataclasses.replace(j.data, n_ant=16, data_len=96),
        model=dataclasses.replace(j.model, features=8),
        quantum=dataclasses.replace(j.quantum, n_qubits=4, n_layers=2, impl="dense"),
        train=dataclasses.replace(j.train, batch_size=16, n_epochs=1),
        serve=dataclasses.replace(j.serve, max_batch=8, buckets=(1, 4, 8), max_wait_ms=1.0, max_queue=64,
                                  batching="bucket"),
        control=jconfig.ControlConfig(**_control(**control)),
    )


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------


def test_control_config_matches_jax_field_for_field():
    t, j = tconfig.ControlConfig(), jconfig.ControlConfig()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert f.type == next(g.type for g in dataclasses.fields(j) if g.name == f.name), f.name
    assert tconfig.ExperimentConfig().control == t
    flags = ["--control.dry_run=true", "--control.ft_steps=300", "--control.min_gain_db=0.3",
             "--control.autoscale=false", "--control.queue_high=8.5", "--control.fleet_debounce=3"]
    got, want = tconfig.from_args(flags).control, jconfig.from_args(flags).control
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dry_run is True and got.autoscale is False and got.ft_steps == 300


# ---------------------------------------------------------------------------
# detectors, autoscaler, counters: step for step
# ---------------------------------------------------------------------------


def _stream(seed, n=300):
    rng = np.random.default_rng(seed)
    base = np.where(np.arange(n) < n // 2, 0.9, 0.7) + 0.01 * rng.standard_normal(n)
    return [float(v) for v in base] + [float(v) for v in 0.02 + 0.005 * rng.standard_normal(40)]


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("knobs", [{}, {"delta": 0.0, "threshold": 0.05, "min_samples": 1}, {"delta": 0.02}])
def test_page_hinkley_step_for_step(direction, knobs):
    for seed in range(3):
        t, j = tdrift.PageHinkley(direction=direction, **knobs), jdrift.PageHinkley(direction=direction, **knobs)
        for i, v in enumerate(_stream(seed)):
            assert t.update(v) == j.update(v), (seed, i)
            assert (t.n, t.mean, t.cum) == (j.n, j.mean, j.cum), (seed, i)
            if i == 200:
                t.reset()
                j.reset()
    for bad in ({"direction": "sideways"}, {"delta": -1.0}, {"threshold": 0.0}):
        with pytest.raises(ValueError) as te:
            tdrift.PageHinkley(**bad)
        with pytest.raises(ValueError) as je:
            jdrift.PageHinkley(**bad)
        assert str(te.value) == str(je.value)


def _drift_script(seed):
    """(scenario, signal, value) observations with drops, rises and resets."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(120):
        for s in range(3):
            conf = 0.9 - (0.35 if s == 1 and t > 40 else 0.0) + 0.01 * rng.standard_normal()
            out.append((s, "confidence", float(conf)))
        db = -12.0 + (4.0 if t > 70 else 0.0) + 0.1 * rng.standard_normal()
        out.append((0, "nmse_parity", float(db)))
        out.append((-1, "overflow_rate", float(0.02 + (0.3 if t > 90 else 0.0) + 0.005 * rng.standard_normal())))
        if t in (60, 100):
            out.append(("reset", 1 if t == 60 else None, None))
    return out


@pytest.mark.parametrize("debounce", [1, 2, 4])
def test_drift_monitor_step_for_step(debounce):
    for seed in range(2):
        t, j = tdrift.DriftMonitor(debounce=debounce), jdrift.DriftMonitor(debounce=debounce)
        fired = 0
        for obs in _drift_script(seed):
            if obs[0] == "reset":
                t.reset(obs[1])
                j.reset(obs[1])
                continue
            got, want = t.observe(*obs), j.observe(*obs)
            assert got == want, obs
            fired += got is not None
            assert t.active() == j.active()
        assert t.state() == j.state() and fired >= 3
    assert tdrift.DB_SCALE == jdrift.DB_SCALE and tdrift.SIGNALS == jdrift.SIGNALS
    with pytest.raises(ValueError, match="unknown drift signal"):
        tdrift.DriftMonitor().observe(0, "confidance", 0.5)


def _recording_scale(calls):
    def scale(n):
        calls.append(n)
        return {"replicas_before": n - 1, "replicas": n}

    return scale


@pytest.mark.parametrize("dry_run", [False, True])
def test_autoscaler_step_for_step(dry_run):
    rng = np.random.default_rng(5)
    kw = dict(min_replicas=1, max_replicas=3, queue_high=8.0, queue_low=1.0, debounce=2, cooldown_ticks=2,
              dry_run=dry_run)
    tc, jc = [], []
    t = tautoscale.Autoscaler(_recording_scale(tc), **kw)
    j = jautoscale.Autoscaler(_recording_scale(jc), **kw)
    replicas = 1
    actions = 0
    for i in range(200):
        depth = float(rng.choice([0.0, 0.5, 4.0, 12.0, 30.0]))
        slo = None if i % 3 else float(rng.choice([0.95, 1.0]))
        got, want = t.observe(depth, replicas, slo), j.observe(depth, replicas, slo)
        assert got == want, i
        assert t.state() == j.state()
        if got and not dry_run:
            replicas = got["replicas"]
        actions += got is not None
    assert tc == jc and actions >= 5
    for bad in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2}, {"queue_low": 9.0, "queue_high": 8.0}):
        with pytest.raises(ValueError) as te:
            tautoscale.Autoscaler(lambda n: n, **bad)
        with pytest.raises(ValueError) as je:
            jautoscale.Autoscaler(lambda n: n, **bad)
        assert str(te.value) == str(je.value)


def test_counter_delta_matches_jax():
    for prev, cur in ((None, None), (None, 5), (3, 7), (7, 3), (2.5, 2.5), (0, 0.0), (10, None)):
        assert tloop.counter_delta(prev, cur) == jcounter_delta(prev, cur)


# ---------------------------------------------------------------------------
# fine-tune: the step against JAX's, the reassembly, the record
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_hdce():
    """A 3-scenario Flax HDCE at the test config (JAX's seeded init) and its
    port state dict."""
    from qdml_tpu.train.hdce import init_hdce_state

    _, st = init_hdce_state(_jcfg(), 4)
    hdce_vars = jax.device_get({"params": st.params, "batch_stats": st.batch_stats})
    return hdce_vars, interop.hdce_state_dict_from_flax(hdce_vars)


def test_finetune_step_matches_jax_masked_step(jax_hdce):
    import optax

    from qdml_tpu.control.finetune import _slice_scenario, _subtree_keys
    from qdml_tpu.models.cnn import activation_dtype
    from qdml_tpu.train.hdce import HDCE as JHDCE
    from qdml_tpu.train.hdce import make_hdce_train_step
    from qdml_tpu.train.state import TrainState

    hdce_vars, base_sd = jax_hdce
    cfg, jcfg, s, lr = _tcfg(), _jcfg(), 2, 1e-3
    # JAX's side, as qdml_tpu/control/finetune.py builds it
    trunk_key, head_key = _subtree_keys(hdce_vars["params"])
    jmodel = JHDCE(n_scenarios=1, features=8, out_dim=jcfg.h_out_dim, dtype=activation_dtype("float32"),
                   bn_momentum=0.9**jcfg.data.n_users, conv_impl=jcfg.model.conv_impl)
    params = {trunk_key: _slice_scenario(hdce_vars["params"][trunk_key], s),
              head_key: jax.tree.map(np.asarray, hdce_vars["params"][head_key])}
    labels = {trunk_key: jax.tree.map(lambda _: "train", params[trunk_key]),
              head_key: jax.tree.map(lambda _: "freeze", params[head_key])}
    tx = optax.multi_transform({"train": optax.adam(lr), "freeze": optax.set_to_zero()}, labels)
    state = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx,
                              batch_stats={trunk_key: _slice_scenario(hdce_vars["batch_stats"][trunk_key], s)})
    jstep = make_hdce_train_step(jmodel, tx, probes=False)
    # the port's
    model = tfinetune.one_trunk_model(cfg, base_sd, s, "cpu")
    opt = tfinetune.trunk_optimizer(model, lr)
    head0 = {k: v.clone() for k, v in model.head.state_dict().items()}
    rng = np.random.default_rng(4)
    got, want = [], []
    for _ in range(4):
        batch = {
            "yp_img": rng.standard_normal((1, 3, 16, *HW, 2)).astype(np.float32),
            "h_label": rng.standard_normal((1, 3, 16, cfg.h_out_dim)).astype(np.float32),
            "h_perf": rng.standard_normal((1, 3, 16, cfg.h_out_dim)).astype(np.float32),
        }
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(m["loss"]))
        got.append(float(hdce_train_step(model, opt, {k: torch.from_numpy(v) for k, v in batch.items()})["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(got)) == 4  # the trunk moved every step
    # the head took no gradient and no update in the port; JAX's neither
    for k, v in model.head.state_dict().items():
        assert torch.equal(v, head0[k]) and model.head.FC.weight.grad is None
    for a, b in zip(jax.tree.leaves(state.params[head_key]), jax.tree.leaves(params[head_key])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.fixture()
def workdir(tmp_path, jax_hdce):
    """A workdir with ``hdce_best`` (the Flax init through the interop
    mapping) and an SC classifier, tiny config."""
    from qdml_tpu_torch.models.qsc import build_classifier

    wd = str(tmp_path / "wd")
    save_checkpoint(wd, "hdce_best", {"params": jax_hdce[1]}, {"epoch": 0, "name": "control_test"})
    clf = build_classifier(_tcfg(), False, "cpu", generator=torch.Generator().manual_seed(3)).state_dict()
    save_checkpoint(wd, "sc_best", {"params": clf}, {"epoch": 0})
    return wd


def test_finetune_reassembles_head_and_peers_bit_identically(workdir):
    base = restore_params(workdir, "hdce_best")[0]["params"]
    rec = tfinetune.finetune_trunk(_tcfg(), workdir, scenario=1, drift_step=3, device="cpu")
    assert rec["tag"] == "hdce_last" and rec["rollback_tag"] == "hdce_best" and rec["base_tag"] == "hdce_best"
    assert np.isfinite(rec["loss_last"]) and rec["steps"] == 4
    assert set(rec) == {"tag", "rollback_tag", "base_tag", "scenario", "drift_step", "steps", "lr", "loss_first",
                        "loss_last", "val_nmse_db_before", "val_nmse_db_after"}
    new, meta = restore_params(workdir, "hdce_last")
    new = new["params"]
    assert set(new) == set(base)
    moved = 0
    for k, v in base.items():
        if k.startswith("trunks.1."):
            moved += not torch.equal(_bits(new[k]), _bits(v))
        else:
            assert torch.equal(_bits(new[k]), _bits(v)), k
    assert moved > 0
    assert meta["finetune"] == {k: rec[k] for k in ("scenario", "drift_step", "steps", "lr", "base_tag",
                                                   "val_nmse_db_before", "val_nmse_db_after")}
    assert meta["epoch"] == 0 and meta["name"] == "control_test"
    # a second episode warm-starts from hdce_last: hdce_prev keeps its source
    rec2 = tfinetune.finetune_trunk(_tcfg(), workdir, scenario=0, drift_step=3, base_tag="hdce_last", device="cpu")
    assert rec2["rollback_tag"] == "hdce_prev"
    prev = restore_params(workdir, "hdce_prev")[0]["params"]
    assert all(torch.equal(_bits(prev[k]), _bits(new[k])) for k in new)


def test_reassembly_takes_the_base_tensors_themselves(jax_hdce):
    base_sd = jax_hdce[1]
    model = tfinetune.one_trunk_model(_tcfg(), base_sd, 2, "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)  # the head too: reassembly must not read it
    out = tfinetune.reassemble(base_sd, model, 2)
    trunk = model.trunks.state_dict()
    for k, v in base_sd.items():
        if k.startswith("trunks.2."):
            assert out[k] is not v and torch.equal(out[k], trunk[k.replace("trunks.2.", "0.")]), k
        else:
            assert out[k] is v, k
    assert not torch.equal(out["trunks.2.cnn.0.weight"], base_sd["trunks.2.cnn.0.weight"])


def test_finetune_validates_inputs_as_jax(workdir):
    from qdml_tpu.control.finetune import finetune_trunk as jfinetune

    for kw in ({"scenario": 7, "drift_step": 1}, {"scenario": 0, "drift_step": 0}):
        with pytest.raises(ValueError) as te:
            tfinetune.finetune_trunk(_tcfg(), workdir, device="cpu", **kw)
        with pytest.raises(ValueError) as je:
            jfinetune(_jcfg(), workdir, **kw)
        assert str(te.value) == str(je.value)
    with pytest.raises(FileNotFoundError):
        tfinetune.finetune_trunk(_tcfg(), str(workdir) + "_none", scenario=0, drift_step=1, device="cpu")


# ---------------------------------------------------------------------------
# the canary's scorer and probes, the deployer's watch
# ---------------------------------------------------------------------------


def _flax_qsc(seed=0):
    from qdml_tpu.serve.engine import ServeEngine as JServeEngine

    jeng = JServeEngine(_jcfg(), {}, {}, quantum=True)
    params = jax.device_get(jeng.clf.init(jax.random.PRNGKey(seed), jnp.zeros((1, *HW, 2))))["params"]
    return {"params": params}


def test_served_nmse_db_matches_jax_on_the_same_probes(jax_hdce):
    hdce_vars, hdce_sd = jax_hdce
    clf_vars = _flax_qsc(1)
    clf_sd = interop.qsc_state_dict_from_flax(clf_vars["params"])
    for s, step in ((0, 0), (1, 3)):
        probes = tdeploy.probe_batch(_tcfg(), s, 24, drift_step=step)
        assert probes["x"].shape == (24, *HW, 2) and probes["h_perf"].shape == (24, _tcfg().h_out_dim)
        got = tdeploy._served_nmse_db(_tcfg(True), hdce_sd, clf_sd, True, probes, device="cpu")
        want = jdeploy._served_nmse_db(_jcfg(), hdce_vars, clf_vars, True, probes)
        assert abs(got - want) <= 1e-3, (s, got, want)


def test_probe_batch_draws_the_drifted_family_reproducibly():
    cfg = _tcfg()
    a, b = tdeploy.probe_batch(cfg, 1, 12, drift_step=3), tdeploy.probe_batch(cfg, 1, 12, drift_step=3)
    flat = tdeploy.probe_batch(cfg, 1, 12)
    np.testing.assert_array_equal(a["x"], b["x"])
    assert not np.array_equal(a["h_perf"], flat["h_perf"])
    assert not np.array_equal(tdeploy.probe_batch(cfg, 0, 12)["h_perf"], flat["h_perf"])


def _fake_swap(calls):
    def swap(tags):
        calls.append(dict(tags))
        return {"epoch": len(calls), "work": ZERO, "tags": dict(tags)}

    return swap


def _run_watch(deploy_mod, cfg):
    calls: list = []
    dep = deploy_mod.Deployer(cfg, "unused_wd", swap_fn=_fake_swap(calls))
    recs = [dep.observe_served(-10.0)]
    recs.append(dep.deploy({"hdce": "hdce_last"}, {"hdce": "hdce_best"}, ref_db=-12.0))
    recs.append(dep.watching())
    recs.append(dep.observe_served(-10.5))  # regressed > rollback_db: rollback
    recs.append(dep.watching())
    recs.append(dep.deploy({"hdce": "hdce_last"}, {"hdce": "hdce_best"}, ref_db=-12.0))
    recs.append(dep.observe_served(-12.1))
    recs.append(dep.observe_served(None))  # a tick without a measurement still counts
    recs.append(dep.live_hdce_tag())
    dry = deploy_mod.Deployer(cfg, "unused_wd", swap_fn=_fake_swap(calls), dry_run=True)
    recs.append(dry.deploy({"hdce": "x"}, {"hdce": "y"}))
    recs.append(dry.watching())
    return recs, calls


def test_deployer_watch_rollback_and_confirm_match_jax():
    got, tcalls = _run_watch(tdeploy, _tcfg(watch_ticks=2, rollback_db=1.0))
    want, jcalls = _run_watch(jdeploy, _jcfg(watch_ticks=2, rollback_db=1.0))
    assert got == want and tcalls == jcalls
    assert [r["action"] for r in (got[3], got[7], got[9])] == ["rollback", "deploy_confirmed", "deploy"]
    assert tcalls == [{"hdce": "hdce_last"}, {"hdce": "hdce_best"}, {"hdce": "hdce_last"}]


def test_deployer_canary_gates_on_probe_sets(workdir):
    rec = tfinetune.finetune_trunk(_tcfg(), workdir, scenario=1, drift_step=3, device="cpu")
    live = restore_params(workdir, "hdce_best")[0]["params"]
    clf = restore_params(workdir, "sc_best")[0]["params"]
    calls: list = []
    relaxed = tdeploy.Deployer(_tcfg(min_gain_db=-50.0, tol_db=50.0), workdir, swap_fn=_fake_swap(calls),
                               live_hdce_vars=live, clf_vars=clf, device="cpu")
    rep = relaxed.canary(rec["tag"], scenario=1, drift_step=3)
    assert rep["passed"] is True and calls == [] and set(rep["base_probes"]) == {"0", "1", "2"}
    assert rep["action"] == "canary" and rep["drifted_probes"]["live_db"] is not None
    strict = tdeploy.Deployer(_tcfg(min_gain_db=1e9), workdir, swap_fn=_fake_swap(calls), device="cpu")
    rep2 = strict.canary(rec["tag"], scenario=1, drift_step=3)  # live from the workdir's newest tags
    assert rep2["passed"] is False and calls == []
    # the same probes and weights score the same on both deployers
    assert rep2["drifted_probes"] == rep["drifted_probes"]


# ---------------------------------------------------------------------------
# the controller's decisions against JAX's
# ---------------------------------------------------------------------------


class _FakePoller:
    def __init__(self, snapshots):
        self.snapshots = list(snapshots)
        self.i = 0
        self.swaps: list = []
        self.scales: list = []
        self.replicas = 2

    def metrics(self):
        m = dict(self.snapshots[min(self.i, len(self.snapshots) - 1)])
        m["replicas"] = self.replicas
        self.i += 1
        return m

    def swap(self, tags):
        self.swaps.append(dict(tags))
        return {"epoch": len(self.swaps), "work": ZERO, "tags": dict(tags)}

    def scale(self, n):
        self.scales.append(n)
        self.replicas = n
        return {"replicas": n}


def _snapshots(ticks=40):
    """Cumulative metric payloads: scenario 1 drifts at tick 10, the queue
    fills from tick 20 to 26, overflow rises from tick 30, one counter reset
    at tick 35, one window below min_window at tick 5."""
    rng = np.random.default_rng(9)
    n = {s: 0 for s in "012"}
    conf = {s: 0.0 for s in "012"}
    routed = overflow = 0
    out = []
    for t in range(ticks):
        per = {}
        for s in "012":
            dn = 2 if t == 5 else 20
            mean = 0.9 - (0.3 if s == "1" and t >= 10 else 0.0) + 0.01 * rng.standard_normal()
            n[s] += dn
            conf[s] += round(mean * dn, 4)
            if t == 35:
                n[s], conf[s] = dn, round(mean * dn, 4)
            per[s] = {"n": n[s], "conf_sum": round(conf[s], 4)}
        routed += 60
        overflow += 30 if t >= 30 else 1
        out.append({
            "per_scenario": per,
            "queue_depth_now": 30.0 if 20 <= t < 26 else 0.0,
            "slo": {"n": 60 * (t + 1), "met": 60 * (t + 1) - (5 if t > 22 else 0), "attainment": 1.0},
            "dispatch": {"routed_rows": routed, "overflow_rows": overflow},
        })
    return out


@pytest.mark.parametrize("dry_run", [True, False])
def test_controller_tick_decisions_match_jax(dry_run, tmp_path):
    kw = dict(dry_run=dry_run, autoscale=True, max_replicas=3, queue_high=8.0, queue_low=0.5, scale_debounce=2,
              cooldown_ticks=1, debounce=2)
    snaps = _snapshots()
    tp, jp = _FakePoller(snaps), _FakePoller(snaps)
    # the adaptation itself (fine-tune, canary) is held elsewhere: here every
    # non-dry adapt runs a stub that fails its canary, the same on both sides
    t = tloop.FleetController(_tcfg(**kw), str(tmp_path), tp, drift_step_hint=3, device="cpu")
    j = jloop.FleetController(_jcfg(**kw), str(tmp_path), jp, drift_step_hint=3)
    for ctrl in (t, j):
        def aborted(scenario, ctrl=ctrl):
            ctrl._attempts[scenario] = ctrl._attempts.get(scenario, 0) + 1
            ctrl.monitor.reset(scenario)
            return ctrl._emit("adapt_aborted", scenario=scenario, canary={"passed": False})

        if not dry_run:
            ctrl._adapt = aborted
    kinds = set()
    for i in range(len(snaps)):
        got, want = t.tick(), j.tick()
        assert got == want, i
        kinds |= {e.get("action") or e.get("signal") for e in got["events"]}
    assert tp.scales == jp.scales and tp.swaps == jp.swaps == []
    assert t.monitor.state() == j.monitor.state() and t.autoscaler.state() == j.autoscaler.state()
    want_kinds = {"confidence", "overflow_rate", "scale", "adapt" if dry_run else "adapt_aborted"}
    assert want_kinds <= kinds, kinds


def test_in_process_adapt_pipeline_on_a_port_engine(workdir):
    cfg = _tcfg(min_gain_db=-50.0, tol_db=50.0, watch_ticks=1)
    engine = ServeEngine.from_workdir(cfg, workdir, device="cpu")
    engine.warmup()
    x = np.random.default_rng(2).standard_normal((8, *HW, 2)).astype(np.float32)
    pool = ReplicaPool(engine, replicas=1).start()
    try:
        ctrl = tloop.FleetController(cfg, workdir, tloop.PoolPoller(pool, engine, workdir), engine=engine,
                                     drift_step_hint=3)
        assert ctrl.device == engine.device
        for _ in range(10):
            ctrl.monitor.observe(1, "confidence", 0.9)
        for _ in range(10):
            ctrl.monitor.observe(1, "confidence", 0.4)
        assert ctrl.monitor.active() == [(1, "confidence")]
        out = ctrl.tick()
        adapted = [e for e in out["events"] if e.get("action") == "adapted"]
        assert adapted, out["events"]
        rec = adapted[0]
        assert rec["finetune"]["tag"] == "hdce_last" and rec["canary"]["passed"] is True
        assert rec["deploy"]["swap"]["tags"] == {"hdce": "hdce_last", "sc": "sc_best"}
        assert rec["deploy"]["swap"]["work"] == ZERO and engine.swap_epoch == 1
        assert ctrl.monitor.active() == []
        served = [f.result(timeout=WAIT) for f in [pool.submit(x[i], rid=i) for i in range(8)]]
        assert all(isinstance(r, Prediction) for r in served)
        twin = ServeEngine.from_workdir(cfg, workdir, device="cpu", tags={"hdce": "hdce_last"})
        h_ref = twin.offline_forward(x)[0]
        np.testing.assert_allclose(np.stack([r.h for r in served]), h_ref, rtol=0, atol=1e-5)
        assert engine.request_path_work() == ZERO
        assert ctrl.deployer.watching()
        ctrl.observe_parity(1, rec["canary"]["drifted_probes"]["cand_db"])
        assert [e["action"] for e in ctrl.tick()["events"]] == ["deploy_confirmed"]
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# the remote controller against the port's endpoint
# ---------------------------------------------------------------------------


def _windows(ticks=12, per=32):
    """Request windows: 6 at input scale 1, then 6 at scale 0.05 (the
    random classifier's confidence in its most routed scenario falls by
    about 0.03)."""
    rng = np.random.default_rng(21)
    return [(1.0 if t < ticks // 2 else 0.05) * rng.standard_normal((per, *HW, 2)).astype(np.float32)
            for t in range(ticks)]


def _serve_in_thread(serve_async, pool, swap_fn):
    aloop = asyncio.new_event_loop()
    th = threading.Thread(target=aloop.run_forever, daemon=True)
    th.start()
    ready: Future = Future()
    asyncio.run_coroutine_threadsafe(serve_async(pool, "127.0.0.1", 0, ready, swap_fn=swap_fn), aloop)
    port = ready.result(timeout=WAIT)

    async def cancel_all():
        tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def stop():
        try:
            asyncio.run_coroutine_threadsafe(cancel_all(), aloop).result(timeout=WAIT)
        finally:
            aloop.call_soon_threadsafe(aloop.stop)
            th.join(timeout=10.0)
            aloop.close()
            pool.stop()

    return port, stop


def _decisions(endpoint_pool, serve_async, cfg, workdir, windows, swap_fn):
    """JAX's dry-run controller over its SocketPoller against an endpoint:
    per tick, one window of traffic served in process, then one tick."""
    port, stop = _serve_in_thread(serve_async, endpoint_pool, swap_fn)
    try:
        ctrl = jloop.FleetController(cfg, workdir, jloop.SocketPoller("127.0.0.1", port), drift_step_hint=3)
        out = []
        for w in windows:
            futs = [endpoint_pool.submit(x) for x in w]
            assert all(not hasattr(f.result(timeout=WAIT), "reason") for f in futs)
            ev = ctrl.tick()["events"]
            out.append(sorted((e.get("action", "drift"), e.get("scenario"), e.get("signal"), e.get("direction"),
                               e.get("replicas")) for e in ev))
        return out, port, stop
    except BaseException:
        stop()
        raise


def test_jax_controller_decides_the_same_against_the_port_endpoint(tmp_path, jax_hdce, capsys):
    from qdml_tpu.serve.engine import ServeEngine as JServeEngine
    from qdml_tpu.serve.server import ReplicaPool as JReplicaPool
    from qdml_tpu.serve.server import serve_async as jserve_async
    from qdml_tpu_torch.serve.server import serve_async as tserve_async

    hdce_vars, hdce_sd = jax_hdce
    clf_vars = _flax_qsc(2)
    clf_sd = interop.qsc_state_dict_from_flax(clf_vars["params"])
    wd = str(tmp_path / "wd")
    save_checkpoint(wd, "hdce_best", {"params": hdce_sd}, {})
    save_checkpoint(wd, "qsc_best", {"params": clf_sd}, {"quantum": qsc_meta_from_state(clf_sd)})
    # a sensitive detector: the random classifier's confidences sit near 1/3
    knobs = dict(dry_run=True, autoscale=True, max_replicas=3, queue_high=8.0, queue_low=0.5, scale_debounce=2,
                 cooldown_ticks=1, min_window=4, ph_delta=0.005, ph_threshold=0.03)
    windows = _windows()
    # JAX's endpoint first, stopped before the port's starts
    jeng = JServeEngine(_jcfg(**knobs), hdce_vars, clf_vars, quantum=True)
    jeng.warmup()
    want, _, stop = _decisions(JReplicaPool(jeng, replicas=2).start(), jserve_async, _jcfg(**knobs), wd, windows,
                               None)
    stop()
    teng = ServeEngine(_tcfg(True, **knobs), hdce_sd, clf_sd, quantum=True, device="cpu")
    teng.warmup()
    tpool = ReplicaPool(teng, replicas=2).start()
    got, port, stop = _decisions(tpool, tserve_async, _jcfg(**knobs), wd, windows,
                                 lambda tags=None: teng.swap_from_workdir(wd, tags=tags))
    try:
        assert got == want
        flat = [d for tick in got for d in tick]
        assert any(d[0] == "scale" for d in flat) and any(d[0] == "drift" for d in flat), got
        assert any(d[0] == "adapt" for d in flat), got
        # the port's own control command against the same endpoint: JAX's
        # header line, then three dry-run ticks, exit 0
        capsys.readouterr()
        rc = cli.main(["control", "--device=cpu", "--ticks=3", "--control.dry_run=true", "--control.interval_s=0.01",
                       f"--serve.port={port}", "--data.n_ant=16", "--model.features=8",
                       f"--train.workdir={tmp_path / 'ws'}"])
        assert rc == 0
        header = json.loads(capsys.readouterr().out.strip().splitlines()[0])
        assert header == {"control": f"127.0.0.1:{port}", "workdir": cli.workdir_of(tconfig.from_args([
            "--data.n_ant=16", "--model.features=8", f"--train.workdir={tmp_path / 'ws'}"])),
            "dry_run": True, "interval_s": 0.01, "autoscale": True, "drift_step_hint": 1}
        assert teng.request_path_work() == ZERO
    finally:
        stop()
