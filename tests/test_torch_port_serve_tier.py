"""The port's serving tier against the JAX package's, on the CPU.

Small size: features 8, n_ant 16 (head 512 wide), S=3, buckets (1, 4, 8),
the plain kernels. Held against ``qdml_tpu.serve``:

- the micro-batcher's admission, flush and shed sequence on a fake clock,
  step for step, in both admission modes;
- ``Histogram.merge`` quantiles, and ``arrival_times`` bit for bit for the
  three arrival processes;
- the drifted request stream: its family table and scenario mix;
- a ``ReplicaPool`` (2 replicas, 2 workers) serving ``h`` against JAX's
  ``ServeEngine._forward`` on the same Flax weights (carried across by
  ``qdml_tpu_torch.interop``) within ``1e-4 * max|h| + 1e-5``;
- ``ServeEngine.from_workdir`` and ``run_loadgen`` (zero stranded futures,
  zero request-path work, parity), the ``loadgen`` and ``serve`` commands.

Also: the kernel launch counters under 8 threads, and the config knobs a JAX
command line carries (the drift knobs, ``model.kernel_size``,
``model.n_conv_layers``, ``model.conv_impl``, ``eval.indicator``). The
batching race and a 2-worker pool on the card are ``cuda``-marked tests in
``tests/test_torch_port_cuda.py`` (this file imports JAX, which the card's
machine lacks).
"""

import dataclasses
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.serve import batcher as jbatcher  # noqa: E402
from qdml_tpu.serve import loadgen as jloadgen  # noqa: E402
from qdml_tpu.serve import types as jtypes  # noqa: E402
from qdml_tpu.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from qdml_tpu.telemetry.counters import Histogram as JHistogram  # noqa: E402
from qdml_tpu_torch import cli  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.serve import batcher as tbatcher  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402
from qdml_tpu_torch.serve import loadgen as tloadgen  # noqa: E402
from qdml_tpu_torch.serve import types as ttypes  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.serve.server import ReplicaPool  # noqa: E402
from qdml_tpu_torch.telemetry.counters import Histogram  # noqa: E402
from qdml_tpu_torch.train.checkpoint import CheckpointRestoreError, save_checkpoint  # noqa: E402
from qdml_tpu_torch.train.torch_interop import qsc_meta_from_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = (1, 4, 8)
HW = (16, 8)
WAIT = 30.0  # seconds any future, join or read may take before the test fails


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    yield
    batching_autotune.invalidate_cache()


# ---------------------------------------------------------------------------
# the micro-batcher, step for step against JAX's
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _script(seed: int, steps: int = 300) -> list[tuple]:
    """Events: ("submit", dt, rid, deadline offset or None), ("next", dt),
    ("hint", dt); dt advances the clock first."""
    rng = np.random.default_rng(seed)
    out, rid = [], 0
    for _ in range(steps):
        dt = float(rng.uniform(0, 0.003))
        u = rng.uniform()
        if u < 0.6:
            # now and then a burst of 10 at one instant, past the queue's 8
            for j in range(10 if rng.uniform() < 0.05 else 1):
                kind = rng.integers(4)
                deadline = None if kind < 2 else (float(rng.uniform(0, 0.02)) if kind == 2 else -0.001)
                out.append(("submit", dt if j == 0 else 0.0, rid, deadline))
                rid += 1
        elif u < 0.9:
            out.append(("next", dt))
        else:
            out.append(("hint", dt))
    return out


def _run_batcher(mod, types_mod, continuous: bool, script) -> list:
    clock = FakeClock()
    mb = mod.MicroBatcher(max_batch=4, max_wait_s=0.005, max_queue=8, clock=clock, continuous=continuous)
    log = []
    for ev in script:
        clock.t += ev[1]
        if ev[0] == "submit":
            _, _, rid, dl = ev
            req = types_mod.Request(rid=rid, x=np.zeros((2, 2, 2), np.float32),
                                    deadline=None if dl is None else clock.t + dl)
            res = mb.submit(req)
            log.append(("submit", None if res is None else (res.rid, res.reason), mb.depth))
        elif ev[0] == "next":
            batch, shed = mb.next_batch()
            log.append(("next", [r.rid for r in batch],
                        [(r.rid, o.rid, o.reason, round(o.latency_s, 12)) for r, o in shed]))
        else:
            log.append(("hint", round(mb.wait_hint(), 12)))
    return log


@pytest.mark.parametrize("continuous", [False, True], ids=["coalesce", "continuous"])
def test_batcher_sequence_matches_jax(continuous):
    for seed in range(3):
        script = _script(seed)
        got = _run_batcher(tbatcher, ttypes, continuous, script)
        want = _run_batcher(jbatcher, jtypes, continuous, script)
        assert got == want
        # the script reaches every branch: full queues, both deadline sheds, flushes
        reasons = {e[1][1] for e in got if e[0] == "submit" and e[1] is not None}
        assert {ttypes.QUEUE_FULL, ttypes.DEADLINE_AT_SUBMIT} <= reasons
        assert any(e[0] == "next" and e[2] for e in got)
        assert any(e[0] == "next" and e[1] for e in got)
    with pytest.raises(ValueError, match="max_queue"):
        tbatcher.MicroBatcher(max_batch=8, max_queue=4)


# ---------------------------------------------------------------------------
# histograms, arrivals, the drifted stream
# ---------------------------------------------------------------------------


def test_histogram_merge_quantiles_match_jax():
    rng = np.random.default_rng(7)
    parts = [rng.exponential(0.01, n).tolist() for n in (1, 17, 250)]
    mine, theirs = Histogram(), JHistogram()
    assert mine.summary() is None and theirs.summary() is None
    for vals in parts:
        a, b = Histogram(), JHistogram()
        for v in vals:
            a.add(v)
            b.add(v)
        assert mine.merge(a) is mine
        theirs.merge(b)
    for unit in ("ms", None):
        assert mine.summary(unit) == theirs.summary(unit)
    assert mine.sum() == theirs.sum() and len(mine) == len(theirs) == 268
    # exact: the merged quantiles are those of the concatenated samples
    whole = Histogram()
    for v in sum(parts, []):
        whole.add(v)
    assert whole.summary() == mine.summary()


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_arrival_times_bit_identical(process):
    for seed, rate, n, b in ((0, 200.0, 1, 4.0), (3, 2000.0, 500, 4.0), (11, 8000.0, 257, 2.5)):
        got = tloadgen.arrival_times(n, rate, np.random.default_rng(seed), process=process, burstiness=b)
        want = jloadgen.arrival_times(n, rate, np.random.default_rng(seed), process=process, burstiness=b)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown arrival"):
        tloadgen.arrival_times(4, 1.0, np.random.default_rng(0), process="nope")


def _tcfg(**serve):
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=4, n_layers=2, impl="dense"),
        serve=tconfig.ServeConfig(buckets=BUCKETS, max_batch=8, max_queue=64),
    )
    return dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, **serve))


def _jcfg(**serve):
    j = jconfig.ExperimentConfig()
    return dataclasses.replace(
        j,
        data=dataclasses.replace(j.data, n_ant=16),
        model=dataclasses.replace(j.model, features=8),
        quantum=dataclasses.replace(j.quantum, n_qubits=4, n_layers=2, impl="dense"),
        serve=dataclasses.replace(j.serve, buckets=BUCKETS, max_batch=8, max_queue=64, **serve),
    )


def test_drifted_request_stream_matches_jax_family_table_and_mix():
    from qdml_tpu.data.channels import family_table as jfamily
    from qdml_tpu_torch.data.channels import ChannelGeometry

    n, at, step, scen = 24, 10, 3, 1
    got = tloadgen.make_request_samples(_tcfg(), n, drift_at=at, drift_step=step, drift_scenario=scen)
    want = jloadgen.make_request_samples(_jcfg(), n, drift_at=at, drift_step=step, drift_scenario=scen)
    np.testing.assert_array_equal(got["indicator"], np.asarray(want["indicator"]))
    assert got["x"].shape == want["x"].shape == (n, *HW, 2) and got["x"].dtype == np.float32
    assert got["h_perf"].shape == want["h_perf"].shape
    geom = dataclasses.replace(
        ChannelGeometry.from_config(_tcfg().data), drift_step=step, drift_scenario=scen
    )
    table, ref = geom.family(), jfamily(3, step, scen)
    assert set(table) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(table[k]), np.asarray(ref[k]), err_msg=k)
    # the stationary prefix is the undrifted stream's table; no drift, no windows
    flat = tloadgen.make_request_samples(_tcfg(), n)
    np.testing.assert_array_equal(flat["indicator"], np.arange(n) % 3)
    with pytest.raises(ValueError, match="drift_scenario"):
        tloadgen.make_request_samples(_tcfg(), n, drift_at=at, drift_step=step, drift_scenario=5)


# ---------------------------------------------------------------------------
# a replica pool against the JAX forward
# ---------------------------------------------------------------------------


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
    jeng = JServeEngine(_jcfg(), {}, {}, quantum=True)
    rng = np.random.default_rng(seed)
    hdce_vars = _randomize(
        jax.device_get(jeng.hdce.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, *HW, 2)))), rng
    )
    clf_vars = {"params": _randomize(
        jax.device_get(jeng.clf.init(jax.random.PRNGKey(1), jnp.zeros((1, *HW, 2))))["params"], rng
    )}
    return jeng, hdce_vars, clf_vars


def _port_sd(hdce_vars, clf_vars):
    return interop.hdce_state_dict_from_flax(hdce_vars), interop.qsc_state_dict_from_flax(clf_vars["params"])


def _close_where_routes_agree(h, pred, h_ref, pred_ref, logp):
    top2 = np.sort(logp, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(pred[sure], pred_ref[sure])
    same = pred == pred_ref
    tol = 1e-4 * np.abs(h_ref).max() + 1e-5
    np.testing.assert_allclose(h[same], h_ref[same], rtol=0, atol=tol)
    return int(same.sum())


def test_replica_pool_serves_jax_forward():
    jeng, hdce_vars, clf_vars = _flax_weights()
    eng = ServeEngine(_tcfg(replicas=2, workers=2), *_port_sd(hdce_vars, clf_vars), quantum=True, device="cpu")
    pool = ReplicaPool(eng).start()
    x = np.random.default_rng(5).standard_normal((40, *HW, 2)).astype(np.float32)
    try:
        assert pool.n_replicas == 2 and pool.workers == 4
        futures = [pool.submit(x[i], rid=i) for i in range(len(x))]
        results = [f.result(timeout=WAIT) for f in futures]
        assert all(isinstance(r, ttypes.Prediction) for r in results)
        health = pool.health()
        assert health["replicas_live"] == 2 and health["warm"] and health["quarantined"] == []
    finally:
        pool.stop()
    h = np.stack([r.h for r in results])
    pred = np.array([r.scenario for r in results])
    h_ref, pred_ref, _ = (np.asarray(v) for v in jax.jit(jeng._forward)(hdce_vars, clf_vars, jnp.asarray(x)))
    logp = np.asarray(jeng.clf.apply(clf_vars, jnp.asarray(x)))
    assert _close_where_routes_agree(h, pred, h_ref, pred_ref, logp) >= len(x) - 2
    merged = pool.merged_metrics()
    assert merged.completed == len(x) and merged.batches >= len(x) / 8
    assert sum(pool.live_metrics()["replica_completed"]) == len(x)
    assert eng.request_path_work() == {"measure": 0, "table_write": 0, "kernel_build": 0}
    assert set(tk.launches.values()) == {0}  # CPU: the plain versions


# ---------------------------------------------------------------------------
# from_workdir, loadgen and the commands
# ---------------------------------------------------------------------------


def _workdir(root: Path, seed=0) -> str:
    _, hdce_vars, clf_vars = _flax_weights(seed)
    hdce_sd, qsc_sd = _port_sd(hdce_vars, clf_vars)
    wd = str(root / "ws" / "Pn_128" / "default")
    save_checkpoint(wd, "hdce_best", {"params": hdce_sd}, {})
    save_checkpoint(wd, "qsc_best", {"params": qsc_sd}, {"quantum": qsc_meta_from_state(qsc_sd)})
    return wd


def test_from_workdir_and_loadgen_hold_parity_and_strand_nothing(tmp_path):
    wd = _workdir(tmp_path)
    cfg = _tcfg(replicas=2, workers=2, drift_step=3, drift_scenario=1)
    eng = ServeEngine.from_workdir(cfg, wd, device="cpu")
    assert eng.quantum and eng.cfg.quantum.n_qubits == 4
    samples = tloadgen.make_request_samples(cfg, 48, drift_at=24, drift_step=3, drift_scenario=1)
    h_off = eng.offline_forward(samples["x"])[0]
    summary = tloadgen.run_loadgen(cfg, eng, rate=4000.0, n=48, process="bursty", deadline_ms=2000.0,
                                   drift_at=24, samples=samples)
    assert summary["completed"] + summary["n_shed"] == 48 and summary["stranded_futures"] == 0
    assert summary["failed_requests"] == 0
    assert summary["compile_cache_after_warmup"] == {"measure": 0, "table_write": 0, "kernel_build": 0}
    assert summary["parity_max_abs_err"] <= 1e-4 * np.abs(h_off).max() + 1e-5
    assert summary["pred_agreement"] == 1.0
    assert summary["replicas"] == 2 and summary["workers"] == 4 and summary["platform"] == "cpu"
    assert set(summary["batching"]) == {"mode", "per_tier", "continuous_admission"}
    assert summary["warmup"]["batching"]["race"]["8"]["key"] == "cpu/cap8/dense/float32"
    assert summary["padding_waste"] is not None and summary["rows"]["dispatched"] >= summary["rows"]["valid"]
    assert summary["drift"] == {"at": 24, "step": 3, "scenario": 1}
    assert summary["windows"]["pre_drift"]["n"] + summary["windows"]["post_drift"]["n"] == summary["completed"]
    assert summary["slo"]["n"] == 48 and summary["mesh"] is None
    # a qsc tag that exists but does not restore fails loudly, never serving SCP128
    (Path(wd) / "qsc_best.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(CheckpointRestoreError):
        ServeEngine.from_workdir(cfg, wd, device="cpu")


def test_loadgen_and_serve_commands_on_the_cpu(tmp_path, capsys):
    _workdir(tmp_path)
    flags = ["--device=cpu", "--data.n_ant=16", "--model.features=8", f"--train.workdir={tmp_path / 'ws'}",
             "--serve.buckets=1,4,8", "--serve.max_batch=8"]
    assert cli.main(["loadgen", *flags, "--n=32", "--rate=2000"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["kind"] == "serve_summary" and summary["n_requests"] == 32
    assert summary["stranded_futures"] == 0
    assert summary["compile_cache_after_warmup"] == {"measure": 0, "table_write": 0, "kernel_build": 0}
    assert summary["parity_max_abs_err"] < 1e-4
    proc = subprocess.Popen(
        [sys.executable, "-m", "qdml_tpu_torch.cli", "serve", *flags, "--serve.port=0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        banner = {}

        def read_banner():  # the banner is the first line that holds "serving"
            for line in proc.stdout:
                if line.startswith('{"serving"'):
                    banner.update(json.loads(line))
                    return

        reader = threading.Thread(target=read_banner, daemon=True)
        reader.start()
        reader.join(timeout=60.0)
        assert banner, proc.stderr.read() if proc.poll() is not None else "no banner in 60 s"
        host, port = banner["serving"].rsplit(":", 1)
        assert host == "127.0.0.1" and int(port) > 0 and banner["host_id"]
        assert banner["compile_cache_after_warmup"] == {"measure": 0, "table_write": 0, "kernel_build": 0}
        assert banner["mesh"] is None and set(banner["cost"]) == {"1", "4", "8"}
    finally:
        proc.send_signal(2)  # SIGINT: run_server stops its pool and flushes
        try:
            proc.wait(timeout=30.0)
        finally:
            if proc.poll() is None:
                proc.kill()


# ---------------------------------------------------------------------------
# the launch counters under threads
# ---------------------------------------------------------------------------


def test_launch_counters_count_every_launch_from_eight_threads(monkeypatch):
    """The wrappers' counting path (``kernels._launch``) from 8 threads at
    once with a stub launch: no count is lost, and a reset under the same
    lock zeroes every counter."""

    class _Stub:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(tk, "_load", lambda name: _Stub())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda idx: 0, raising=False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    tk.reset_launch_counts()
    per_thread = 4000

    def work():
        for _ in range(per_thread):
            tk._launch("circuit_expvals", torch.device("cpu"))

    try:
        threads = [threading.Thread(target=work, daemon=True) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
        assert tk.launches["circuit_expvals"] == 8 * per_thread
    finally:
        sys.setswitchinterval(old)
        tk.reset_launch_counts()
    assert set(tk.launches.values()) == {0}


# ---------------------------------------------------------------------------
# the knobs of a JAX command line
# ---------------------------------------------------------------------------


def test_data_drift_knobs_reach_every_generator():
    from qdml_tpu.data.channels import family_table as jfamily
    from qdml_tpu_torch.data.channels import ChannelGeometry
    from qdml_tpu_torch.data.datasets import GridData, sweep_batch

    cfg = tconfig.from_args(["--data.drift_step=3", "--data.drift_scenario=1", "--data.n_ant=16",
                             "--data.data_len=8"])
    assert (cfg.data.drift_step, cfg.data.drift_scenario) == (3, 1)
    assert (tconfig.DataConfig().drift_step, tconfig.DataConfig().drift_scenario) == (
        jconfig.DataConfig().drift_step, jconfig.DataConfig().drift_scenario)
    geom = ChannelGeometry.from_config(cfg.data)
    assert (geom.drift_step, geom.drift_scenario) == (3, 1)
    for k, v in jfamily(3, 3, 1).items():
        np.testing.assert_array_equal(np.asarray(geom.family()[k]), np.asarray(v), err_msg=k)
    # training data, eval batches: the drifted table, a different channel law
    grid, flat = GridData.synthesize(cfg.data, "cpu"), GridData.synthesize(
        dataclasses.replace(cfg.data, drift_step=0), "cpu")
    assert grid.geom.drift_step == 3 and flat.geom.drift_step == 0
    drifted = sweep_batch(cfg.data, 0, 0, 6, 10.0, device="cpu")
    still = sweep_batch(dataclasses.replace(cfg.data, drift_step=0), 0, 0, 6, 10.0, device="cpu")
    assert not torch.equal(drifted["h_perf"], still["h_perf"])
    with pytest.raises(ValueError, match="drift_scenario"):
        ChannelGeometry.from_config(dataclasses.replace(cfg.data, drift_scenario=3))


def test_model_kernel_size_is_accepted_and_recorded():
    cfg = tconfig.from_args(["--model.kernel_size=5"])
    assert cfg.model.kernel_size == 5
    assert tconfig.ModelConfig().kernel_size == jconfig.ModelConfig().kernel_size == 3


def test_model_n_conv_layers_is_accepted_and_recorded():
    cfg = tconfig.from_args(["--model.n_conv_layers=4"])
    assert cfg.model.n_conv_layers == 4
    assert tconfig.ModelConfig().n_conv_layers == jconfig.ModelConfig().n_conv_layers == 3


def test_model_conv_impl_is_validated_as_in_jax():
    from qdml_tpu.models.cnn import resolve_conv_impl

    for impl in ("auto", "conv", "shift_matmul"):
        assert tconfig.from_args([f"--model.conv_impl={impl}"]).model.conv_impl == impl
    assert tconfig.ModelConfig().conv_impl == jconfig.ModelConfig().conv_impl
    with pytest.raises(ValueError) as jerr:
        resolve_conv_impl("winograd")
    with pytest.raises(ValueError) as terr:
        tconfig.from_args(["--model.conv_impl=winograd"])
    assert str(terr.value) == str(jerr.value)


def test_eval_indicator_is_accepted_and_recorded():
    cfg = tconfig.from_args(["--eval.indicator=2"])
    assert cfg.eval.indicator == 2
    assert tconfig.EvalConfig().indicator == jconfig.EvalConfig().indicator == -1


def test_serve_fields_match_jax_defaults_and_validation(capsys):
    from qdml_tpu_torch.serve.engine import serve_mesh

    t, j = tconfig.ServeConfig(), jconfig.ServeConfig()
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert {f.name for f in dataclasses.fields(t)} == {f.name for f in dataclasses.fields(j)}
    assert tconfig.from_args(["--serve.checkify=true"]).serve.checkify is True
    with pytest.raises(ValueError, match="serve.shard must be"):
        serve_mesh(tconfig.from_args(["--serve.shard=maybe"]), "cpu")
    with pytest.raises(ValueError, match="requires sharding"):
        serve_mesh(tconfig.from_args(["--serve.shard=off", "--serve.expert_sharding=true"]), "cpu")
    assert serve_mesh(tconfig.from_args(["--serve.expert_sharding=true"]), "cpu") is None
    assert "experts unsharded" in capsys.readouterr().out
    assert serve_mesh(tconfig.from_args(["--serve.shard=off"]), "cpu") is None
