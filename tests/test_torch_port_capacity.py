"""The port's capacity planner (``plan``) against the JAX package's, on the CPU.

Both are stdlib code seeded through ``random``, so on the same windows and
seeds they must give the same numbers: the queue core (arrivals, the
simulated waits, the closed forms), ``window_model``, ``validate_windows``
and ``plan_backends`` on the JAX package's recorded windows
(``results/trace_dryrun/``, ``results/fleet_router/``) and on a window the
port's traced loadgen writes here, ``emit_target``'s record (which the
port's ``load_planner_target`` reads unchanged) and ``plan``'s exit codes
and output. The closed-form cases of ``tests/test_capacity.py`` run against
the port's module.
"""

from __future__ import annotations

import glob
import json
import math
import random
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.telemetry import capacity as jcap  # noqa: E402
from qdml_tpu_torch.control.fleet_scale import load_planner_target  # noqa: E402
from qdml_tpu_torch.telemetry import capacity as tcap  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = sorted(glob.glob(str(ROOT / "results" / "trace_dryrun" / "traced_t*.jsonl"))) + sorted(
    glob.glob(str(ROOT / "results" / "fleet_router" / "baseline*.jsonl")))
TRACED = sorted(glob.glob(str(ROOT / "results" / "trace_dryrun" / "traced_t*.jsonl")))


def _dists_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].points == b[k].points, k


# ---------------------------------------------------------------------------
# the queue core and the closed forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("process,burst", [("poisson", 1.0), ("mmpp", 3.0), ("uniform", 1.0)])
def test_replay_arrivals_match_jax(process, burst):
    for seed in (0, 5):
        assert tcap.replay_arrivals(700, 80.0, process, burst, seed=seed) == jcap.replay_arrivals(
            700, 80.0, process, burst, seed=seed)
    assert tcap.replay_arrivals(3, 0.0, process) == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("servers", [1, 2, 4])
def test_simulate_queue_matches_jax(servers):
    rng = random.Random(servers)
    arr = tcap.replay_arrivals(3000, 90.0, "poisson", seed=servers)
    svc = [rng.expovariate(120.0 / servers) for _ in arr]
    assert tcap.simulate_queue(arr, svc, servers) == jcap.simulate_queue(arr, svc, servers)


def test_simulate_queue_multiserver_and_empty():
    assert tcap.simulate_queue([], []) == []
    assert tcap.simulate_queue([0.0, 0.0], [1.0, 1.0], servers=2) == [0.0, 0.0]
    assert tcap.simulate_queue([0.0, 0.0], [1.0, 1.0], servers=1) == [0.0, 1.0]


def test_simulator_matches_md1_closed_form():
    lam, d, n = 0.7, 1.0, 60000
    arr = tcap.replay_arrivals(n, lam, "poisson", seed=3)
    waits = sorted(tcap.simulate_queue(arr, [d] * n))
    for q in (0.5, 0.9, 0.99):
        assert tcap.md1_wait_quantile(q, lam, d) == pytest.approx(waits[min(n - 1, int(q * n))], rel=0.10, abs=0.05)


def test_simulator_matches_mm1_closed_form():
    lam, mu, n = 0.6, 1.0, 60000
    rng = random.Random(11)
    arr = tcap.replay_arrivals(n, lam, "poisson", seed=5)
    svc = [rng.expovariate(mu) for _ in range(n)]
    soj = sorted(w + s for w, s in zip(tcap.simulate_queue(arr, svc), svc))
    assert tcap.mm1_sojourn_quantile(0.9, lam, mu) == pytest.approx(soj[int(0.9 * n)], rel=0.08)


def test_md1_cdf_shape_and_quantile_inversion_match_jax():
    lam, d = 0.5, 1.0
    assert tcap.md1_wait_cdf(0.0, lam, d) == pytest.approx(1 - lam * d)
    assert tcap.md1_wait_cdf(-1.0, lam, d) == 0.0
    assert tcap.md1_wait_cdf(10.0, lam=1.5, d=1.0) == 0.0
    prev = 0.0
    for t in (0.0, 0.5, 1.0, 2.0, 4.0, 8.0):
        cur = tcap.md1_wait_cdf(t, lam, d)
        assert 0.0 <= cur <= 1.0 and cur >= prev and cur == jcap.md1_wait_cdf(t, lam, d)
        prev = cur
    for q in (0.5, 0.9, 0.99):
        t = tcap.md1_wait_quantile(q, lam, d)
        assert tcap.md1_wait_cdf(t, lam, d) == pytest.approx(q, abs=1e-3) and t == jcap.md1_wait_quantile(q, lam, d)
        assert tcap.mm1_sojourn_quantile(q, 0.6, 1.0) == jcap.mm1_sojourn_quantile(q, 0.6, 1.0)


def test_quantile_dist_matches_jax():
    ph = {"n": 100, "mean_ms": 11.0, "p50_ms": 10.0, "p95_ms": 20.0, "p99_ms": 30.0, "max_ms": 40.0}
    t, j = tcap.QuantileDist.from_summary(ph), jcap.QuantileDist.from_summary(ph)
    assert t.points == j.points and t.mean() == j.mean()
    assert [t.quantile(q / 100) for q in range(101)] == [j.quantile(q / 100) for q in range(101)]
    r1, r2 = random.Random(0), random.Random(0)
    assert [t.sample(r1) for _ in range(500)] == [j.sample(r2) for _ in range(500)]
    assert tcap.QuantileDist.from_summary(None) is None and tcap.QuantileDist.from_summary({"p50_ms": None}) is None
    assert (tcap.P99_BAND, tcap.WIRE_P99_BAND, tcap.RPS_BAND_FRAC, tcap.PHASE_ORDER) == (
        jcap.P99_BAND, jcap.WIRE_P99_BAND, jcap.RPS_BAND_FRAC, jcap.PHASE_ORDER)


# ---------------------------------------------------------------------------
# the JAX package's recorded windows
# ---------------------------------------------------------------------------


def test_there_are_recorded_windows():
    assert len(TRACED) >= 2 and len(COMMITTED) >= 4


@pytest.mark.parametrize("path", COMMITTED, ids=lambda p: Path(p).name)
def test_window_model_matches_jax_on_recorded_windows(path):
    t, j = tcap.window_model(tcap.load_summary(path)), jcap.window_model(jcap.load_summary(path))
    assert t["mode"] == j["mode"] and t["mode"] in ("phases", "wire")
    assert t["residual_ms"] == j["residual_ms"]
    _dists_equal(t["phases"], j["phases"])


def test_validate_windows_matches_jax_on_recorded_windows():
    got = tcap.validate_windows(COMMITTED, n_samples=4000, seed=1)
    assert got == jcap.validate_windows(COMMITTED, n_samples=4000, seed=1)
    assert got["ok"] is True and got["n_windows"] == len(COMMITTED)


@pytest.mark.parametrize("path", TRACED[:2], ids=lambda p: Path(p).name)
def test_plan_backends_matches_jax_on_recorded_windows(path):
    summary = jcap.load_summary(path)
    target = float(summary["rps"]) * 3.0
    p99 = float(summary["latency_ms"]["p99_ms"]) * 1.5
    got = tcap.plan_backends(path, target, p99, max_backends=5, n_samples=1500, seed=2)
    assert got == jcap.plan_backends(path, target, p99, max_backends=5, n_samples=1500, seed=2)
    assert [r["backends"] for r in got["sweep"]] == [1, 2, 3, 4, 5]
    assert tcap.emit_target(got) == jcap.emit_target(got)


# ---------------------------------------------------------------------------
# synthetic windows (tests/test_capacity.py's), both packages
# ---------------------------------------------------------------------------


def _phase(p50, p95=None, p99=None, mx=None):
    return {"n": 500, "mean_ms": p50, "p50_ms": p50, "p95_ms": p95 or p50 * 1.2, "p99_ms": p99 or p50 * 1.4,
            "max_ms": mx or p50 * 1.6}


def _traced_summary(p99_ms=32.0, mean_ms=21.0, rps=100.0):
    return {
        "kind": "serve_summary", "n_requests": 2000, "rps": rps, "offered_rps": rps * 1.01,
        "arrival": {"process": "poisson", "burstiness": 1.0},
        "latency_ms": {"mean_ms": mean_ms, "p50_ms": mean_ms, "p95_ms": p99_ms * 0.9, "p99_ms": p99_ms,
                       "max_ms": p99_ms * 1.3},
        "phases": {"batch_wait": _phase(4.0), "queue_wait": _phase(1.0), "compute": _phase(10.0),
                   "fetch": _phase(2.0), "wire": _phase(3.0), "pick": _phase(0.5)},
        "trace": {"reconciliation": {"mean_unattributed_ms": 0.5}},
    }


def _wire_summary(p99_ms=30.0):
    return {"kind": "serve_summary", "completed": 1500, "rps": 90.0,
            "latency_ms": {"mean_ms": 21.0, "p50_ms": 20.0, "p95_ms": 27.0, "p99_ms": p99_ms, "max_ms": 45.0},
            "router": {"wire_latency_ms": _phase(20.0, 26.0, 29.0, 44.0)}}


def _write_window(tmp_path, name, summary):
    p = tmp_path / name
    p.write_text(json.dumps({"kind": "manifest", "argv": ["test"]}) + "\n" + json.dumps(summary) + "\n")
    return str(p)


@pytest.mark.parametrize("summary", [_traced_summary(), _traced_summary(300.0, 150.0), _wire_summary(),
                                     _wire_summary(90.0), {"kind": "serve_summary", "latency_ms": {"p99_ms": 5.0}}],
                         ids=["phases", "phases_inconsistent", "wire", "wire_wide", "bare"])
def test_validate_window_matches_jax_on_synthetic_windows(tmp_path, summary):
    path = _write_window(tmp_path, "w.jsonl", summary)
    got = tcap.validate_window(path, n_samples=3000, seed=1)
    assert got == jcap.validate_window(path, n_samples=3000, seed=1)


def test_validate_window_bands(tmp_path):
    row = tcap.validate_window(_write_window(tmp_path, "a.jsonl", _traced_summary()), n_samples=8000, seed=1)
    assert row["mode"] == "phases" and row["ok"] is True
    assert row["p99_ratio"] == pytest.approx(1.0, abs=math.log(tcap.P99_BAND))
    bad = tcap.validate_window(_write_window(tmp_path, "b.jsonl", _traced_summary(300.0, 150.0)), n_samples=4000,
                               seed=1)
    assert bad["ok"] is False and bad["p99_ratio"] < 1.0 / tcap.P99_BAND
    wire = tcap.validate_window(_write_window(tmp_path, "c.jsonl", _wire_summary(90.0)), n_samples=4000, seed=1)
    assert wire["mode"] == "wire" and wire["p99_ratio"] < 1.0 / tcap.P99_BAND and wire["ok"] is True
    with pytest.raises(ValueError):
        tcap.load_summary(_write_window(tmp_path, "d.jsonl", {"kind": "counters", "completed": 1}))


def test_plan_backends_sweep_and_floor_match_jax(tmp_path):
    path = _write_window(tmp_path, "traced.jsonl", _traced_summary())
    rep = tcap.plan_backends(path, target_rps=300.0, p99_ms=60.0, max_backends=8, n_samples=3000, seed=2)
    assert rep == jcap.plan_backends(path, target_rps=300.0, p99_ms=60.0, max_backends=8, n_samples=3000, seed=2)
    k = rep["backends_needed"]
    assert k is not None and rep["sweep"][0]["stable"] is False
    assert all(not r["meets_target"] for r in rep["sweep"][: k - 1]) and rep["sweep"][k - 1]["meets_target"]
    floor = tcap.plan_backends(path, target_rps=100.0, p99_ms=5.0, max_backends=4, n_samples=2000, seed=2)
    assert floor["backends_needed"] is None
    with pytest.raises(ValueError, match="no phase spans"):
        tcap.plan_backends(_write_window(tmp_path, "wire.jsonl", _wire_summary()), target_rps=50.0, p99_ms=100.0)


# ---------------------------------------------------------------------------
# a window the port's traced loadgen writes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_window(tmp_path_factory):
    from qdml_tpu_torch import config as tconfig
    from qdml_tpu_torch.serve import batching_autotune
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.loadgen import run_loadgen
    from qdml_tpu_torch.telemetry import run_manifest
    from qdml_tpu_torch.train import hdce as thdce
    from qdml_tpu_torch.train import qsc as tqsc
    from qdml_tpu_torch.utils.metrics import MetricsLogger

    d = tmp_path_factory.mktemp("window")
    batching_autotune.set_table_path(str(d / "batching.json"))
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16), model=tconfig.ModelConfig(features=8),
        serve=tconfig.ServeConfig(max_batch=8, buckets=(4, 8), max_wait_ms=1.0, max_queue=256, batching="bucket",
                                  trace_sample=1.0, arrival="poisson"))
    hdce, _ = thdce.make_trainer(cfg, "cpu", 4)
    clf, _ = tqsc.make_trainer(cfg, False, "cpu", 4)
    eng = ServeEngine(cfg, hdce.state_dict(), clf.state_dict(), device="cpu")
    path = d / "traced.jsonl"
    log = MetricsLogger(str(path), echo=False, manifest=run_manifest(cfg, include_torch=False))
    try:
        sm = run_loadgen(cfg, eng, rate=150.0, n=240, deadline_ms=500.0, logger=log)
    finally:
        log.close()
        batching_autotune.set_table_path(None)
    assert sm["phases"] and sm["stranded_futures"] == 0
    return str(path)


def test_the_port_written_window_models_as_jaxs(port_window):
    t, j = tcap.window_model(tcap.load_summary(port_window)), jcap.window_model(jcap.load_summary(port_window))
    assert t["mode"] == j["mode"] == "phases"
    assert set(t["phases"]) >= {"batch_wait", "queue_wait", "compute", "fetch"}
    _dists_equal(t["phases"], j["phases"])
    assert t["residual_ms"] == j["residual_ms"]


def test_the_port_written_window_validates_and_plans_as_jaxs(port_window):
    got = tcap.validate_windows([port_window], n_samples=4000, seed=0)
    assert got == jcap.validate_windows([port_window], n_samples=4000, seed=0)
    assert got["rows"][0]["mode"] == "phases" and got["rows"][0]["predicted_p99_ms"] > 0
    plan = tcap.plan_backends(port_window, 2000.0, 16.0, max_backends=4, n_samples=1200, seed=0)
    assert plan == jcap.plan_backends(port_window, 2000.0, 16.0, max_backends=4, n_samples=1200, seed=0)


# ---------------------------------------------------------------------------
# the command and the planner -> autoscaler handoff
# ---------------------------------------------------------------------------


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    [], ["--trace=GOOD"], ["--trace=GOOD", "--validate", "--seed=1"], ["--trace=GOOD,BAD", "--validate", "--seed=1"],
    ["--trace=GOOD", "--target-rps=300", "--p99-ms=60", "--seed=2"],
    ["--trace=GOOD", "--target-rps=100", "--p99-ms=5", "--max-backends=2", "--seed=2"],
], ids=["no_trace", "no_question", "validate_ok", "validate_fail", "plan_answered", "plan_unmeetable"])
def test_plan_main_matches_jax(tmp_path, capsys, argv):
    good = _write_window(tmp_path, "good.jsonl", _traced_summary())
    bad = _write_window(tmp_path, "bad.jsonl", _traced_summary(p99_ms=300.0, mean_ms=150.0))
    argv = [a.replace("GOOD", good).replace("BAD", bad) for a in argv]
    assert _run(tcap.plan_main, argv, capsys) == _run(jcap.plan_main, argv, capsys)


def test_emit_target_loads_through_load_planner_target(tmp_path, capsys):
    good = _write_window(tmp_path, "good.jsonl", _traced_summary())
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    args = [f"--trace={good}", "--target-rps=300", "--p99-ms=60", "--seed=2"]
    assert tcap.plan_main([*args, f"--emit-target={out_t}"]) == 0
    assert jcap.plan_main([*args, f"--emit-target={out_j}"]) == 0
    capsys.readouterr()
    assert json.loads(out_t.read_text()) == json.loads(out_j.read_text())
    tgt = load_planner_target(str(out_t))
    assert tgt["backends_needed"] >= 2 and len(tgt["assumptions_sha"]) == 64 and tgt["trace"] == good
    # an unmeetable plan is emitted with a null answer, and the loader refuses it
    assert tcap.plan_main([f"--trace={good}", "--target-rps=100", "--p99-ms=5", "--max-backends=2",
                           f"--emit-target={out_t}"]) == 3
    capsys.readouterr()
    with pytest.raises(ValueError, match="no actionable"):
        load_planner_target(str(out_t))
