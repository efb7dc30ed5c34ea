"""Open-loop load generator and offline-parity harness (``qdml_tpu/serve/loadgen.py``).

Open loop: arrivals are scheduled by the arrival process's clock, not by
completions, so the generator keeps offering load while requests are in
flight; that is the only traffic model that shows queue growth, coalescing
and shedding. Three processes (:func:`arrival_times`, a copy of the JAX
package's, so the same numpy ``Generator`` seed gives the same array):
``poisson``; ``bursty``, a two-state Markov-modulated Poisson process whose
mean rate stays ``rate``; ``diurnal``, a sinusoidal day trace by thinning.

:func:`run_loadgen` drives a :class:`~qdml_tpu_torch.serve.server.ReplicaPool`
in process and :func:`run_loadgen_socket` a running server over the wire;
both return the JAX package's ``serve_summary``: latency percentiles, rps,
goodput and padding waste, SLO attainment, sheds, stranded futures, parity
of every served estimate against the engine's ``offline_forward``, the
``batching`` and ``dispatch`` blocks, the phase trace, and with
``--drift-at`` the ``windows`` and ``drift`` blocks. Where JAX reports its
compile-cache counters (``compile_cache_after_warmup``), the port reports
:meth:`~qdml_tpu_torch.serve.engine.ServeEngine.request_path_work`.

The requests come from the port's generator on the CPU
(:func:`make_request_samples`): the same rows for the same config on any
machine, past the training range as in JAX, but not JAX's bits (its
``jax.random`` stream cannot be reproduced).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import torch

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.data.channels import ChannelGeometry
from qdml_tpu_torch.data.datasets import make_network_batch
from qdml_tpu_torch.serve.engine import ServeEngine
from qdml_tpu_torch.serve.metrics import ServeMetrics
from qdml_tpu_torch.serve.server import ReplicaPool
from qdml_tpu_torch.serve.types import Prediction
from qdml_tpu_torch.telemetry.spans import span
from qdml_tpu_torch.telemetry.tracing import TraceContext
from qdml_tpu_torch.utils import lockdep
from qdml_tpu_torch.utils.metrics import nmse_db

ARRIVAL_PROCESSES = ("poisson", "bursty", "diurnal")


def arrival_times(
    n: int,
    rate: float,
    rng: np.random.Generator,
    process: str = "poisson",
    burstiness: float = 4.0,
    period_s: float | None = None,
) -> np.ndarray:
    """``n`` increasing arrival offsets (seconds from t0) with mean rate
    ``rate`` under the named process.

    ``bursty``: two-state MMPP. The lull state offers ``rate/burstiness``;
    the burst state offers ``2*rate - rate/burstiness`` so equal expected
    dwell in each state preserves the mean. Dwells are exponential with mean
    ~20 arrivals, so a run of a few hundred requests sees several
    burst/lull cycles.

    ``diurnal``: inhomogeneous Poisson via thinning against the peak rate of
    a sinusoidal day trace ``rate * (1 + depth*sin(2*pi*t/period))`` with
    ``depth = 1 - 1/burstiness`` (burstiness 4 -> peak/trough ratio 7); the
    ``period_s`` default compresses ~2 "days" into the run.
    """
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(
            f"unknown arrival process {process!r} (have {ARRIVAL_PROCESSES})"
        )
    if rate <= 0 or n < 1:
        raise ValueError(f"need rate > 0 and n >= 1, got rate={rate}, n={n}")
    if process == "poisson":
        return np.cumsum(rng.exponential(1.0 / rate, n))
    b = max(1.0, float(burstiness))
    if process == "bursty":
        r_lull = rate / b
        r_burst = 2.0 * rate - r_lull  # equal dwell -> mean stays `rate`
        dwell_mean = 20.0 / rate  # ~20 arrivals per state visit
        rates = (r_lull, r_burst)
        state = int(rng.integers(2))
        t, next_switch = 0.0, float(rng.exponential(dwell_mean))
        out = np.empty(n)
        for i in range(n):
            while True:
                gap = float(rng.exponential(1.0 / rates[state]))
                if t + gap < next_switch:
                    t += gap
                    break
                # no arrival before the state flips: a gap drawn at the old
                # rate must not overrun the new dwell (lull-rate gaps would
                # swallow whole bursts and drag the realized mean under
                # `rate`) — truncate at the switch and resample at the new
                # state's rate; exponentials are memoryless, so this is the
                # exact MMPP law, not an approximation
                t = next_switch
                state ^= 1
                next_switch = t + float(rng.exponential(dwell_mean))
            out[i] = t
        return out
    # diurnal: thinning at the trace's peak rate
    depth = 1.0 - 1.0 / b
    period = float(period_s) if period_s else max(n / rate / 2.0, 1e-3)
    r_max = rate * (1.0 + depth)
    out = np.empty(n)
    t, i = 0.0, 0
    while i < n:
        t += float(rng.exponential(1.0 / r_max))
        r_t = rate * (1.0 + depth * np.sin(2.0 * np.pi * t / period))
        if rng.uniform() * r_max <= r_t:
            out[i] = t
            i += 1
    return out


# the request stream's tag in the generator's seed: never the training grid's
# stream (seeded with data.seed alone) nor the eval sweep's
_REQUEST_STREAM = 0x52455153


def _request_generator(cfg: ExperimentConfig, *key: int) -> torch.Generator:
    words = (int(cfg.data.seed), _REQUEST_STREAM, *(int(k) for k in key))
    seed = int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))
    return torch.Generator().manual_seed(seed)


def make_request_samples(
    cfg: ExperimentConfig,
    n: int,
    drift_at: int | None = None,
    drift_step: int = 0,
    drift_scenario: int = 0,
) -> dict[str, np.ndarray]:
    """``n`` request samples past the training range, round-robin over the
    scenario and user grid (``qdml_tpu/serve/loadgen.py:139-196``), drawn on
    the CPU: ``x`` (pilot images, NHWC), ``h_perf`` (ground truth) and
    ``indicator`` (true scenario), as host arrays.

    Drift (``drift_at`` with ``drift_step > 0``): requests from index
    ``drift_at`` on come from the drifted family table (the geometry with
    ``drift_step`` / ``drift_scenario`` through ``dataclasses.replace``),
    and every other one of them from the drifting family; ``None`` (or
    ``drift_step=0``) is the stationary stream."""
    geom = ChannelGeometry.from_config(cfg.data)
    i = torch.arange(n)
    scen = i % cfg.data.n_scenarios
    user = (i // cfg.data.n_scenarios) % cfg.data.n_users
    start = cfg.data.data_len * 3

    def _gen(geom_, scen_, user_, part):
        batch = make_network_batch(
            _request_generator(cfg, start, part), scen_, user_, cfg.data.snr_db, geom_
        )
        return (
            batch["yp_img"].numpy().astype(np.float32),
            batch["h_perf"].numpy().astype(np.float32),
            batch["indicator"].numpy(),
        )

    if drift_at is None or drift_step <= 0 or drift_at >= n:
        x, h_perf, ind = _gen(geom, scen, user, 0)
        return {"x": x, "h_perf": h_perf, "indicator": ind}
    if not (0 <= drift_scenario < cfg.data.n_scenarios):
        raise ValueError(
            f"drift_scenario must be a scenario id < {cfg.data.n_scenarios}, "
            f"got {drift_scenario}"
        )
    k = max(0, int(drift_at))
    geom_d = dataclasses.replace(geom, drift_step=int(drift_step), drift_scenario=int(drift_scenario))
    # post-drift mix: every other request from the drifting family
    j = i[k:]
    scen_d = torch.where((j - k) % 2 == 0, torch.full_like(j, drift_scenario), scen[k:])
    parts = [_gen(geom, scen[:k], user[:k], 0)] if k else []
    parts.append(_gen(geom_d, scen_d, user[k:], 1))
    x, h_perf, ind = (np.concatenate(cols) for cols in zip(*parts))
    return {"x": x, "h_perf": h_perf, "indicator": ind}


def _trace_reconciliation(pairs: list[tuple[float, float]]) -> dict | None:
    """Phase-sum vs end-to-end reconciliation over traced requests: ``pairs``
    of (observed total, sum of reported phase durations), each element
    measured on ONE clock (the total on the observer's clock, the phases as
    durations on their own producers' clocks — durations compare across
    hosts; timestamps never do). The
    ``unattributed`` residual is stack/scheduling time no phase claims —
    honest, never re-labeled as wire."""
    if not pairs:
        return None
    n = len(pairs)
    tot = sum(t for t, _ in pairs)
    ph = sum(p for _, p in pairs)
    return {
        "n": n,
        "mean_latency_ms": round(tot / n * 1e3, 3),
        "mean_phase_sum_ms": round(ph / n * 1e3, 3),
        "mean_unattributed_ms": round((tot - ph) / n * 1e3, 3),
        "attributed_fraction": round(ph / tot, 4) if tot > 0 else None,
    }


def _window_stats(
    ids: list[int],
    done: dict,
    offline_h: np.ndarray,
    offline_pred: np.ndarray,
    h_perf: np.ndarray,
    indicator: np.ndarray,
    drift_scenario: int | None = None,
) -> dict | None:
    """Parity/NMSE/confidence stats over one id window of completed results —
    the per-phase view the drift story needs (pre- vs post-drift vs
    recovered), same math as the run-level figures."""
    ids = [i for i in ids if i in done]
    if not ids:
        return None
    served_h = np.stack([done[i].h for i in ids])
    off_h, off_p = offline_h[ids], offline_pred[ids]
    pow_ = float(np.sum(h_perf[ids] ** 2))
    confs = [done[i].confidence for i in ids if done[i].confidence is not None]
    out = {
        "n": len(ids),
        "parity_max_abs_err": float(np.max(np.abs(served_h - off_h))),
        "pred_agreement": float(
            np.mean([done[i].scenario == int(off_p[k]) for k, i in enumerate(ids)])
        ),
        "nmse_db_served": nmse_db(
            float(np.sum((served_h - h_perf[ids]) ** 2)) / pow_
        ),
        "nmse_db_offline": nmse_db(float(np.sum((off_h - h_perf[ids]) ** 2)) / pow_),
        "conf_mean": round(float(np.mean(confs)), 4) if confs else None,
    }
    if drift_scenario is not None:
        # the drifting family's own served NMSE (rows by TRUE scenario): the
        # number the fine-tune must move and the canary must not regress
        rows = [k for k, i in enumerate(ids) if int(indicator[i]) == drift_scenario]
        if rows:
            pw = float(np.sum(h_perf[np.asarray(ids)[rows]] ** 2))
            out["nmse_db_drift_scenario"] = nmse_db(
                float(np.sum((served_h[rows] - h_perf[np.asarray(ids)[rows]]) ** 2))
                / pw
            )
    return out


def run_loadgen(
    cfg: ExperimentConfig,
    engine: ServeEngine,
    rate: float = 200.0,
    n: int = 256,
    seed: int = 0,
    deadline_ms: float | None = None,
    logger=None,
    process: str | None = None,
    replicas: int | None = None,
    pool: ReplicaPool | None = None,
    drift_at: int | None = None,
    samples: dict | None = None,
    results: list | None = None,
) -> dict:
    """Drive a warmed (or about-to-be-warmed) engine with open-loop traffic
    (``qdml_tpu/serve/loadgen.py:258-543``).

    The offline parity reference runs before ``engine.warmup()`` re-arms the
    request-path work counters, so the gate measures serving alone.
    ``process`` selects the arrival process (default ``cfg.serve.arrival``);
    ``replicas`` sizes the :class:`~qdml_tpu_torch.serve.server.ReplicaPool`
    (default ``cfg.serve.replicas``, each with ``cfg.serve.workers``
    workers), whose metrics the summary merges exactly. ``samples``
    (:func:`make_request_samples`'s dict, at least ``n`` rows) replaces the
    generated requests; ``results``, a list, receives every result that
    resolved, each with its request's index as ``rid`` (a caller holding the
    served answers against a twin on another device).

    ``drift_at`` injects channel-family drift from the traffic side
    (``serve.drift_step`` / ``serve.drift_scenario`` shape it): the summary
    grows a ``windows`` block (pre/post-drift parity, NMSE and confidence)
    and a ``drift`` block.

    ``pool`` attaches to an existing started pool instead of creating one;
    the summary's per-request stats are then rebuilt from this run's results
    alone, the request-path work is the delta across the traffic window,
    and the caller keeps the pool (no stop)."""
    process = process or cfg.serve.arrival
    if process not in ARRIVAL_PROCESSES:
        # fail on the config typo before the restore and warmup are spent
        raise ValueError(
            f"unknown arrival process {process!r} (have {ARRIVAL_PROCESSES})"
        )
    drift_step = int(cfg.serve.drift_step)
    drift_scen = int(cfg.serve.drift_scenario)
    drifting = drift_at is not None and drift_step > 0
    if samples is None:
        samples = make_request_samples(
            cfg, n,
            drift_at=drift_at if drifting else None,
            drift_step=drift_step, drift_scenario=drift_scen,
        )
    x, h_perf = samples["x"][:n], samples["h_perf"][:n]
    indicator = samples["indicator"][:n]

    external_pool = pool is not None
    with span("loadgen_offline_reference", n=n):
        offline_h, offline_pred, _offline_conf = engine.offline_forward(x)
    if external_pool:
        if not engine._warm:
            raise ValueError("run_loadgen(pool=...) requires a started (warmed) pool")
        warm = None
        work_before = engine.request_path_work()
    else:
        with span("serve_warmup", buckets=list(engine.buckets)):
            warm = engine.warmup()

    sink = None if logger is None else logger.telemetry
    if not external_pool:
        pool = ReplicaPool(
            engine, replicas=replicas, sink=sink, log_requests=n <= 2048
        ).start()
    rng = np.random.default_rng(seed)
    arrivals = arrival_times(
        n, rate, rng, process=process, burstiness=cfg.serve.burstiness
    )

    futures = []
    t0 = time.perf_counter()
    with span("loadgen_traffic", rate_rps=rate, n=n, process=process):
        for i in range(n):
            lag = t0 + arrivals[i] - time.perf_counter()
            if lag > 0:
                time.sleep(lag)  # open loop: schedule by the arrival clock only
            futures.append(pool.submit(x[i], rid=i, deadline_ms=deadline_ms))
        # the offered window ends when the last request was offered: the
        # drain must not dilute the offered rate
        offered_elapsed = time.perf_counter() - t0
        # a future that resolves with a failure is a typed error the client
        # saw (failed_requests); one that never resolves is a stranded client
        # (stranded_futures, which must stay 0). Neither aborts the run.
        resolved = []
        stranded = 0
        failed = 0
        for f in futures:
            try:
                resolved.append(f.result(timeout=60.0))
            except FuturesTimeout:
                stranded += 1
            except Exception:  # lint: disable=broad-except(a worker-forwarded failure can be ANY engine/chaos exception type: the measurement counts the typed closure the client saw and keeps measuring)
                failed += 1
    if results is not None:
        results.extend(resolved)
    if external_pool:
        work_after = engine.request_path_work()
        cache_after = {k: max(0, v - work_before.get(k, 0)) for k, v in work_after.items()}
    else:
        pool.stop()
        cache_after = engine.request_path_work()
    # end-of-run poll of the live metrics view, folded slim: only the fields
    # the verb adds to the summary below
    live = pool.live_metrics()
    live_slim = {
        k: live.get(k)
        for k in (
            "workers", "replicas", "replica_completed",
            "queue_depth_now", "buckets", "completed", "swap_epoch",
            "phases", "trace",
        )
    }

    done = {r.rid: r for r in resolved if isinstance(r, Prediction)}
    shed = [r for r in resolved if not isinstance(r, Prediction)]
    parity_max = 0.0
    nmse_served = nmse_offline = None
    pred_agree = None
    if done:
        ids = sorted(done)
        served_h = np.stack([done[i].h for i in ids])
        off_h, off_p = offline_h[ids], offline_pred[ids]
        parity_max = float(np.max(np.abs(served_h - off_h)))
        pred_agree = float(
            np.mean([done[i].scenario == int(off_p[k]) for k, i in enumerate(ids)])
        )
        pow_ = float(np.sum(h_perf[ids] ** 2))
        nmse_served = nmse_db(float(np.sum((served_h - h_perf[ids]) ** 2)) / pow_)
        nmse_offline = nmse_db(float(np.sum((off_h - h_perf[ids]) ** 2)) / pow_)

    if external_pool:
        # this RUN's window only: the pool's collectors span its whole
        # lifetime (other runs, controller probes), so replay the results
        # into a fresh collector — latency/SLO/scenario stats exact, batch
        # fill/queue depth unknowable here and reported null
        metrics_all = ServeMetrics(sink=sink, log_requests=False)
        metrics_all._t0 = t0
        for r in resolved:
            if isinstance(r, Prediction):
                metrics_all.observe_prediction(r)
            else:
                metrics_all.observe_shed(r, had_deadline=deadline_ms is not None)
        metrics_all.completed = len(done)
        # goodput is exact from results alone (observe_prediction counted the
        # useful rows); the dispatch-side row ledger is not — rows_dispatched
        # stays 0, so padding_waste reports None, never a fabricated perfect
        # fill
    else:
        # aggregate across every replica's every worker (== the single loop's
        # metrics when replicas=workers=1); any one collector alone would
        # undercount the pool
        metrics_all = pool.merged_metrics(sink=sink)
    summary = metrics_all.summary(
        compile_cache=cache_after,
        # the device type served on: a CPU run compared against a card's
        # compares hardware, not code
        platform=engine.device.type,
        offered_rps=round(n / offered_elapsed, 2),
        target_rps=rate,
        n_requests=n,
        n_shed=len(shed),
        # resilience accounting: a stranded future is a client hung
        # forever and must stay 0;
        # failed_requests resolved WITH a typed error (clients saw closure)
        stranded_futures=stranded,
        failed_requests=failed,
        breaker=None if pool.breaker is None else pool.breaker.summary(),
        arrival={"process": process, "burstiness": cfg.serve.burstiness},
        deadline_ms=deadline_ms,
        parity_max_abs_err=parity_max,
        pred_agreement=pred_agree,
        nmse_db_served=nmse_served,
        nmse_db_offline=nmse_offline,
        # fleet facts: aggregate rps is the `rps` field
        # above; topology makes "scaled out" vs "sped up" attributable
        replicas=pool.n_replicas,
        workers=pool.workers,
        mesh=engine.mesh_topology(),
        # scenario scale-out facts: how many expert families this fleet
        # serves, which routing dispatch the race baked into the buckets,
        # and the observed sparse overflow-fallback rate
        n_scenarios=cfg.data.n_scenarios,
        dispatch=engine.dispatch_summary(),
        # which batching mode each tier serves (measured or forced) and
        # whether the feed admitted continuously
        batching=engine.batching_summary(),
        bucket_sharding=engine.bucket_sharding or None,
        warmup=warm,
        server_metrics=live_slim,
    )
    if drifting:
        summary["drift"] = {
            "at": int(drift_at),
            "step": drift_step,
            "scenario": drift_scen,
        }
        # chunked sub-windows ride along so a controller harness can replay
        # the run as a SEQUENCE of windowed measurements (the nmse_parity
        # drift detector consumes windows, not one aggregate)
        chunk = max(24, n // 12)
        chunks = []
        for lo in range(0, n, chunk):
            st = _window_stats(
                list(range(lo, min(lo + chunk, n))), done, offline_h,
                offline_pred, h_perf, indicator,
                drift_scenario=drift_scen,
            )
            if st is not None:
                st["start"] = lo
                st["pre_drift"] = lo + chunk <= int(drift_at)
                chunks.append(st)
        summary["windows"] = {
            "pre_drift": _window_stats(
                list(range(int(drift_at))), done, offline_h, offline_pred,
                h_perf, indicator, drift_scenario=drift_scen,
            ),
            "post_drift": _window_stats(
                list(range(int(drift_at), n)), done, offline_h, offline_pred,
                h_perf, indicator, drift_scenario=drift_scen,
            ),
            "chunks": chunks,
        }
    if summary.get("rps") is not None and pool.n_replicas:
        summary["rps_per_replica"] = round(summary["rps"] / pool.n_replicas, 2)
    if summary.get("trace"):
        # phase sums vs the same requests' end-to-end latencies (both on the
        # batcher clock here — the in-process path is single-clock by
        # construction)
        summary["trace"]["reconciliation"] = _trace_reconciliation(
            [
                (r.latency_s, r.trace.phase_sum_s())
                for r in resolved
                if isinstance(r, Prediction) and r.trace is not None
            ]
        )
    metrics_all.flush(
        compile_cache=cache_after, workers=pool.workers, replicas=pool.n_replicas
    )
    if logger is not None:
        logger.telemetry.write_raw(summary)
    return summary


def run_loadgen_socket(
    cfg: ExperimentConfig,
    address: tuple[str, int],
    rate: float = 200.0,
    n: int = 256,
    seed: int = 0,
    deadline_ms: float | None = None,
    logger=None,
    process: str | None = None,
    clients: int = 8,
    timeout_s: float = 30.0,
    retries: int = 3,
    x: np.ndarray | None = None,
    results: list | None = None,
) -> dict:
    """Open-loop traffic over the socket protocol against a running server
    (``qdml_tpu/serve/loadgen.py:546-750``).

    The wire twin of :func:`run_loadgen`: ``clients``
    :class:`~qdml_tpu_torch.serve.client.ServeClient` connections offer
    requests on the arrival clock, each exchange with the client's retry
    discipline, so a transient reset is recorded (``reconnects`` /
    ``retries``) instead of aborting the run, and a retried id never
    dispatches twice (server-side dedup). Latency is measured client-side,
    wire to wire; sheds come from typed replies; ``server_metrics`` from an
    end-of-run ``{"op": "metrics"}`` poll, which carries the server's
    request-path work, faults, restarts and breaker. ``x`` overrides the
    request samples; ``results``, when given, is extended with each
    request's reply (None for a give-up), in request order. Pointed at a
    fleet router (:mod:`qdml_tpu_torch.fleet`), the summary keeps its
    per-backend rows and the router's own ledger."""
    process = process or cfg.serve.arrival
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(
            f"unknown arrival process {process!r} (have {ARRIVAL_PROCESSES})"
        )
    from concurrent.futures import ThreadPoolExecutor

    from qdml_tpu_torch.serve.client import ServeClient, ServeClientError

    if x is None:
        x = make_request_samples(cfg, n)["x"]
    host, port = address
    pool = [
        ServeClient(
            host, port, timeout_s=timeout_s, retries=retries, seed=seed + i
        )
        for i in range(max(1, int(clients)))
    ]
    rng = np.random.default_rng(seed)
    arrivals = arrival_times(
        n, rate, rng, process=process, burstiness=cfg.serve.burstiness
    )
    metrics = ServeMetrics(
        sink=None if logger is None else logger.telemetry, log_requests=False
    )
    # ONE collector shared by every client thread: ServeMetrics is
    # single-thread by contract (the serve loop gives each worker its own),
    # so the harness serializes its bookkeeping — read-modify-write counter
    # interleavings would silently undercount the very numbers the chaos
    # gates read (SLO rows, sheds)
    mlock = lockdep.Lock("loadgen:mlock")
    shed_counts: dict[str, int] = {}
    give_ups = 0
    replies: list[dict | None] = [None] * n
    # (client wall, reported phase-duration sum) per traced reply — the
    # reconciliation input; wall is THIS clock, phases are durations, no
    # cross-host timestamp ever differenced
    trace_pairs: list[tuple[float, float]] = []

    def _one(i: int) -> None:
        client = pool[i % len(pool)]
        t_req = time.perf_counter()
        try:
            rep = client.request(
                x[i], rid=f"lg{seed}-{i}", deadline_ms=deadline_ms
            )
        except ServeClientError:
            # counted via the client's give_ups ledger; a give-up under an
            # offered deadline is an SLO miss (the client never got a usable
            # answer within its budget)
            if deadline_ms is not None:
                with mlock:
                    metrics.slo_total += 1
            return
        replies[i] = rep
        wall = time.perf_counter() - t_req
        if rep.get("ok"):
            # a traced reply's phase spans fold into the client-side phase
            # histograms RAW (exact quantiles live harness-side), and its
            # wall/phase-sum pair feeds the reconciliation fact
            tr = TraceContext.from_wire(rep.get("trace"))
            p = Prediction(
                rid=rep.get("id"),
                h=np.asarray(rep.get("h", ()), np.float32),
                scenario=int(rep.get("pred", -1)),
                latency_s=wall,
                bucket=int(rep.get("bucket", 0)),
                batch_n=0,
                deadline_met=(
                    None if deadline_ms is None else wall * 1e3 <= deadline_ms
                ),
                confidence=None,
                trace=tr,
            )
            with mlock:
                metrics.observe_prediction(p)
                if tr is not None:
                    trace_pairs.append((wall, tr.phase_sum_s()))
        else:
            reason = str(rep.get("reason", "error"))
            with mlock:
                shed_counts[reason] = shed_counts.get(reason, 0) + 1
                if deadline_ms is not None:
                    metrics.slo_total += 1  # typed rejection under an SLO = a miss

    t0 = time.perf_counter()
    with span("loadgen_socket_traffic", rate_rps=rate, n=n, process=process):
        with ThreadPoolExecutor(max_workers=len(pool)) as ex:
            jobs = []
            for i in range(n):
                lag = t0 + arrivals[i] - time.perf_counter()
                if lag > 0:
                    time.sleep(lag)
                jobs.append(ex.submit(_one, i))
            offered_elapsed = time.perf_counter() - t0
            stranded = 0
            for j in jobs:
                try:
                    j.result(timeout=timeout_s * (retries + 2))
                except FuturesTimeout:
                    stranded += 1  # a client call that never returned at all
    give_ups = sum(c.give_ups for c in pool)
    server_metrics = None
    try:
        server_metrics = pool[0].metrics().get("metrics")
    except (ServeClientError, ConnectionError, OSError):
        pass  # end-of-run observability poll is best-effort
    for c in pool:
        c.close_connection()
    if results is not None:
        results.extend(replies)

    metrics.completed = sum(1 for r in replies if r is not None and r.get("ok"))
    metrics.shed = dict(shed_counts)
    metrics._t0 = t0
    summary = metrics.summary(
        compile_cache=(server_metrics or {}).get("compile_cache_after_warmup"),
        platform=None,  # the server's device is in server_metrics, not known here
        transport="socket",
        offered_rps=round(n / offered_elapsed, 2),
        target_rps=rate,
        n_requests=n,
        n_shed=sum(shed_counts.values()),
        stranded_futures=stranded,
        give_ups=give_ups,
        # deadline-exhausted give-ups are typed SLO misses (the client
        # honored its budget); the DIFFERENCE — retries exhausted against a
        # live server — is the resilience signal the chaos checks gate on
        deadline_give_ups=sum(c.deadline_give_ups for c in pool),
        # the resilience ledger the reconnect-instead-of-abort bugfix exists
        # to report: transient resets during the window, retries spent
        reconnects=sum(c.reconnects for c in pool),
        retries=sum(c.retries_used for c in pool),
        clients=len(pool),
        arrival={"process": process, "burstiness": cfg.serve.burstiness},
        deadline_ms=deadline_ms,
        # lifted from the server poll so the report's breaker gate reads
        # socket summaries exactly like in-process ones
        breaker=(server_metrics or {}).get("breaker"),
        server_metrics=(
            None
            if server_metrics is None
            else {
                k: server_metrics.get(k)
                for k in (
                    "workers", "replicas", "replica_completed", "queue_depth_now",
                    "buckets", "completed", "swap_epoch", "faults", "restarts",
                    "breaker",
                    # the server/fleet-side trace decomposition rides the
                    # SAME end-of-run poll — no second verb round-trip per
                    # committed window
                    "phases", "trace",
                )
                # fleet-router poll: the per-host rows and the router's own
                # ledger ride along with the merged counters — never a
                # blended blob
            } | (
                {
                    k: server_metrics.get(k)
                    for k in ("fleet", "backends_polled", "per_backend")
                }
                if server_metrics.get("fleet")
                else {}
            )
        ),
        **(
            {"router": (server_metrics or {}).get("router")}
            if (server_metrics or {}).get("router")
            else {}
        ),
    )
    if summary.get("trace"):
        summary["trace"]["reconciliation"] = _trace_reconciliation(trace_pairs)
    if logger is not None:
        logger.telemetry.write_raw(summary)
    return summary
