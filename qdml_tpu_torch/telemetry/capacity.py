"""Trace-replay capacity planner: ``plan`` (a copy of
``qdml_tpu/telemetry/capacity.py``).

The question at fleet scale is "how many backends hold X rps at p99 <= Y
ms". A discrete-event queue model of the batcher -> engine -> fetch
pipeline answers it from recorded windows, never from a live system:

- **service-time distributions**: each phase's quantile summary
  (``{n, mean_ms, p50_ms, p95_ms, p99_ms, max_ms}``, the ``phases`` block a
  traced loadgen writes into its ``serve_summary``) becomes an inverse-CDF
  piecewise-linear distribution (:class:`QuantileDist`);
- **arrival replay**: arrivals re-synthesize the window's arrival process
  (``arrival.process`` + ``offered_rps`` + ``n_requests`` from its
  summary): Poisson, MMPP bursts or uniform, seeded;
- **the queue core**: :func:`simulate_queue`, a c-server FIFO
  discrete-event simulation (Lindley recursion over a free-server heap),
  held against the exact M/D/1 waiting-time CDF (Crommelin's formula,
  :func:`md1_wait_cdf`) and the M/M/1 closed form;
- **validation** (``plan --validate``): replay each window against itself.
  Phase distributions + the unattributed residual + replayed arrivals must
  reproduce the window's measured client p99 within a factor of
  :data:`P99_BAND` either way and its throughput within
  :data:`RPS_BAND_FRAC`. Windows without phase spans validate through the
  router's merged wire-latency distribution, in a wider band;
- **planning** (``plan --target-rps=X --p99-ms=Y``): sweep backend counts;
  per candidate the simulation makes queue wait endogenous (service = the
  compute distribution at ``workers`` servers per backend, the other phases
  ride along as exogenous adders) and answers with the predicted p99.

The numbers are the JAX package's on the same windows and seeds (stdlib
``random`` only), so a window either package's loadgen wrote plans the
same. :func:`emit_target`'s record is what
:func:`~qdml_tpu_torch.control.fleet_scale.load_planner_target` reads.

Host-side only: ``plan`` dispatches before the CLI parses a config or
resolves a device, like ``report``.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import math
import random

#: validation band: predicted p99 within this factor of measured (either way)
P99_BAND = 2.0
#: wire-mode band: the router's wire span cannot see client-side connection
#: queueing (a client stalling before the front socket inflates the measured
#: client tail with time no server/router span contains; the JAX package
#: set this band from its own CPU fleet windows), so the weaker model gets
#: an order-of-magnitude band; throughput stays at the tight RPS_BAND_FRAC,
#: and the phase-span windows the PLANNER consumes hold the 2x P99_BAND
WIRE_P99_BAND = 6.0
#: validation band: predicted throughput within this fraction of measured
RPS_BAND_FRAC = 0.15

#: the routed request pipeline's phases, in span order (telemetry/tracing.py
#: PHASES + the router tier's wire/pick)
PHASE_ORDER = ("batch_wait", "queue_wait", "compute", "fetch", "wire", "pick")


class QuantileDist:
    """Inverse-CDF piecewise-linear distribution through committed
    quantile points. The q=0 anchor is set below p50 (at p50/4) — the
    artifacts do not carry a minimum, and anchoring at 0 would bias the
    body of a tight distribution downward."""

    def __init__(self, points: list[tuple[float, float]]):
        pts = sorted((float(q), max(0.0, float(v))) for q, v in points)
        if not pts or pts[0][0] > 0.0:
            lo = pts[0][1] if pts else 0.0
            pts.insert(0, (0.0, lo * 0.25))
        self.points = pts

    @classmethod
    def from_summary(cls, ph: dict | None) -> "QuantileDist | None":
        """From a committed ``{p50_ms, p95_ms, p99_ms, max_ms}`` block
        (phase summaries and Histogram.summary() share the shape)."""
        if not ph or ph.get("p50_ms") is None:
            return None
        pts = [(0.5, ph["p50_ms"])]
        for q, key in ((0.95, "p95_ms"), (0.99, "p99_ms"), (1.0, "max_ms")):
            if ph.get(key) is not None:
                pts.append((q, ph[key]))
        return cls(pts)

    def quantile(self, q: float) -> float:
        pts = self.points
        if q <= pts[0][0]:
            return pts[0][1]
        for (q0, v0), (q1, v1) in zip(pts, pts[1:]):
            if q <= q1:
                if q1 == q0:
                    return v1
                w = (q - q0) / (q1 - q0)
                return v0 + w * (v1 - v0)
        return pts[-1][1]

    def sample(self, rng: random.Random) -> float:
        return self.quantile(rng.random())

    def mean(self) -> float:
        """Mean of the piecewise-linear CDF (trapezoid over segments)."""
        total = 0.0
        for (q0, v0), (q1, v1) in zip(self.points, self.points[1:]):
            total += (q1 - q0) * (v0 + v1) / 2.0
        return total


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


# ---------------------------------------------------------------------------
# arrivals + the queue core
# ---------------------------------------------------------------------------


def replay_arrivals(
    n: int,
    rate: float,
    process: str = "poisson",
    burstiness: float = 1.0,
    seed: int = 0,
) -> list[float]:
    """Re-synthesize the traced arrival process: ``n`` arrival times at
    mean ``rate``/s. Poisson draws exponential interarrivals; mmpp
    modulates between a hot state (rate * burstiness) and a cold state
    (balancing the mean); uniform is the deterministic pacer."""
    rng = random.Random(seed)
    if rate <= 0 or n <= 0:
        return [0.0] * max(0, n)
    out: list[float] = []
    t = 0.0
    if process == "uniform":
        step = 1.0 / rate
        return [i * step for i in range(n)]
    if process == "mmpp" and burstiness > 1.0:
        hot = rate * burstiness
        cold = rate / burstiness
        phase_len = max(4, n // 8)
        for i in range(n):
            r = hot if (i // phase_len) % 2 == 0 else cold
            t += rng.expovariate(r)
            out.append(t)
        return out
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def simulate_queue(
    arrivals: list[float], services: list[float], servers: int = 1
) -> list[float]:
    """c-server FIFO queue by discrete-event simulation: returns each
    job's queue WAIT (start - arrival), in arrival order. The free-server
    heap is the c-server generalization of the Lindley recursion; tests
    pin it against the exact M/D/1 and M/M/1 waiting-time laws."""
    free = [0.0] * max(1, int(servers))
    heapq.heapify(free)
    waits = []
    for t, s in zip(arrivals, services):
        f = heapq.heappop(free)
        start = f if f > t else t
        waits.append(start - t)
        heapq.heappush(free, start + s)
    return waits


# -- closed forms (the queue core's ground truth in tests) -------------------


def md1_wait_cdf(t: float, lam: float, d: float) -> float:
    """Exact M/D/1 waiting-time CDF (Crommelin):
    ``P(W <= t) = (1-rho) * sum_{j=0}^{floor(t/d)}
    (lam*(j*d - t))^j / j! * exp(-lam*(j*d - t))``. Stable in float64 for
    the moderate-utilization regimes the tests use (the alternating terms
    stay far from cancellation at rho <= ~0.8, t/d <= ~30)."""
    if t < 0:
        return 0.0
    rho = lam * d
    if rho >= 1.0:
        return 0.0
    k = int(t // d)
    s = 0.0
    for j in range(k + 1):
        u = lam * (j * d - t)  # <= 0
        s += (u ** j) / math.factorial(j) * math.exp(-u)
    return max(0.0, min(1.0, (1.0 - rho) * s))


def md1_wait_quantile(q: float, lam: float, d: float) -> float:
    """Invert :func:`md1_wait_cdf` numerically (bisection)."""
    lo, hi = 0.0, d
    while md1_wait_cdf(hi, lam, d) < q:
        hi *= 2.0
        if hi > 1e6 * d:
            return hi
    for _ in range(80):
        mid = (lo + hi) / 2.0
        if md1_wait_cdf(mid, lam, d) < q:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


def mm1_sojourn_quantile(q: float, lam: float, mu: float) -> float:
    """M/M/1 sojourn (wait + service) quantile: exponential with rate
    ``mu - lam``."""
    return -math.log(1.0 - q) / (mu - lam)


# ---------------------------------------------------------------------------
# artifact models
# ---------------------------------------------------------------------------


def load_summary(path: str) -> dict:
    """The window's ``serve_summary`` record from a committed JSONL."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "serve_summary":
                return rec
    raise ValueError(f"no serve_summary record in {path}")


def window_model(summary: dict) -> dict:
    """What the committed window supports: ``mode='phases'`` when the
    window carries phase spans (trace sampling on), else ``mode='wire'``
    when the router's exactly-merged wire-latency distribution is there,
    else ``mode=None`` (not validatable)."""
    phases = {
        name: QuantileDist.from_summary((summary.get("phases") or {}).get(name))
        for name in PHASE_ORDER
    }
    phases = {k: v for k, v in phases.items() if v is not None}
    lat = summary.get("latency_ms") or {}
    recon = ((summary.get("trace") or {}).get("reconciliation")) or {}
    if phases:
        # unattributed residual: client-measured mean minus the phase-sum
        # mean — client-side overhead the spans cannot see, carried as a
        # constant shift (reconciliation block when present, else derived)
        resid = recon.get("mean_unattributed_ms")
        if resid is None and lat.get("mean_ms") is not None:
            resid = max(
                0.0,
                lat["mean_ms"] - sum(d.mean() for d in phases.values()),
            )
        return {"mode": "phases", "phases": phases,
                "residual_ms": float(resid or 0.0)}
    wire = QuantileDist.from_summary(
        ((summary.get("router") or {}).get("wire_latency_ms"))
    )
    if wire is not None:
        resid = 0.0
        if lat.get("mean_ms") is not None:
            resid = max(0.0, lat["mean_ms"] - wire.mean())
        return {"mode": "wire", "phases": {"wire": wire},
                "residual_ms": float(resid)}
    return {"mode": None, "phases": {}, "residual_ms": 0.0}


def _measured(summary: dict) -> dict:
    lat = summary.get("latency_ms") or {}
    return {
        "n": int(summary.get("n_requests") or summary.get("completed") or 0),
        "rps": float(summary.get("rps") or 0.0),
        "offered_rps": float(
            summary.get("offered_rps") or summary.get("rps") or 0.0
        ),
        "p99_ms": lat.get("p99_ms"),
        "mean_ms": lat.get("mean_ms"),
        "process": ((summary.get("arrival") or {}).get("process")) or "poisson",
        "burstiness": float(
            ((summary.get("arrival") or {}).get("burstiness")) or 1.0
        ),
    }


def validate_window(path: str, n_samples: int = 20000, seed: int = 0) -> dict:
    """Self-replay one committed window: sample every phase (plus the
    residual), replay the arrival process, and compare the predicted
    client p99 + throughput against the window's own measurements."""
    summary = load_summary(path)
    model = window_model(summary)
    meas = _measured(summary)
    row = {"path": path, "mode": model["mode"],
           "measured_p99_ms": meas["p99_ms"], "measured_rps": meas["rps"]}
    if model["mode"] is None or not meas["p99_ms"] or meas["n"] <= 0:
        row.update(predicted_p99_ms=None, p99_ratio=None, ok=None,
                   note="window carries neither phase spans nor wire quantiles")
        return row
    rng = random.Random(seed * 7919 + 13)
    totals = []
    for _ in range(n_samples):
        totals.append(
            sum(d.sample(rng) for d in model["phases"].values())
            + model["residual_ms"]
        )
    totals.sort()
    pred_p99 = _percentile(totals, 0.99)
    pred_mean = sum(totals) / len(totals)
    # throughput: replay the arrivals, complete each at arrival + sampled
    # latency; the predicted rate is requests over the completion span
    arr = replay_arrivals(meas["n"], meas["offered_rps"], meas["process"],
                          meas["burstiness"], seed=seed)
    rng2 = random.Random(seed * 104729 + 7)
    done = [
        t + (sum(d.sample(rng2) for d in model["phases"].values())
             + model["residual_ms"]) / 1e3
        for t in arr
    ]
    span = max(done) - min(arr) if done else 0.0
    pred_rps = meas["n"] / span if span > 0 else 0.0
    p99_ratio = pred_p99 / meas["p99_ms"]
    rps_err = abs(pred_rps - meas["rps"]) / meas["rps"] if meas["rps"] else None
    band = P99_BAND if model["mode"] == "phases" else WIRE_P99_BAND
    ok = (
        abs(math.log(p99_ratio)) <= math.log(band)
        and rps_err is not None and rps_err <= RPS_BAND_FRAC
    )
    row.update(
        predicted_p99_ms=round(pred_p99, 3),
        predicted_mean_ms=round(pred_mean, 3),
        measured_mean_ms=meas["mean_ms"],
        predicted_rps=round(pred_rps, 2),
        p99_ratio=round(p99_ratio, 4),
        rps_err=None if rps_err is None else round(rps_err, 4),
        band={"p99_factor": band, "rps_frac": RPS_BAND_FRAC},
        ok=ok,
    )
    return row


def validate_windows(paths: list[str], n_samples: int = 20000,
                     seed: int = 0) -> dict:
    rows = [validate_window(p, n_samples=n_samples, seed=seed) for p in paths]
    judged = [r for r in rows if r.get("ok") is not None]
    ratios = [abs(math.log(r["p99_ratio"])) for r in judged if r.get("p99_ratio")]
    errs = [r["rps_err"] for r in judged if r.get("rps_err") is not None]
    return {
        "rows": rows,
        "n_windows": len(judged),
        "ok": bool(judged) and all(r["ok"] for r in judged),
        "max_p99_ratio": (
            round(math.exp(max(ratios)), 4) if ratios else None
        ),
        "max_rps_err": round(max(errs), 4) if errs else None,
        "band": {"p99_factor": P99_BAND, "wire_p99_factor": WIRE_P99_BAND,
                 "rps_frac": RPS_BAND_FRAC},
    }


# ---------------------------------------------------------------------------
# planning sweep
# ---------------------------------------------------------------------------


def plan_backends(
    trace_path: str,
    target_rps: float,
    p99_ms: float,
    max_backends: int = 8,
    workers: int = 1,
    n_samples: int = 4000,
    seed: int = 0,
) -> dict:
    """Sweep fleet sizes against a target: for each candidate backend
    count the DES makes queue wait ENDOGENOUS — arrivals at the target
    rate hash-split across backends, each backend a ``workers``-server
    queue whose service is the traced compute(+fetch) distribution — and
    the other phases ride along as exogenous adders. Returns the sweep
    table and the smallest fleet meeting the p99 target (None when even
    ``max_backends`` misses it)."""
    summary = load_summary(trace_path)
    model = window_model(summary)
    if model["mode"] != "phases":
        raise ValueError(
            f"{trace_path} carries no phase spans — plan needs a traced "
            "window (serve.trace_sample > 0)"
        )
    phases = model["phases"]
    service_d = [d for name, d in phases.items() if name in ("compute", "fetch")]
    adders = [d for name, d in phases.items()
              if name not in ("compute", "fetch", "queue_wait")]
    rows = []
    answer = None
    for k in range(1, max(1, int(max_backends)) + 1):
        rng = random.Random(seed * 31 + k)
        per = max(1, n_samples // k)
        lam = target_rps / k
        all_latency: list[float] = []
        stable = True
        for _b in range(k):
            arr = replay_arrivals(per, lam, "poisson", seed=rng.randrange(1 << 30))
            svc = [sum(d.sample(rng) for d in service_d) / 1e3 for _ in range(per)]
            mean_svc = sum(svc) / len(svc) if svc else 0.0
            rho = lam * mean_svc / max(1, workers)
            if rho >= 0.98:
                stable = False
            waits = simulate_queue(arr, svc, servers=workers)
            for w, s in zip(waits, svc):
                extra = sum(d.sample(rng) for d in adders)
                all_latency.append(
                    (w + s) * 1e3 + extra + model["residual_ms"]
                )
        all_latency.sort()
        pred = _percentile(all_latency, 0.99)
        meets = stable and pred <= p99_ms
        rows.append({
            "backends": k,
            "per_backend_rps": round(lam, 2),
            "utilization": round(rho, 4),
            "stable": stable,
            "predicted_p99_ms": round(pred, 3),
            "meets_target": meets,
        })
        if meets and answer is None:
            answer = k
    return {
        "trace": trace_path,
        "target_rps": target_rps,
        "p99_target_ms": p99_ms,
        "workers_per_backend": workers,
        "sweep": rows,
        "backends_needed": answer,
    }


def emit_target(plan_rec: dict) -> dict:
    """The planner->autoscaler handoff record (``plan --emit-target``):
    the answer (``backends_needed``) plus everything it was conditioned on
    — target, workers, trace path — sealed under ``assumptions_sha``, a
    sha256 over the canonical planning inputs AND the full sweep table.
    The fleet autoscaler (control/fleet_scale.py) records the sha in every
    ``fleet_scale_event`` it emits while obeying this target, so a
    decision trail always says WHICH planning run it was obeying; a re-plan
    against a different trace or target changes the sha even when the
    answer count happens to match."""
    basis = {
        "trace": plan_rec["trace"],
        "target_rps": plan_rec["target_rps"],
        "p99_target_ms": plan_rec["p99_target_ms"],
        "workers_per_backend": plan_rec["workers_per_backend"],
        "sweep": plan_rec["sweep"],
    }
    sha = hashlib.sha256(
        json.dumps(basis, sort_keys=True).encode()
    ).hexdigest()
    return {
        "backends_needed": plan_rec["backends_needed"],
        "target_rps": plan_rec["target_rps"],
        "p99_target_ms": plan_rec["p99_target_ms"],
        "workers_per_backend": plan_rec["workers_per_backend"],
        "trace": plan_rec["trace"],
        "assumptions_sha": sha,
    }


# ---------------------------------------------------------------------------
# CLI: plan
# ---------------------------------------------------------------------------


def _arg(argv: list[str], name: str, default):
    return next(
        (a.split("=", 1)[1] for a in argv if a.startswith(f"--{name}=")),
        default,
    )


def plan_main(argv: list[str]) -> int:
    """``plan --trace=W1.jsonl[,W2.jsonl...] --validate
    [--json=out.json] [--seed=0]`` gates every window's self-replay
    inside the band (exit 0 iff all pass); ``plan
    --trace=traced.jsonl --target-rps=X --p99-ms=Y [--max-backends=8]
    [--workers=1]`` answers the capacity question; add
    ``--emit-target=target.json`` to also write the sealed
    planner->autoscaler handoff record (:func:`emit_target`). Host-side
    only."""
    traces = [p for p in (_arg(argv, "trace", "") or "").split(",") if p]
    if not traces:
        print("plan needs --trace=<window.jsonl>[,more.jsonl]")
        return 2
    seed = int(_arg(argv, "seed", "0"))
    out_json = _arg(argv, "json", None)
    if any(a == "--validate" for a in argv):
        rep = validate_windows(traces, seed=seed)
        print(json.dumps({"plan_validation": rep}, indent=2))
        if out_json:
            with open(out_json, "w") as fh:
                json.dump(rep, fh, indent=2)
        return 0 if rep["ok"] else 3
    target = _arg(argv, "target-rps", None)
    p99 = _arg(argv, "p99-ms", None)
    if target is None or p99 is None:
        print("plan needs --validate, or --target-rps=X with --p99-ms=Y")
        return 2
    rep = plan_backends(
        traces[0], float(target), float(p99),
        max_backends=int(_arg(argv, "max-backends", "8")),
        workers=int(_arg(argv, "workers", "1")),
        seed=seed,
    )
    print(json.dumps({"plan": rep}, indent=2))
    if out_json:
        with open(out_json, "w") as fh:
            json.dump(rep, fh, indent=2)
    target_json = _arg(argv, "emit-target", None)
    if target_json:
        # emitted even when backends_needed is None (the autoscaler's
        # loader refuses the null — an unmeetable plan must fail LOUDLY
        # at consumption, not silently vanish at emission)
        with open(target_json, "w") as fh:
            json.dump({"fleet_target": emit_target(rep)}, fh, indent=2)
    return 0 if rep["backends_needed"] is not None else 3
