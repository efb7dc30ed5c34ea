"""``report``: regression-aware markdown summary over telemetry files
(a full copy of ``qdml_tpu/telemetry/report.py``).

Loads one or more *current* artifacts (telemetry/metrics JSONL with a manifest
header, a bench one-line record, a committed ``results/bench_tpu_*.json``, or
a driver ``BENCH_rNN.json`` wrapper) plus one *baseline* artifact, extracts
every throughput metric both sides share, and emits a markdown delta table.
Exits nonzero (:data:`EXIT_REGRESSION`) when any shared metric regressed by
more than the threshold. The data and exit code are the JAX package's on the
same artifacts, so either package's ``report`` reads either's files; a
manifest whose ``jax`` block is null (the port's) is read from its ``torch``
block.

Platform honesty: artifacts from two platforms are not comparable; when the
two sides ran on different platforms the deltas are still reported but the
gate is disarmed, with a note saying so.

Usage (via the CLI, host-side: no device, no config parsing):

    python -m qdml_tpu_torch.cli report --current=PATH[,PATH...] --baseline=PATH \
        [--threshold=10] [--out=report.md]
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

# Per-implementation QSC sub-benches (qsc_dense, qsc_pallas, ... — NOT the
# scan-fused variants, which measure a different program). These are
# implementation-race entrants, not independent workloads: the gate compares
# best-of-impls on each side, so a fixed impl losing ground (or being
# retired) cannot fail CI while a faster dispatch is available — the exact
# "gating on a losing fixed impl" failure the autotuned dispatcher removes.
# qsc_auto is deliberately NOT demoted: the auto-dispatched path IS the
# train/serve hot path, so a qsc_auto regression (e.g. a stale table
# dispatching a loser while a fixed impl still measures fast) must fail the
# gate like any other hot-path metric — it still feeds best-of-impls too.
_QSC_IMPL_RE = re.compile(r"^qsc_(?!auto\.)(?!.*scan)[^.]+\.samples_per_sec$")
_QSC_BEST_RE = re.compile(r"^qsc_(?!.*scan)[^.]+\.samples_per_sec$")
QSC_BEST_KEY = "qsc.best_of_impls"

EXIT_OK = 0
EXIT_USAGE = 2
EXIT_REGRESSION = 3

DEFAULT_THRESHOLD_PCT = 10.0


def _iter_objs(path: str) -> list[Any]:
    """Parse a file as one JSON value or as JSONL; skip unparseable lines."""
    with open(path) as fh:
        text = fh.read().strip()
    if not text:
        return []
    try:
        return [json.loads(text)]
    except json.JSONDecodeError:
        pass
    objs = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            objs.append(json.loads(line))
        except json.JSONDecodeError:
            continue
    return objs


def _record_from(obj: dict) -> dict | None:
    """A bench-style record from a raw object, unwrapping driver wrappers."""
    if "metric" in obj and "value" in obj:
        return obj
    parsed = obj.get("parsed")
    if isinstance(parsed, dict) and "metric" in parsed:
        return parsed
    tail = obj.get("tail")
    if isinstance(tail, str):
        for line in reversed(tail.strip().splitlines()):
            try:
                cand = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(cand, dict) and "metric" in cand:
                return cand
    return None


def _serving_from(obj: dict) -> dict | None:
    """Latency/throughput/SLO/fleet numbers from a ``serve_summary``
    telemetry record (the loadgen harness writes one per run). Latency
    percentiles live in a separate namespace from throughput because their
    regression sign is inverted: serving got WORSE when latency went UP.
    SLO attainment inverts the other way (a DROP is the regression), and the
    fleet block (replicas × devices) makes rps deltas attributable to
    scale-out vs speed-up."""
    if obj.get("kind") != "serve_summary":
        return None
    out: dict = {
        "latency": {},
        "rps": None,
        "platform": obj.get("platform"),
        "phases": None,
        "trace": None,
        "slo_attainment": None,
        "fleet": None,
        "n_scenarios": None,
        "dispatch": None,
        "overflow_rate": None,
        "goodput_rps": None,
        "padding_waste": None,
        "batching": None,
        "stranded_futures": None,
        "breaker_open_fraction": None,
        "router": None,
    }
    lat = obj.get("latency_ms") or {}
    for key in ("p50_ms", "p95_ms", "p99_ms"):
        if isinstance(lat.get(key), (int, float)):
            out["latency"][key] = float(lat[key])
    if isinstance(obj.get("rps"), (int, float)):
        out["rps"] = float(obj["rps"])
    # goodput-first serving metrics (ragged-batching PR): useful-rows/s gates
    # like rps (lower = regression); padding waste — the dispatched-row
    # fraction XLA computed for nothing — gates absolutely like the sparse
    # overflow rate (near-zero baselines make ratios meaningless)
    if isinstance(obj.get("goodput_rps"), (int, float)):
        out["goodput_rps"] = float(obj["goodput_rps"])
    if isinstance(obj.get("padding_waste"), (int, float)):
        out["padding_waste"] = float(obj["padding_waste"])
    batching = obj.get("batching")
    if isinstance(batching, dict):
        out["batching"] = {
            "mode": batching.get("mode"),
            "continuous_admission": batching.get("continuous_admission"),
        }
    # resilience metrics (fault-tolerance PR): stranded futures gate
    # always-armed at 0 (a client hung forever is a protocol violation on
    # any hardware); the breaker open fraction gates absolutely like the
    # overflow rate (healthy runs sit at 0.0 — ratios are meaningless)
    if isinstance(obj.get("stranded_futures"), int):
        out["stranded_futures"] = obj["stranded_futures"]
    brk = obj.get("breaker")
    if isinstance(brk, dict) and isinstance(
        brk.get("open_fraction"), (int, float)
    ):
        out["breaker_open_fraction"] = float(brk["open_fraction"])
    # per-phase latency decomposition (request tracing, docs/TELEMETRY.md):
    # the sampled traced fraction's batch_wait/queue_wait/compute/fetch/wire
    # histograms plus the coverage fact — the report's attribution input (a
    # p99 move gates per phase, so it is blamed on the phase that moved)
    phases = obj.get("phases")
    if isinstance(phases, dict):
        ph = {k: v for k, v in phases.items() if isinstance(v, dict)}
        out["phases"] = ph or None
    tr = obj.get("trace")
    if isinstance(tr, dict):
        out["trace"] = tr
    slo = obj.get("slo")
    if isinstance(slo, dict) and isinstance(slo.get("attainment"), (int, float)):
        out["slo_attainment"] = float(slo["attainment"])
    fleet = {}
    if isinstance(obj.get("replicas"), int):
        fleet["replicas"] = obj["replicas"]
    if isinstance(obj.get("workers"), int):
        fleet["workers"] = obj["workers"]
    mesh = obj.get("mesh")
    if isinstance(mesh, dict) and isinstance(mesh.get("devices"), int):
        fleet["devices"] = mesh["devices"]
    if isinstance(obj.get("rps_per_replica"), (int, float)):
        fleet["rps_per_replica"] = float(obj["rps_per_replica"])
    out["fleet"] = fleet or None
    # scenario scale-out facts (sparse-dispatch PR): expert-family count,
    # the routing mode the warmup race baked in, and the sparse
    # overflow-fallback rate — a rising rate is an O(S) compute leak the
    # gate must catch even while rps still looks healthy
    if isinstance(obj.get("n_scenarios"), int):
        out["n_scenarios"] = obj["n_scenarios"]
    disp = obj.get("dispatch")
    if isinstance(disp, dict):
        out["dispatch"] = {
            "mode": disp.get("mode"),
            "capacity_factor": disp.get("capacity_factor"),
        }
        if isinstance(disp.get("overflow_rate"), (int, float)):
            out["overflow_rate"] = float(disp["overflow_rate"])
    # fleet-router facts (docs/FLEET.md): a loadgen window measured THROUGH
    # the router tier carries the router's own ledger — backend count,
    # balancing policy, failovers/ejections — so the fleet line names the
    # topology the latency/goodput deltas were measured across
    rt = obj.get("router")
    if isinstance(rt, dict):
        out["router"] = {
            "backends": rt.get("backends"),
            "backends_live": rt.get("backends_live"),
            "balance": rt.get("balance"),
            "failovers": rt.get("failovers"),
            "ejections": rt.get("ejections"),
            "dedup_hits": rt.get("dedup_hits"),
        }
    return out


def extract(path: str) -> dict:
    """Pull ``{manifest, record, throughput, serving, cost, platform}`` out
    of one artifact. ``cost`` maps a program key (a bench sub-bench name, a
    train-loop ``cost`` record name, or ``serve_bucket[N]``) to its XLA cost
    block (:func:`qdml_tpu_torch.telemetry.cost.counting` record shape)."""
    src: dict = {
        "path": path,
        "manifest": None,
        "record": None,
        "throughput": {},
        "serving": None,
        "cost": {},
        "roofline": {},
        "host_transfers": {},
        "platform": None,
        "qsc_scaling": None,
        "scenario_scaling": None,
        "monitor": None,
    }
    for obj in _iter_objs(path):
        if not isinstance(obj, dict):
            continue
        if obj.get("kind") == "manifest":
            # last wins: an appended/resumed stream carries one manifest per
            # invocation, and the last record belongs to the last invocation
            src["manifest"] = obj
            continue
        if obj.get("kind") == "monitor_summary":
            # the flight deck's end-of-attachment rollup (qdml-tpu monitor):
            # burn-rate peaks, alert counts by mark/signal, planner
            # validation — last wins like every other summary record
            src["monitor"] = obj
            continue
        if obj.get("kind") == "cost" and obj.get("name"):
            key = str(obj["name"])
            if obj.get("bucket") is not None:
                key = f"{key}[{obj['bucket']}]"
            src["cost"][key] = obj  # last record per program wins
            continue
        serving = _serving_from(obj)
        if serving is not None:
            src["serving"] = serving  # last serve_summary wins
            if serving["rps"] is not None:
                # completed-request throughput rides the existing gate
                # (lower = regression, same as samples/sec)
                src["throughput"]["serve.rps"] = serving["rps"]
            if serving["goodput_rps"] is not None:
                # goodput (useful-rows/s) rides the same gate: padded rows
                # never count, so a mode that pads more cannot inflate it
                src["throughput"]["serve.goodput_rps"] = serving["goodput_rps"]
            if serving["platform"] and not src["platform"]:
                # serving-only artifacts carry their backend too, so the
                # platform-mismatch disarm covers latency gates (a bench
                # record in the same stream keeps precedence)
                src["platform"] = serving["platform"]
            continue
        rec = _record_from(obj)
        if rec is not None:
            src["record"] = rec  # last record in the stream wins
    rec = src["record"]
    if rec is not None:
        src["platform"] = rec.get("platform") or src["platform"]
        if isinstance(rec.get("value"), (int, float)):
            src["throughput"][rec.get("metric") or "value"] = float(rec["value"])
        for key, d in (rec.get("details") or {}).items():
            if not isinstance(d, dict):
                continue
            if key == "qsc_scaling" and isinstance(d.get("points"), list):
                # The qubit-scaling axis: each point's measured number is
                # already best-of-impls AT THAT n (the dispatcher raced the
                # candidates and the winner was timed), so every n-bucket
                # gates as its own throughput metric — n=16 regressing
                # cannot hide behind n=6 improving. The zero-padded key
                # keeps the table sorted by qubit count.
                src["qsc_scaling"] = d
                for p in d["points"]:
                    if isinstance(p, dict) and isinstance(
                        p.get("samples_per_sec"), (int, float)
                    ):
                        nk = f"qsc_scaling.n{int(p['n_qubits']):02d}"
                        src["throughput"][f"{nk}.best_of_impls"] = float(
                            p["samples_per_sec"]
                        )
                continue
            if key == "scenario_scaling" and isinstance(d.get("points"), list):
                # The scenario-scaling axis, gated exactly like the qubit
                # one: each point's measured number is already
                # best-of-dispatch AT THAT S (the routing race timed the
                # loser too), so every S-bucket gates as its own metric —
                # S=64 regressing cannot hide behind S=3 improving.
                src["scenario_scaling"] = d
                for p in d["points"]:
                    if isinstance(p, dict) and isinstance(
                        p.get("samples_per_sec"), (int, float)
                    ):
                        sk = f"scenario_scaling.s{int(p['n_scenarios']):02d}"
                        src["throughput"][f"{sk}.best_of_dispatch"] = float(
                            p["samples_per_sec"]
                        )
                continue
            if isinstance(d.get("samples_per_sec"), (int, float)):
                src["throughput"][f"{key}.samples_per_sec"] = float(d["samples_per_sec"])
            if isinstance(d.get("cost"), dict):
                src["cost"][key] = d["cost"]
            # achieved-vs-roofline fraction (bench train records since the
            # latency-floor PR): gated with an inverted-improvement sign —
            # the fraction DROPPING is the regression
            roof = d.get("roofline")
            if isinstance(roof, dict) and isinstance(roof.get("fraction"), (int, float)):
                src["roofline"][key] = float(roof["fraction"])
            # steady-state host transfers inside the timed loop: 0 by
            # construction; any reappearance is a program-property failure
            if isinstance(d.get("host_transfers"), (int, float)):
                src["host_transfers"][key] = int(d["host_transfers"])
    # Synthesized best-of-impls QSC metric: the regression gate for the
    # quantum classifier compares the fastest implementation measured on each
    # side (the per-impl rows stay in the table, informational).
    impl_vals = [v for k, v in src["throughput"].items() if _QSC_BEST_RE.match(k)]
    if impl_vals:
        src["throughput"][QSC_BEST_KEY] = max(impl_vals)
    return src


def _manifest_line(src: dict) -> str | None:
    man = src.get("manifest")
    if not man:
        return None
    jx = man.get("jax") or man.get("torch") or {}
    bits = []
    if man.get("config_hash"):
        bits.append(f"config `{man['config_hash']}`")
    if man.get("git"):
        sha = man["git"].get("sha", "")[:12]
        bits.append(f"git `{sha}`" + ("*" if man["git"].get("dirty") else ""))
    if jx.get("backend"):
        bits.append(
            f"{jx.get('device_count', '?')}x {jx.get('backend')} "
            f"({jx.get('process_count', 1)} proc)"
        )
    knobs = man.get("knobs")
    if knobs:
        bits.append(
            "knobs rng={rng_impl}/trig={trig_impl}/moments={moments_dtype}".format(**knobs)
        )
    if not bits:
        return None
    return f"  - manifest `{os.path.basename(src['path'])}`: " + ", ".join(bits)


def _pct(cur: float, base: float) -> float | None:
    """Relative delta, or None for a zero baseline — a ratio against zero is
    undefined, and the alternative (float inf) leaks bare ``Infinity`` into
    the strict-JSON ``--json`` gate output."""
    return (cur - base) / base * 100.0 if base else None


def _cost_deltas(base_cost: dict, cur_cost: dict) -> dict | None:
    """FLOPs/bytes deltas between two available cost blocks; None when either
    side has no comparable numbers."""
    out = {}
    for field in ("flops", "bytes_accessed"):
        b, c = base_cost.get(field), cur_cost.get(field)
        if isinstance(b, (int, float)) and isinstance(c, (int, float)) and b:
            out[field] = {"baseline": b, "current": c, "delta_pct": round(_pct(c, b), 2)}
    return out or None


# A regressed benchmark whose program also changed by more than this is
# flagged "program change" — the regression may be MORE work, not slower
# execution of the same work.
PROGRAM_CHANGE_PCT = 1.0

# Absolute slack on the sparse-dispatch overflow-fallback rate (fraction of
# routed rows): healthy runs sit at/near 0.0, so the gate compares absolute
# rates, not ratios — 2 points of new overflow is a capacity-factor misfit
# worth failing on, whatever the baseline was.
OVERFLOW_RATE_SLACK = 0.02

# Absolute slack on the serving padding-waste fraction (padded rows /
# dispatched rows), gated like the overflow rate and for the same reason: a
# well-tiered deployment sits near 0 where ratios explode. 5 points of new
# padding is a tier ladder (or admission policy) that no longer fits the
# traffic's fill distribution — FLOPs burned on rows nobody asked for.
PADDING_WASTE_SLACK = 0.05

# Absolute slack on the circuit-breaker open fraction (fast-failed submits /
# offered submits), same absolute-comparison rationale: a healthy window
# sits at 0.0. 5 points of new brownout means the breaker spent a
# meaningful share of the window open — either the watermarks misfit the
# traffic or capacity regressed under it.
BREAKER_OPEN_SLACK = 0.05


def _lint_gate(lint_path: str | None) -> dict | None:
    """Row data from a lint gate's ``--json`` artifact: the port's own
    (``python -m qdml_tpu_torch.cli lint --json=F``), or the JAX package's,
    which has the same schema. The lint gate is host-side static analysis:
    platform disarm rules never apply to it."""
    if lint_path is None:
        return None
    try:
        with open(lint_path) as fh:
            lint = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return {"path": lint_path, "ok": False, "new_findings": None,
                "error": f"{type(e).__name__}: {e}"}
    return {
        "path": lint_path,
        "ok": bool(lint.get("ok")) and int(lint.get("new_findings") or 0) == 0,
        "new_findings": int(lint.get("new_findings") or 0),
        "suppressed": lint.get("suppressed"),
        "baselined": lint.get("baselined"),
        "per_rule": lint.get("per_rule") or {},
        "error": None,
    }


def build_report_data(
    current_paths: list[str],
    baseline_path: str,
    threshold_pct: float = DEFAULT_THRESHOLD_PCT,
    lint_path: str | None = None,
) -> dict:
    """Full machine-readable report: markdown + per-gate rows + cost deltas.

    Returns ``{"markdown", "gates", "regressions", "gate_armed",
    "disarm_reason", "cost", "threshold_pct", ...}`` — the ``--json`` output
    is this dict minus the markdown, so CI consumes the same resolution the
    human-facing table shows (no markdown parsing)."""
    base = extract(baseline_path)
    curs = [extract(p) for p in current_paths]
    cur_tp: dict[str, float] = {}
    for c in curs:
        cur_tp.update(c["throughput"])
    cur_cost: dict[str, dict] = {}
    for c in curs:
        cur_cost.update(c["cost"])
    gates: list[dict] = []
    cost_rows: list[dict] = []
    disarm_reason: str | None = None
    # Platform resolution must match the value resolution (later files win a
    # shared metric, so the later file's platform labels the merged set);
    # heterogeneous current platforms disarm the gate below.
    cur_platforms = [c["platform"] for c in curs if c["platform"]]
    cur_platform = cur_platforms[-1] if cur_platforms else None

    lines = [
        "# qdml-tpu telemetry report",
        "",
        f"- baseline: `{baseline_path}`"
        + (f" (platform {base['platform']})" if base["platform"] else ""),
        "- current: " + ", ".join(f"`{p}`" for p in current_paths)
        + (f" (platform {cur_platform})" if cur_platform else ""),
        f"- regression threshold: {threshold_pct:g}%",
    ]
    for src in [base] + curs:
        man_line = _manifest_line(src)
        if man_line:
            lines.append(man_line)
    lines.append("")

    regressions: list[dict] = []
    gate_armed = True
    transfer_failed = False
    stranded_failed = False
    monitor_failed = False

    # Lint gate (the `cli lint --json` artifact): folded in alongside the perf
    # gates so CI reads ONE exit code. Static analysis is host-side — the
    # platform-mismatch disarm below never applies to this row, and a lint
    # failure alone forces the regression exit code (report_main).
    lint = _lint_gate(lint_path)
    if lint is not None:
        if lint["error"]:
            status, detail = "regression", f"unreadable lint artifact: {lint['error']}"
        elif lint["ok"]:
            status = "ok"
            detail = (
                f"0 new findings ({lint['suppressed']} suppressed, "
                f"{lint['baselined']} baselined)"
            )
        else:
            status = "regression"
            per_rule = ", ".join(f"{k}: {v}" for k, v in lint["per_rule"].items())
            detail = f"{lint['new_findings']} new finding(s) — {per_rule or 'see artifact'}"
        gates.append(
            {"metric": "lint.new_findings", "kind": "lint",
             "baseline": 0, "current": lint["new_findings"],
             "delta_pct": None, "status": status}
        )
        lines.append(f"- lint gate (`{lint['path']}`): **{status}** — {detail}")
        lines.append("")
        if status == "regression":
            regressions.append(
                {"metric": "lint.new_findings", "baseline": 0,
                 "current": lint["new_findings"], "delta_pct": None}
            )

    if len(set(cur_platforms)) > 1:
        gate_armed = False
        disarm_reason = (
            f"current artifacts span platforms {sorted(set(cur_platforms))}"
        )
        lines.append(
            f"> **note**: current artifacts span platforms {sorted(set(cur_platforms))} "
            "— merged deltas are not attributable to one platform, regression "
            "gate disarmed."
        )
        lines.append("")
    elif base["platform"] and cur_platform and base["platform"] != cur_platform:
        gate_armed = False
        disarm_reason = (
            f"platform mismatch: baseline {base['platform']} vs current {cur_platform}"
        )
        lines.append(
            f"> **note**: platform mismatch (baseline {base['platform']} vs "
            f"current {cur_platform}) — deltas shown, regression gate disarmed "
            "(cross-platform throughput ratios compare hardware/contention, "
            "not code)."
        )
        lines.append("")

    def _data(note: str | None = None) -> dict:
        return {
            "schema": 1,
            "baseline": baseline_path,
            "current": list(current_paths),
            "threshold_pct": threshold_pct,
            "baseline_platform": base["platform"],
            "current_platform": cur_platform,
            "gate_armed": gate_armed,
            "disarm_reason": disarm_reason,
            "gates": gates,
            "regressions": regressions,
            "cost": cost_rows,
            "lint": lint,
            # lint failures force the regression exit even when the perf gate
            # is platform-disarmed: static analysis ran on THIS host's source
            "lint_failed": bool(lint is not None and not lint["ok"]),
            # a reappearing steady-state host transfer is a PROGRAM property
            # (the bench loop is transfer-free by construction), so like lint
            # it forces the regression exit even under platform disarm
            "transfer_failed": transfer_failed,
            # a stranded future (a client hung forever) violates the serving
            # protocol's resolution invariant on ANY hardware — always-armed
            # like lint, forces the regression exit under platform disarm
            "stranded_failed": stranded_failed,
            # monitor invariants (alert expectations + planner validation)
            # are correctness properties of the observability stack itself —
            # always-armed like lint/stranded, forces the regression exit
            "monitor_failed": monitor_failed,
            "note": note,
            "markdown": "\n".join(lines),
        }

    if not base["throughput"]:
        lines.append(
            "_baseline carries no throughput metrics (nothing to gate; "
            "e.g. a targets-only BASELINE.json)._"
        )
        return _data("baseline carries no throughput metrics")
    if not cur_tp:
        # A baseline with numbers and a current run that measured NOTHING is
        # a gate failure, not a pass: the fully-errored bench path still
        # writes a record (value null, error-only details), and CI must not
        # promote it. Armed regardless of platform tags — "nothing measured"
        # is a failure on any hardware.
        lines.append(
            "_current artifacts carry no throughput metrics — **gate fails**: "
            "an all-errored run cannot demonstrate the absence of a "
            "regression._"
        )
        regressions.append(
            {"metric": "(no throughput measured)", "baseline": None,
             "current": None, "delta_pct": None}
        )
        # the sentinel is a real gate row too: --json consumers iterating
        # `gates` must see WHAT failed, not just exit_code 3
        gates.append(
            {"metric": "(no throughput measured)", "kind": "throughput",
             "baseline": None, "current": None, "delta_pct": None,
             "status": "regression"}
        )
        gate_armed, disarm_reason = True, None
        return _data("current artifacts carry no throughput metrics")

    lines += [
        "| metric | baseline | current | delta | status |",
        "|---|---|---|---|---|",
    ]
    for key in sorted(set(base["throughput"]) | set(cur_tp)):
        b = base["throughput"].get(key)
        c = cur_tp.get(key)
        if b is None or c is None:
            only = "current-only" if b is None else "baseline-only"
            gates.append(
                {"metric": key, "kind": "throughput", "baseline": b,
                 "current": c, "delta_pct": None, "status": only}
            )
            lines.append(
                f"| {key} | {'—' if b is None else f'{b:g}'} | "
                f"{'—' if c is None else f'{c:g}'} | — | {only} |"
            )
            continue
        delta_pct = _pct(c, b)
        program_change = None
        if delta_pct is None:
            gates.append(
                {"metric": key, "kind": "throughput", "baseline": b, "current": c,
                 "delta_pct": None, "status": "zero-baseline"}
            )
            lines.append(f"| {key} | {b:g} | {c:g} | — | zero-baseline |")
            continue
        if delta_pct < -threshold_pct:
            if _QSC_IMPL_RE.match(key):
                # one entrant of the QSC implementation race slowed down;
                # the gate judges the race's winner (qsc.best_of_impls), so
                # a losing fixed impl can no longer fail CI by itself
                gates.append(
                    {"metric": key, "kind": "throughput", "baseline": b,
                     "current": c, "delta_pct": round(delta_pct, 2),
                     "status": "informational"}
                )
                lines.append(
                    f"| {key} | {b:g} | {c:g} | {delta_pct:+.1f}% | "
                    "informational (best-of-impls gates QSC) |"
                )
                continue
            status_key, status_md = "regression", "**REGRESSION**"
            # Perf regression vs program change: when the regressed
            # sub-bench's own XLA cost moved too, the slowdown is (at least
            # partly) MORE WORK, not slower execution of the same program.
            prog = key.rsplit(".", 1)[0]
            deltas = None
            if prog in base["cost"] and prog in cur_cost:
                deltas = _cost_deltas(base["cost"][prog], cur_cost[prog])
            if deltas and any(
                abs(d["delta_pct"]) > PROGRAM_CHANGE_PCT for d in deltas.values()
            ):
                program_change = deltas
                status_key = "regression+program-change"
                status_md += " (program changed)"
            reg = {"metric": key, "baseline": b, "current": c,
                   "delta_pct": round(delta_pct, 2)}
            if program_change:
                reg["program_change"] = program_change
            regressions.append(reg)
        elif delta_pct > threshold_pct:
            status_key = status_md = "improved"
        else:
            status_key = status_md = "ok"
        row = {"metric": key, "kind": "throughput", "baseline": b, "current": c,
               "delta_pct": round(delta_pct, 2), "status": status_key}
        if program_change:
            row["program_change"] = program_change
        gates.append(row)
        lines.append(f"| {key} | {b:g} | {c:g} | {delta_pct:+.1f}% | {status_md} |")

    # Serving-latency section: tail percentiles from serve_summary records.
    # The delta sign is INVERTED relative to throughput — latency going UP
    # beyond the threshold is the regression; the same platform rules arm
    # the gate (cross-platform latencies compare hardware, not code).
    base_lat = (base.get("serving") or {}).get("latency") or {}
    cur_lat: dict[str, float] = {}
    for c_src in curs:
        cur_lat.update((c_src.get("serving") or {}).get("latency") or {})
    if base_lat or cur_lat:
        lines += [
            "",
            "## serving latency",
            "",
        ]
        # fleet topology line: a serve.rps delta between 1 replica on 1
        # device and 4 replicas on 8 is scale-out, not speed-up — name the
        # topologies so the aggregate-rps gate reads attributably
        def _fleet_str(src):
            serving = src.get("serving") or {}
            f = serving.get("fleet")
            if not f and not serving.get("router"):
                return None
            # a socket window measured THROUGH the router tier has no
            # in-process fleet block — the router facts alone still make a
            # fleet line (the topology the numbers were measured across)
            if not f:
                s = "router front"
            else:
                topo = [f"{f.get('replicas', '?')} replica(s)"]
                if f.get("devices"):
                    topo.append(f"{f['devices']} device(s)")
                s = " x ".join(topo)
                if f.get("rps_per_replica") is not None:
                    s += f" ({f['rps_per_replica']:g} rps/replica)"
            # scenario scale-out facts ride the fleet line: expert-family
            # count, which routing dispatch the race baked in, and the
            # sparse overflow-fallback rate when one was measured
            if serving.get("n_scenarios") is not None:
                s += f", S={serving['n_scenarios']}"
            disp = serving.get("dispatch")
            if disp and disp.get("mode"):
                s += f" {disp['mode']}-dispatch"
                if serving.get("overflow_rate") is not None:
                    s += f" (overflow {serving['overflow_rate']:.2%})"
            # batching mode rides the fleet line too: a p99/goodput delta
            # between a bucket fleet and a ragged one is a MODE change, and
            # the reader must see it named (the bucket-vs-ragged dryrun's
            # whole comparison hangs on this label)
            bat = serving.get("batching")
            if bat and bat.get("mode"):
                s += f" {bat['mode']}-batching"
                if serving.get("padding_waste") is not None:
                    s += f" (pad waste {serving['padding_waste']:.2%})"
            # the fleet-router line: a window measured through the router
            # tier names how many hosts it spanned and the balancing policy
            # — a p99 delta across different fan-outs is topology, not code
            rt = serving.get("router")
            if rt and rt.get("backends"):
                s += (
                    f", via router over {rt['backends']} backend(s)"
                    f" [{rt.get('balance', '?')}]"
                )
                if rt.get("backends_live") is not None and (
                    rt["backends_live"] != rt["backends"]
                ):
                    s += f" ({rt['backends_live']} live)"
                if rt.get("failovers"):
                    s += f", {rt['failovers']} failover(s)"
            return s

        base_fleet = _fleet_str(base)
        cur_fleet = next(
            (s for s in (_fleet_str(c) for c in reversed(curs)) if s), None
        )
        if base_fleet or cur_fleet:
            lines.append(
                f"- fleet: baseline {base_fleet or 'n/a'} -> current "
                f"{cur_fleet or 'n/a'}"
            )
            lines.append("")
        lines += [
            "| percentile | baseline | current | delta | status |",
            "|---|---|---|---|---|",
        ]
        for key in ("p50_ms", "p95_ms", "p99_ms"):
            b = base_lat.get(key)
            c = cur_lat.get(key)
            if b is None and c is None:
                continue
            if b is None or c is None:
                only = "current-only" if b is None else "baseline-only"
                gates.append(
                    {"metric": f"serving.{key}", "kind": "latency", "baseline": b,
                     "current": c, "delta_pct": None, "status": only}
                )
                lines.append(
                    f"| {key} | {'—' if b is None else f'{b:g}'} | "
                    f"{'—' if c is None else f'{c:g}'} | — | {only} |"
                )
                continue
            delta_pct = _pct(c, b)
            if delta_pct is None:
                gates.append(
                    {"metric": f"serving.{key}", "kind": "latency", "baseline": b,
                     "current": c, "delta_pct": None, "status": "zero-baseline"}
                )
                lines.append(f"| {key} | {b:g} | {c:g} | — | zero-baseline |")
                continue
            if delta_pct > threshold_pct:
                status_key, status_md = "regression", "**REGRESSION**"
                regressions.append(
                    {"metric": f"serving.{key}", "baseline": b, "current": c,
                     "delta_pct": round(delta_pct, 2)}
                )
            elif delta_pct < -threshold_pct:
                status_key = status_md = "improved"
            else:
                status_key = status_md = "ok"
            gates.append(
                {"metric": f"serving.{key}", "kind": "latency", "baseline": b,
                 "current": c, "delta_pct": round(delta_pct, 2), "status": status_key}
            )
            lines.append(f"| {key} | {b:g} | {c:g} | {delta_pct:+.1f}% | {status_md} |")

    # Phase-decomposition section (request tracing, docs/TELEMETRY.md): the
    # per-phase p99s from the traced sample, each gated EXACTLY like the
    # end-to-end latency percentiles (up beyond threshold = regression, same
    # platform arming rules) — so an end-to-end p99 move is ATTRIBUTED to
    # the phase that moved instead of staying one opaque number. Router-
    # aggregated blocks that carry only exact (n, sum, mean) — quantiles
    # cannot cross a process boundary — contribute no p99 row and are shown
    # as coverage only.
    base_ph = (base.get("serving") or {}).get("phases") or {}
    cur_ph: dict[str, dict] = {}
    cur_trace: dict | None = None
    for c_src in curs:
        s_serving = c_src.get("serving") or {}
        if s_serving.get("phases"):
            cur_ph.update(s_serving["phases"])
        if s_serving.get("trace"):
            cur_trace = s_serving["trace"]
    if base_ph or cur_ph:
        from qdml_tpu_torch.telemetry.tracing import PHASES as _PHASE_ORDER

        lines += ["", "## serving phase decomposition (where the time goes)", ""]
        if cur_trace is not None:
            cov = (
                f"sampled {cur_trace.get('sampled', '?')} of "
                f"{cur_trace.get('completed', '?')} completed requests"
            )
            if isinstance(cur_trace.get("fraction"), (int, float)):
                cov += f" ({cur_trace['fraction']:.1%})"
            rec = cur_trace.get("reconciliation")
            if isinstance(rec, dict) and rec.get("attributed_fraction") is not None:
                cov += (
                    f"; phases attribute {rec['attributed_fraction']:.1%} of "
                    "end-to-end latency"
                )
            lines.append(f"- trace coverage: {cov}")
        lines.append(
            "- clock-skew rule: every phase is a single-clock duration — wire "
            "time is router-measured around its own exchange; two hosts' "
            "clocks are never differenced"
        )
        lines += [
            "",
            "| phase | baseline p99 (ms) | current p99 (ms) | delta | status |",
            "|---|---|---|---|---|",
        ]
        phase_moved: list[str] = []
        names = [p for p in _PHASE_ORDER if p in base_ph or p in cur_ph]
        names += sorted((set(base_ph) | set(cur_ph)) - set(names))
        for name in names:
            b = (base_ph.get(name) or {}).get("p99_ms")
            c = (cur_ph.get(name) or {}).get("p99_ms")
            metric = f"serve.phase.{name}.p99_ms"
            if b is None and c is None:
                continue  # exact-sum-only blocks: no quantile to gate
            if b is None or c is None:
                only = "current-only" if b is None else "baseline-only"
                gates.append(
                    {"metric": metric, "kind": "phase", "baseline": b,
                     "current": c, "delta_pct": None, "status": only}
                )
                lines.append(
                    f"| {name} | {'—' if b is None else f'{b:g}'} | "
                    f"{'—' if c is None else f'{c:g}'} | — | {only} |"
                )
                continue
            delta_pct = _pct(c, b)
            if delta_pct is None:
                gates.append(
                    {"metric": metric, "kind": "phase", "baseline": b,
                     "current": c, "delta_pct": None, "status": "zero-baseline"}
                )
                lines.append(f"| {name} | {b:g} | {c:g} | — | zero-baseline |")
                continue
            if delta_pct > threshold_pct:
                status_key, status_md = "regression", "**REGRESSION**"
                phase_moved.append(f"{name} ({delta_pct:+.1f}%)")
                regressions.append(
                    {"metric": metric, "baseline": b, "current": c,
                     "delta_pct": round(delta_pct, 2)}
                )
            elif delta_pct < -threshold_pct:
                status_key = status_md = "improved"
            else:
                status_key = status_md = "ok"
            gates.append(
                {"metric": metric, "kind": "phase", "baseline": b, "current": c,
                 "delta_pct": round(delta_pct, 2), "status": status_key}
            )
            lines.append(
                f"| {name} | {b:g} | {c:g} | {delta_pct:+.1f}% | {status_md} |"
            )
        if phase_moved:
            e2e = next(
                (r for r in regressions if r["metric"] == "serving.p99_ms"), None
            )
            lines.append("")
            lines.append(
                "- p99 attribution: the "
                + (
                    f"end-to-end p99 move ({e2e['delta_pct']:+.1f}%) "
                    if e2e
                    else "tail move "
                )
                + "is carried by: "
                + ", ".join(phase_moved)
            )

    # Serving-SLO gate: attainment = fraction of deadline-carrying requests
    # answered within their deadline (serve_summary.slo.attainment). The
    # sign works like roofline-fraction: a DROP beyond the threshold is the
    # regression; the same platform rules arm it (attainment under load is a
    # hardware-throughput-shaped number).
    b_slo = (base.get("serving") or {}).get("slo_attainment")
    c_slo = None
    for c_src in curs:
        v = (c_src.get("serving") or {}).get("slo_attainment")
        if v is not None:
            c_slo = v
    if b_slo is not None or c_slo is not None:
        if not (base_lat or cur_lat):
            # an all-shed run can carry an SLO figure with NO latency
            # samples — give the bullet its own section instead of
            # orphaning it under the throughput table
            lines += ["", "## serving"]
        if b_slo is None or c_slo is None:
            only = "current-only" if b_slo is None else "baseline-only"
            gates.append(
                {"metric": "serve.slo_attainment", "kind": "slo", "baseline": b_slo,
                 "current": c_slo, "delta_pct": None, "status": only}
            )
            lines.append(
                f"- serving SLO attainment: "
                f"{'—' if b_slo is None else f'{b_slo:g}'} -> "
                f"{'—' if c_slo is None else f'{c_slo:g}'} ({only})"
            )
        else:
            delta_pct = _pct(c_slo, b_slo)
            if delta_pct is None:
                status_key = status_md = "zero-baseline"
            elif delta_pct < -threshold_pct:
                status_key, status_md = "regression", "**REGRESSION**"
                regressions.append(
                    {"metric": "serve.slo_attainment", "baseline": b_slo,
                     "current": c_slo, "delta_pct": round(delta_pct, 2)}
                )
            elif delta_pct > threshold_pct:
                status_key = status_md = "improved"
            else:
                status_key = status_md = "ok"
            gates.append(
                {"metric": "serve.slo_attainment", "kind": "slo",
                 "baseline": b_slo, "current": c_slo,
                 "delta_pct": None if delta_pct is None else round(delta_pct, 2),
                 "status": status_key}
            )
            lines.append(
                f"- serving SLO attainment: {b_slo:g} -> {c_slo:g} "
                + (f"({delta_pct:+.1f}%) " if delta_pct is not None else "")
                + f"{status_md}"
            )

    # Absolute-slack serving gates (one shared shape, two metrics): both
    # compare ABSOLUTELY, not as ratios — healthy baselines sit at/near 0.0
    # where a relative delta is undefined or explosive. Regression when the
    # current fraction exceeds the baseline by more than the metric's slack.
    def _absolute_gate(field: str, metric: str, kind: str, slack: float,
                       label: str) -> None:
        b_val = (base.get("serving") or {}).get(field)
        c_val = None
        for c_src in curs:
            v = (c_src.get("serving") or {}).get(field)
            if v is not None:
                c_val = v
        if b_val is None and c_val is None:
            return
        if b_val is None or c_val is None:
            only = "current-only" if b_val is None else "baseline-only"
            gates.append(
                {"metric": metric, "kind": kind, "baseline": b_val,
                 "current": c_val, "delta_pct": None, "status": only}
            )
            lines.append(
                f"- {label}: {'—' if b_val is None else f'{b_val:g}'} -> "
                f"{'—' if c_val is None else f'{c_val:g}'} ({only})"
            )
            return
        if c_val > b_val + slack:
            status_key, status_md = "regression", "**REGRESSION**"
            regressions.append(
                {"metric": metric, "baseline": b_val, "current": c_val,
                 "delta_pct": None}
            )
        elif c_val < b_val - slack:
            status_key = status_md = "improved"
        else:
            status_key = status_md = "ok"
        gates.append(
            {"metric": metric, "kind": kind, "baseline": b_val,
             "current": c_val, "delta_pct": None, "status": status_key}
        )
        lines.append(f"- {label}: {b_val:g} -> {c_val:g} {status_md}")

    # Sparse-dispatch overflow: the fraction of routed rows the capacity
    # buckets could NOT hold (served by the dense fallback — never dropped,
    # but each one is O(S) compute for O(1) work); rising = the capacity
    # factor no longer fits the traffic skew.
    _absolute_gate("overflow_rate", "serve.overflow_rate", "dispatch",
                   OVERFLOW_RATE_SLACK, "sparse-dispatch overflow rate")
    # Serving padding waste: the fraction of dispatched rows that were
    # padding (serve_summary.padding_waste — goodput's complement); rising =
    # the tier ladder (or admission policy) no longer fits the traffic's
    # fill levels — compute the goodput gate cannot see while rps still
    # looks healthy.
    _absolute_gate("padding_waste", "serve.padding_waste", "batching",
                   PADDING_WASTE_SLACK, "serving padding waste")
    # Circuit-breaker open fraction: fast-failed submits / offered submits
    # (serve_summary.breaker.open_fraction); rising = the breaker spent a
    # meaningful share of the window browning out — capacity regressed under
    # the traffic, or the watermarks no longer fit it.
    _absolute_gate("breaker_open_fraction", "serve.breaker_open_fraction",
                   "breaker", BREAKER_OPEN_SLACK, "breaker open fraction")

    # Stranded-futures gate: ALWAYS-ARMED, baseline pinned at the invariant
    # (0), like the lint and host-transfer gates — a future that never
    # resolved is a client hung forever, a protocol violation no platform
    # mismatch can excuse. Reported only when the current window measured it
    # (serve_summary.stranded_futures; old baselines without the field never
    # disarm the check).
    c_stranded = None
    for c_src in curs:
        v = (c_src.get("serving") or {}).get("stranded_futures")
        if v is not None:
            c_stranded = v
    if c_stranded is not None:
        st_status = "ok" if c_stranded == 0 else "regression"
        gates.append(
            {"metric": "serve.stranded_futures", "kind": "resilience",
             "baseline": 0, "current": c_stranded, "delta_pct": None,
             "status": st_status}
        )
        lines.append(
            f"- stranded futures (always-armed, invariant 0): {c_stranded} "
            + ("ok" if st_status == "ok" else "**REGRESSION**")
        )
        if st_status == "regression":
            stranded_failed = True
            regressions.append(
                {"metric": "serve.stranded_futures", "baseline": 0,
                 "current": c_stranded, "delta_pct": None}
            )

    # Monitoring section (qdml-tpu monitor, docs/TELEMETRY.md "flight
    # deck"): the burn-rate alerting and the capacity planner are part of
    # the observability stack itself, so their invariants gate ALWAYS-ARMED
    # like lint/stranded — a monitor that fails to page during an injected
    # fault (or pages on a healthy baseline) is broken on any hardware.
    cur_mon = None
    for c_src in curs:
        if c_src.get("monitor") is not None:
            cur_mon = c_src["monitor"]  # last monitor_summary wins
    if cur_mon is not None:
        lines += ["", "## monitoring (flight deck)", ""]
        alerts = cur_mon.get("alerts") or {}
        lines.append(
            f"- monitor: {cur_mon.get('windows', 0)} windows at "
            f"{cur_mon.get('interval_s', 0)}s, "
            f"{cur_mon.get('scrape_errors', 0)} scrape errors, "
            f"{cur_mon.get('counter_resets', 0)} counter resets, "
            f"{alerts.get('fired', 0)} alert(s) fired / "
            f"{alerts.get('resolved', 0)} resolved"
        )
        # peak burn per signal: informational — the alert-expectation gate
        # below is the pass/fail judgment, the peaks say how close it came
        peaks = cur_mon.get("peak_burn") or {}
        hot = {
            s: p for s, p in peaks.items()
            if isinstance(p, dict) and (p.get("fast") or 0) > 0
        }
        if hot:
            lines.append(
                "- peak burn (fast/slow x budget): " + ", ".join(
                    f"{s} {p.get('fast', 0):g}/{p.get('slow', 0):g}"
                    for s, p in sorted(hot.items())
                )
            )
        by_mark = alerts.get("by_mark") or {}
        expect = cur_mon.get("expect") or {}
        for mark in sorted(expect.get("fired") or []):
            fired = int(by_mark.get(mark, 0))
            ok = fired > 0
            gates.append(
                {"metric": f"monitor.alerts[{mark}]", "kind": "monitor",
                 "baseline": 1, "current": fired, "delta_pct": None,
                 "status": "ok" if ok else "regression"}
            )
            lines.append(
                f"- alert expectation `{mark}` (fault injected, >=1 must "
                f"fire): {fired} " + ("ok" if ok else "**REGRESSION**")
            )
            if not ok:
                monitor_failed = True
                regressions.append(
                    {"metric": f"monitor.alerts[{mark}]", "baseline": 1,
                     "current": fired, "delta_pct": None}
                )
        for mark in sorted(expect.get("quiet") or []):
            fired = int(by_mark.get(mark, 0))
            ok = fired == 0
            gates.append(
                {"metric": f"monitor.alerts[{mark}]", "kind": "monitor",
                 "baseline": 0, "current": fired, "delta_pct": None,
                 "status": "ok" if ok else "regression"}
            )
            lines.append(
                f"- alert expectation `{mark}` (healthy window, none may "
                f"fire): {fired} " + ("ok" if ok else "**REGRESSION**")
            )
            if not ok:
                monitor_failed = True
                regressions.append(
                    {"metric": f"monitor.alerts[{mark}]", "baseline": 0,
                     "current": fired, "delta_pct": None}
                )
        planner = cur_mon.get("planner")
        if isinstance(planner, dict):
            p_ok = bool(planner.get("ok"))
            gates.append(
                {"metric": "monitor.planner_validation", "kind": "monitor",
                 "baseline": None, "current": planner.get("max_p99_ratio"),
                 "delta_pct": None,
                 "status": "ok" if p_ok else "regression"}
            )
            band = planner.get("band") or {}
            lines.append(
                f"- planner validation ({planner.get('n_windows', 0)} "
                f"windows, p99 within x{band.get('p99_factor', '?')} "
                f"(wire-mode x{band.get('wire_p99_factor', '?')}), "
                f"rps within {band.get('rps_frac', '?')}): max p99 ratio "
                f"{planner.get('max_p99_ratio')}, max rps err "
                f"{planner.get('max_rps_err')} "
                + ("ok" if p_ok else "**REGRESSION**")
            )
            if not p_ok:
                monitor_failed = True
                regressions.append(
                    {"metric": "monitor.planner_validation", "baseline": None,
                     "current": planner.get("max_p99_ratio"),
                     "delta_pct": None}
                )
        # Event-spine loss ledger (telemetry/events.py): a monitor that
        # tailed the spine commits event_drops = ring evictions + cursor
        # lost. Zero means the committed stream saw EVERY envelope the
        # fleet published — any loss voids the correlation evidence below,
        # so this arms whenever the summary carries the counter.
        drops = cur_mon.get("event_drops")
        if drops is not None:
            d_ok = int(drops) == 0
            gates.append(
                {"metric": "monitor.event_drops", "kind": "monitor",
                 "baseline": 0, "current": int(drops), "delta_pct": None,
                 "status": "ok" if d_ok else "regression"}
            )
            spine = cur_mon.get("spine") or {}
            lines.append(
                f"- event spine: {spine.get('events', 0)} envelope(s) "
                f"tailed, loss ledger {int(drops)} "
                f"(ring {spine.get('ring_dropped', 0)} / cursor "
                f"{spine.get('cursor_lost', 0)}) "
                + ("ok" if d_ok else "**REGRESSION**")
            )
            if not d_ok:
                monitor_failed = True
                regressions.append(
                    {"metric": "monitor.event_drops", "baseline": 0,
                     "current": int(drops), "delta_pct": None}
                )
        # Hands-off loop (telemetry/attach.py): the attachment must never
        # have given up, every decision made under a burn alert must carry
        # the alert-episode id (the by-id join between monitor_alert and
        # fleet_scale_event), and when the dryrun EXPECTS an alert-driven
        # scale-up (expect.scale_up_correlated) at least one up-decision
        # must actually be stamped with an episode.
        hands = cur_mon.get("handsoff")
        if isinstance(hands, dict):
            scale_events = hands.get("scale_events") or []
            uncorrelated = [
                e for e in scale_events
                if e.get("burn_alert") and not e.get("alert_episode")
            ]
            corr_ups = [
                e for e in scale_events
                if e.get("direction") == "up" and e.get("alert_episode")
            ]
            h_ok = hands.get("give_up") is None and not uncorrelated
            if expect.get("scale_up_correlated") and not corr_ups:
                h_ok = False
            gates.append(
                {"metric": "monitor.handsoff", "kind": "monitor",
                 "baseline": None, "current": len(scale_events),
                 "delta_pct": None,
                 "status": "ok" if h_ok else "regression"}
            )
            lines.append(
                f"- hands-off loop: {hands.get('ticks', 0)} tick(s), "
                f"{len(scale_events)} scale decision(s) "
                f"({len(corr_ups)} alert-correlated up), "
                f"{hands.get('reattaches', 0)} reattach(es), give-up "
                f"{'none' if hands.get('give_up') is None else hands['give_up'].get('reason')} "
                + ("ok" if h_ok else "**REGRESSION**")
            )
            if not h_ok:
                monitor_failed = True
                regressions.append(
                    {"metric": "monitor.handsoff", "baseline": None,
                     "current": len(scale_events), "delta_pct": None}
                )

    # Roofline section: achieved-vs-roofline fraction per train sub-bench
    # (bench.py details.*.roofline.fraction — telemetry/cost.py). The sign is
    # inverted like latency in spirit but the metric is a fraction of the
    # hardware ceiling: the fraction DROPPING beyond the threshold is the
    # regression (the fused path slid back toward dispatch-/transfer-bound).
    # Platform rules arm it like throughput — a fraction is measured against
    # THIS platform's ridge, so cross-platform deltas compare hardware.
    base_roof = base.get("roofline") or {}
    cur_roof: dict[str, float] = {}
    for c_src in curs:
        cur_roof.update(c_src.get("roofline") or {})
    if base_roof or cur_roof:
        lines += [
            "",
            "## roofline fraction (achieved / ceiling at program intensity)",
            "",
            "| program | baseline | current | delta | status |",
            "|---|---|---|---|---|",
        ]
        for key in sorted(set(base_roof) | set(cur_roof)):
            b = base_roof.get(key)
            c = cur_roof.get(key)
            metric = f"{key}.roofline_fraction"
            if b is None or c is None:
                only = "current-only" if b is None else "baseline-only"
                gates.append(
                    {"metric": metric, "kind": "roofline", "baseline": b,
                     "current": c, "delta_pct": None, "status": only}
                )
                lines.append(
                    f"| {key} | {'—' if b is None else f'{b:g}'} | "
                    f"{'—' if c is None else f'{c:g}'} | — | {only} |"
                )
                continue
            delta_pct = _pct(c, b)
            if delta_pct is None:
                gates.append(
                    {"metric": metric, "kind": "roofline", "baseline": b,
                     "current": c, "delta_pct": None, "status": "zero-baseline"}
                )
                lines.append(f"| {key} | {b:g} | {c:g} | — | zero-baseline |")
                continue
            if delta_pct < -threshold_pct:
                status_key, status_md = "regression", "**REGRESSION**"
                regressions.append(
                    {"metric": metric, "baseline": b, "current": c,
                     "delta_pct": round(delta_pct, 2)}
                )
            elif delta_pct > threshold_pct:
                status_key = status_md = "improved"
            else:
                status_key = status_md = "ok"
            gates.append(
                {"metric": metric, "kind": "roofline", "baseline": b,
                 "current": c, "delta_pct": round(delta_pct, 2), "status": status_key}
            )
            lines.append(f"| {key} | {b:g} | {c:g} | {delta_pct:+.1f}% | {status_md} |")

    # Qubit-scaling section: the n=4..24 axis (bench.py --scaling /
    # scripts/qubit_scaling_sweep.py). The per-n GATES already sit in the
    # throughput table above (qsc_scaling.nNN.best_of_impls — each point is
    # the dispatcher's measured winner at that n, i.e. best-of-impls by
    # construction); this section is the human-facing crossover view: which
    # impl won each n, at what chi, and what it beat.
    cur_scaling = next(
        (c.get("qsc_scaling") for c in reversed(curs) if c.get("qsc_scaling")),
        None,
    )
    if cur_scaling is not None:
        pts = [p for p in cur_scaling.get("points", []) if isinstance(p, dict)]
        lines += [
            "",
            "## qubit scaling (best-of-impls per n)",
            "",
            f"- topology: {cur_scaling.get('devices_on_model', '?')} device(s) "
            f"on the model axis, platform {cur_scaling.get('platform', '?')}",
            "",
            "| n | impl | chi | batch | samples/s | vs next | agreement |",
            "|---|---|---|---|---|---|---|",
        ]
        for p in sorted(pts, key=lambda p: p.get("n_qubits", 0)):
            n = p.get("n_qubits", "?")
            if "error" in p and "samples_per_sec" not in p:
                lines.append(f"| {n} | — | — | — | — | — | error: {p['error']} |")
                continue
            impl = p.get("quantum_impl", "?")
            chi = p.get("mps_chi", "—")
            # margin over the best losing candidate's train time, straight
            # off the recorded race
            cands = p.get("candidates") or {}
            timed = {
                k: v["train_ms"]
                for k, v in cands.items()
                if isinstance(v, dict)
                and isinstance(v.get("train_ms"), (int, float))
                and k != impl
            }
            if timed and isinstance(
                (cands.get(impl) or {}).get("train_ms"), (int, float)
            ):
                k2 = min(timed, key=timed.get)
                ratio = timed[k2] / cands[impl]["train_ms"]
                vs_next = f"{ratio:.2f}x vs {k2}"
            else:
                vs_next = "only candidate" if impl != "?" else "—"
            agr = p.get("agreement") or {}
            if agr.get("max_abs_delta") is not None:
                agree = f"{agr['max_abs_delta']:.2e} vs {agr.get('reference')}"
            else:
                agree = "—"
            sps = p.get("samples_per_sec")
            lines.append(
                f"| {n} | {impl} | {chi} | {p.get('batch', '—')} | "
                f"{sps if sps is not None else '—'} | {vs_next} | {agree} |"
            )

    # Scenario-scaling section: the S=3..64 axis (bench.py --scenario-scaling
    # / scripts/scenario_scaling_sweep.py). The per-S GATES already sit in
    # the throughput table (scenario_scaling.sNN.best_of_dispatch — each
    # point is the routing race's measured winner at that S); this section is
    # the human-facing crossover view: which dispatch won each S, at what
    # capacity, and what it beat.
    cur_sscaling = next(
        (
            c.get("scenario_scaling")
            for c in reversed(curs)
            if c.get("scenario_scaling")
        ),
        None,
    )
    if cur_sscaling is not None:
        pts = [p for p in cur_sscaling.get("points", []) if isinstance(p, dict)]
        lines += [
            "",
            "## scenario scaling (best-of-dispatch per S)",
            "",
            f"- platform {cur_sscaling.get('platform', '?')}, capacity factor "
            f"{cur_sscaling.get('capacity_factor', '?')}",
            "",
            "| S | dispatch | capacity | batch | rows/s | vs other | agreement |",
            "|---|---|---|---|---|---|---|",
        ]
        for p in sorted(pts, key=lambda p: p.get("n_scenarios", 0)):
            s_n = p.get("n_scenarios", "?")
            if "error" in p and "samples_per_sec" not in p:
                lines.append(f"| {s_n} | — | — | — | — | — | error: {p['error']} |")
                continue
            mode = p.get("dispatch", "?")
            cands = p.get("candidates") or {}
            timed = {
                k: v["infer_ms"]
                for k, v in cands.items()
                if isinstance(v, dict)
                and isinstance(v.get("infer_ms"), (int, float))
                and k != mode
            }
            if timed and isinstance(
                (cands.get(mode) or {}).get("infer_ms"), (int, float)
            ):
                k2 = min(timed, key=timed.get)
                vs = f"{timed[k2] / cands[mode]['infer_ms']:.2f}x vs {k2}"
            else:
                vs = "only candidate" if mode != "?" else "—"
            agr = p.get("agreement") or {}
            agree = (
                f"{agr['max_abs_delta']:.2e}"
                if isinstance(agr.get("max_abs_delta"), (int, float))
                else "—"
            )
            sps = p.get("samples_per_sec")
            lines.append(
                f"| {s_n} | {mode} | {p.get('capacity', '—')} | "
                f"{p.get('batch', '—')} | {sps if sps is not None else '—'} | "
                f"{vs} | {agree} |"
            )

    # Steady-state host-transfer gate: the bench's timed loops are
    # transfer-free by construction (0 committed in every record) and run
    # under the strict device->host transfer guard on accelerator backends;
    # a reintroduced sync trips the guard and bench.py records the failed
    # sub-bench with host_transfers=1 — so "current > baseline" is the
    # reachable failure signal, not a hypothetical. A program property,
    # armed regardless of platform (like the lint gate).
    base_ht = base.get("host_transfers") or {}
    cur_ht: dict[str, int] = {}
    for c_src in curs:
        cur_ht.update(c_src.get("host_transfers") or {})
    ht_rows = []
    for key in sorted(set(base_ht) & set(cur_ht)):
        b, c = base_ht[key], cur_ht[key]
        if c > b:
            transfer_failed = True
            gates.append(
                {"metric": f"{key}.host_transfers", "kind": "host-transfers",
                 "baseline": b, "current": c, "delta_pct": None,
                 "status": "regression"}
            )
            regressions.append(
                {"metric": f"{key}.host_transfers", "baseline": b, "current": c,
                 "delta_pct": None}
            )
            ht_rows.append(f"- **{key}**: {b} -> {c} steady-state host transfer(s)")
        else:
            gates.append(
                {"metric": f"{key}.host_transfers", "kind": "host-transfers",
                 "baseline": b, "current": c, "delta_pct": None, "status": "ok"}
            )
    if ht_rows:
        lines += ["", "## steady-state host transfers — **REGRESSION**", ""] + ht_rows

    # Cost section: the XLA accounting for every program both sides measured.
    # A FLOPs/bytes delta is a PROGRAM change (config, lowering, fusion), a
    # regression with flat cost is an execution change — the table separates
    # the two failure stories.
    shared_cost = sorted(
        k
        for k in set(base["cost"]) & set(cur_cost)
        if base["cost"][k].get("available") and cur_cost[k].get("available")
    )
    if shared_cost:
        lines += [
            "",
            "## cost (XLA program accounting)",
            "",
            "| program | GFLOPs | Δ flops | MB accessed | Δ bytes | roofline |",
            "|---|---|---|---|---|---|",
        ]
        for k in shared_cost:
            bc, cc = base["cost"][k], cur_cost[k]
            deltas = _cost_deltas(bc, cc) or {}
            f_d = deltas.get("flops", {}).get("delta_pct")
            b_d = deltas.get("bytes_accessed", {}).get("delta_pct")
            changed = any(
                abs(d["delta_pct"]) > PROGRAM_CHANGE_PCT for d in deltas.values()
            )
            cost_rows.append(
                {"program": k, "baseline": {f: bc.get(f) for f in
                                            ("flops", "bytes_accessed", "peak_temp_bytes", "roofline")},
                 "current": {f: cc.get(f) for f in
                             ("flops", "bytes_accessed", "peak_temp_bytes", "roofline")},
                 "deltas": deltas, "program_changed": changed}
            )
            gflops = (
                f"{cc['flops'] / 1e9:.3f}" if isinstance(cc.get("flops"), (int, float)) else "—"
            )
            mb = (
                f"{cc['bytes_accessed'] / 1e6:.2f}"
                if isinstance(cc.get("bytes_accessed"), (int, float))
                else "—"
            )
            roof = cc.get("roofline", "unknown")
            if cc.get("roofline") != bc.get("roofline"):
                roof = f"{bc.get('roofline')} → {roof}"
            if changed:  # inside the last cell: a 7th cell would be dropped
                roof += " — **program changed**"
            lines.append(
                f"| {k} | {gflops} | "
                f"{'—' if f_d is None else f'{f_d:+.1f}%'} | {mb} | "
                f"{'—' if b_d is None else f'{b_d:+.1f}%'} | {roof} |"
            )

    lines.append("")
    flagged = [r for r in regressions if r.get("program_change")]
    if regressions:
        lines.append(
            f"**{len(regressions)} metric(s) regressed beyond {threshold_pct:g}%**"
            + ("" if gate_armed else " (gate disarmed: platform mismatch)")
        )
        if flagged:
            lines.append(
                f"- {len(flagged)} regression(s) coincide with a changed "
                "program (FLOPs/bytes moved): likely a config/lowering "
                "change, not a pure slowdown — "
                + ", ".join(r["metric"] for r in flagged)
            )
    else:
        lines.append("No regressions beyond threshold.")
    return _data()


def build_report(
    current_paths: list[str],
    baseline_path: str,
    threshold_pct: float = DEFAULT_THRESHOLD_PCT,
) -> tuple[str, list[dict], bool]:
    """Back-compat view of :func:`build_report_data`: ``(markdown,
    regressions, gate_armed)``. ``regressions`` lists every shared metric
    whose current value regressed beyond ``threshold_pct``; ``gate_armed``
    is False when the two sides ran on different platforms."""
    data = build_report_data(current_paths, baseline_path, threshold_pct)
    return data["markdown"], data["regressions"], data["gate_armed"]


def report_main(argv: list[str]) -> int:
    """CLI entry: parse ``--current/--baseline/--threshold/--out/--json``,
    print the markdown, return the gate's exit code. ``--json=PATH`` also
    writes the machine-readable gate output (per-gate status + deltas,
    disarm reason, cost deltas, the exit code itself) so CI consumes the
    gate without parsing markdown."""
    currents: list[str] = []
    baseline: str | None = None
    threshold = DEFAULT_THRESHOLD_PCT
    out: str | None = None
    json_out: str | None = None
    lint_path: str | None = None
    for arg in argv:
        if arg.startswith("--current="):
            currents += [p for p in arg.split("=", 1)[1].split(",") if p]
        elif arg.startswith("--baseline="):
            baseline = arg.split("=", 1)[1]
        elif arg.startswith("--lint="):
            lint_path = arg.split("=", 1)[1]
        elif arg.startswith("--threshold="):
            raw = arg.split("=", 1)[1]
            try:
                threshold = float(raw)
            except ValueError:
                print(f"report: --threshold must be a number, got {raw!r}")
                return EXIT_USAGE
        elif arg.startswith("--out="):
            out = arg.split("=", 1)[1]
        elif arg.startswith("--json="):
            json_out = arg.split("=", 1)[1]
        else:
            print(f"report: unrecognised argument {arg!r}")
            return EXIT_USAGE
    if not currents or baseline is None:
        print(
            "usage: qdml-tpu report --current=PATH[,PATH...] --baseline=PATH "
            "[--threshold=PCT] [--out=FILE.md] [--json=FILE.json] "
            "[--lint=LINT.json]"
        )
        return EXIT_USAGE
    for p in currents + [baseline]:
        if not os.path.exists(p):
            print(f"report: no such file {p!r}")
            return EXIT_USAGE
    data = build_report_data(currents, baseline, threshold, lint_path=lint_path)
    md = data["markdown"]
    print(md)
    rc = (
        EXIT_REGRESSION
        if (
            (data["regressions"] and data["gate_armed"])
            or data["lint_failed"]
            or data.get("transfer_failed")
            or data.get("stranded_failed")
            or data.get("monitor_failed")
        )
        else EXIT_OK
    )
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as fh:
            fh.write(md + "\n")
    if json_out:
        payload = {k: v for k, v in data.items() if k != "markdown"}
        payload["exit_code"] = rc
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as fh:
            json.dump(payload, fh, indent=2)
    return rc
