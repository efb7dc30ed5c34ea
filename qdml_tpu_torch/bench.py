"""Training and serving throughput rows of the port (the root ``bench.py``'s measurement rows).

    python -m qdml_tpu_torch.bench [--device=cpu] [--out=PATH] [--steps=20] [--scan-steps=16]

Prints one JSON line. Its rows, each the counterpart of a root ``bench.py``
measurement at that package's shapes (a 3 x 3 grid of 256-row cells, 2304
rows a step):

- ``hdce_fwd_flops_per_sample``, ``qsc_fwd_flops_per_sample``: the forward
  FLOP model (``bench.py:94-124``); a train step counts 3x the forward;
- ``hdce_train``: the fused HDCE step, one dispatch a step
  (``_bench_hdce``, ``bench.py:216``), and ``hdce_train_scan``: K steps a
  dispatch through :mod:`qdml_tpu_torch.train.scan` (``_bench_hdce_scan``,
  ``:273``): samples/s, the achieved TFLOP/s and, on the card, the MFU
  against the card's float32 peak (parity runs float32 with no TF32, so the
  tensor-core rates do not apply; the record names the peak it used);
- ``qsc_train``: the quantum classifier step per dispatch at circuit impls
  ``dense``, ``pallas`` and ``pallas_circuit`` (``_bench_qsc``, ``:343``),
  and ``qsc_train_scan`` at impl ``auto`` (``_bench_qsc_scan``, ``:429``);
- ``scenario_scaling``: one point per S of
  :data:`~qdml_tpu_torch.eval.sweep.SCENARIO_SCALING_GRID` at JAX's reduced
  geometry (8 x 4 pilot images, 16 conv channels, a 256-wide head, 64 rows):
  the routing race's winner and every candidate's time
  (:func:`~qdml_tpu_torch.ops.dispatch_autotune.ensure_route`, forced), rows/s,
  and :func:`~qdml_tpu_torch.eval.sweep.dispatch_agreement`
  (``_bench_scenario_scaling``, ``:736``);
- ``serve_infer``: a warmed engine's ``infer`` at bucket 64 (``:897``).

A row that fails is recorded as ``{"error": ...}`` (``bench.py:993``) and the
run exits 1. The scan rows gather each step's batch from a grid materialised
on the device, where the JAX package synthesizes it inside its scan: the
record says ``"synthesis": "gather"``, and the FLOP rates count the model
only. The root ``bench.py``'s TPU probing, child processes and committed
records have no counterpart on one card. Times are host wall clock around
work ended by a device synchronisation; a CPU run names ``platform: cpu``
and leaves the MFU out.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from qdml_tpu_torch import config as cfg_mod
from qdml_tpu_torch.utils.device import resolve_device

# the root bench.py's grid: 3 scenarios x 3 users of 256-row cells
GRID = (3, 3)
CELL_BATCH = 256
QSC_IMPLS = ("dense", "pallas", "pallas_circuit")
# float32 outside the tensor cores, H100 SXM data sheet (no TF32: parity runs
# float32 convs and products)
FP32_PEAK = {"flops_per_s": 67e12, "source": "NVIDIA H100 SXM data sheet, FP32 (non-tensor-core)"}
# the scenario axis's reduced geometry (bench.py:757-760)
SCALING_HW = (8, 4)
SCALING_FEATURES = 16
SCALING_OUT = 256


def hdce_fwd_flops_per_sample(cfg: cfg_mod.ExperimentConfig) -> float:
    """Conv trunk + estimation head, per sample, forward (``bench.py:94-105``):
    3 convs of 3x3, the first from the 2 (re/im) channels, then the head."""
    h, w = cfg.image_hw
    f = cfg.model.features
    k2 = 9
    conv = 2 * h * w * k2 * 2 * f + 2 * (2 * h * w * k2 * f * f)
    head = 2 * (f * h * w) * cfg.h_out_dim
    return float(conv + head)


def qsc_fwd_flops_per_sample(cfg: cfg_mod.ExperimentConfig) -> float:
    """CNN front end + the dense-unitary circuit (a 2^n x 2^n complex
    product) + the head, per sample, forward (``bench.py:108-124``)."""
    h, w = cfg.image_hw
    n_q = cfg.quantum.n_qubits
    flat = 32 * (h // 4) * (w // 4)
    pre = 2 * h * w * 9 * 2 * 16 + 2 * (h // 2) * (w // 2) * 9 * 16 * 32
    pre += 2 * flat * n_q
    dim = 1 << n_q
    circ = 4.0 * dim * dim + 2.0 * dim * n_q
    head = 2 * n_q * cfg.quantum.n_classes
    return float(pre + circ + head)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rate(fn: Callable[[], Any], dev: torch.device, steps: int, warm: int = 2) -> dict:
    """``fn`` called ``warm`` times untimed, then ``steps`` times between
    two device synchronisations: calls a second and ms a call (host wall)."""
    for _ in range(warm):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    return {"calls_per_s": steps / wall, "ms": 1e3 * wall / steps}


def _flop_rates(samples_per_s: float, fwd_flops: float, dev: torch.device) -> dict:
    tflops = samples_per_s * 3.0 * fwd_flops / 1e12
    out: dict[str, Any] = {"model_tflops": round(tflops, 4)}
    if dev.type == "cuda":
        out["mfu_fp32"] = round(tflops * 1e12 / FP32_PEAK["flops_per_s"], 5)
    return out


def _grid_cfg(**quantum) -> cfg_mod.ExperimentConfig:
    cfg = cfg_mod.ExperimentConfig()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, data_len=CELL_BATCH),
        quantum=dataclasses.replace(cfg.quantum, **quantum),
        train=dataclasses.replace(cfg.train, batch_size=CELL_BATCH, n_epochs=1),
    )


def _grid(cfg: cfg_mod.ExperimentConfig, dev: torch.device):
    """The grid of one cell batch a (scenario, user) cell on the device, and
    the chunk inputs of its one window: indices (S, U, B), SNR."""
    from qdml_tpu_torch.data.datasets import GridData

    data = GridData.synthesize(cfg.data, dev)
    idx = np.broadcast_to(np.arange(CELL_BATCH), (*GRID, CELL_BATCH)).astype(np.int64)
    return data, idx, np.float32(cfg.data.snr_db)


def bench_hdce(dev: torch.device, steps: int, scan_k: int) -> dict:
    """The fused HDCE step at 2304 rows: per dispatch and K a dispatch."""
    from qdml_tpu_torch.train import hdce

    cfg = _grid_cfg()
    data, idx, snr = _grid(cfg, dev)
    rows = GRID[0] * GRID[1] * CELL_BATCH
    fwd = hdce_fwd_flops_per_sample(cfg)
    model, opt = hdce.make_trainer(cfg, dev, steps_per_epoch=100)
    batch = data.batch(torch.as_tensor(idx, device=dev), float(snr))
    t = _rate(lambda: hdce.hdce_train_step(model, opt, batch), dev, steps)
    sps = t["calls_per_s"] * rows
    per_step = {"samples_per_sec": round(sps, 1), "step_ms": round(t["ms"], 4), "rows": rows,
                **_flop_rates(sps, fwd, dev)}

    model, opt = hdce.make_trainer(cfg, dev, steps_per_epoch=10**6)
    run = hdce.make_hdce_scan_steps(model, opt, data, scan_k)
    idx_k, snr_k = np.broadcast_to(idx, (scan_k, *idx.shape)).copy(), np.full(scan_k, snr, np.float32)
    scan_steps = max(1, steps // scan_k)
    t = _rate(lambda: run(idx_k, snr_k), dev, scan_steps)
    sps = t["calls_per_s"] * scan_k * rows
    scan = {"samples_per_sec": round(sps, 1), "dispatch_ms": round(t["ms"], 4), "scan_steps": scan_k,
            "rows": rows, "graphs": len(run.graphs), "synthesis": "gather", **_flop_rates(sps, fwd, dev)}
    return {"hdce_train": per_step, "hdce_train_scan": scan}


def bench_qsc(dev: torch.device, steps: int, scan_k: int) -> dict:
    """The quantum classifier step at 2304 rows at each fixed impl, then K a
    dispatch at impl ``auto`` (the race first, on the card)."""
    from qdml_tpu_torch.quantum import autotune
    from qdml_tpu_torch.quantum.circuits import resolve_impl
    from qdml_tpu_torch.train import qsc

    rows = GRID[0] * GRID[1] * CELL_BATCH
    base = _grid_cfg()
    data, idx, snr = _grid(base, dev)
    batch = data.batch(torch.as_tensor(idx, device=dev), float(snr))
    fwd = qsc_fwd_flops_per_sample(base)
    out: dict[str, Any] = {}
    for impl in QSC_IMPLS:
        try:
            model, opt = qsc.make_trainer(_grid_cfg(impl=impl), True, dev, steps_per_epoch=100)
            model.train()
            t = _rate(lambda: qsc.classifier_train_step(model, opt, batch), dev, steps)
            sps = t["calls_per_s"] * rows
            out[impl] = {"samples_per_sec": round(sps, 1), "step_ms": round(t["ms"], 4),
                         "quantum_impl": impl, **_flop_rates(sps, fwd, dev)}
        except Exception as e:  # one impl failing keeps the others' rows
            out[impl] = _error(e)
    cfg = _grid_cfg(impl="auto")
    entry = autotune.prewarm(cfg, batch=rows, device=dev)
    model, opt = qsc.make_trainer(cfg, True, dev, steps_per_epoch=10**6)
    model.train()
    run = qsc.make_sc_scan_steps(model, opt, data, scan_k)
    idx_k, snr_k = np.broadcast_to(idx, (scan_k, *idx.shape)).copy(), np.full(scan_k, snr, np.float32)
    t = _rate(lambda: run(idx_k, snr_k), dev, max(1, steps // scan_k))
    sps = t["calls_per_s"] * scan_k * rows
    q = cfg.quantum
    scan = {"samples_per_sec": round(sps, 1), "dispatch_ms": round(t["ms"], 4), "scan_steps": scan_k,
            "graphs": len(run.graphs), "synthesis": "gather",
            "quantum_impl": resolve_impl(q.impl, q.backend, q.n_qubits, q.n_layers, rows, mode="train",
                                         platform=dev.type),
            **_flop_rates(sps, fwd, dev)}
    if entry is not None:
        scan["autotune"] = {k: entry[k] for k in ("key", "best_train", "best_fwd", "candidates")}
    return {"qsc_train": out, "qsc_train_scan": scan}


def bench_scenario_scaling(dev: torch.device, capacity_factor: float = 1.25) -> dict:
    """One point per S: the routing race (forced, so its times are this
    run's), the winner's time and rows/s, and sparse-vs-dense agreement."""
    from qdml_tpu_torch.eval.sweep import SCENARIO_SCALING_GRID, dispatch_agreement, scenario_batch
    from qdml_tpu_torch.models.cnn import seeded_init_
    from qdml_tpu_torch.ops import dispatch_autotune as da
    from qdml_tpu_torch.ops.routing import expert_capacity
    from qdml_tpu_torch.quantum.autotune import _time_callable
    from qdml_tpu_torch.train.hdce import HDCE

    points = []
    for s in SCENARIO_SCALING_GRID:
        b = scenario_batch(s)
        point: dict[str, Any] = {
            "n_scenarios": s, "batch": b, "capacity_factor": capacity_factor,
            "capacity": expert_capacity(b, s, capacity_factor), "candidates_raced": da.eligible_modes(s),
        }
        try:
            rng = np.random.default_rng(0)
            model = HDCE(s, SCALING_FEATURES, out_dim=SCALING_OUT, image_hw=SCALING_HW)
            model = seeded_init_(model, torch.Generator().manual_seed(0)).to(dev).eval()
            x = torch.tensor(rng.standard_normal((b, 2, *SCALING_HW)).astype(np.float32), device=dev)
            entry = da.ensure_route(model, x, s, capacity_factor=capacity_factor, force=True)
            winner = entry["best_infer"]
            point["dispatch"] = winner
            point["candidates"] = entry["candidates"]
            if entry.get("excluded"):
                point["excluded"] = entry["excluded"]
            ms = entry["candidates"][winner].get("infer_ms")
            if ms is None:  # a window-only winner was never timed
                fn, args = da.route_candidates(model, x, s, capacity_factor)[winner]
                ms = round(_time_callable(fn, args, 0.2, 30), 4)
            point["infer_ms"] = ms
            point["samples_per_sec"] = round(1e3 / ms * b, 1)
            point["agreement"] = dispatch_agreement(s, batch=b, features=8, capacity_factor=capacity_factor,
                                                    device=dev)
        except Exception as e:  # one S failing keeps the other points
            point.update(_error(e))
        points.append(point)
    return {"points": points, "features": SCALING_FEATURES, "image_hw": list(SCALING_HW),
            "out_dim": SCALING_OUT, "table": da.table_path()}


def bench_serve_infer(dev: torch.device, steps: int, bucket: int = 64) -> dict:
    """A warmed engine (classical classifier, seeded weights) serving full
    buckets: requests a second and ms a batch, host wall clock."""
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.train.hdce import build_hdce

    cfg = cfg_mod.ExperimentConfig()
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, max_batch=bucket, buckets=(bucket,)))
    gen = torch.Generator().manual_seed(0)
    hdce_sd = build_hdce(cfg, "cpu", generator=gen).state_dict()
    clf_sd = build_classifier(cfg, False, "cpu", generator=gen).state_dict()
    engine = ServeEngine(cfg, hdce_sd, clf_sd, device=dev)
    t0 = time.perf_counter()
    warm = engine.warmup()
    warmup_s = time.perf_counter() - t0
    x = np.random.default_rng(0).standard_normal((bucket, *cfg.image_hw, 2)).astype(np.float32)
    engine.infer(x)
    times = []
    for _ in range(max(3, steps)):
        t1 = time.perf_counter()
        engine.infer(x)  # returns host arrays: ends in a sync
        times.append(time.perf_counter() - t1)
    med = statistics.median(times)
    return {
        "samples_per_sec": round(bucket / med, 1), "batch_ms_p50": round(1e3 * med, 4),
        "batch_ms_max": round(1e3 * max(times), 4), "bucket": bucket, "batches": len(times),
        "warmup_s": round(warmup_s, 3), "dispatch": warm["dispatch"]["mode"],
        "request_path_work": engine.request_path_work(),
    }


def _error(e: BaseException) -> dict:
    return {"error": f"{type(e).__name__}: {e}"}


def _card(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu"}
    out = {"platform": "cuda", "kind": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count()}
    try:
        out["name_power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        out["name_power_limit"] = _error(e)["error"]
    return out


def run(device: str | None = None, steps: int = 20, scan_k: int = 16) -> dict:
    """Every row on ``device`` (the card unless ``"cpu"``); a failed row is
    an ``{"error": ...}`` entry. Returns the record."""
    dev = resolve_device(device)
    cfg = cfg_mod.ExperimentConfig()
    record: dict[str, Any] = {
        "device": _card(dev),
        "grid": {"scenarios": GRID[0], "users": GRID[1], "cell_batch": CELL_BATCH},
        "hdce_fwd_flops_per_sample": hdce_fwd_flops_per_sample(cfg),
        "qsc_fwd_flops_per_sample": qsc_fwd_flops_per_sample(cfg),
        "peak": FP32_PEAK if dev.type == "cuda" else None,
    }
    rows: list[tuple[tuple[str, ...], Callable[[], dict]]] = [
        (("hdce_train", "hdce_train_scan"), lambda: bench_hdce(dev, steps, scan_k)),
        (("qsc_train", "qsc_train_scan"), lambda: bench_qsc(dev, steps, scan_k)),
        (("scenario_scaling",), lambda: {"scenario_scaling": bench_scenario_scaling(dev)}),
        (("serve_infer",), lambda: {"serve_infer": bench_serve_infer(dev, steps)}),
    ]
    for names, fn in rows:
        try:
            record.update(fn())
        except Exception as e:  # a failed row is recorded, the others still run
            for name in names:
                record[name] = _error(e)
    return record


def errors(record: dict) -> list[str]:
    """The failed rows' names, nested entries included (``qsc_train.pallas``,
    ``scenario_scaling.S8``)."""
    bad = [k for k, v in record.items() if isinstance(v, dict) and "error" in v]
    bad += [f"qsc_train.{k}" for k, v in (record.get("qsc_train") or {}).items()
            if isinstance(v, dict) and "error" in v]
    bad += [f"scenario_scaling.S{p['n_scenarios']}"
            for p in (record.get("scenario_scaling") or {}).get("points", []) if "error" in p]
    return bad


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    opts = {"device": None, "out": None, "steps": "20", "scan-steps": "16"}
    for arg in args:
        key, sep, value = arg.lstrip("-").partition("=")
        if not arg.startswith("--") or not sep or key not in opts:
            print(f"usage: python -m qdml_tpu_torch.bench [--device=cpu] [--out=PATH] [--steps=N] "
                  f"[--scan-steps=K]; got {arg!r}", file=sys.stderr)
            return 2
        opts[key] = value
    record = run(opts["device"], int(opts["steps"]), int(opts["scan-steps"]))
    line = json.dumps(record)
    print(line, flush=True)
    if opts["out"]:
        os.makedirs(os.path.dirname(os.path.abspath(opts["out"])), exist_ok=True)
        with open(opts["out"], "w") as fh:
            fh.write(line + "\n")
    bad = errors(record)
    if bad:
        print(f"bench: failed rows {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
