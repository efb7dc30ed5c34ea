"""Training and serving throughput rows of the port (the root ``bench.py``'s measurement rows).

    python -m qdml_tpu_torch.bench [--device=cpu] [--out=PATH] [--steps=20] [--scan-steps=16]
                                   [--qubits=4,6,...,24]

Prints one JSON line. Its rows, each the counterpart of a root ``bench.py``
measurement at that package's shapes (a 3 x 3 grid of 256-row cells, 2304
rows a step):

The training rows run the trainers' steps as the default config runs them:
with the numerics probe computed in every step (``train.probe_every`` 100
> 0; ``probes`` on each row), which the rows never fetch.

- ``hdce_fwd_flops_per_sample``, ``qsc_fwd_flops_per_sample``: the forward
  FLOP model (``bench.py:94-124``); a train step counts 3x the forward;
- ``hdce_train``: the fused HDCE step, one dispatch a step
  (``_bench_hdce``, ``bench.py:216``), and ``hdce_train_scan``: K steps a
  dispatch through :mod:`qdml_tpu_torch.train.scan` (``_bench_hdce_scan``,
  ``:273``): samples/s, the achieved TFLOP/s and, on the card, the MFU
  against the card's float32 peak (parity runs float32 with no TF32, so the
  tensor-core rates do not apply; the record names the peak it used);
- ``hdce_bf16``, ``hdce_bf16_scan``: the same two at ``model.dtype=
  bfloat16`` (``bench.py:1049, 1058``), and ``hdce_bf16_scan_bf16m``, the
  scan row with ``train.moments_dtype=bfloat16`` as well (JAX's
  ``hdce_bf16_scan_fast_bf16m``, ``:1093-1101``): their MFU is taken against
  the card's dense bfloat16 tensor-core peak. JAX's ``_rbg`` and ``_fast``
  levers act only on synthesis inside the scan, which these rows do not run,
  so those rows are left out and the record says so;
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
- ``qsc_scaling``: one point per n of
  :data:`~qdml_tpu_torch.eval.sweep.QUBIT_SCALING_GRID` (``--qubits``
  narrows it): the circuit-impl race over every impl eligible at n, forced,
  at :func:`~qdml_tpu_torch.eval.sweep.scaling_batch` rows and bond
  dimension :func:`~qdml_tpu_torch.eval.sweep.scaling_chi` (the kernels run
  for real on the card, so nothing is excluded); the winner's train step
  (one forward and ``backward()``, JAX's ``value_and_grad``) timed as the
  candidates were; and :func:`~qdml_tpu_torch.eval.sweep.impl_agreement`
  (``_bench_qsc_scaling`` and ``run_scaling_child``, ``:538-735``), at a
  truncating chi also at the exact one (``agreement_exact_chi``); a point
  carries no cost record;
- ``serve_infer``: a warmed engine's ``infer`` at bucket 64 (``:897``).

Every training row also carries the three fields ``report`` reads: ``cost``
(the counted first dispatch, :func:`~qdml_tpu_torch.telemetry.cost.
counting`), ``roofline`` (:func:`~qdml_tpu_torch.telemetry.cost.
achieved_roofline` at the row's measured dispatch rate) and
``host_transfers`` (none in the timed loop).

The line also carries the JAX bench record's envelope (``metric``, ``value``,
``unit``, ``platform``, ``details``: :func:`_envelope`), which ``report``
reads.

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
# the bfloat16 rows' products and convs run on the tensor cores
BF16_PEAK = {"flops_per_s": 989e12, "source": "NVIDIA H100 SXM data sheet, BF16 tensor core, dense"}
PEAKS = {"float32": ("mfu_fp32", FP32_PEAK), "bfloat16": ("mfu_bf16", BF16_PEAK)}
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


def _counted(fn: Callable[[], Any], dev: torch.device, dtype: str = "float32") -> tuple[Callable[[], Any], dict]:
    """``fn`` whose first call (the first of :func:`_rate`'s untimed warm
    calls, a real dispatch) is counted for a cost record
    (:func:`~qdml_tpu_torch.telemetry.cost.counting`), and that record,
    filled once the call has run."""
    from qdml_tpu_torch.telemetry.cost import counting

    rec: dict = {}
    state = {"first": True}

    def call():
        if not state["first"]:
            return fn()
        state["first"] = False
        with counting(dev, dtype) as got:
            out = fn()
        rec.update(got)
        return out

    return call, rec


def _telemetry_fields(cost: dict, calls_per_s: float) -> dict:
    """The three fields ``report`` reads from a training row: its ``cost``
    record, the achieved ``roofline`` at the measured dispatch rate, and
    ``host_transfers``, the device-to-host fetches inside the timed loop
    (none: it fetches nothing, and ends in one device synchronisation)."""
    from qdml_tpu_torch.telemetry.cost import achieved_roofline

    return {"cost": cost, "roofline": achieved_roofline(cost, calls_per_s), "host_transfers": 0}


def _flop_rates(samples_per_s: float, fwd_flops: float, dev: torch.device, dtype: str = "float32") -> dict:
    """Model TFLOP/s and, on the card, the MFU against the peak of the
    row's activation dtype, which the row names."""
    tflops = samples_per_s * 3.0 * fwd_flops / 1e12
    out: dict[str, Any] = {"model_tflops": round(tflops, 4)}
    if dev.type == "cuda":
        key, peak = PEAKS[dtype]
        out[key] = round(tflops * 1e12 / peak["flops_per_s"], 5)
        out["peak"] = peak["source"]
    return out


def _grid_cfg(dtype: str = "float32", moments: str = "float32", **quantum) -> cfg_mod.ExperimentConfig:
    cfg = cfg_mod.ExperimentConfig()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, data_len=CELL_BATCH),
        model=dataclasses.replace(cfg.model, dtype=dtype),
        quantum=dataclasses.replace(cfg.quantum, **quantum),
        train=dataclasses.replace(cfg.train, batch_size=CELL_BATCH, n_epochs=1, moments_dtype=moments),
    )


def _grid(cfg: cfg_mod.ExperimentConfig, dev: torch.device):
    """The grid of one cell batch a (scenario, user) cell on the device, and
    the chunk inputs of its one window: indices (S, U, B), SNR."""
    from qdml_tpu_torch.data.datasets import GridData

    data = GridData.synthesize(cfg.data, dev)
    idx = np.broadcast_to(np.arange(CELL_BATCH), (*GRID, CELL_BATCH)).astype(np.int64)
    return data, idx, np.float32(cfg.data.snr_db)


def _hdce_per_step(dev: torch.device, steps: int, dtype: str) -> dict:
    """The fused HDCE step at 2304 rows, one dispatch a step."""
    from qdml_tpu_torch.train import hdce

    cfg = _grid_cfg(dtype)
    data, idx, snr = _grid(cfg, dev)
    rows = GRID[0] * GRID[1] * CELL_BATCH
    model, opt = hdce.make_trainer(cfg, dev, steps_per_epoch=100)
    batch = data.batch(torch.as_tensor(idx, device=dev), float(snr))
    probes = cfg.train.probe_every > 0
    fn, cost = _counted(lambda: hdce.hdce_train_step(model, opt, batch, probes), dev, dtype)
    t = _rate(fn, dev, steps)
    sps = t["calls_per_s"] * rows
    return {"samples_per_sec": round(sps, 1), "step_ms": round(t["ms"], 4), "rows": rows, "dtype": dtype,
            "probes": probes,
            **_flop_rates(sps, hdce_fwd_flops_per_sample(cfg), dev, dtype),
            **_telemetry_fields(cost, t["calls_per_s"])}


def _hdce_scan(dev: torch.device, steps: int, scan_k: int, dtype: str, moments: str = "float32") -> dict:
    """The fused HDCE step at 2304 rows, K a dispatch (one CUDA graph on the card)."""
    from qdml_tpu_torch.train import hdce

    cfg = _grid_cfg(dtype, moments)
    data, idx, snr = _grid(cfg, dev)
    rows = GRID[0] * GRID[1] * CELL_BATCH
    model, opt = hdce.make_trainer(cfg, dev, steps_per_epoch=10**6)
    run = hdce.make_hdce_scan_steps(model, opt, data, scan_k, probes=cfg.train.probe_every > 0)
    idx_k, snr_k = np.broadcast_to(idx, (scan_k, *idx.shape)).copy(), np.full(scan_k, snr, np.float32)
    fn, cost = _counted(lambda: run(idx_k, snr_k), dev, dtype)
    t = _rate(fn, dev, max(1, steps // scan_k))
    sps = t["calls_per_s"] * scan_k * rows
    return {"samples_per_sec": round(sps, 1), "dispatch_ms": round(t["ms"], 4), "scan_steps": scan_k,
            "rows": rows, "graphs": len(run.graphs), "synthesis": "gather", "dtype": dtype,
            "moments_dtype": moments, "probes": cfg.train.probe_every > 0,
            **_flop_rates(sps, hdce_fwd_flops_per_sample(cfg), dev, dtype),
            **_telemetry_fields(cost, t["calls_per_s"])}


def bench_hdce(dev: torch.device, steps: int, scan_k: int) -> dict:
    """The fused HDCE step at 2304 rows: per dispatch and K a dispatch."""
    return {"hdce_train": _hdce_per_step(dev, steps, "float32"),
            "hdce_train_scan": _hdce_scan(dev, steps, scan_k, "float32")}


def bench_hdce_bf16(dev: torch.device, steps: int, scan_k: int) -> dict:
    """The HDCE rows at bfloat16 activations, and the scan row with bfloat16
    Adam moments as well."""
    bf16m = _hdce_scan(dev, steps, scan_k, "bfloat16", "bfloat16")
    bf16m["left_out"] = (
        "hdce_bf16_scan_rbg and hdce_bf16_scan_fast: their rng_impl=rbg and trig_impl=split act only "
        "on synthesis inside the scan, and these rows gather their batches from a grid made before "
        "(synthesis: gather)"
    )
    return {"hdce_bf16": _hdce_per_step(dev, steps, "bfloat16"),
            "hdce_bf16_scan": _hdce_scan(dev, steps, scan_k, "bfloat16"),
            "hdce_bf16_scan_bf16m": bf16m}


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
    probes = base.train.probe_every > 0
    out: dict[str, Any] = {}
    for impl in QSC_IMPLS:
        try:
            model, opt = qsc.make_trainer(_grid_cfg(impl=impl), True, dev, steps_per_epoch=100)
            model.train()
            fn, cost = _counted(lambda: qsc.classifier_train_step(model, opt, batch, probes=probes), dev)
            t = _rate(fn, dev, steps)
            sps = t["calls_per_s"] * rows
            out[impl] = {"samples_per_sec": round(sps, 1), "step_ms": round(t["ms"], 4),
                         "quantum_impl": impl, "probes": probes, **_flop_rates(sps, fwd, dev),
                         **_telemetry_fields(cost, t["calls_per_s"])}
        except Exception as e:  # lint: disable=broad-except(candidate isolation: one impl failing must not kill the others' rows; the error, a DivergenceError's dump path in its message included, is recorded on the row)
            out[impl] = _error(e)
    cfg = _grid_cfg(impl="auto")
    entry = autotune.prewarm(cfg, batch=rows, device=dev)
    model, opt = qsc.make_trainer(cfg, True, dev, steps_per_epoch=10**6)
    model.train()
    run = qsc.make_sc_scan_steps(model, opt, data, scan_k, probes=probes)
    idx_k, snr_k = np.broadcast_to(idx, (scan_k, *idx.shape)).copy(), np.full(scan_k, snr, np.float32)
    fn, cost = _counted(lambda: run(idx_k, snr_k), dev)
    t = _rate(fn, dev, max(1, steps // scan_k))
    sps = t["calls_per_s"] * scan_k * rows
    q = cfg.quantum
    scan = {"samples_per_sec": round(sps, 1), "dispatch_ms": round(t["ms"], 4), "scan_steps": scan_k,
            "graphs": len(run.graphs), "synthesis": "gather", "probes": probes,
            "quantum_impl": resolve_impl(q.impl, q.backend, q.n_qubits, q.n_layers, rows, mode="train",
                                         platform=dev.type),
            **_flop_rates(sps, fwd, dev), **_telemetry_fields(cost, t["calls_per_s"])}
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
        except Exception as e:  # lint: disable=broad-except(point isolation: one S failing must not kill the sweep's other points; the error is recorded on the point)
            point.update(_error(e))
        points.append(point)
    return {"points": points, "features": SCALING_FEATURES, "image_hw": list(SCALING_HW),
            "out_dim": SCALING_OUT, "table": da.table_path()}


def bench_qsc_scaling(
    dev: torch.device,
    budget_s: float = 0.25,
    n_values: tuple[int, ...] | None = None,
    n_layers: int = 3,
    mps_chi: int = 16,
) -> dict:
    """The qubit-scaling axis: per n the impl race (forced), the winner's
    train step, and its agreement with an independent formulation. A point
    that fails records its error and the others still run."""
    from qdml_tpu_torch.eval.sweep import QUBIT_SCALING_GRID, impl_agreement, scaling_batch, scaling_chi
    from qdml_tpu_torch.quantum import autotune
    from qdml_tpu_torch.quantum.circuits import run_circuit

    points = []
    for n in n_values or QUBIT_SCALING_GRID:
        batch, chi = scaling_batch(n), scaling_chi(n, mps_chi)
        impls = autotune.eligible_impls(n)
        point: dict[str, Any] = {"n_qubits": n, "dim": 1 << n, "batch": batch, "candidates_raced": impls}
        try:
            entry = autotune.ensure(n, n_layers, batch, force=True, impls=impls, budget_s=budget_s,
                                    device=dev, mps_chi=chi)
            winner = entry.get("best_train")
            point["candidates"] = entry["candidates"]
            if winner is None:
                point["error"] = "no candidate ran (see candidates.*.error)"
                points.append(point)
                continue
            point["quantum_impl"] = winner
            # chi belongs to the mps run: on the point only when mps won
            if winner == "mps":
                point["mps_chi"] = chi
            elif isinstance(entry["candidates"].get("mps"), dict):
                entry["candidates"]["mps"].setdefault("mps_chi", chi)
            rng = np.random.default_rng(0)
            angles = torch.tensor(rng.uniform(-1, 1, (batch, n)).astype(np.float32), device=dev)
            weights = torch.tensor(rng.uniform(0, 2 * np.pi, (n_layers, n, 2)).astype(np.float32),
                                   device=dev, requires_grad=True)

            def step(a, w):
                w.grad = None
                loss = (run_circuit(a, w, n, n_layers, impl=winner, mps_chi=chi) ** 2).sum()
                loss.backward()
                return loss

            ms = autotune._time_callable(step, (angles, weights), budget_s, 30)
            point["train_ms"] = round(ms, 4)
            point["steps_per_sec"] = round(1e3 / ms, 3)
            point["samples_per_sec"] = round(1e3 / ms * batch, 1)
            point["agreement"] = impl_agreement(n, winner, n_layers, batch=min(4, batch), mps_chi=chi, device=dev)
            # at a truncating chi the agreement is the truncation error (as
            # in JAX); where mps is the winner or the reference, the same
            # check at the exact chi 2^(n/2) holds the numerics alone
            ref = point["agreement"]["reference"]
            if ref is not None and "mps" in (winner, ref) and chi < 1 << (n // 2):
                point["agreement_exact_chi"] = impl_agreement(
                    n, winner, n_layers, batch=min(4, batch), mps_chi=1 << (n // 2), device=dev)
        except Exception as e:  # lint: disable=broad-except(point isolation: one n failing must not kill the sweep's other points; the error is recorded on the point)
            point.update(_error(e))
        points.append(point)
    return {"points": points, "n_layers": n_layers, "mps_chi": mps_chi, "budget_s": budget_s,
            "table": autotune.table_path()}


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


def run(
    device: str | None = None, steps: int = 20, scan_k: int = 16, qubits: tuple[int, ...] | None = None
) -> dict:
    """Every row on ``device`` (the card unless ``"cpu"``), ``qsc_scaling``
    at ``qubits`` (default: the whole grid); a failed row is an ``{"error":
    ...}`` entry. Returns the record."""
    dev = resolve_device(device)
    cfg = cfg_mod.ExperimentConfig()
    record: dict[str, Any] = {
        "device": _card(dev),
        "grid": {"scenarios": GRID[0], "users": GRID[1], "cell_batch": CELL_BATCH},
        "hdce_fwd_flops_per_sample": hdce_fwd_flops_per_sample(cfg),
        "qsc_fwd_flops_per_sample": qsc_fwd_flops_per_sample(cfg),
        "peak": {"float32": FP32_PEAK, "bfloat16": BF16_PEAK} if dev.type == "cuda" else None,
    }
    rows: list[tuple[tuple[str, ...], Callable[[], dict]]] = [
        (("hdce_train", "hdce_train_scan"), lambda: bench_hdce(dev, steps, scan_k)),
        (("hdce_bf16", "hdce_bf16_scan", "hdce_bf16_scan_bf16m"), lambda: bench_hdce_bf16(dev, steps, scan_k)),
        (("qsc_train", "qsc_train_scan"), lambda: bench_qsc(dev, steps, scan_k)),
        (("scenario_scaling",), lambda: {"scenario_scaling": bench_scenario_scaling(dev)}),
        (("qsc_scaling",), lambda: {"qsc_scaling": bench_qsc_scaling(dev, n_values=qubits)}),
        (("serve_infer",), lambda: {"serve_infer": bench_serve_infer(dev, steps)}),
    ]
    for names, fn in rows:
        try:
            record.update(fn())
        except Exception as e:  # lint: disable=broad-except(sub-bench isolation: one failing row must not kill the others; the error, a DivergenceError's dump path in its message included, is recorded on the row)
            for name in names:
                record[name] = _error(e)
    record.update(_envelope(record, dev, scan_k))
    return record


# the rows report gates (by their JAX names where JAX has the row: the
# qsc_<impl> rows feed report's best-of-impls metric)
_DETAIL_ROWS = ("hdce_train", "hdce_train_scan", "hdce_bf16", "hdce_bf16_scan", "hdce_bf16_scan_bf16m",
                "qsc_train_scan", "serve_infer")


def _envelope(record: dict, dev: torch.device, scan_k: int) -> dict:
    """The JAX bench record's envelope (``bench.py``'s one line: ``metric``,
    ``value``, ``unit``, ``platform``, ``details``), so that either
    package's ``report`` reads this line: the headline is the float32 HDCE
    K-step row, ``details`` the training and serving rows (each impl of
    ``qsc_train`` as ``qsc_<impl>``)."""
    from qdml_tpu_torch.telemetry.cost import detect_platform

    details = {k: record[k] for k in _DETAIL_ROWS if isinstance(record.get(k), dict) and "error" not in record[k]}
    for impl, row in (record.get("qsc_train") or {}).items():
        if isinstance(row, dict) and "error" not in row:
            details[f"qsc_{impl}"] = row
    return {
        "metric": "hdce_train_samples_per_sec",
        "value": (record.get("hdce_train_scan") or {}).get("samples_per_sec"),
        "unit": f"samples/sec (3x3 DML grid train step, cell batch {CELL_BATCH}, float32, {scan_k}-step graph)",
        "platform": detect_platform(dev),
        "details": details,
    }


def errors(record: dict) -> list[str]:
    """The failed rows' names, nested entries included (``qsc_train.pallas``,
    ``scenario_scaling.S8``)."""
    bad = [k for k, v in record.items() if isinstance(v, dict) and "error" in v]
    bad += [f"qsc_train.{k}" for k, v in (record.get("qsc_train") or {}).items()
            if isinstance(v, dict) and "error" in v]
    bad += [f"scenario_scaling.S{p['n_scenarios']}"
            for p in (record.get("scenario_scaling") or {}).get("points", []) if "error" in p]
    bad += [f"qsc_scaling.n{p['n_qubits']}"
            for p in (record.get("qsc_scaling") or {}).get("points", []) if "error" in p]
    return bad


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    opts = {"device": None, "out": None, "steps": "20", "scan-steps": "16", "qubits": None}
    for arg in args:
        key, sep, value = arg.lstrip("-").partition("=")
        if not arg.startswith("--") or not sep or key not in opts:
            print(f"usage: python -m qdml_tpu_torch.bench [--device=cpu] [--out=PATH] [--steps=N] "
                  f"[--scan-steps=K] [--qubits=N,N,...]; got {arg!r}", file=sys.stderr)
            return 2
        opts[key] = value
    qubits = tuple(int(v) for v in opts["qubits"].split(",")) if opts["qubits"] else None
    record = run(opts["device"], int(opts["steps"]), int(opts["scan-steps"]), qubits)
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
