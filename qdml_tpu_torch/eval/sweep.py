"""The SNR sweep (``qdml_tpu/eval/sweep.py:51-281``; reference ``model_val``, ``Test.py:64-275``).

For each SNR of ``cfg.eval.snr_grid`` over ``test_len`` fresh test samples:

- the classical baselines: the full-pilot LS observation and its LMMSE
  refinements, generic (the headline curve) and with the empirical
  beam-delay prior (the oracle);
- scenario classification with the classical CNN and, when given, the
  quantum classifier, which runs through the circuit impl its config names
  (impl ``pallas`` launches the QSC kernel, ``pallas_circuit`` the circuit
  kernel);
- the HDCE estimate with every row routed to its PREDICTED scenario's trunk:
  with ``dispatch="dense"`` all trunks run on the batch and
  :func:`select_expert` keeps each row's; with ``"sparse"`` only each row's
  trunk runs, on capacity buckets (:func:`sparse_dispatch`, capacity factor
  ``serve.capacity_factor``, one host sync a classifier and batch to read the
  overflow count), value-equivalent to float tolerance;
- when a DCE was trained, the monolithic estimate with no routing
  (``err_dce``, ``qdml_tpu/eval/sweep.py:191-192``);
- NMSE against the perfect channel for LS, MMSE, MMSE-oracle, DCE and HDCE
  behind each classifier, and both classifiers' accuracy.

:func:`load_sweep_models` restores the models a sweep evaluates from a
workdir's checkpoints. :func:`batch_metrics` is one batch's error and power sums as a function of
``(models, batch, snr_db, profile)``, so a test can hand it the JAX package's
own batch. :func:`run_snr_sweep` draws each batch on the device
(:func:`~qdml_tpu_torch.data.datasets.sweep_batch`), keeps the per-batch
float32 sums there, and fetches them once per SNR point, adding them in
float64 as the JAX ``make_snr_scan`` does (``:206-230``).

The scenario-scaling axis (``:284-349``): :data:`SCENARIO_SCALING_GRID`,
:func:`scenario_batch` and :func:`dispatch_agreement`, sparse routing held
against dense at each S; the routing race that picks between them is
:mod:`qdml_tpu_torch.ops.dispatch_autotune` and its timed points are
``python -m qdml_tpu_torch.bench``'s. The qubit-scaling axis (``:352-436``):
:data:`QUBIT_SCALING_GRID`, :func:`scaling_batch`, :func:`scaling_chi` and
:func:`impl_agreement`, a point's winning circuit impl held against an
independent formulation; its timed points are the bench's ``qsc_scaling``.
Not ported yet: the ``mesh`` (A.10, multi-rank half).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.data.baselines import beam_delay_profile, mmse_estimate, mmse_generic_estimate
from qdml_tpu_torch.data.channels import ChannelGeometry, label_noise_var
from qdml_tpu_torch.data.datasets import sweep_batch
from qdml_tpu_torch.models.qsc import build_classifier
from qdml_tpu_torch.ops.routing import select_expert, sparse_dispatch
from qdml_tpu_torch.train.checkpoint import latest_tag, reconcile_quantum_cfg, restore_params
from qdml_tpu_torch.train.dce import build_dce
from qdml_tpu_torch.models.cnn import seeded_init_
from qdml_tpu_torch.train.hdce import HDCE, build_hdce
from qdml_tpu_torch.utils.complexops import CArr
from qdml_tpu_torch.utils.device import resolve_device
from qdml_tpu_torch.utils.metrics import MetricsLogger, nmse_db


@dataclass
class SweepModels:
    """The models a sweep evaluates, in eval mode on one device: the HDCE,
    the classical classifier and (optionally) the quantum one and the
    monolithic DCE."""

    hdce: nn.Module
    sc: nn.Module
    qsc: nn.Module | None = None
    dce: nn.Module | None = None


def load_sweep_models(
    cfg: ExperimentConfig, workdir: str, device: str | torch.device | None = None
) -> tuple[ExperimentConfig, SweepModels]:
    """The HDCE, the SC and, when one was trained, the QSC (``Test.py:81-86``)
    and the DCE (``qdml_tpu/cli.py:327-329``) restored from ``workdir`` on
    ``device`` (``qdml_tpu/cli.py:307-330``):
    each family's :func:`latest_tag`, or its ``*_best`` tag, which raises as
    missing. Returns the config reconciled with the QSC checkpoint's quantum
    architecture, and the models."""
    dev = resolve_device(device)
    hdce_vars, _ = restore_params(workdir, latest_tag(workdir, "hdce") or "hdce_best", dev)
    sc_vars, _ = restore_params(workdir, latest_tag(workdir, "sc") or "sc_best", dev)
    qsc_tag = latest_tag(workdir, "qsc")
    qsc = None
    if qsc_tag is not None:
        qsc_vars, qsc_meta = restore_params(workdir, qsc_tag, dev)
        cfg = reconcile_quantum_cfg(cfg, qsc_meta)
        qsc = build_classifier(cfg, True, dev)
        qsc.load_state_dict(qsc_vars["params"])
    hdce = build_hdce(cfg, dev)
    hdce.load_state_dict(hdce_vars["params"])
    sc = build_classifier(cfg, False, dev)
    sc.load_state_dict(sc_vars["params"])
    dce = None
    dce_tag = latest_tag(workdir, "dce")
    if dce_tag is not None:
        dce = build_dce(cfg, dev)
        dce.load_state_dict(restore_params(workdir, dce_tag, dev)[0]["params"])
    return cfg, SweepModels(hdce, sc, qsc, dce)


def _sum_sq(x) -> torch.Tensor:
    return x.abs2().sum() if isinstance(x, CArr) else (x * x).sum()


def _diff(a: CArr, b: CArr) -> CArr:
    return CArr(a.re - b.re, a.im - b.im)


@torch.no_grad()
def batch_metrics(
    models: SweepModels,
    batch: dict,
    snr_db: float,
    profile: torch.Tensor,
    geom: ChannelGeometry,
    dispatch: str = "dense",
    capacity_factor: float = 1.25,
) -> dict[str, torch.Tensor]:
    """Error and power sums and correct counts of one batch, as 0-dim float32
    tensors on the batch's device (``qdml_tpu/eval/sweep.py:109-201``).
    ``batch`` holds ``yp_img (B, n_sub, n_beam, 2)`` NHWC, the complex
    ``h_ls`` and ``h_perf_c (B, h_dim)`` and ``indicator (B,)``. ``dispatch``
    routes the HDCE rows dense or sparse (``:60-82``)."""
    h = batch["h_perf_c"]
    h_ls = batch["h_ls"]
    sigma2 = label_noise_var(geom, snr_db)
    h_mmse = mmse_generic_estimate(h_ls, sigma2, geom)
    h_mmse_oracle = mmse_estimate(h_ls, sigma2, profile, geom)
    x = batch["yp_img"].permute(0, 3, 1, 2).contiguous()  # NCHW
    n_scen = geom.n_scenarios

    if dispatch == "dense":
        est_all = models.hdce(x.expand(n_scen, *x.shape))  # (S, B, 2 * h_dim), once for both classifiers

        def route(pred):
            return select_expert(est_all, pred)

    else:

        def dense(xb, pb):
            return select_expert(models.hdce(xb.expand(n_scen, *xb.shape)), pb)

        def route(pred):
            return sparse_dispatch(models.hdce, dense, x, pred, n_scen, capacity_factor)[0]

    out = {
        "pow": _sum_sq(h),
        "err_ls": _sum_sq(_diff(h_ls, h)),
        "err_mmse": _sum_sq(_diff(h_mmse, h)),
        "err_mmse_oracle": _sum_sq(_diff(h_mmse_oracle, h)),
        "count": torch.full((), float(x.shape[0]), device=x.device),
    }
    label2 = torch.cat([h.re, h.im], dim=-1)
    if models.dce is not None:
        out["err_dce"] = _sum_sq(models.dce(x) - label2)
    for name, model in (("classical", models.sc), ("quantum", models.qsc)):
        if model is None:
            continue
        pred = torch.argmax(model(x), dim=-1)
        out[f"err_hdce_{name}"] = _sum_sq(route(pred) - label2)
        out[f"correct_{name}"] = (pred == batch["indicator"]).sum().to(torch.float32)
    return out


def run_snr_sweep(
    cfg: ExperimentConfig,
    models: SweepModels,
    logger: MetricsLogger | None = None,
    device: str | torch.device | None = None,
    dispatch: str = "dense",
) -> dict[str, Any]:
    """The full sweep; returns ``{"snr": [...], "nmse_db": {curve: [...]},
    "acc": {classifier: [...]}}`` with the JAX package's keys. Every SNR row
    is also logged (curve NMSEs in dB, accuracies, sample count, and the
    point's wall seconds up to its one fetch) when a logger is given.
    ``dispatch`` routes the HDCE rows dense or sparse (capacity factor
    ``cfg.serve.capacity_factor``)."""
    if dispatch not in ("dense", "sparse"):
        raise ValueError(f"dispatch must be dense|sparse, got {dispatch!r}")
    dev = resolve_device(device)
    geom = ChannelGeometry.from_config(cfg.data)
    profile = beam_delay_profile(geom, device=dev)
    bs = cfg.eval.batch_size
    n_batches = max(cfg.eval.test_len // bs, 1)
    start = cfg.data.data_len * 3  # the JAX sweep's offset (Test.py:127), here a seed word
    curves: dict[str, list] = {}
    accs: dict[str, list] = {}
    for snr in cfg.eval.snr_grid:
        t0 = time.perf_counter()
        per_batch: dict[str, list[torch.Tensor]] = {}
        for b in range(n_batches):
            batch = sweep_batch(cfg.data, start, b * bs, bs, float(snr), dev, geom)
            metrics = batch_metrics(
                models, batch, float(snr), profile, geom, dispatch, cfg.serve.capacity_factor
            )
            for key, value in metrics.items():
                per_batch.setdefault(key, []).append(value)
        # one fetch per SNR point; float32 batch sums added in float64
        keys = list(per_batch)
        host = torch.stack([torch.stack(per_batch[k]) for k in keys]).cpu().numpy()
        sums = {k: float(host[i].astype(np.float64).sum()) for i, k in enumerate(keys)}
        seconds = time.perf_counter() - t0
        pow_ = max(sums["pow"], 1e-30)
        row: dict[str, float] = {}
        for key, value in sums.items():
            if key.startswith("err_"):
                db = nmse_db(value / pow_)
                curves.setdefault(key[4:], []).append(db)
                row[f"nmse_db_{key[4:]}"] = db
            elif key.startswith("correct_"):
                acc = value / sums["count"]
                accs.setdefault(key[8:], []).append(acc)
                row[f"acc_{key[8:]}"] = acc
        if logger is not None:
            logger.log(snr_db=float(snr), n_samples=sums["count"], seconds=seconds, **row)
    return {"snr": list(cfg.eval.snr_grid), "nmse_db": curves, "acc": accs}


# ---------------------------------------------------------------------------
# Scenario-scaling axis (S = 3 ... 64)
# ---------------------------------------------------------------------------

# The reference's 3-scenario grid (the dense anchor), the near side of the
# sparse-eligibility edge (4), the first raced point (8), and the scale-out
# regime where the dense all-trunks pass burns O(S) work for O(1) useful
# work (qdml_tpu/eval/sweep.py:289-293).
SCENARIO_SCALING_GRID = (3, 4, 8, 16, 32, 64)


def scenario_batch(n_scenarios: int) -> int:
    """Each point's request batch: the serving engine's largest default
    bucket, the same at every S, so the axis scales the expert count and not
    the batch (``qdml_tpu/eval/sweep.py:296-303``)."""
    return 64


def dispatch_agreement(
    n_scenarios: int,
    batch: int = 32,
    features: int = 8,
    capacity_factor: float = 1.25,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """How far sparse routing sits from dense at one scenario-scaling point
    (``qdml_tpu/eval/sweep.py:306-349``): the same trunks (seeded, 16x8
    pilots, ``features`` channels, a 64-wide head), inputs and predictions,
    under a balanced load (buckets fill evenly: the sparse path alone) and a
    fully skewed one (every row to expert 0: the overflow rows take the
    dense value). The two routes share no packing code, so a packing or
    unpacking fault cannot cancel out. Returns ``{"max_abs_delta",
    "overflow_balanced", "overflow_skewed"}``; runs on the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    s = int(n_scenarios)
    rng = np.random.default_rng(seed)
    model = HDCE(s, features, out_dim=64, image_hw=(16, 8))
    seeded_init_(model, torch.Generator().manual_seed(seed))
    model = model.to(dev).eval()
    x = torch.tensor(rng.standard_normal((batch, 16, 8, 2)).astype(np.float32), device=dev)
    x = x.permute(0, 3, 1, 2).contiguous()  # the trunks' NCHW

    def dense_fb(xb, pb):
        return select_expert(model(xb.expand(s, *xb.shape)), pb)

    out: dict[str, Any] = {"max_abs_delta": 0.0}
    with torch.inference_mode():
        for name, pred in (
            ("balanced", torch.arange(batch, device=dev) % s),
            ("skewed", torch.zeros(batch, dtype=torch.long, device=dev)),
        ):
            routed, overflow = sparse_dispatch(model, dense_fb, x, pred, s, capacity_factor)
            delta = float((routed - dense_fb(x, pred)).abs().max())
            out["max_abs_delta"] = round(max(out["max_abs_delta"], delta), 8)
            out[f"overflow_{name}"] = int(overflow)
    return out


# ---------------------------------------------------------------------------
# Qubit-scaling axis (n = 4 ... 24)
# ---------------------------------------------------------------------------

# The published 4/6/8-qubit regime, the dense and kernel windows' edges
# (10/12), the tensor crossover (14), and the mps-only regime (16/20/24)
# (qdml_tpu/eval/sweep.py:356-359).
QUBIT_SCALING_GRID = (4, 6, 8, 10, 12, 14, 16, 20, 24)


def scaling_batch(n_qubits: int) -> int:
    """Each point's circuit batch: it shrinks as the statevector footprint
    ``batch * 2^n`` grows, the same at every run of one n
    (``qdml_tpu/eval/sweep.py:362-373``)."""
    if n_qubits <= 16:
        return 64
    if n_qubits <= 20:
        return 8
    return 2


def scaling_chi(n_qubits: int, chi: int) -> int:
    """The mps bond dimension a point runs: ``chi`` capped at the exactness
    bound 2^(n/2), past which it buys nothing (``qdml_tpu/eval/sweep.py:
    376-380``)."""
    return max(2, min(int(chi), 1 << (n_qubits // 2)))


def impl_agreement(
    n_qubits: int,
    impl: str,
    n_layers: int = 3,
    batch: int = 4,
    mps_chi: int | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """How far ``impl``'s per-wire <Z> sits from an independent formulation
    at the same seeded angles and weights (``qdml_tpu/eval/sweep.py:
    383-436``): ``dense`` up to 12 qubits, ``mps`` against a ``tensor``
    winner at 13-14, ``tensor`` up to 14. Past 14 the port has only ``mps``
    on one device (``sharded_statevector``, JAX's other reference there,
    needs a mesh), so the point reports ``{"reference": None,
    "max_abs_delta": None}`` rather than a self-check. Runs on the card
    unless ``device="cpu"``."""
    from qdml_tpu_torch.quantum.circuits import run_circuit

    reference: str | None = None
    if impl != "dense" and n_qubits <= 12:
        reference = "dense"
    elif impl == "tensor":
        reference = "mps"
    elif impl != "tensor" and n_qubits <= 14:
        reference = "tensor"
    if reference is None:
        return {"reference": None, "max_abs_delta": None}
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    angles = torch.tensor(rng.uniform(-1, 1, (batch, n_qubits)).astype(np.float32), device=dev)
    weights = torch.tensor(rng.uniform(0, 2 * np.pi, (n_layers, n_qubits, 2)).astype(np.float32), device=dev)
    chi = scaling_chi(n_qubits, mps_chi or 16)
    with torch.no_grad():
        out = run_circuit(angles, weights, n_qubits, n_layers, impl=impl, mps_chi=chi)
        ref = run_circuit(angles, weights, n_qubits, n_layers, impl=reference, mps_chi=chi)
    return {"reference": reference, "max_abs_delta": round(float((out - ref).abs().max()), 8)}
