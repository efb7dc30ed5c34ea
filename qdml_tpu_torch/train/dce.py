"""DCE: the monolithic direct channel estimator and its training
(``qdml_tpu/train/dce.py``).

The reference defines ``DCE_P128`` (one ``Conv_P128`` trunk and the
``FC_P128`` head, no per-scenario branching) as the baseline the
hierarchical HDCE improves on, but ships no loop for it; the JAX package's
loop uses the HDCE hyperparameters, and so does this one: one step over the
flattened (S, U, B) grid batch (the whole-batch NMSE against the noisy LS
label ``h_label``, BatchNorm in train mode with decay 0.9 over the flattened
batch), Adam with the halving schedule, and the tags ``dce_best`` (best
validation NMSE), ``dce_resume`` (every epoch) and ``dce_last``. Dispatch is
the other trainers': ``train.scan_steps=K >= 1`` (default 1) runs K steps a
dispatch (:func:`make_dce_scan_steps`), 0 one at a time. Telemetry as the
HDCE trainer's (``qdml_tpu/train/dce.py:150-214``): probes (branches
:data:`PROBE_BRANCHES`), the loop's clock, flight recorder and one cost
record, and the sanitizer under ``train.checkify``.
"""

from __future__ import annotations

import math

import torch

from qdml_tpu_torch.config import ExperimentConfig, activation_dtype
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
from qdml_tpu_torch.models.cnn import DCEP128, flax_init_
from qdml_tpu_torch.models.losses import nmse_loss
from qdml_tpu_torch.train.checkpoint import save_checkpoint, save_train_state, try_resume
from qdml_tpu_torch.train.hdce import run_device
from qdml_tpu_torch.train.optim import Optimizer, get_optimizer
from qdml_tpu_torch.telemetry.numerics import branch_params
from qdml_tpu_torch.telemetry.sanitizer import checkify_step
from qdml_tpu_torch.train.scan import (
    LoopTelemetry,
    ScanSteps,
    make_scan_steps,
    run_epoch,
    run_steps,
    scan_eligible,
)
from qdml_tpu_torch.utils.device import resolve_device
from qdml_tpu_torch.utils.metrics import MetricsLogger, nmse_db


def build_dce(cfg: ExperimentConfig, device: str | torch.device | None = None) -> DCEP128:
    """The DCE the config describes on ``device``, in eval mode (weights to
    be loaded); float32 whatever ``model.dtype`` says, as eval builds it in
    JAX."""
    return DCEP128(cfg.model.features, cfg.h_out_dim, cfg.image_hw).to(resolve_device(device)).eval()


def make_trainer(
    cfg: ExperimentConfig,
    device: str | torch.device | None,
    steps_per_epoch: int,
    init_state: dict | None = None,
) -> tuple[DCEP128, Optimizer]:
    """The DCE that :func:`train_dce` trains (``qdml_tpu/train/dce.py:125-
    136``): weights drawn as Flax draws them from a CPU generator seeded with
    ``cfg.train.seed`` (or ``init_state``), activations in ``model.dtype``,
    in train mode, and ``cfg.train``'s optimizer and schedule."""
    dev = resolve_device(device)
    model = DCEP128(cfg.model.features, cfg.h_out_dim, cfg.image_hw, dtype=activation_dtype(cfg.model.dtype))
    flax_init_(model, torch.Generator().manual_seed(cfg.train.seed))
    if init_state is not None:
        model.load_state_dict(init_state)
    model = model.to(dev).train()
    return model, get_optimizer(cfg.train, model.parameters(), steps_per_epoch)


def flat_batch(batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The grid batch flattened (``qdml_tpu/train/dce.py:39-41``): NCHW
    images (S*U*B, 2, H, W) and the packed labels ``h_label``, ``h_perf``
    (S*U*B, 2 * h_dim)."""
    img = batch["yp_img"]
    x = img.reshape(-1, *img.shape[3:]).permute(0, 3, 1, 2).contiguous()
    return x, batch["h_label"].reshape(x.shape[0], -1), batch["h_perf"].reshape(x.shape[0], -1)


# the JAX DCE's top-level parameter branches, by the port's name prefixes
PROBE_BRANCHES = (("cnn.", "ConvP128_0"), ("FC.", "FCP128_0"))


def dce_train_step(model: DCEP128, opt: Optimizer, batch: dict, probes: bool = False) -> dict[str, torch.Tensor]:
    """One step in train mode: the whole-batch NMSE against ``h_label``
    (and, detached, against ``h_perf``), one backward, one update. Returns
    the losses (and with ``probes`` the numerics probe) as device tensors
    (no host sync)."""
    model.train()
    x, label, perf = flat_batch(batch)
    pred = model(x)
    loss = nmse_loss(pred, label)
    with torch.no_grad():
        loss_perf = nmse_loss(pred, perf)
    opt.zero_grad()
    loss.backward()
    probe = opt.step(branch_params(model.named_parameters(), PROBE_BRANCHES) if probes else None)
    out = {"loss": loss.detach(), "loss_perf": loss_perf}
    if probe is not None:
        out["probe"] = probe
    return out


def make_dce_scan_steps(model: DCEP128, opt: Optimizer, data: GridData, k: int, probes: bool = False) -> ScanSteps:
    """K DCE steps a dispatch (``qdml_tpu/train/dce.py:95-105``)."""
    return make_scan_steps(_step_fn(model, opt, probes), data, opt, k)


def _step_fn(model: DCEP128, opt: Optimizer, probes: bool = False, checkify_errors: bool = False):
    def step(batch, _noise, probes=probes):
        return dce_train_step(model, opt, batch, probes)

    return checkify_step(step) if checkify_errors else step


@torch.no_grad()
def dce_eval_step(model: DCEP128, batch: dict) -> dict[str, torch.Tensor]:
    """Error and power sums of one validation batch in eval mode, so the
    caller forms the NMSE over all validation data (``qdml_tpu/train/dce.py:
    112-122``)."""
    model.eval()
    x, label, _ = flat_batch(batch)
    pred = model(x)
    return {"err": torch.sum((pred - label) ** 2), "pow": torch.sum(label**2)}


def train_dce(
    cfg: ExperimentConfig,
    data: GridData | None = None,
    device: str | torch.device | None = None,
    workdir: str | None = None,
    logger: MetricsLogger | None = None,
    init_state: dict | None = None,
) -> tuple[DCEP128, dict]:
    """Train the monolithic DCE over the DML grid (``qdml_tpu/train/dce.py:
    139-255``). ``data``, ``device`` and ``init_state`` as in
    :func:`~qdml_tpu_torch.train.hdce.train_hdce`. Returns the model (eval
    mode) and the history of per-epoch ``train_loss`` and ``val_nmse``."""
    logger = logger or MetricsLogger(echo=False)
    dev = run_device(data, device)
    if data is None:
        data = GridData.synthesize(cfg.data, dev)
    train_loader = DMLGridLoader(data, cfg.train.batch_size, "train")
    val_loader = DMLGridLoader(data, cfg.train.batch_size, "val")
    model, opt = make_trainer(cfg, dev, train_loader.steps_per_epoch, init_state)

    start_epoch, best = 0, math.inf
    if cfg.train.resume:
        start_epoch, rmeta = try_resume(workdir, "dce_resume", model, opt)
        best = float(rmeta.get("best", best))

    probes_on = cfg.train.probe_every > 0  # 0 computes no probes
    scan_run = None
    if scan_eligible(cfg, logger, dev):
        scan_run = make_dce_scan_steps(model, opt, data, cfg.train.scan_steps, probes_on)
    step_fn = _step_fn(model, opt, probes_on, cfg.train.checkify)
    tele = LoopTelemetry("dce_train", cfg, dev, model.state_dict, workdir, dtype=cfg.model.dtype)

    history: dict[str, list] = {"train_loss": [], "val_nmse": []}
    for epoch in range(start_epoch, cfg.train.n_epochs):
        if scan_run is not None:
            tot, n = run_epoch(scan_run, train_loader, epoch, logger, cfg.train.print_freq, tele=tele)
        else:
            tot, n = run_steps(step_fn, opt, train_loader, epoch, logger, cfg.train.print_freq, tele=tele)
        train_loss = float(tot) / n if n else 0.0

        sums: dict[str, torch.Tensor | float] = {"err": 0.0, "pow": 0.0}
        for batch in val_loader.epoch(epoch, shuffle=False):
            out = dce_eval_step(model, batch)
            for k in sums:
                sums[k] = sums[k] + out[k]
        val_nmse = float(sums["err"]) / max(float(sums["pow"]), 1e-30)
        history["train_loss"].append(train_loss)
        history["val_nmse"].append(val_nmse)
        logger.log(epoch=epoch, train_loss=train_loss, val_nmse=val_nmse, val_nmse_db=nmse_db(val_nmse))
        if workdir is not None:
            meta = {"epoch": epoch, "val_nmse": val_nmse, "name": cfg.name}
            if val_nmse < best:
                best = val_nmse
                save_checkpoint(workdir, "dce_best", {"params": model.state_dict()}, meta)
            save_train_state(workdir, "dce_resume", model, opt, {**meta, "best": best})
    if workdir is not None:
        save_checkpoint(
            workdir,
            "dce_last",
            {"params": model.state_dict()},
            {"epoch": cfg.train.n_epochs - 1, "name": cfg.name},
        )
    model.eval()
    return model, history
