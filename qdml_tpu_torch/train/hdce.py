"""HDCE: the stacked per-scenario trunks, the shared head, and their training
(``qdml_tpu/train/hdce.py``).

One fused step trains the whole (S, U) grid: trunk s sees all U*B rows of
scenario s (so its BatchNorm normalizes over U*B rows, as the JAX fused step
does, ``train/hdce.py:18-29``), the loss is the mean over the (S, U) cells of
each cell's whole-batch NMSE against the noisy LS label ``h_label``, and one
backward reaches every trunk and the head. BatchNorm running statistics
decay by ``0.9 ** n_users`` per step, the JAX package's compensation for its
one update per grid step (``train/hdce.py:202``), with the biased batch
variance (:class:`qdml_tpu_torch.models.cnn.BatchNorm2d`).

:func:`train_hdce` runs epochs of that step over a :class:`GridData` grid,
validates, and writes ``hdce_best`` / ``hdce_resume`` / ``hdce_last``. With
``train.scan_steps=K >= 1`` (the default, K = 1) the steps run K a dispatch
(:func:`make_hdce_scan_steps`, one CUDA-graph replay on the card); 0 runs
them one at a time. With ``model.dtype=bfloat16`` the trainer's model, its
validation included, runs bfloat16 activations on float32 parameters
(``models/cnn.py``), as JAX's does. The JAX package's mesh, flight recorder
and cost records are not ported (ROADMAP A.10, A.12).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from qdml_tpu_torch.config import ExperimentConfig, activation_dtype
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
from qdml_tpu_torch.models.cnn import FCP128, StackedConvP128, flax_init_, seeded_init_
from qdml_tpu_torch.train.checkpoint import save_checkpoint, save_train_state, try_resume
from qdml_tpu_torch.train.optim import Optimizer, get_optimizer
from qdml_tpu_torch.train.scan import ScanSteps, make_scan_steps, run_epoch, run_steps, scan_eligible
from qdml_tpu_torch.utils.device import resolve_device
from qdml_tpu_torch.utils.metrics import MetricsLogger, nmse_db


class HDCE(nn.Module):
    """``(S, B, 2, H, W) -> (S, B, out_dim)``: scenario s flows through trunk s,
    every scenario shares the one head (reference ``Runner...py:139-142``).
    State-dict keys: ``trunks.{s}.cnn.*`` and ``head.FC.*``. ``bn_decay`` is
    the trunks' BatchNorm running-statistics decay per update, ``dtype`` the
    activation dtype of the trunks and the head (parameters stay float32)."""

    def __init__(
        self,
        n_scenarios: int = 3,
        features: int = 32,
        out_dim: int = 2048,
        image_hw: tuple[int, int] = (16, 8),
        bn_decay: float = 0.9,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.trunks = StackedConvP128(n_scenarios, features, bn_decay, dtype)
        self.head = FCP128(features * image_hw[0] * image_hw[1], out_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunks(x))


def build_hdce(
    cfg: ExperimentConfig,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
) -> HDCE:
    """The HDCE the config describes on ``device``, in eval mode; its weights
    are drawn from ``generator`` when one is given. float32 whatever
    ``model.dtype`` says: serving and eval build it so, as the JAX engine
    does (``qdml_tpu/serve/engine.py:137-141``)."""
    dev = resolve_device(device)
    model = HDCE(cfg.data.n_scenarios, cfg.model.features, cfg.h_out_dim, cfg.image_hw)
    if generator is not None:
        seeded_init_(model, generator)
    return model.to(dev).eval()


def init_hdce_state(
    cfg: ExperimentConfig,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
) -> HDCE:
    """The HDCE to train (``qdml_tpu/train/hdce.py:196-216``): BatchNorm decay
    ``0.9 ** n_users``, activations in ``model.dtype``, weights drawn as Flax
    draws them from ``generator`` (default: a CPU generator seeded with
    ``cfg.train.seed``), in train mode."""
    dev = resolve_device(device)
    model = HDCE(
        cfg.data.n_scenarios, cfg.model.features, cfg.h_out_dim, cfg.image_hw,
        bn_decay=0.9**cfg.data.n_users, dtype=activation_dtype(cfg.model.dtype),
    )
    flax_init_(model, generator or torch.Generator().manual_seed(cfg.train.seed))
    return model.to(dev).train()


def make_trainer(
    cfg: ExperimentConfig,
    device: str | torch.device | None,
    steps_per_epoch: int,
    init_state: dict | None = None,
) -> tuple[HDCE, Optimizer]:
    """The HDCE that :func:`train_hdce` trains and its optimizer: the seeded
    init (or ``init_state``) and ``cfg.train``'s optimizer and schedule."""
    model = init_hdce_state(cfg, device)
    if init_state is not None:
        model.load_state_dict(init_state)
    return model, get_optimizer(cfg.train, model.parameters(), steps_per_epoch)


def cell_nmse(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-grid-cell whole-batch NMSE: (S, U, B, D) -> (S, U)."""
    err = torch.sum((pred - label) ** 2, dim=(-1, -2))
    return err / torch.sum(label**2, dim=(-1, -2))


def grid_images(batch: dict) -> torch.Tensor:
    """The batch's NHWC pilot images (S, U, B, H, W, 2) as the trunks' NCHW
    input (S, U*B, 2, H, W)."""
    img = batch["yp_img"]
    s, u, b, h, w, c = img.shape
    return img.reshape(s, u * b, h, w, c).permute(0, 1, 4, 2, 3).contiguous()


def hdce_loss(model: HDCE, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused step's losses (``qdml_tpu/train/hdce.py:91-129``): the mean
    over (S, U) of the cell NMSE against ``h_label`` (differentiable) and
    against ``h_perf`` (detached)."""
    s, u, b = batch["yp_img"].shape[:3]
    pred = model(grid_images(batch)).reshape(s, u, b, -1)
    loss = cell_nmse(pred, batch["h_label"]).mean()
    with torch.no_grad():
        loss_perf = cell_nmse(pred, batch["h_perf"]).mean()
    return loss, loss_perf


def hdce_train_step(model: HDCE, opt: Optimizer, batch: dict) -> dict[str, torch.Tensor]:
    """One fused grid step, in train mode: losses, one backward, one update.
    Returns the losses as device tensors (no host sync)."""
    model.train()
    loss, loss_perf = hdce_loss(model, batch)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "loss_perf": loss_perf}


def make_hdce_scan_steps(model: HDCE, opt: Optimizer, data: GridData, k: int) -> ScanSteps:
    """K fused HDCE steps a dispatch (``qdml_tpu/train/hdce.py:154-172``):
    :func:`hdce_train_step` bound into :mod:`qdml_tpu_torch.train.scan`."""
    return make_scan_steps(_step_fn(model, opt), data, opt, k)


def _step_fn(model: HDCE, opt: Optimizer):
    return lambda batch, _noise: hdce_train_step(model, opt, batch)


@torch.no_grad()
def hdce_eval_step(model: HDCE, batch: dict) -> dict[str, torch.Tensor]:
    """Error and power sums of one validation batch in eval mode, so the
    caller forms the NMSE over ALL validation data
    (``qdml_tpu/train/hdce.py:175-193``)."""
    model.eval()
    s, u, b = batch["yp_img"].shape[:3]
    pred = model(grid_images(batch)).reshape(s, u, b, -1)
    return {
        "err": torch.sum((pred - batch["h_label"]) ** 2),
        "pow": torch.sum(batch["h_label"] ** 2),
        "err_perf": torch.sum((pred - batch["h_perf"]) ** 2),
        "pow_perf": torch.sum(batch["h_perf"] ** 2),
    }


def run_device(data: GridData | None, device: str | torch.device | None) -> torch.device:
    """The device a trainer runs on: the one asked for, else that of the
    data it was handed, else the card."""
    if device is None and data is not None:
        return data.device
    return resolve_device(device)


def train_hdce(
    cfg: ExperimentConfig,
    data: GridData | None = None,
    device: str | torch.device | None = None,
    workdir: str | None = None,
    logger: MetricsLogger | None = None,
    init_state: dict | None = None,
) -> tuple[HDCE, dict]:
    """Full HDCE training run (reference ``train_Conv_Linear_of_HDCE``).

    ``data`` is the grid to train on (default: synthesized from ``cfg.data``
    on the device); ``init_state`` a state dict to start from instead of the
    seeded init. Returns the trained model and the history of per-epoch
    ``train_loss``, ``val_nmse`` and ``val_nmse_perf``."""
    logger = logger or MetricsLogger(echo=False)
    dev = run_device(data, device)
    if data is None:
        data = GridData.synthesize(cfg.data, dev)
    train_loader = DMLGridLoader(data, cfg.train.batch_size, "train")
    val_loader = DMLGridLoader(data, cfg.train.batch_size, "val")
    model, opt = make_trainer(cfg, dev, train_loader.steps_per_epoch, init_state)

    start_epoch, best = 0, math.inf
    if cfg.train.resume:
        start_epoch, rmeta = try_resume(workdir, "hdce_resume", model, opt)
        best = float(rmeta.get("best", best))  # don't clobber a better *_best

    scan_run = None
    if scan_eligible(cfg, logger, dev):
        scan_run = make_hdce_scan_steps(model, opt, data, cfg.train.scan_steps)

    history: dict[str, list] = {"train_loss": [], "val_nmse": [], "val_nmse_perf": []}
    for epoch in range(start_epoch, cfg.train.n_epochs):
        if scan_run is not None:
            tot, n = run_epoch(scan_run, train_loader, epoch, logger, cfg.train.print_freq)
        else:
            tot, n = run_steps(_step_fn(model, opt), opt, train_loader, epoch, logger, cfg.train.print_freq)
        train_loss = float(tot) / n if n else 0.0

        sums: dict[str, torch.Tensor | float] = {"err": 0.0, "pow": 0.0, "err_perf": 0.0, "pow_perf": 0.0}
        for batch in val_loader.epoch(epoch, shuffle=False):
            out = hdce_eval_step(model, batch)
            for k in sums:
                sums[k] = sums[k] + out[k]
        val_nmse = float(sums["err"]) / max(float(sums["pow"]), 1e-30)
        val_perf = float(sums["err_perf"]) / max(float(sums["pow_perf"]), 1e-30)
        history["train_loss"].append(train_loss)
        history["val_nmse"].append(val_nmse)
        history["val_nmse_perf"].append(val_perf)
        logger.log(
            epoch=epoch,
            train_loss=train_loss,
            val_nmse=val_nmse,
            val_nmse_db=nmse_db(val_nmse),
            val_nmse_perf=val_perf,
        )

        if workdir is not None:
            meta = {"epoch": epoch, "val_nmse": val_nmse, "name": cfg.name}
            if val_nmse < best:
                best = val_nmse
                save_checkpoint(workdir, "hdce_best", {"params": model.state_dict()}, meta)
            save_train_state(workdir, "hdce_resume", model, opt, {**meta, "best": best})
    if workdir is not None:
        save_checkpoint(
            workdir,
            "hdce_last",
            {"params": model.state_dict()},
            {"epoch": cfg.train.n_epochs - 1, "name": cfg.name},
        )
    model.eval()
    return model, history
