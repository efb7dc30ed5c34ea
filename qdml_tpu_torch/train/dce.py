"""DCE: the monolithic direct channel estimator and its training
(``qdml_tpu/train/dce.py``).

The reference defines ``DCE_P128`` (one ``Conv_P128`` trunk and the
``FC_P128`` head, no per-scenario branching) as the baseline the
hierarchical HDCE improves on, but ships no loop for it; the JAX package's
loop uses the HDCE hyperparameters, and so does this one: one step over the
flattened (S, U, B) grid batch (the whole-batch NMSE against the noisy LS
label ``h_label``, BatchNorm in train mode with decay 0.9 over the flattened
batch), Adam with the halving schedule, and the tags ``dce_best`` (best
validation NMSE), ``dce_resume`` (every epoch) and ``dce_last``. The JAX
package's default dispatch is a K=1 scan of the same step; the port runs it
one dispatch at a time (``train.scan_steps`` is not a port config field
until ``train/scan.py`` is ported, ROADMAP A.9). Its flight recorder and
cost records are not ported (ROADMAP A.12).
"""

from __future__ import annotations

import math

import torch

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
from qdml_tpu_torch.models.cnn import DCEP128, flax_init_
from qdml_tpu_torch.models.losses import nmse_loss
from qdml_tpu_torch.train.checkpoint import save_checkpoint, save_train_state, try_resume
from qdml_tpu_torch.train.hdce import run_device
from qdml_tpu_torch.train.optim import Optimizer, get_optimizer
from qdml_tpu_torch.utils.device import resolve_device
from qdml_tpu_torch.utils.metrics import MetricsLogger, nmse_db


def build_dce(cfg: ExperimentConfig, device: str | torch.device | None = None) -> DCEP128:
    """The DCE the config describes on ``device``, in eval mode (weights to
    be loaded)."""
    return DCEP128(cfg.model.features, cfg.h_out_dim, cfg.image_hw).to(resolve_device(device)).eval()


def make_trainer(
    cfg: ExperimentConfig,
    device: str | torch.device | None,
    steps_per_epoch: int,
    init_state: dict | None = None,
) -> tuple[DCEP128, Optimizer]:
    """The DCE that :func:`train_dce` trains (``qdml_tpu/train/dce.py:125-
    136``): weights drawn as Flax draws them from a CPU generator seeded with
    ``cfg.train.seed`` (or ``init_state``), in train mode, and
    ``cfg.train``'s optimizer and schedule."""
    dev = resolve_device(device)
    model = DCEP128(cfg.model.features, cfg.h_out_dim, cfg.image_hw)
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


def dce_train_step(model: DCEP128, opt: Optimizer, batch: dict) -> dict[str, torch.Tensor]:
    """One step in train mode: the whole-batch NMSE against ``h_label``
    (and, detached, against ``h_perf``), one backward, one update. Returns
    the losses as device tensors (no host sync)."""
    model.train()
    x, label, perf = flat_batch(batch)
    pred = model(x)
    loss = nmse_loss(pred, label)
    with torch.no_grad():
        loss_perf = nmse_loss(pred, perf)
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {"loss": loss.detach(), "loss_perf": loss_perf}


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

    history: dict[str, list] = {"train_loss": [], "val_nmse": []}
    for epoch in range(start_epoch, cfg.train.n_epochs):
        tot, n = None, 0
        for batch in train_loader.epoch(epoch):
            m = dce_train_step(model, opt, batch)
            tot = m["loss"] if tot is None else tot + m["loss"]  # one fetch per epoch
            n += 1
            if n % cfg.train.print_freq == 0:
                logger.log(step=opt.count, epoch=epoch, loss=float(m["loss"]))
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
