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
(``models/cnn.py``), as JAX's does.

Under a world of several ranks (``qdml_tpu/train/hdce.py:247-275``) the
trainer lays the model on the mesh (:mod:`qdml_tpu_torch.parallel`): each
rank keeps its share (:func:`~qdml_tpu_torch.parallel.federated.
shard_hdce_state`: trunk f under ``fed``, head columns under ``model``)
and computes on its rectangle of every batch, BatchNorm takes its
statistics over the data line, and :func:`hdce_mesh_train_step` takes the
global step. Its loss on each rank is that rank's PART of the global loss:
each cell's error over this rank's rows divided by the cell's power over
the whole batch (one all-reduce over ``data``), summed over the rank's
cells and divided by the grid's S*U. The parts sum to the one-rank loss, so
the gradients are summed: the trunks' over ``data``, the head's over
``data`` and ``fed`` (the federated aggregation). Every rank logs the
all-reduced loss, and rank 0 writes the checkpoints in the one-rank layout
(gathered by :func:`~qdml_tpu_torch.parallel.federated.gather_hdce_state`).
The JAX package's flight recorder and cost records are not ported (ROADMAP
A.12).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from qdml_tpu_torch.config import ExperimentConfig, activation_dtype
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
from qdml_tpu_torch.models.cnn import FCP128, StackedConvP128, flax_init_, seeded_init_
from qdml_tpu_torch.parallel.mesh import training_mesh
from qdml_tpu_torch.parallel.multihost import make_grid_placer
from qdml_tpu_torch.train.checkpoint import save_checkpoint, try_resume
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


def hdce_mesh_train_step(model, opt: Optimizer, batch: dict, mesh, n_scenarios: int) -> dict[str, torch.Tensor]:
    """One step of the global fused grid step on this rank of ``mesh``
    (the module docstring): this rank's part of the loss, its backward, the
    update (the optimizer's ``grad_sync`` sums the gradients first).
    Returns the global losses, the same on every rank."""
    from qdml_tpu_torch.parallel.collectives import all_reduce_
    from qdml_tpu_torch.parallel.dp import reduce_over_

    model.train()
    s, u, b = batch["yp_img"].shape[:3]
    pred = model(grid_images(batch)).reshape(s, u, b, -1)
    label, perf = batch["h_label"], batch["h_perf"]
    with torch.no_grad():
        pows = torch.stack([torch.sum(label**2, dim=(-1, -2)), torch.sum(perf**2, dim=(-1, -2))])
        all_reduce_(pows, mesh.group("data"))
        part_perf = (torch.sum((pred - perf) ** 2, dim=(-1, -2)) / pows[1]).sum()
    cells = n_scenarios * u
    part = (torch.sum((pred - label) ** 2, dim=(-1, -2)) / pows[0]).sum() / cells
    opt.zero_grad()
    part.backward()
    opt.step()
    losses = torch.stack([part.detach(), part_perf / cells])
    reduce_over_([losses], mesh, ("data", "fed"))
    return {"loss": losses[0], "loss_perf": losses[1]}


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
    mesh = training_mesh(cfg, dev)
    if data is None:
        data = GridData.synthesize(cfg.data, dev)
    train_loader = DMLGridLoader(data, cfg.train.batch_size, "train")
    val_loader = DMLGridLoader(data, cfg.train.batch_size, "val")
    model, opt = make_trainer(cfg, dev, train_loader.steps_per_epoch, init_state)

    start_epoch, best = 0, math.inf
    if cfg.train.resume:
        start_epoch, rmeta = try_resume(workdir, "hdce_resume", model, opt)
        best = float(rmeta.get("best", best))  # don't clobber a better *_best

    step_fn = _step_fn(model, opt)
    if mesh is not None:
        model, opt = lay_out_on_mesh(cfg, model, opt, mesh, train_loader.steps_per_epoch)
        fed = mesh.shape["fed"] > 1
        make_grid_placer(train_loader, mesh, fed=fed)
        make_grid_placer(val_loader, mesh, fed=fed)

        def step_fn(batch, _noise):
            return hdce_mesh_train_step(model, opt, batch, mesh, cfg.data.n_scenarios)

    scan_run = None
    if scan_eligible(cfg, logger, dev, mesh=mesh):
        scan_run = make_hdce_scan_steps(model, opt, data, cfg.train.scan_steps)

    history: dict[str, list] = {"train_loss": [], "val_nmse": [], "val_nmse_perf": []}
    for epoch in range(start_epoch, cfg.train.n_epochs):
        if scan_run is not None:
            tot, n = run_epoch(scan_run, train_loader, epoch, logger, cfg.train.print_freq)
        else:
            tot, n = run_steps(step_fn, opt, train_loader, epoch, logger, cfg.train.print_freq)
        train_loss = float(tot) / n if n else 0.0

        sums: dict[str, torch.Tensor | float] = {"err": 0.0, "pow": 0.0, "err_perf": 0.0, "pow_perf": 0.0}
        for batch in val_loader.epoch(epoch, shuffle=False):
            out = hdce_eval_step(model, batch)
            for k in sums:
                sums[k] = sums[k] + out[k]
        if mesh is not None:
            from qdml_tpu_torch.parallel.dp import reduce_over_

            stacked = torch.stack([torch.as_tensor(sums[k], device=dev) for k in sums])
            reduce_over_([stacked], mesh, ("data", "fed"))
            sums = dict(zip(sums, stacked))
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
            params, opt_state = _whole_state(model, opt, mesh)
            writer = mesh is None or mesh.rank == 0
            if val_nmse < best:
                best = val_nmse
                if writer:
                    save_checkpoint(workdir, "hdce_best", {"params": params}, meta)
            if writer:
                save_checkpoint(workdir, "hdce_resume", {"params": params, "opt": opt_state}, {**meta, "best": best})
    if workdir is not None:
        params, _ = _whole_state(model, opt, mesh)
        if mesh is None or mesh.rank == 0:
            save_checkpoint(
                workdir, "hdce_last", {"params": params}, {"epoch": cfg.train.n_epochs - 1, "name": cfg.name}
            )
    model.eval()
    return model, history


def lay_out_on_mesh(cfg: ExperimentConfig, model: HDCE, opt: Optimizer, mesh, steps_per_epoch: int):
    """The HDCE and its optimizer laid out on ``mesh``: rank 0's state on
    every rank, this rank's shard of it (with its share of the optimizer
    state), BatchNorm over the data line, and the gradient sums of the
    global step as the optimizer's ``grad_sync``."""
    from qdml_tpu_torch.parallel.dp import attach_batchnorm_group, replicate, sync_grads
    from qdml_tpu_torch.parallel.federated import shard_hdce_state

    replicate(model, mesh, opt)
    shard, opt_state = shard_hdce_state(
        model, mesh, cfg.data.n_scenarios, tensor_parallel=mesh.shape["model"] > 1,
        opt_state=opt.state_dict(),
    )
    local_opt = get_optimizer(cfg.train, shard.parameters(), steps_per_epoch)
    local_opt.load_state_dict(opt_state)
    attach_batchnorm_group(shard, mesh.group("data"))
    local_opt.grad_sync = sync_grads([
        (list(shard.trunks.parameters()), mesh.group("data"), "sum"),
        (list(shard.head.parameters()), mesh.group("data"), "sum"),
        (list(shard.head.parameters()), mesh.group("fed"), "sum"),
    ])
    return shard, local_opt


def _whole_state(model, opt: Optimizer, mesh) -> tuple[dict, dict]:
    """The model's and the optimizer's state dicts in the one-rank layout:
    as they are without a mesh, gathered from the ranks under one (a
    collective, every rank calls it)."""
    if mesh is None:
        return model.state_dict(), opt.state_dict()
    from qdml_tpu_torch.parallel.federated import gather_hdce_state

    return gather_hdce_state(model, opt.state_dict())
