"""Scenario-classifier training, classical SC and quantum QSC (``qdml_tpu/train/qsc.py``).

The grid flattens to one batch (equal cell sizes make the summed per-cell
mean the flat mean) and the loss is the NLL of the scenario label. The
quantum classifier trains with AdamW (reference ``Runner...py:320``), its
circuit under QuantumNAT noise when configured (the noise drawn from a
generator seeded with ``(train.seed + 1, start_epoch)``, as the JAX trainer
folds its key), and with gradient pruning in front of the update when
configured. With ``quantum.impl=auto`` the circuit impls are timed on the
card before the first step (``quantum/autotune.prewarm`` at the flattened
grid batch, as ``qdml_tpu/train/qsc.py:194-201``), and the entry is logged
as ``kind="quantum_autotune"``. :func:`train_classifier` writes
``{sc,qsc}_best`` (best validation accuracy), ``_resume`` and ``_last``.
With ``train.scan_steps=K >= 1`` (default 1) the steps run K a dispatch
(:func:`make_sc_scan_steps`; on the card one CUDA-graph replay, the
QuantumNAT generator registered with the graph so it draws what the
per-step path draws), 0 one at a time.

Telemetry as the HDCE trainer's (``qdml_tpu/train/qsc.py:247-295``): the
numerics probe in every step at ``train.probe_every > 0`` (branches named
as JAX's tree, :data:`QSC_BRANCHES` / :data:`SC_BRANCHES`), the loop's
clock, flight recorder (the QuantumNAT generator's seed and offset in a
dump) and one cost record, and the sanitizer under ``train.checkify``.
Set-up spans: ``qsc_make_trainer`` (``sc_make_trainer``) over ``qsc_init``,
``qsc_to_device`` and ``optimizer_init``; the impl race's
``circuit_impl_race`` (:func:`~qdml_tpu_torch.quantum.autotune.prewarm`).

Under a world of several ranks (``qdml_tpu/train/qsc.py:221-242``) the
state is replicated from rank 0, each rank computes on its rows of every
batch (B over ``data``), the gradients are averaged over ``data`` before
the update, and the logged losses and validation sums are reduced over
``data``. Every rank draws the same QuantumNAT noise (the circuit weights'
noise is not per row). Under ``quantum.backend=sharded`` (the
``sharded_16q`` preset) the circuit runs on the model line
(:mod:`qdml_tpu_torch.quantum.sharded`). Rank 0 alone races the circuit
impls, at a rank's batch, and every rank dispatches its winner; rank 0
writes the checkpoints.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
from qdml_tpu_torch.models.cnn import SCP128, flax_init_
from qdml_tpu_torch.models.losses import nll_loss
from qdml_tpu_torch.models.qsc import QSCP128
from qdml_tpu_torch.parallel.mesh import training_mesh
from qdml_tpu_torch.quantum import autotune
from qdml_tpu_torch.quantum.circuits import resolve_backend, resolve_impl
from qdml_tpu_torch.train.checkpoint import save_checkpoint, save_train_state, try_resume
from qdml_tpu_torch.train.hdce import run_device
from qdml_tpu_torch.train.optim import Optimizer, get_optimizer
from qdml_tpu_torch.telemetry.numerics import branch_params
from qdml_tpu_torch.telemetry.spans import span
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
from qdml_tpu_torch.utils.metrics import MetricsLogger


def build_classifier(
    cfg: ExperimentConfig,
    quantum: bool,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
) -> nn.Module:
    """The classifier to train (``qdml_tpu/train/qsc.py:42-55, 156-172``):
    ``QSCP128`` with the config's QuantumNAT knobs, or ``SCP128``; weights
    drawn as Flax draws them, circuit weights uniform in [0, 2pi), from
    ``generator`` (default: a CPU generator seeded with ``cfg.train.seed``)."""
    dev = resolve_device(device)
    gen = generator or torch.Generator().manual_seed(cfg.train.seed)
    q = cfg.quantum
    if quantum:
        clf: nn.Module = QSCP128(
            q.n_qubits, q.n_layers, q.n_classes, q.backend, q.impl, q.input_norm,
            use_quantumnat=q.use_quantumnat, noise_level=q.noise_level, mps_chi=q.mps_chi,
        )
    else:
        clf = SCP128(q.n_classes)
    flax_init_(clf, gen)
    if quantum:
        w = clf.qlayer.weights
        with torch.no_grad():
            w.copy_(2.0 * math.pi * torch.rand(w.shape, generator=gen, device=gen.device))
    return clf.to(dev)


def make_trainer(
    cfg: ExperimentConfig,
    quantum: bool,
    device: str | torch.device | None,
    steps_per_epoch: int,
    init_state: dict | None = None,
) -> tuple[nn.Module, Optimizer]:
    """The classifier that :func:`train_classifier` trains and its optimizer:
    the seeded init (or ``init_state``), ``cfg.train``'s optimizer and
    schedule, and for the quantum classifier AdamW (reference
    ``Runner...py:320``) with the quantum config's gradient pruning. Spans
    ``qsc_make_trainer`` over ``qsc_init`` (the module built and drawn on
    the host), ``qsc_to_device`` and ``optimizer_init`` (``sc_*`` for the
    classical classifier)."""
    tag = "qsc" if quantum else "sc"
    with span(f"{tag}_make_trainer"):
        with span(f"{tag}_init"):
            model = build_classifier(cfg, quantum, "cpu")
        with span(f"{tag}_to_device"):
            model = model.to(resolve_device(device))
        if init_state is not None:
            model.load_state_dict(init_state)
        train_cfg = dataclasses.replace(cfg.train, optimizer="adamw") if quantum else cfg.train
        opt = get_optimizer(
            train_cfg, model.parameters(), steps_per_epoch, cfg.quantum if quantum else None
        )
    return model, opt


def grid_batch(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """The flattened grid: NCHW images (S*U*B, 2, H, W) and labels (S*U*B,)."""
    img = batch["yp_img"]
    x = img.reshape(-1, *img.shape[3:]).permute(0, 3, 1, 2).contiguous()
    return x, batch["indicator"].reshape(-1)


def classifier_loss(
    model: nn.Module,
    batch: dict,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The classifier step's loss (``qdml_tpu/train/qsc.py:58-88``): NLL over
    the flattened grid, with the quantum model in train mode (QuantumNAT)."""
    x, labels = grid_batch(batch)
    if isinstance(model, QSCP128):
        log_probs = model(x, train=True, noise=noise, generator=generator)
    else:
        log_probs = model(x)
    return nll_loss(log_probs, labels)


# the JAX classifiers' top-level parameter branches, by the port's name prefixes
QSC_BRANCHES = (("preprocess.", "QSCPreprocess_0"), ("qlayer.", "qweights"), ("classifier.", "Dense_0"))
SC_BRANCHES = (("conv1.", "Conv_0"), ("conv2.", "Conv_1"), ("FC.", "Dense_0"))


def probe_branches(model: nn.Module) -> tuple:
    return QSC_BRANCHES if isinstance(model, QSCP128) else SC_BRANCHES


def classifier_train_step(
    model: nn.Module,
    opt: Optimizer,
    batch: dict,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    probes: bool = False,
) -> dict[str, torch.Tensor]:
    """One classifier step: loss, backward, (prune,) update. Returns the loss
    (and with ``probes`` the numerics probe) as device tensors."""
    loss = classifier_loss(model, batch, noise, generator)
    opt.zero_grad()
    loss.backward()
    probe = opt.step(branch_params(model.named_parameters(), probe_branches(model)) if probes else None)
    out = {"loss": loss.detach()}
    if probe is not None:
        out["probe"] = probe
    return out


def make_sc_scan_steps(
    model: nn.Module, opt: Optimizer, data: GridData, k: int, generator: torch.Generator | None = None,
    probes: bool = False,
) -> ScanSteps:
    """K classifier steps a dispatch (``qdml_tpu/train/qsc.py:116-137``),
    the QuantumNAT noise drawn from ``generator`` step by step; a generator
    on the card is registered with the graphs (``presplit_keys`` in JAX)."""
    draws = isinstance(model, QSCP128) and model.use_quantumnat and model.noise_level > 0
    gens = (generator,) if draws and generator is not None and generator.device.type == "cuda" else ()
    return make_scan_steps(_step_fn(model, opt, generator, probes=probes), data, opt, k, generators=gens)


def _step_fn(model: nn.Module, opt: Optimizer, generator: torch.Generator | None, mesh=None,
             probes: bool = False, checkify_errors: bool = False):
    """The step the loops run, ``(batch, noise, probes=...) -> metrics``
    (``probes`` defaults to the loop's setting; the per-step loop passes its
    cadence); under ``checkify_errors`` run by the sanitizer."""
    def step(batch, _noise, probes=probes):
        out = classifier_train_step(model, opt, batch, generator=generator, probes=probes)
        out["loss"] = data_mean(out["loss"], mesh)
        return out

    return checkify_step(step) if checkify_errors else step


@torch.no_grad()
def classifier_eval_step(model: nn.Module, batch: dict) -> dict[str, torch.Tensor]:
    """NLL sum, correct predictions and count of one validation batch
    (``qdml_tpu/train/qsc.py:139-153``)."""
    x, labels = grid_batch(batch)
    log_probs = model(x)
    return {
        "nll_sum": -torch.gather(log_probs, -1, labels[:, None]).sum(),
        "correct": (torch.argmax(log_probs, -1) == labels).sum(),
        "count": torch.full((), float(labels.numel()), device=labels.device),
    }


def circuit_batch(cfg: ExperimentConfig, mesh=None) -> int:
    """The circuit's batch in a classifier step: the flattened grid, or a
    rank's rows of it under a ``mesh`` whose data axis divides the batch."""
    bs = cfg.train.batch_size
    if mesh is not None and bs % mesh.shape["data"] == 0:
        bs //= mesh.shape["data"]
    return cfg.data.n_scenarios * cfg.data.n_users * bs


def step_circuit_impl(cfg: ExperimentConfig, device: torch.device, mesh=None) -> str:
    """The circuit impl a training step of the quantum classifier runs on
    ``device``: its train-mode resolution at the step's circuit batch
    (:func:`circuit_batch`; after
    :func:`~qdml_tpu_torch.quantum.autotune.prewarm`, the race's winner)."""
    q = cfg.quantum
    return resolve_impl(
        q.impl, q.backend, q.n_qubits, q.n_layers, circuit_batch(cfg, mesh), mode="train", platform=device.type
    )


def replicate_for_data(state, opt: Optimizer, mesh, *loaders) -> None:
    """A replicated model under ``mesh`` (``qdml_tpu/train/qsc.py:221-231``):
    rank 0's ``state`` (a module, or its parameter tensors) and optimizer
    state on every rank, the gradients averaged over ``data`` before each
    update, and the loaders switched to this rank's rows."""
    from qdml_tpu_torch.parallel.dp import replicate, sync_grads
    from qdml_tpu_torch.parallel.multihost import make_grid_placer

    replicate(state, mesh, opt)
    opt.grad_sync = sync_grads([(opt.params, mesh.group("data"), "mean")])
    for loader in loaders:
        make_grid_placer(loader, mesh)


def data_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over the data line (a loss of equal parts); ``t``
    itself without a mesh."""
    if mesh is None:
        return t
    from qdml_tpu_torch.parallel.collectives import all_reduce_

    return all_reduce_(t.detach().clone(), mesh.group("data")) / mesh.shape["data"]


def noise_generator(cfg: ExperimentConfig, start_epoch: int, device: torch.device) -> torch.Generator:
    """The QuantumNAT generator of a run starting at ``start_epoch``: seeded
    from ``(train.seed + 1, start_epoch)``, so a resumed run draws fresh noise
    instead of replaying the first epochs' (``qdml_tpu/train/qsc.py:244-246``)."""
    seed = int(np.random.SeedSequence((cfg.train.seed + 1, start_epoch)).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def train_classifier(
    cfg: ExperimentConfig,
    quantum: bool,
    data: GridData | None = None,
    device: str | torch.device | None = None,
    workdir: str | None = None,
    logger: MetricsLogger | None = None,
    init_state: dict | None = None,
) -> tuple[nn.Module, dict]:
    """Train SC_P128 (classical) or QSC_P128 (quantum) over the grid
    (reference ``train_QSC_P128``). ``data`` and ``init_state`` as in
    :func:`~qdml_tpu_torch.train.hdce.train_hdce`. Returns the model and the
    history of per-epoch ``train_loss``, ``val_loss`` and ``val_acc``."""
    logger = logger or MetricsLogger(echo=False)
    dev = run_device(data, device)
    mesh = training_mesh(cfg, dev)
    if data is None:
        data = GridData.synthesize(cfg.data, dev)
    train_loader = DMLGridLoader(data, cfg.train.batch_size, "train")
    val_loader = DMLGridLoader(data, cfg.train.batch_size, "val")
    model, opt = make_trainer(cfg, quantum, dev, train_loader.steps_per_epoch, init_state)
    tag = "qsc" if quantum else "sc"
    if quantum:
        # the step flattens the grid into one batch, so the circuit's batch is
        # the whole grid (a rank's rows of it under a mesh); a no-op when an
        # impl is pinned or tuning is off
        entry = autotune.prewarm(cfg, batch=circuit_batch(cfg, mesh), device=dev, mesh=mesh)
        if entry is not None:
            logger.log(
                kind="quantum_autotune",
                key=entry["key"],
                impl=entry["best_train"],
                impl_infer=entry["best_fwd"],
                candidates=entry["candidates"],
            )

    start_epoch, best_acc = 0, -1.0
    if cfg.train.resume:
        start_epoch, rmeta = try_resume(workdir, f"{tag}_resume", model, opt)
        best_acc = float(rmeta.get("best", best_acc))
    gen = noise_generator(cfg, start_epoch, dev)
    if mesh is not None:
        replicate_for_data(model, opt, mesh, train_loader, val_loader)
    probes_on = cfg.train.probe_every > 0  # 0 computes no probes
    scan_run = None
    if scan_eligible(cfg, logger, dev, step_circuit_impl(cfg, dev, mesh) if quantum else None, mesh=mesh):
        scan_run = make_sc_scan_steps(model, opt, data, cfg.train.scan_steps, gen, probes=probes_on)
    step_fn = _step_fn(model, opt, gen, mesh, probes_on, cfg.train.checkify)
    tele = LoopTelemetry(f"{tag}_train", cfg, dev, model.state_dict, workdir, rng=gen)

    history: dict[str, list] = {"train_loss": [], "val_loss": [], "val_acc": []}
    for epoch in range(start_epoch, cfg.train.n_epochs):
        model.train()
        if scan_run is not None:
            tot, n = run_epoch(scan_run, train_loader, epoch, logger, cfg.train.print_freq, tele=tele)
        else:
            tot, n = run_steps(step_fn, opt, train_loader, epoch, logger, cfg.train.print_freq, tele=tele)
        train_loss = float(tot) / n if n else 0.0

        model.eval()
        sums: dict[str, torch.Tensor | float] = {"nll_sum": 0.0, "correct": 0.0, "count": 0.0}
        for batch in val_loader.epoch(epoch, shuffle=False):
            out = classifier_eval_step(model, batch)
            for k in sums:
                sums[k] = sums[k] + out[k]
        if mesh is not None:
            from qdml_tpu_torch.parallel.dp import reduce_over_

            stacked = torch.stack([torch.as_tensor(sums[k], dtype=torch.float32, device=dev) for k in sums])
            reduce_over_([stacked], mesh, ("data",))
            sums = dict(zip(sums, stacked))
        count = max(float(sums["count"]), 1.0)
        val_loss = float(sums["nll_sum"]) / count
        val_acc = float(sums["correct"]) / count
        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        history["val_acc"].append(val_acc)
        logger.log(epoch=epoch, train_loss=train_loss, val_loss=val_loss, val_acc=val_acc)

        if workdir is not None and (mesh is None or mesh.rank == 0):
            meta: dict = {"epoch": epoch, "val_acc": val_acc, "name": cfg.name}
            if quantum:
                q = cfg.quantum
                meta["quantum"] = {
                    "n_qubits": q.n_qubits,
                    "n_layers": q.n_layers,
                    "n_classes": q.n_classes,
                    "backend": resolve_backend(q.backend, q.n_qubits),
                    "impl": q.impl,
                    # the mps knob, provenance only: the eval config's chi wins
                    "mps_chi": q.mps_chi,
                    "input_norm": q.input_norm,
                }
                meta["training"] = {"use_quantumnat": q.use_quantumnat, "noise_level": q.noise_level}
            if val_acc > best_acc:
                best_acc = val_acc
                save_checkpoint(workdir, f"{tag}_best", {"params": model.state_dict()}, meta)
            save_train_state(workdir, f"{tag}_resume", model, opt, {**meta, "best": best_acc})
    if workdir is not None and (mesh is None or mesh.rank == 0):
        save_checkpoint(
            workdir,
            f"{tag}_last",
            {"params": model.state_dict()},
            {"epoch": cfg.train.n_epochs - 1, "name": cfg.name},
        )
    model.eval()
    return model, history
