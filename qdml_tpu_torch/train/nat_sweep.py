"""The noise-aware training sweep: an ensemble of quantum classifiers, one
per QuantumNAT noise level, trained in one step (``qdml_tpu/train/
nat_sweep.py``).

Every noise level is an ensemble member with its own parameters, AdamW state
and noise; the JAX package advances them all with ``jit(vmap(member_step))``.
Here the parameters are stacked along a leading member axis E (one tensor a
parameter name) and one step runs the whole ensemble:

- the CNN front end and the linear head run under ``torch.func.vmap`` of
  ``functional_call`` over the stacked parameters (the front end has no
  BatchNorm, so there are no buffers to carry);
- the circuit runs once for all members: member m at
  ``qlayer.weights[m] + sigma_m * eps_m`` (QuantumNAT, the gradient taken at
  the noisy point, :func:`~qdml_tpu_torch.ops.quantumnat.perturb_members`),
  through :func:`~qdml_tpu_torch.quantum.circuits.run_circuit_ensemble`, which
  at impl ``pallas_circuit`` is one member-axis launch of the circuit kernel
  and one of its adjoint. Autograd then runs through vmap, the ensemble
  Function and vmap again. A kernel that fails to build or launch stops the
  run; nothing falls back to E launches or to the plain versions;
- the loss is the sum of the members' NLLs, so each member's gradient is its
  own, and one AdamW over the stacked parameters takes each member's own
  update (elementwise), with gradient pruning, when configured, per member.

Noise: epoch e's draws come from a CPU generator seeded from ``(train.seed +
101, e)``, so a resumed epoch repeats what an uninterrupted run would draw,
and a run on the card draws what a run on the CPU draws. Tags:
``nat_sweep_best`` (the single best member, loadable into one ``QSCP128``),
``nat_sweep_member_best`` (every member at its best validation accuracy),
``nat_sweep_resume`` (stacked parameters and optimizer, every epoch) and
``nat_sweep_last``, with the JAX package's meta keys. With
``train.scan_steps=K >= 1`` (default 1) the ensemble steps run K a dispatch
(:func:`make_sweep_scan_steps`; each chunk reads its slice of the epoch's
noise from a static device copy), 0 one at a time. Under a world of
several ranks (``qdml_tpu/train/nat_sweep.py:300-328``) the stacked
ensemble is replicated, each rank computes on its rows, the gradients are
averaged over ``data``, the logged losses and validation means are
averaged over it too, and rank 0 writes the checkpoints. Telemetry as the
QSC trainer's (``qdml_tpu/train/nat_sweep.py:226-387``), with the probe per
member: (E,) vectors, and any bad member trips the watchdog.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call, vmap

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
from qdml_tpu_torch.models.qsc import QSCP128
from qdml_tpu_torch.ops.quantumnat import perturb_members
from qdml_tpu_torch.parallel.collectives import broadcast_object
from qdml_tpu_torch.parallel.mesh import training_mesh
from qdml_tpu_torch.quantum import autotune
from qdml_tpu_torch.quantum.circuits import run_circuit_ensemble
from qdml_tpu_torch.train import qsc as train_qsc
from qdml_tpu_torch.train.checkpoint import has_checkpoint, restore_checkpoint, save_checkpoint
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
from qdml_tpu_torch.utils.metrics import MetricsLogger

QWEIGHTS = "qlayer.weights"


def _is_qweight(name: str, _t: torch.Tensor) -> bool:
    """The circuit weights, the only entries QuantumNAT perturbs
    (``qdml_tpu/train/nat_sweep.py:46``)."""
    return name == QWEIGHTS


def _sweep_cfg(cfg: ExperimentConfig) -> ExperimentConfig:
    # noise is injected per member from outside, so QuantumNAT is off in the module
    return dataclasses.replace(cfg, quantum=dataclasses.replace(cfg.quantum, use_quantumnat=False))


def build_sweep_model(cfg: ExperimentConfig) -> QSCP128:
    """One member's module: the shapes and the circuit dispatch whose
    parameters the stacked ensemble carries (on the meta device: its own
    parameters are never used)."""
    q = cfg.quantum
    with torch.device("meta"):
        return QSCP128(q.n_qubits, q.n_layers, q.n_classes, q.backend, q.impl, q.input_norm, mps_chi=q.mps_chi)


def member_states(cfg: ExperimentConfig, n_members: int) -> list[dict[str, torch.Tensor]]:
    """Each member's initial state dict, drawn as the QSC trainer draws one
    (Flax's init, circuit weights uniform in [0, 2pi)) from a CPU generator
    seeded from ``(train.seed, m)``."""
    states = []
    for m in range(n_members):
        seed = int(np.random.SeedSequence((cfg.train.seed, m)).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        states.append(train_qsc.build_classifier(_sweep_cfg(cfg), True, "cpu", gen).state_dict())
    return states


def stack_states(states: Sequence[dict[str, torch.Tensor]], device) -> dict[str, torch.Tensor]:
    """Member state dicts -> stacked leaf parameters (E, ...) on ``device``."""
    return {
        k: torch.stack([s[k] for s in states]).to(device=device, dtype=torch.float32).requires_grad_(True)
        for k in states[0]
    }


def member_state(params: dict[str, torch.Tensor], m: int) -> dict[str, torch.Tensor]:
    """Member ``m``'s state dict, loadable into one ``QSCP128``."""
    return {k: v[m].detach().clone() for k, v in params.items()}


def init_sweep(
    cfg: ExperimentConfig,
    noise_levels: Sequence[float],
    steps_per_epoch: int,
    device: torch.device,
    init_states: Sequence[dict[str, torch.Tensor]] | None = None,
) -> tuple[QSCP128, dict[str, torch.Tensor], Optimizer, torch.Tensor]:
    """The member module, the stacked parameters (``init_states``, one state
    dict a member, or :func:`member_states`), their AdamW with the quantum
    config's per-member gradient pruning, as the single-model QSC trainer
    (reference ``Runner...py:320``), and the members' sigmas (E,)."""
    model = build_sweep_model(cfg)
    states = list(init_states) if init_states is not None else member_states(cfg, len(noise_levels))
    if len(states) != len(noise_levels):
        raise ValueError(f"{len(states)} member states for {len(noise_levels)} noise levels")
    params = stack_states(states, device)
    train_cfg = dataclasses.replace(cfg.train, optimizer="adamw")
    opt = get_optimizer(train_cfg, params.values(), steps_per_epoch, cfg.quantum, members=True)
    sigmas = torch.tensor([float(s) for s in noise_levels], dtype=torch.float32, device=device)
    return model, params, opt, sigmas


def _sub(params: dict[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def ensemble_log_probs(
    model: QSCP128,
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    train: bool,
    sigmas: torch.Tensor | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Every member's log-probabilities (E, N, n_classes) on the shared
    NCHW images ``x`` (N, 2, H, W): the front end and the head vmapped over
    the stacked parameters, the circuit one ensemble call, at the noisy
    circuit weights ``w + sigma_m * noise[m]`` when ``noise`` (E, L, n, 2)
    is given."""
    if model.input_norm:
        x = x / torch.sqrt(torch.mean(x**2, dim=(1, 2, 3), keepdim=True) + 1e-12)
    angles = vmap(lambda p: functional_call(model.preprocess, p, (x,)))(_sub(params, "preprocess."))
    if noise is not None:
        params = perturb_members(params, sigmas, _is_qweight, {QWEIGHTS: noise})
    expz = run_circuit_ensemble(
        angles, params[QWEIGHTS], model.n_qubits, model.n_layers, model.backend,
        impl=model.impl, mode="train" if train else "infer", mps_chi=model.mps_chi,
    )
    logits = vmap(lambda p, e: functional_call(model.classifier, p, (e,)))(_sub(params, "classifier."), expz)
    return torch.log_softmax(logits, dim=-1)


def member_nll(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(E, N, C) log-probabilities, (N,) labels -> each member's mean NLL (E,)."""
    idx = labels.long()[None, :, None].expand(log_probs.shape[0], -1, 1)
    return -torch.gather(log_probs, -1, idx)[..., 0].mean(dim=-1)


def sweep_train_step(
    model: QSCP128,
    params: dict[str, torch.Tensor],
    opt: Optimizer,
    sigmas: torch.Tensor,
    batch: dict,
    noise: torch.Tensor,
    probes: bool = False,
) -> dict[str, torch.Tensor]:
    """One ensemble step (``qdml_tpu/train/nat_sweep.py:87-108``): every
    member's NLL over the flattened grid at its noisy circuit weights, one
    backward of their sum, one (pruned) AdamW update. ``noise`` is the
    step's unit draws (E, L, n, 2). Returns the members' losses (E,) (and
    with ``probes`` the per-member probe) on the device."""
    x, labels = train_qsc.grid_batch(batch)
    losses = member_nll(ensemble_log_probs(model, params, x, True, sigmas, noise), labels)
    opt.zero_grad()
    losses.sum().backward()
    probe = opt.step(branch_params(params.items(), train_qsc.QSC_BRANCHES) if probes else None)
    out = {"loss": losses.detach()}
    if probe is not None:
        out["probe"] = probe
    return out


def make_sweep_scan_steps(
    model: QSCP128,
    params: dict[str, torch.Tensor],
    opt: Optimizer,
    sigmas: torch.Tensor,
    data: GridData,
    k: int,
    probes: bool = False,
) -> ScanSteps:
    """K ensemble steps a dispatch (``qdml_tpu/train/nat_sweep.py:139-161``):
    each call takes its chunk's unit noise (k', E, L, n, 2) on the device."""
    shape = (sigmas.shape[0], model.n_layers, model.n_qubits, 2)
    return make_scan_steps(_step_fn(model, params, opt, sigmas, probes=probes), data, opt, k, noise_shape=shape)


def _step_fn(model: QSCP128, params: dict[str, torch.Tensor], opt: Optimizer, sigmas: torch.Tensor, mesh=None,
             probes: bool = False, checkify_errors: bool = False):
    def step(batch, noise, probes=probes):
        out = sweep_train_step(model, params, opt, sigmas, batch, noise, probes)
        out["loss"] = train_qsc.data_mean(out["loss"], mesh)
        return out

    return checkify_step(step) if checkify_errors else step


@torch.no_grad()
def sweep_eval_step(model: QSCP128, params: dict[str, torch.Tensor], batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Each member's clean NLL and accuracy on one batch, (E,) each
    (``qdml_tpu/train/nat_sweep.py:151-165``)."""
    x, labels = train_qsc.grid_batch(batch)
    logp = ensemble_log_probs(model, params, x, False)
    acc = (torch.argmax(logp, dim=-1) == labels[None]).float().mean(dim=-1)
    return member_nll(logp, labels), acc


def epoch_noise(cfg: ExperimentConfig, epoch: int, steps: int, n_members: int) -> torch.Tensor:
    """Epoch ``epoch``'s unit normal circuit-weight draws (steps, E, L, n, 2),
    from a CPU generator seeded from ``(train.seed + 101, epoch)``: a resumed
    epoch draws what an uninterrupted run draws
    (``qdml_tpu/train/nat_sweep.py:325-328``), on any device."""
    q = cfg.quantum
    seed = int(np.random.SeedSequence((cfg.train.seed + 101, epoch)).generate_state(1)[0])
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((steps, n_members, q.n_layers, q.n_qubits, 2), generator=gen)


def train_nat_sweep(
    cfg: ExperimentConfig,
    noise_levels: Sequence[float] | None = None,
    data: GridData | None = None,
    device: str | torch.device | None = None,
    workdir: str | None = None,
    logger: MetricsLogger | None = None,
    init_states: Sequence[dict[str, torch.Tensor]] | None = None,
) -> tuple[dict[str, torch.Tensor], dict]:
    """Train one quantum classifier per noise level (default
    ``cfg.quantum.noise_sweep``), all in one step (``qdml_tpu/train/
    nat_sweep.py:179-496``). ``data``, ``device`` as in
    :func:`~qdml_tpu_torch.train.qsc.train_classifier`; ``init_states`` one
    state dict a member instead of the seeded init. With ``cfg.train.resume``
    a ``nat_sweep_resume`` of other noise levels is refused. Returns the
    stacked parameters and the per-epoch, per-member ``train_loss``,
    ``val_loss`` and ``val_acc`` arrays (E,)."""
    levels = [float(s) for s in (cfg.quantum.noise_sweep if noise_levels is None else noise_levels)]
    n_members = len(levels)
    logger = logger or MetricsLogger(echo=False)
    dev = run_device(data, device)
    mesh = training_mesh(cfg, dev)
    if data is None:
        data = GridData.synthesize(cfg.data, dev)
    train_loader = DMLGridLoader(data, cfg.train.batch_size, "train")
    val_loader = DMLGridLoader(data, cfg.train.batch_size, "val")
    spe = train_loader.steps_per_epoch
    model, params, opt, sigmas = init_sweep(cfg, levels, spe, dev, init_states)
    # the circuit impl race at one member's batch, the flattened grid, before
    # the first step; a no-op when an impl is pinned or tuning is off
    entry = autotune.prewarm(cfg, batch=train_qsc.circuit_batch(cfg, mesh), device=dev, mesh=mesh)
    if entry is not None:
        logger.log(
            kind="quantum_autotune",
            key=entry["key"],
            impl=entry["best_train"],
            impl_infer=entry["best_fwd"],
            candidates=entry["candidates"],
        )
    q = cfg.quantum
    quantum_meta = {
        "n_qubits": q.n_qubits,
        "n_layers": q.n_layers,
        "n_classes": q.n_classes,
        "input_norm": q.input_norm,
    }

    def load_into(stacked: dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for k, v in stacked.items():
                params[k].copy_(v)

    start_epoch, best_acc = 0, -1.0
    # rank 0's view of what is on disk decides for every rank
    if broadcast_object(cfg.train.resume and workdir is not None and has_checkpoint(workdir, "nat_sweep_resume")):
        payload, rmeta = restore_checkpoint(workdir, "nat_sweep_resume", map_location=dev)
        stored = rmeta.get("noise_levels")
        if stored is not None and list(stored) != levels:
            raise ValueError(
                f"resume noise_levels mismatch: checkpoint has {stored}, requested {levels} — "
                "members would keep training under the wrong sigma"
            )
        load_into(payload["params"])
        opt.load_state_dict(payload["opt"])
        start_epoch = int(rmeta.get("epoch", -1)) + 1
        best_acc = float(rmeta.get("best_acc", best_acc))

    # per-member best-validation tracking, a copy of the stacked parameters
    member_best = {k: v.detach().clone() for k, v in params.items()}
    member_best_acc = np.full(n_members, -1.0)
    member_best_epoch = np.full(n_members, -1)
    # the first epoch the selection considers: a resumed run without its
    # member-best tag never scored the epochs before it
    member_best_from_epoch = start_epoch
    if broadcast_object(start_epoch > 0 and has_checkpoint(workdir, "nat_sweep_member_best")):
        mb, mb_meta = restore_checkpoint(workdir, "nat_sweep_member_best", map_location=dev)
        mb_levels = mb_meta.get("noise_levels")
        if mb_levels is not None and list(mb_levels) != levels:
            raise ValueError(
                f"nat_sweep_member_best noise_levels mismatch: checkpoint has {mb_levels}, requested {levels}"
            )
        member_best = {k: v.to(dev) for k, v in mb["params"].items()}
        member_best_acc = np.asarray(mb_meta.get("member_best_acc", member_best_acc), float)
        member_best_epoch = np.asarray(mb_meta.get("member_best_epoch", member_best_epoch), int)
        member_best_from_epoch = int(mb_meta.get("member_best_from_epoch", -1))

    if mesh is not None:
        train_qsc.replicate_for_data(params.values(), opt, mesh, train_loader, val_loader)
    probes_on = cfg.train.probe_every > 0  # 0 computes no probes
    scan_run = None
    if scan_eligible(cfg, logger, dev, train_qsc.step_circuit_impl(cfg, dev, mesh), mesh=mesh):
        scan_run = make_sweep_scan_steps(model, params, opt, sigmas, data, cfg.train.scan_steps, probes_on)
    step = _step_fn(model, params, opt, sigmas, mesh, probes_on, cfg.train.checkify)
    tele = LoopTelemetry("nat_sweep_train", cfg, dev, lambda: params, workdir)

    writes = workdir is not None and (mesh is None or mesh.rank == 0)
    history: dict[str, list] = {"train_loss": [], "val_loss": [], "val_acc": []}
    for epoch in range(start_epoch, cfg.train.n_epochs):
        # the epoch's noise, one copy to the device
        noise = epoch_noise(cfg, epoch, spe, n_members).to(dev)
        # what replays the epoch's draws, for a dump
        tele.rng = {"seed_sequence": [cfg.train.seed + 101, epoch], "draws": "epoch_noise"}
        if scan_run is not None:
            tot, n = run_epoch(scan_run, train_loader, epoch, logger, cfg.train.print_freq, noise, tele=tele)
        else:
            tot, n = run_steps(step, opt, train_loader, epoch, logger, cfg.train.print_freq, noise, tele=tele)
        train_loss = tot / n if n else np.zeros(n_members)

        vloss = vacc = None
        vn = 0
        for batch in val_loader.epoch(epoch, shuffle=False):
            losses, accs = sweep_eval_step(model, params, batch)
            vloss = losses if vloss is None else vloss + losses
            vacc = accs if vacc is None else vacc + accs
            vn += 1
        if mesh is not None and vn:
            vloss, vacc = train_qsc.data_mean(vloss, mesh), train_qsc.data_mean(vacc, mesh)
        vloss = vloss.cpu().numpy().astype(np.float64) / vn if vn else np.zeros(n_members)
        vacc = vacc.cpu().numpy().astype(np.float64) / vn if vn else np.zeros(n_members)
        history["train_loss"].append(train_loss)
        history["val_loss"].append(vloss)
        history["val_acc"].append(vacc)
        per_member = {}
        for i, s in enumerate(levels):
            per_member[f"train_loss_sigma{s:g}"] = float(train_loss[i])
            per_member[f"val_loss_sigma{s:g}"] = float(vloss[i])
            per_member[f"val_acc_sigma{s:g}"] = float(vacc[i])
        logger.log(epoch=epoch, **per_member)

        improved = vacc > member_best_acc
        if improved.any():
            with torch.no_grad():
                for k, v in params.items():
                    mask = torch.as_tensor(improved, device=v.device).reshape((-1,) + (1,) * (v.dim() - 1))
                    member_best[k] = torch.where(mask, v.detach(), member_best[k])
            member_best_acc = np.where(improved, vacc, member_best_acc)
            member_best_epoch = np.where(improved, epoch, member_best_epoch)
            if writes:
                save_checkpoint(workdir, "nat_sweep_member_best", {"params": member_best}, {
                    "member_best_acc": [float(a) for a in member_best_acc],
                    "member_best_epoch": [int(e) for e in member_best_epoch],
                    "member_best_from_epoch": member_best_from_epoch,
                    "noise_levels": levels,
                    "name": cfg.name,
                    "quantum": quantum_meta,
                })

        if writes:
            top = int(np.argmax(vacc))
            if float(vacc[top]) > best_acc:
                best_acc = float(vacc[top])
                save_checkpoint(workdir, "nat_sweep_best", {"params": member_state(params, top)}, {
                    "epoch": epoch,
                    "member": top,
                    "sigma": levels[top],
                    "val_acc": best_acc,
                    "name": cfg.name,
                    "quantum": quantum_meta,
                })
            save_checkpoint(
                workdir, "nat_sweep_resume",
                {"params": {k: v.detach() for k, v in params.items()}, "opt": opt.state_dict()},
                {"epoch": epoch, "best_acc": best_acc, "noise_levels": levels, "name": cfg.name,
                 "quantum": quantum_meta},
            )
    if writes:
        save_checkpoint(
            workdir, "nat_sweep_last", {"params": {k: v.detach() for k, v in params.items()}},
            {"noise_levels": levels, "name": cfg.name, "quantum": quantum_meta},
        )
    return params, history
