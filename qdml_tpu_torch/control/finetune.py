"""Continual fine-tuning of ONE drifted scenario trunk (``qdml_tpu/control/finetune.py``).

When a scenario's channel family drifts, only that scenario's trunk needs
new weights: the shared head serves every family and the other families
did not move.

- **warm start**: the live checkpoint restores from the workdir (an
  explicit ``base_tag``, else ``latest_tag``);
- **one-trunk model**: trunk ``s`` of the stacked trunks
  (:class:`~qdml_tpu_torch.models.cnn.StackedConvP128`) and the head make a
  1-scenario :class:`~qdml_tpu_torch.train.hdce.HDCE` (:func:`one_trunk_model`);
  every other trunk never enters the step;
- **masked optimizer**: Adam updates the trunk alone; the head rides in the
  forward, so the trunk adapts to the head it will serve behind, but it
  takes no gradient and no update (:func:`trunk_optimizer`; JAX's
  ``optax.multi_transform`` with ``set_to_zero`` on the head);
- **drifted data**: the port's grid of the drifted family
  (``data.drift_step`` / ``data.drift_scenario``), walked through
  :meth:`~qdml_tpu_torch.data.datasets.DMLGridLoader.set_process_slice`
  with ``scen_start=s, scen_count=1``;
- **reassembly**: the head and every other trunk are the base checkpoint's
  tensors verbatim, so they are bit-identical by construction, not by
  arithmetic; only trunk ``s``'s entries are replaced. The result saves as
  ``hdce_last`` with the ``finetune`` meta (``hdce_prev`` first keeps the
  base when ``hdce_last`` was the warm-start source).

It trains with ``model.dtype`` activations (``qdml_tpu/control/finetune.py:
143``) on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qdml_tpu_torch.config import ExperimentConfig, activation_dtype
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
from qdml_tpu_torch.serve.engine import trunk_state
from qdml_tpu_torch.telemetry.spans import span
from qdml_tpu_torch.train.checkpoint import latest_tag, restore_params, save_checkpoint
from qdml_tpu_torch.train.hdce import HDCE, hdce_eval_step, hdce_train_step
from qdml_tpu_torch.utils.device import resolve_device


def one_trunk_model(cfg: ExperimentConfig, base_sd, scenario: int, device) -> HDCE:
    """The 1-scenario HDCE of trunk ``scenario`` and the head of ``base_sd``
    (an HDCE state dict), in train mode on ``device``: BatchNorm decay
    ``0.9 ** n_users`` and ``model.dtype`` activations, as the trainer's."""
    model = HDCE(
        1, cfg.model.features, cfg.h_out_dim, cfg.image_hw,
        bn_decay=0.9**cfg.data.n_users, dtype=activation_dtype(cfg.model.dtype),
    )
    model.load_state_dict(trunk_state(base_sd, scenario))
    return model.to(device).train()


def trunk_optimizer(model: HDCE, lr: float) -> torch.optim.Adam:
    """Adam over the trunk alone (optax's defaults: betas 0.9/0.999, eps
    1e-8); the head takes no gradient."""
    model.head.requires_grad_(False)
    return torch.optim.Adam(model.trunks.parameters(), lr=lr)


def reassemble(base_sd, model: HDCE, scenario: int) -> dict[str, torch.Tensor]:
    """``base_sd`` with trunk ``scenario``'s entries replaced by ``model``'s
    trunk (on the CPU, in the base's dtypes); every other entry is the base
    tensor itself."""
    out = dict(base_sd)
    for k, v in model.trunks.state_dict().items():
        key = f"trunks.{scenario}.{k.split('.', 1)[1]}"
        out[key] = v.detach().to("cpu", base_sd[key].dtype, copy=True)
    return out


def finetune_trunk(
    cfg: ExperimentConfig,
    workdir: str,
    scenario: int,
    drift_step: int,
    steps: int | None = None,
    lr: float | None = None,
    batch_size: int | None = None,
    base_tag: str | None = None,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> dict:
    """Fine-tune trunk ``scenario`` on its drifted channel family and save
    the reassembled checkpoint as ``hdce_last``.

    Returns the promotion record ``{"tag", "rollback_tag", "base_tag",
    "scenario", "drift_step", "steps", "lr", "loss_first", "loss_last",
    "val_nmse_db_before", "val_nmse_db_after"}``; ``rollback_tag`` names a
    checkpoint with the pre-fine-tune weights."""
    if not (0 <= scenario < cfg.data.n_scenarios):
        raise ValueError(f"scenario must be < {cfg.data.n_scenarios}, got {scenario}")
    if drift_step < 1:
        raise ValueError(f"drift_step must be >= 1 to fine-tune, got {drift_step}")
    ctl = cfg.control
    steps = int(steps if steps is not None else ctl.ft_steps)
    lr = float(lr if lr is not None else ctl.ft_lr)
    batch_size = int(batch_size if batch_size is not None else ctl.ft_batch)

    base_tag = base_tag or latest_tag(workdir, "hdce")
    if base_tag is None:
        raise FileNotFoundError(f"no hdce checkpoint under {workdir!r} to warm-start from")
    base_vars, base_meta = restore_params(workdir, base_tag)
    base_sd = base_vars["params"]
    dev = resolve_device(device)
    model = one_trunk_model(cfg, base_sd, scenario, dev)
    opt = trunk_optimizer(model, lr)

    # the drifted family's grid; the loaders walk scenario `scenario` alone
    drift_data = dataclasses.replace(
        cfg.data, drift_step=int(drift_step), drift_scenario=int(scenario), seed=cfg.data.seed + seed,
    )
    grid = GridData.synthesize(drift_data, dev)
    train_loader = DMLGridLoader(grid, batch_size, "train")
    train_loader.set_process_slice(0, train_loader.batch_size, scen_start=scenario, scen_count=1)
    val_loader = DMLGridLoader(grid, batch_size, "val")
    val_loader.set_process_slice(0, val_loader.batch_size, scen_start=scenario, scen_count=1)

    def _val_nmse_db() -> float:
        err = pow_ = 0.0
        for i, batch in enumerate(val_loader.epoch(0, shuffle=False)):
            out = hdce_eval_step(model, batch)
            err += float(out["err"])
            pow_ += float(out["pow"])
            if i >= 3:  # a few hundred samples bound the probe cost
                break
        return 10.0 * np.log10(max(err / max(pow_, 1e-30), 1e-30))

    with span("control_finetune", scenario=scenario, drift_step=drift_step, steps=steps):
        val_before = _val_nmse_db()
        first = last = None
        done = epoch = 0
        while done < steps:
            for batch in train_loader.epoch(epoch):
                last = hdce_train_step(model, opt, batch)["loss"]
                first = last if first is None else first
                done += 1
                if done >= steps:
                    break
            epoch += 1
        val_after = _val_nmse_db()
    loss_first = None if first is None else float(first)
    loss_last = None if last is None else float(last)
    if loss_last is None or not np.isfinite(loss_last):
        raise RuntimeError(
            f"fine-tune of scenario {scenario} produced non-finite loss "
            f"({loss_last}) — refusing to promote a checkpoint"
        )

    new_sd = reassemble(base_sd, model, scenario)
    rollback_tag = base_tag
    if base_tag == "hdce_last":
        # the promotion below overwrites the warm-start source: keep a copy on disk
        save_checkpoint(workdir, "hdce_prev", base_vars, base_meta or None)
        rollback_tag = "hdce_prev"
    rec = {
        "tag": "hdce_last",
        "rollback_tag": rollback_tag,
        "base_tag": base_tag,
        "scenario": int(scenario),
        "drift_step": int(drift_step),
        "steps": steps,
        "lr": lr,
        "loss_first": loss_first,
        "loss_last": loss_last,
        "val_nmse_db_before": round(float(val_before), 3),
        "val_nmse_db_after": round(float(val_after), 3),
    }
    meta = {
        "epoch": int((base_meta or {}).get("epoch", -1)),
        "name": cfg.name,
        "finetune": {k: rec[k] for k in (
            "scenario", "drift_step", "steps", "lr", "base_tag",
            "val_nmse_db_before", "val_nmse_db_after",
        )},
    }
    save_checkpoint(workdir, "hdce_last", {"params": new_sd}, meta)
    return rec
