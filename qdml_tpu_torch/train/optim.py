"""Optimizers and the LR schedule (``qdml_tpu/train/optim.py``).

- ``adam`` is ``torch.optim.Adam(eps=1e-8)``, ``adamw`` is
  ``torch.optim.AdamW(weight_decay)``, ``sgd`` is ``torch.optim.SGD(momentum)``:
  each takes the same update as its optax counterpart on the same gradients
  (``tests/test_torch_port_optim.py``);
- the learning rate halves every ``lr_decay_epochs`` epochs down to
  ``lr_floor``, indexed by the update count as optax indexes its schedule
  (the rate of update k is ``schedule(k)``, k counting from 0);
- gradient pruning, when the quantum config asks for it, runs on the
  gradients between ``backward()`` and the update, as it sits at the front of
  the JAX package's optax chain; for stacked ensemble parameters
  (``members=True``) it prunes each member on its own, as the JAX package's
  ``vmap`` of the whole update does. Adam and AdamW are elementwise, so one
  optimizer over stacked parameters takes each member's own update
  (``tests/test_torch_port_nat_sweep.py`` holds it to E separate ones).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

from qdml_tpu_torch.config import QuantumConfig, TrainConfig
from qdml_tpu_torch.ops.grad_prune import check_prune_args, gradient_prune_


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Step-indexed schedule: halve every ``lr_decay_epochs`` epochs, floored."""

    def sched(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return max(cfg.lr * 0.5 ** (epoch // cfg.lr_decay_epochs), cfg.lr_floor)

    return sched


class Optimizer:
    """A torch optimizer driven by the schedule, with optional gradient
    pruning in front. ``count`` is the number of updates taken; the pruned
    fraction of the last update is ``prune_ratio`` (a 0-d tensor, or (E,)
    with ``members``: every parameter then carries a leading member axis and
    is pruned member by member)."""

    def __init__(
        self,
        opt: torch.optim.Optimizer,
        schedule: Callable[[int], float],
        prune: tuple[float, str] | None = None,
        members: bool = False,
    ):
        self.opt = opt
        self.schedule = schedule
        self.prune = prune
        self.members = members
        self.count = 0
        self.prune_ratio: torch.Tensor | None = None

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for group in self.opt.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.prune is not None:
            self.prune_ratio = gradient_prune_(
                [p.grad for p in self.params], *self.prune, members=self.members
            )
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def get_optimizer(
    cfg: TrainConfig,
    params: Iterable[torch.Tensor],
    steps_per_epoch: int,
    quantum: QuantumConfig | None = None,
    members: bool = False,
) -> Optimizer:
    if cfg.moments_dtype == "bfloat16":
        raise NotImplementedError(
            "moments_dtype='bfloat16' (bf16 Adam moments, a documented non-default "
            "deviation of the JAX package) is not ported (ROADMAP A.6)"
        )
    if cfg.moments_dtype != "float32":
        raise ValueError(f"moments_dtype must be float32 or bfloat16, got {cfg.moments_dtype!r}")
    sched = lr_schedule(cfg, steps_per_epoch)
    params = list(params)
    lr0 = sched(0)
    if cfg.optimizer == "adam":
        opt: torch.optim.Optimizer = torch.optim.Adam(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8)
    elif cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(
            params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay
        )
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=cfg.momentum)
    else:
        raise NotImplementedError(f"optimizer {cfg.optimizer!r}")
    prune = None
    if quantum is not None and quantum.use_gradient_pruning:
        check_prune_args(quantum.gradient_threshold, quantum.gradient_prune_mode)
        prune = (quantum.gradient_threshold, quantum.gradient_prune_mode)
    return Optimizer(opt, sched, prune, members)
