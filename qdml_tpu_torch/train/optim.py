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
  (``tests/test_torch_port_nat_sweep.py`` holds it to E separate ones);
- the rate lives in a 0-d float32 tensor on the parameters' device
  (:attr:`Optimizer.lr`), written by the host before each update or, on the
  K-step path (:mod:`qdml_tpu_torch.train.scan`), once before each chunk
  (:meth:`Optimizer.pin_rate`): a CUDA graph that captured ``Adam.step``
  reads it at every replay, where a Python float would replay the rate of
  the capture step through every halving. On the card Adam and AdamW are
  built with ``capturable=True`` (step count and bias correction on the
  card), on the per-step path too, so both paths take the same update. The
  CPU keeps the plain optimizers with a float rate: ``capturable`` is
  CUDA-only.
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
    is pruned member by member). ``lr`` is the rate of the next update, a
    0-d float32 tensor on the parameters' device; on the card every param
    group reads that tensor."""

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
        self.lr = torch.tensor(float(schedule(0)), dtype=torch.float32, device=self.params[0].device)
        # a capturable optimizer (Adam, AdamW on the card) reads the tensor
        # itself; the others take a float from the host at every update
        self.tensor_lr = all(group.get("capturable", False) for group in opt.param_groups)
        self._pinned = False
        self._bind_groups()

    def _bind_groups(self) -> None:
        """Point every param group at :attr:`lr` when the optimizer is
        capturable (after construction and after a ``load_state_dict``,
        which installs the saved groups' options)."""
        if self.tensor_lr:
            for group in self.opt.param_groups:
                group["lr"] = self.lr

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for group in self.opt.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def _write_lr(self, rate: float) -> None:
        self.lr.fill_(rate)  # on the card a device write, no host sync
        if not self.tensor_lr:
            for group in self.opt.param_groups:
                group["lr"] = rate

    def pin_rate(self, steps: int) -> float:
        """Write the rate of the next ``steps`` updates once, for a K-step
        dispatch whose captured updates cannot ask the host. The schedule
        changes only at epoch boundaries and a chunk never crosses one, so
        one rate is exact; a chunk whose updates would take two rates
        raises. Updates then leave the rate alone until :meth:`unpin_rate`."""
        rates = {self.schedule(self.count + i) for i in range(steps)}
        if len(rates) != 1:
            raise ValueError(
                f"updates {self.count}..{self.count + steps - 1} span rates {sorted(rates)}: "
                "a K-step dispatch must not cross an epoch boundary"
            )
        rate = rates.pop()
        self._write_lr(rate)
        self._pinned = True
        return rate

    def unpin_rate(self) -> None:
        self._pinned = False

    def step(self) -> None:
        if self.prune is not None:
            self.prune_ratio = gradient_prune_(
                [p.grad for p in self.params], *self.prune, members=self.members
            )
        if not self._pinned:
            self._write_lr(self.schedule(self.count))
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        state = self.opt.state_dict()
        if self.tensor_lr:  # the rate is the schedule's, a float in the file
            for group in state["param_groups"]:
                group["lr"] = float(self.schedule(self.count))
        return {"opt": state, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        """Restore a saved state, from either device: the saved groups'
        ``capturable`` is replaced by this optimizer's own before torch
        loads it, so the step counts land where this optimizer keeps them
        (on the card when capturable, as saved otherwise)."""
        opt_state = dict(state["opt"])
        opt_state["param_groups"] = [
            {**g, "capturable": self.tensor_lr} if "capturable" in g else g for g in opt_state["param_groups"]
        ]
        self.opt.load_state_dict(opt_state)
        self.count = int(state["count"])
        self._bind_groups()


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
    # capturable on the card: step count and bias correction stay there, so
    # a captured update replays right and the per-step path takes the same one
    cap = params[0].device.type == "cuda"
    if cfg.optimizer == "adam":
        opt: torch.optim.Optimizer = torch.optim.Adam(
            params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, capturable=cap
        )
    elif cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(
            params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay,
            capturable=cap,
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
