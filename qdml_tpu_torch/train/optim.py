"""Optimizers and the LR schedule (``qdml_tpu/train/optim.py``).

- ``adam`` is ``torch.optim.Adam(eps=1e-8)``, ``adamw`` is
  ``torch.optim.AdamW(weight_decay)``, ``sgd`` is ``torch.optim.SGD(momentum)``:
  each takes the same update as its optax counterpart on the same gradients
  (``tests/test_torch_port_optim.py``);
- ``adam`` with ``train.moments_dtype="bfloat16"`` is :class:`AdamLowp`, the
  JAX package's ``scale_by_adam_lowp`` (``qdml_tpu/train/optim.py:24-85``):
  the first moment stored in bfloat16, the second in float32, every
  product, bias correction and square root in float32. ``adamw`` and ``sgd``
  warn and keep float32 moments, as in JAX;
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
  CUDA-only. :class:`AdamLowp` keeps its count on the parameters' device
  everywhere and reads :attr:`Optimizer.lr` on the card, so it captures.
"""

from __future__ import annotations

import warnings
from typing import Callable, Iterable, Mapping

import torch

from qdml_tpu_torch.config import QuantumConfig, TrainConfig
from qdml_tpu_torch.ops.grad_prune import check_prune_args, gradient_prune_
from qdml_tpu_torch.telemetry.spans import span


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Step-indexed schedule: halve every ``lr_decay_epochs`` epochs, floored."""

    def sched(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return max(cfg.lr * 0.5 ** (epoch // cfg.lr_decay_epochs), cfg.lr_floor)

    return sched


class AdamLowp(torch.optim.Optimizer):
    """Adam whose first moment ``exp_avg`` is stored in bfloat16 and second
    moment ``exp_avg_sq`` in float32 (``qdml_tpu/train/optim.py:24-85``):

        mu = bf16(b1 * f32(mu) + (1 - b1) * g)
        nu = b2 * nu + ((1 - b2) * g) * g
        p -= lr * ((f32(mu) / bc1) / (sqrt(nu / bc2) + eps)),  bc_i = 1 - b_i^count

    each operation rounded in float32 as optax rounds it. A bfloat16 nu
    could not decay: its per-step change (1 - b2 = 1e-3) is below half a
    bfloat16 ulp. The count is a float32 tensor on the parameters' device
    and the update reads the rate as a tensor when ``capturable`` (the card,
    where the rate is :attr:`Optimizer.lr`), so a CUDA graph may capture it.
    ``torch._foreach_*`` ops over each parameter group."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps: float = 1e-8, capturable: bool = False):
        super().__init__(params, {"lr": lr, "betas": betas, "eps": eps, "capturable": capturable})

    def _init_state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32, memory_format=torch.preserve_format)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamLowp.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self._init_state(p) for p in params]
            grads = [p.grad for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            steps = [st["step"] for st in states]
            torch._foreach_add_(steps, 1.0)
            bc1 = 1.0 - torch.pow(b1, steps[0])
            bc2 = 1.0 - torch.pow(b2, steps[0])
            # first moment: f32 arithmetic, stored rounded to bf16
            mu32 = [m.float() for m in mus]
            torch._foreach_mul_(mu32, b1)
            torch._foreach_add_(mu32, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_copy_(mus, mu32)
            torch._foreach_copy_(mu32, mus)  # the update reads the stored mu
            # second moment in f32
            g2 = torch._foreach_mul(grads, 1.0 - b2)
            torch._foreach_mul_(g2, grads)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, g2)
            den = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(mu32, bc1)
            torch._foreach_div_(mu32, den)
            torch._foreach_mul_(mu32, group["lr"])
            torch._foreach_sub_(params, mu32)
        return None

    def load_state_dict(self, state_dict: dict) -> None:
        """torch casts a loaded state to its parameter's dtype; the moments
        go back to their storage dtypes and the count to the parameter's
        device."""
        super().load_state_dict(state_dict)
        for p, state in self.state.items():
            if "exp_avg" in state:
                state["exp_avg"] = state["exp_avg"].to(torch.bfloat16)
                state["exp_avg_sq"] = state["exp_avg_sq"].to(torch.float32)
                state["step"] = state["step"].to(torch.float32).to(p.device)


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
        # Under a mesh: reduces the gradients over the ranks before pruning
        # and the update (parallel.dp.sync_grads), as GSPMD's gradient is
        # the global one by the time optax sees it
        self.grad_sync: Callable[[], None] | None = None
        # Under a mesh: per probe branch, the group whose ranks hold distinct
        # shards of it, over which the probe's sums are added (the global probe)
        self.probe_groups: Mapping | None = None
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

    def step(self, probe: Mapping[str, list[torch.Tensor]] | None = None) -> dict | None:
        """One update. With ``probe`` (the parameters by branch, named as
        the JAX package's parameter tree), returns the numerics probe of it
        (:func:`~qdml_tpu_torch.telemetry.numerics.probe_tree`, device
        tensors, no host sync): the gradients after ``grad_sync`` and before
        pruning, the parameters before the update, and the updates the
        optimizer applied (:meth:`updates`), as JAX probes the optax updates;
        each branch's sums added over its :attr:`probe_groups` entry."""
        if self.grad_sync is not None:
            self.grad_sync()
        pre = None
        if probe is not None:
            from qdml_tpu_torch.telemetry.numerics import branch_stats

            pre = {k: branch_stats([p.grad for p in ps], ps, members=self.members) for k, ps in probe.items()}
        if self.prune is not None:
            self.prune_ratio = gradient_prune_(
                [p.grad for p in self.params], *self.prune, members=self.members
            )
        if not self._pinned:
            self._write_lr(self.schedule(self.count))
        self.opt.step()
        self.count += 1
        if pre is None:
            return None
        from qdml_tpu_torch.telemetry.numerics import branch_stats, probe_from_stats

        upd = self.updates()
        stats = {
            k: pre[k] + branch_stats(updates=[upd[p] for p in ps if p in upd], members=self.members)
            for k, ps in probe.items()
        }
        return probe_from_stats(stats, True, True, True, self.probe_groups)

    @torch.no_grad()
    def updates(self) -> dict[torch.Tensor, torch.Tensor]:
        """The deltas the last :meth:`step` applied, per parameter, computed
        from the optimizer's state as the update formula reads it (not a
        difference of parameters, which would cancel to a few bits): Adam's
        ``-lr * (m / bc1) / (sqrt(v / bc2) + eps)``, AdamW's plus ``-lr * wd *
        p_before``, SGD's ``-lr * buf`` (or ``-lr * g``). Multi-tensor
        (``torch._foreach_*``) device ops over each param group, so a CUDA
        graph captures them with the step in a few launches."""
        out: dict[torch.Tensor, torch.Tensor] = {}
        sgd = isinstance(self.opt, torch.optim.SGD)
        adamw = isinstance(self.opt, torch.optim.AdamW)
        for group in self.opt.param_groups:
            lr = group["lr"]
            params = [p for p in group["params"] if p.grad is not None and (sgd or p in self.opt.state)]
            if not params:
                continue
            if sgd:
                bufs = [self.opt.state.get(p, {}).get("momentum_buffer") for p in params]
                upd = torch._foreach_mul([p.grad if b is None else b for p, b in zip(params, bufs)], -lr)
                out.update(zip(params, upd))
                continue
            b1, b2 = group["betas"]
            states = [self.opt.state[p] for p in params]
            steps = [st["step"] for st in states]
            bc1 = torch._foreach_pow(b1, steps)
            torch._foreach_neg_(bc1)
            torch._foreach_add_(bc1, 1.0)
            bc2 = torch._foreach_pow(b2, steps)
            torch._foreach_neg_(bc2)
            torch._foreach_add_(bc2, 1.0)
            direction = torch._foreach_div([st["exp_avg"].float() for st in states], bc1)
            den = torch._foreach_div([st["exp_avg_sq"] for st in states], bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(direction, den)
            upd = torch._foreach_mul(direction, -lr)
            if adamw and group["weight_decay"]:
                wd = lr * group["weight_decay"]
                # p before the update: p_new = p_old (1 - lr wd) - lr direction
                before = torch._foreach_sub(params, upd)  # p + lr * direction
                torch._foreach_div_(before, 1.0 - wd)
                torch._foreach_mul_(before, wd)
                torch._foreach_sub_(upd, before)
            out.update(zip(params, upd))
        return out

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


_MOMENTS_DTYPES = ("float32", "bfloat16")


@span("optimizer_init")
def get_optimizer(
    cfg: TrainConfig,
    params: Iterable[torch.Tensor],
    steps_per_epoch: int,
    quantum: QuantumConfig | None = None,
    members: bool = False,
) -> Optimizer:
    """``cfg``'s optimizer and rate schedule over ``params``, built under an
    ``optimizer_init`` span (a first construction imports what torch.optim
    loads lazily)."""
    # the JAX package's rejection contract: a typo like 'bf16' must not
    # silently select the f32 path
    if cfg.moments_dtype not in _MOMENTS_DTYPES:
        raise ValueError(f"moments_dtype must be one of {_MOMENTS_DTYPES}, got {cfg.moments_dtype!r}")
    lowp = cfg.moments_dtype == "bfloat16"
    if lowp and cfg.optimizer != "adam":
        warnings.warn(
            f"moments_dtype='bfloat16' applies only to optimizer='adam'; "
            f"optimizer {cfg.optimizer!r} keeps float32 moments",
            stacklevel=2,
        )
    sched = lr_schedule(cfg, steps_per_epoch)
    params = list(params)
    lr0 = sched(0)
    # capturable on the card: step count and bias correction stay there, so
    # a captured update replays right and the per-step path takes the same one
    cap = params[0].device.type == "cuda"
    if cfg.optimizer == "adam" and lowp:
        opt: torch.optim.Optimizer = AdamLowp(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8, capturable=cap)
    elif cfg.optimizer == "adam":
        opt = torch.optim.Adam(
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
