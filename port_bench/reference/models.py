"""The plain reference: the reference repository's estimator
(``Estimators_QuantumNAT_onchipQNN.py``: ``Conv_P128`` trunks and the
``FC_P128`` head) and its training step, written from the published
description in plain float32 PyTorch.

Nothing here imports the program under test. Every function takes its
parameters as a dict of tensors named as the benchmark names them
(:func:`hdce_specs`), which are the names the port's state dicts use, so
that the benchmark can hand the same seeded weights to both sides.

S trunks of three [3x3 conv without bias, BatchNorm, ReLU] from the 2
re/im channels to ``features`` channels, flattened in C-major order, and
one shared linear head. In training, BatchNorm normalises with the biased
batch variance, and its running mean and variance decay towards the
batch's by ``0.9 ** n_users`` a step (the reference's momentum 0.1 a
user's update, taken once a grid step). The loss is the mean over the
(scenario, user) cells of each cell's NMSE over its whole batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


# -- parameter specifications: (name, shape, init) ---------------------------
# init is ("normal", std) or ("const", value)


def _fan_in(shape) -> int:
    return int(math.prod(shape[1:]))


def hdce_specs(n_scenarios: int, features: int, image_hw: tuple[int, int], out_dim: int) -> list[tuple]:
    """The HDCE's parameters and BatchNorm buffers, drawn as Flax's
    lecun-normal draws weights (std 1/sqrt(fan_in)), with a zero head bias
    and BatchNorm at its identity."""
    specs = []
    for s in range(n_scenarios):
        ch = 2
        for i in (0, 3, 6):
            shape = (features, ch, 3, 3)
            specs.append((f"trunks.{s}.cnn.{i}.weight", shape, ("normal", _fan_in(shape) ** -0.5)))
            bn = f"trunks.{s}.cnn.{i + 1}"
            specs += [(f"{bn}.weight", (features,), ("const", 1.0)),
                      (f"{bn}.bias", (features,), ("const", 0.0)),
                      (f"{bn}.running_mean", (features,), ("const", 0.0)),
                      (f"{bn}.running_var", (features,), ("const", 1.0)),
                      (f"{bn}.num_batches_tracked", (), ("const", 0))]
            ch = features
    flat = features * image_hw[0] * image_hw[1]
    specs.append(("head.FC.weight", (out_dim, flat), ("normal", flat ** -0.5)))
    specs.append(("head.FC.bias", (out_dim,), ("const", 0.0)))
    return specs


RUNNING = ("running_mean", "running_var")


def trainable(specs: list[tuple]) -> list[str]:
    """The names of the parameters a training step moves, in spec order."""
    return [n for n, _, _ in specs if not n.endswith((*RUNNING, "num_batches_tracked"))]


def running(specs: list[tuple]) -> list[str]:
    """The names of the BatchNorm running statistics, in spec order."""
    return [n for n, _, _ in specs if n.endswith(RUNNING)]


# -- HDCE --------------------------------------------------------------------


def _batch_norm(x: torch.Tensor, p: dict, name: str, batch_stats: dict) -> torch.Tensor:
    """Train-mode BatchNorm over the batch; its mean and biased variance go
    into ``batch_stats`` under ``name``."""
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    mean = x.mean(dim=(0, 2, 3))
    var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    batch_stats[name] = (mean.detach(), var.detach())
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean.view(1, -1, 1, 1)) * (inv * w).view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def trunk(p: dict, s: int, x: torch.Tensor, batch_stats: dict) -> torch.Tensor:
    """Trunk ``s`` in training: (N, 2, H, W) -> (N, features * H * W)."""
    for i in (0, 3, 6):
        x = F.conv2d(x, p[f"trunks.{s}.cnn.{i}.weight"], padding=1)
        x = torch.relu(_batch_norm(x, p, f"trunks.{s}.cnn.{i + 1}", batch_stats))
    return x.flatten(1)


def head(p: dict, feats: torch.Tensor) -> torch.Tensor:
    return feats @ p["head.FC.weight"].t() + p["head.FC.bias"]


def hdce_loss(p: dict, x: torch.Tensor, label: torch.Tensor, batch_stats: dict) -> torch.Tensor:
    """``x`` (S, U, B, 2, H, W) images and ``label`` (S, U, B, D): the mean
    over the (S, U) cells of each cell's NMSE over its batch. Each
    BatchNorm's batch statistics go into ``batch_stats``."""
    s_n, u_n, b = x.shape[:3]
    losses = []
    for s in range(s_n):
        pred = head(p, trunk(p, s, x[s].reshape(u_n * b, *x.shape[3:]), batch_stats)).reshape(u_n, b, -1)
        err = ((pred - label[s]) ** 2).sum(dim=(-1, -2))
        losses.append(err / (label[s] ** 2).sum(dim=(-1, -2)))
    return torch.stack(losses).mean()
