"""Losses (``qdml_tpu/models/losses.py``): whole-batch NMSE and the classifiers' NLL.

The NMSE is the reference ``NMSELoss``: ``sum((x_hat - x)**2) / sum(x**2)``
over the whole batch, not a per-sample mean. The classifier loss is
``F.nll_loss`` over log-softmax outputs, the mean negative log-likelihood.
"""

from __future__ import annotations

import torch


def nmse_loss(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Whole-batch NMSE over real (packed re/im) arrays."""
    return torch.sum((x_hat - x) ** 2) / torch.sum(x**2)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood given log-probabilities."""
    return -torch.gather(log_probs, -1, labels[..., None].long())[..., 0].mean()


def accuracy(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(log_probs, dim=-1) == labels).float().mean()
