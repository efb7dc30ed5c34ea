"""Predicted-scenario expert routing (``qdml_tpu/ops/routing.py:42-57``).

The dense route: every trunk runs on the whole batch and each row keeps the
output of its predicted expert. The capacity-bucketed sparse route comes with
a later slice (ROADMAP A.8).
"""

from __future__ import annotations

import torch


def select_expert(stacked: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """``stacked`` (S, B, D), ``pred`` (B,) int ids -> (B, D).

    Out-of-range ids are clipped into ``[0, S-1]``, as in the JAX package, so
    a corrupted id degrades to the nearest valid expert instead of wrapping
    (negative ids) or failing."""
    idx = pred.clamp(0, stacked.shape[0] - 1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]
