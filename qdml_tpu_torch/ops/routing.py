"""Predicted-scenario expert routing (``qdml_tpu/ops/routing.py``).

Two routes give each row the output of its predicted scenario's trunk:

- **dense** (:func:`select_expert`): every trunk runs on the whole batch and
  each row keeps its expert's output;
- **sparse** (:func:`sparse_dispatch`): rows are packed into fixed-capacity
  per-expert buckets, only the chosen trunk runs on each bucket, and the
  outputs are unpacked. Work drops from ``S * B`` trunk rows to about
  ``capacity_factor * B`` whatever S is. Rows past their bucket's capacity
  (overflow) take the dense route's value and are never dropped.

The bookkeeping is the JAX package's: ranks from a one-hot cumsum (no sort)
and a ``(S * C + 1, ...)`` bucket tensor whose last slot takes overflow and
padding rows. Where JAX branches on overflow inside its program
(``lax.cond``), the port reads the overflow count on the host: one sync per
call, and a balanced batch runs no dense pass at all.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def select_expert(stacked: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """``stacked`` (S, B, D), ``pred`` (B,) int ids -> (B, D).

    Out-of-range ids are clipped into ``[0, S-1]``, as in the JAX package, so
    a corrupted id degrades to the nearest valid expert instead of wrapping
    (negative ids) or failing."""
    idx = pred.clamp(0, stacked.shape[0] - 1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]


def expert_capacity(batch: int, n_experts: int, capacity_factor: float) -> int:
    """Per-expert bucket size ``ceil(B * f / S)`` clamped to ``[1, B]``
    (``qdml_tpu/ops/routing.py:85-92``)."""
    c = math.ceil(batch * float(capacity_factor) / max(1, int(n_experts)))
    return max(1, min(int(c), int(batch)))


def bucket_ranks(
    pred: torch.Tensor, n_experts: int, valid: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(clipped ids, rank among the rows of the same expert in batch order).
    Rows with ``valid=False`` take no rank, so a padded batch packs its real
    rows as the unpadded batch would."""
    pred_c = pred.long().clamp(0, n_experts - 1)
    onehot = (pred_c[:, None] == torch.arange(n_experts, device=pred.device)[None, :]).long()
    if valid is not None:
        onehot = onehot * valid.long()[:, None]
    rank = (torch.cumsum(onehot, dim=0) - 1).gather(1, pred_c[:, None])[:, 0]
    return pred_c, rank


def sparse_dispatch(
    run_experts: Callable[[torch.Tensor], torch.Tensor],
    dense_fallback: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    pred: torch.Tensor,
    n_experts: int,
    capacity_factor: float = 1.25,
    valid: torch.Tensor | None = None,
    capacity: int | None = None,
) -> tuple[torch.Tensor, int]:
    """Capacity-bucketed top-1 dispatch, value-equivalent to
    ``select_expert(all trunks, pred)`` (``qdml_tpu/ops/routing.py:111-171``).

    ``run_experts``: ``(S, C, *feat) -> (S, C, D)``, expert s on its bucket's
    rows. ``dense_fallback``: ``(x, pred) -> (B, D)``, all trunks plus the
    gather; it runs only when a valid row overflowed. ``valid``: optional (B,)
    bool; padding rows take no capacity and their outputs are the caller's
    to drop. ``capacity`` overrides :func:`expert_capacity` of ``x.shape[0]``.

    Returns ``(out (B, D), overflow)``: ``overflow`` counts the valid rows the
    dense fallback served, read on the host (the one sync of a call)."""
    b = x.shape[0]
    s = int(n_experts)
    c = capacity if capacity is not None else expert_capacity(b, s, capacity_factor)
    pred_c, rank = bucket_ranks(pred, s, valid=valid)
    fits = rank < c
    if valid is not None:
        fits = fits & valid
    # the trash slot s * c takes overflow and padding rows
    slot = torch.where(fits, pred_c * c + rank, torch.full_like(rank, s * c))
    buckets = x.new_zeros((s * c + 1,) + tuple(x.shape[1:]))
    buckets[slot] = x
    out_sc = run_experts(buckets[: s * c].reshape(s, c, *x.shape[1:]))
    out_flat = out_sc.reshape(s * c, out_sc.shape[-1])
    routed = out_flat[slot.clamp(max=s * c - 1)]
    missed = ~fits if valid is None else (~fits) & valid
    overflow = int(missed.sum())
    # rows that did not fit take the dense value; with no valid row
    # overflowing only padding is left out, and it reads 0 as in JAX
    dense_out = dense_fallback(x, pred_c) if overflow else torch.zeros_like(routed)
    return torch.where(fits[:, None], routed, dense_out), overflow
