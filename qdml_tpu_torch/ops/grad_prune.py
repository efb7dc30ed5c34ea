"""On-chip-QNN gradient pruning (``qdml_tpu/ops/grad_prune.py``), in place on ``.grad``.

Reference behaviour: after ``loss.backward()`` and before
``optimizer.step()``, zero every gradient element with ``|g| <= threshold``
across ALL parameters. The JAX package puts this at the front of its optax
chain; the port applies :func:`gradient_prune_` between ``backward()`` and
``optimizer.step()`` (:class:`qdml_tpu_torch.train.optim.Optimizer` does).

``mode="quantile"`` reads ``threshold`` in [0, 1) as the FRACTION of elements
to prune: the cutoff is the global ``threshold``-quantile of ``|g|`` (linear
interpolation, as ``jnp.quantile``), and elements AT the cutoff survive, so
0.0 prunes nothing and ties under-prune instead of zeroing a whole
all-equal gradient.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

PRUNE_MODES = ("absolute", "quantile")


def check_prune_args(threshold: float, mode: str) -> None:
    if mode not in PRUNE_MODES:
        raise ValueError(f"gradient_prune mode must be absolute|quantile, got {mode!r}")
    if mode == "quantile" and not 0.0 <= threshold < 1.0:
        raise ValueError(f"quantile threshold must be in [0, 1), got {threshold}")


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` with linear interpolation, its float32
    arithmetic step for step: position q * (n - 1), floor and ceil, weights."""
    srt = torch.sort(flat).values
    n = flat.numel()
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    high_w = float(pos - torch.floor(pos))
    low_w = float(1.0 - torch.tensor(high_w, dtype=torch.float32))
    lo = min(max(int(math.floor(float(pos))), 0), n - 1)
    hi = min(max(int(math.ceil(float(pos))), 0), n - 1)
    return srt[lo] * low_w + srt[hi] * high_w


def gradient_prune_(
    grads: Sequence[torch.Tensor], threshold: float = 0.1, mode: str = "absolute"
) -> torch.Tensor:
    """Zero the small elements of ``grads`` in place; returns the pruned
    fraction as a 0-d tensor (no host sync)."""
    check_prune_args(threshold, mode)
    grads = [g for g in grads if g is not None]
    if mode == "quantile":
        cutoff = _quantile(torch.cat([g.abs().reshape(-1) for g in grads]), threshold)
        masks = [g.abs() >= cutoff for g in grads]
    else:
        # reference parity: |g| <= threshold is zeroed
        masks = [g.abs() > threshold for g in grads]
    total = sum(g.numel() for g in grads)
    kept = torch.stack([m.sum() for m in masks]).sum()
    for g, m in zip(grads, masks):
        g.mul_(m)
    return 1.0 - kept.float() / total
