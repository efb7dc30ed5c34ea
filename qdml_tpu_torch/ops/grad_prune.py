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

With ``members=True`` every gradient carries a leading member axis (the
noise-sweep ensemble's stacked parameters) and each member is pruned on its
own: the JAX package ``vmap``s the whole optimizer update over the members,
so its quantile is taken per member, over that member's elements only.
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
    """``jnp.quantile(flat, q, axis=-1)`` with linear interpolation, its
    float32 arithmetic step for step: position q * (n - 1), floor and ceil,
    weights. One quantile per row of ``flat``."""
    srt = torch.sort(flat, dim=-1).values
    n = flat.shape[-1]
    pos = torch.tensor(q, dtype=torch.float32) * (n - 1)
    high_w = float(pos - torch.floor(pos))
    low_w = float(1.0 - torch.tensor(high_w, dtype=torch.float32))
    lo = min(max(int(math.floor(float(pos))), 0), n - 1)
    hi = min(max(int(math.ceil(float(pos))), 0), n - 1)
    return srt[..., lo] * low_w + srt[..., hi] * high_w


def gradient_prune_(
    grads: Sequence[torch.Tensor],
    threshold: float = 0.1,
    mode: str = "absolute",
    members: bool = False,
) -> torch.Tensor:
    """Zero the small elements of ``grads`` in place; returns the pruned
    fraction as a 0-d tensor (no host sync), or one fraction per member, an
    (E,) tensor, with ``members`` (each gradient (E, ...), pruned member by
    member)."""
    check_prune_args(threshold, mode)
    grads = [g for g in grads if g is not None]
    # one row per member, or one row for everything
    rows = grads[0].shape[0] if members else 1

    def per_row(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(rows, -1)

    if mode == "quantile":
        cutoff = _quantile(torch.cat([per_row(g.abs()) for g in grads], dim=1), threshold)
        masks = [g.abs() >= cutoff.reshape((rows,) + (1,) * (g.dim() - 1)) if members
                 else g.abs() >= cutoff[0] for g in grads]
    else:
        # reference parity: |g| <= threshold is zeroed
        masks = [g.abs() > threshold for g in grads]
    total = sum(per_row(g).shape[1] for g in grads)
    kept = torch.stack([per_row(m).sum(dim=1) for m in masks]).sum(dim=0)
    for g, m in zip(grads, masks):
        g.mul_(m)
    ratio = 1.0 - kept.float() / total
    return ratio if members else ratio[0]
