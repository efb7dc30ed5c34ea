"""QuantumNAT noise injection (``qdml_tpu/ops/quantumnat.py``).

Reference behaviour (QuantumNAT, arXiv:2110.11331): during training the
quantum parameters are evaluated at ``param + noise_level * N(0, 1)``; the
gradient is taken at that noisy point and the optimizer updates the clean
parameter. :class:`qdml_tpu_torch.models.qsc.QSCP128` does this for its
circuit weights; :func:`perturb` is the tree-level version over a dict of
tensors.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch


def perturb(
    params: Mapping[str, torch.Tensor],
    generator: torch.Generator,
    noise_level: float,
    where: Callable[[str, torch.Tensor], bool] | None = None,
) -> dict[str, torch.Tensor]:
    """``params + noise_level * N(0, 1)`` on the selected floating-point
    entries (``where(name, tensor)``; default all), drawn from ``generator``
    in the order of ``params``. The others are returned as they are."""
    out = {}
    for name, t in params.items():
        if t.is_floating_point() and (where is None or where(name, t)):
            noise = torch.randn(t.shape, generator=generator, device=generator.device)
            out[name] = t + noise_level * noise.to(device=t.device, dtype=t.dtype)
        else:
            out[name] = t
    return out
