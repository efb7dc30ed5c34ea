"""QuantumNAT noise injection (``qdml_tpu/ops/quantumnat.py``).

Reference behaviour (QuantumNAT, arXiv:2110.11331): during training the
quantum parameters are evaluated at ``param + noise_level * N(0, 1)``; the
gradient is taken at that noisy point and the optimizer updates the clean
parameter. :class:`qdml_tpu_torch.models.qsc.QSCP128` does this for its
circuit weights; :func:`perturb` is the tree-level version over a dict of
tensors, and :func:`perturb_members` the noise-sweep ensemble's, where
member m of stacked parameters gets its own sigma and its own noise, as the
JAX package's ``vmap`` of ``perturb`` gives it (``qdml_tpu/train/
nat_sweep.py:87-100``).
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


def perturb_members(
    params: Mapping[str, torch.Tensor],
    sigmas: torch.Tensor,
    where: Callable[[str, torch.Tensor], bool],
    noise: Mapping[str, torch.Tensor],
) -> dict[str, torch.Tensor]:
    """Stacked parameters (leading member axis E) with member m's selected
    entries at ``p[m] + sigmas[m] * noise[name][m]``, ``noise`` the unit
    normal draws of the selected entries (the caller draws them, so a run on
    the card and its CPU twin, or a test feeding the JAX package's draws,
    see the same numbers). Entries ``where(name, tensor)`` rejects are
    returned as they are."""
    out = {}
    for name, t in params.items():
        if not (t.is_floating_point() and where(name, t)):
            out[name] = t
            continue
        scale = sigmas.to(device=t.device, dtype=t.dtype).reshape((-1,) + (1,) * (t.dim() - 1))
        out[name] = t + scale * noise[name].to(device=t.device, dtype=t.dtype)
    return out
