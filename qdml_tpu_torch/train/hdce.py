"""HDCE: the stacked per-scenario trunks plus the shared head (``qdml_tpu/train/hdce.py``).

Only the module this slice serves. The fused training step, BatchNorm
momentum compensation and the loaders come with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.models.cnn import FCP128, StackedConvP128, seeded_init_
from qdml_tpu_torch.utils.device import resolve_device


class HDCE(nn.Module):
    """``(S, B, 2, H, W) -> (S, B, out_dim)``: scenario s flows through trunk s,
    every scenario shares the one head (reference ``Runner...py:139-142``).
    State-dict keys: ``trunks.{s}.cnn.*`` and ``head.FC.*``."""

    def __init__(
        self,
        n_scenarios: int = 3,
        features: int = 32,
        out_dim: int = 2048,
        image_hw: tuple[int, int] = (16, 8),
    ):
        super().__init__()
        self.trunks = StackedConvP128(n_scenarios, features)
        self.head = FCP128(features * image_hw[0] * image_hw[1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunks(x))


def build_hdce(
    cfg: ExperimentConfig,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
) -> HDCE:
    """The HDCE the config describes on ``device``, in eval mode; its weights
    are drawn from ``generator`` when one is given."""
    dev = resolve_device(device)
    model = HDCE(cfg.data.n_scenarios, cfg.model.features, cfg.h_out_dim, cfg.image_hw)
    if generator is not None:
        seeded_init_(model, generator)
    return model.to(dev).eval()
