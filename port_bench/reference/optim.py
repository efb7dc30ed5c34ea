"""Adam as published (Kingma and Ba), in plain float32 PyTorch, over a dict
of parameters."""

from __future__ import annotations

import torch


class Adam:
    """``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params: dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        b1, b2 = self.betas
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr * (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + self.eps))
