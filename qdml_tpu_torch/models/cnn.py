"""Classical models (``qdml_tpu/models/cnn.py``) as torch modules in NCHW.

Reference architectures (``Estimators_QuantumNAT_onchipQNN.py``):

- ``Conv_P128`` (:237-268): 3 x [Conv3x3(no bias) + BatchNorm + ReLU],
  channels 2->32->32->32, flatten to 32*16*8 = 4096;
- ``FC_P128`` (:272-279): Linear(4096 -> 2048), the shared head;
- ``DCE_P128`` (:40-75): the monolithic estimator, ``Conv_P128`` then the
  ``FC_P128`` head in one module;
- ``SC_P128`` (:79-101): the classical scenario classifier;
- ``QSC_P128.preprocess`` (:152-162): the quantum classifier's CNN front end.

The trunks' BatchNorm follows the JAX package in train mode, not torch's
``BatchNorm2d`` (:class:`BatchNorm2d`): the running statistics decay by the
Flax momentum (``running = decay * running + (1 - decay) * batch``, torch
momentum ``1 - decay``) and take the BIASED batch variance, which Flax both
normalizes with and keeps; torch keeps the unbiased one. :func:`flax_init_`
draws a module's weights as Flax initialises them; :func:`seeded_init_` is
the serving path's seeded draw.

Parameter names are the reference's own (``cnn.{0,3,6}.weight``,
``cnn.{1,4,7}.*``, ``FC.*``, ``conv1``/``conv2``, ``preprocess.{0,3,7}.*``),
the names ``qdml_tpu/train/torch_interop.py`` writes, so reference ``.pth``
files and weights carried from Flax (:mod:`qdml_tpu_torch.interop`) load with
one ``load_state_dict``. Inputs are NCHW ``(B, 2, n_sub, n_beam)`` and
flattening is torch's C-major order, as in the reference.

Activation dtype (``model.dtype``, ``qdml_tpu/models/cnn.py:70-185``): the
trunks, the head and the DCE take a ``dtype`` and cast where Flax casts,
with explicit casts rather than ``torch.autocast``, whose per-op policies
are not Flax's. Each conv reads its input and weight in ``dtype`` and
writes ``dtype``; BatchNorm and ReLU run in float32 on the conv's output
(Flax ``BatchNorm(dtype=float32)``); the trunk's flattened output is
float32; the head reads input, weight and bias in ``dtype``, adds the bias
to the rounded product in ``dtype``, as Flax's ``Dense(dtype)``, and returns
float32. Parameters and their names stay float32 whatever the dtype. The
classifiers take no dtype: JAX's ignore ``model.dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from qdml_tpu_torch.data.channels import truncated_normal


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with the Flax ``BatchNorm`` train-mode statistics
    (``qdml_tpu/models/cnn.py:134-136``): normalize with the biased batch
    variance and fold it, biased, into the running variance with decay
    ``decay`` (Flax's momentum). Eval mode is torch's own. State-dict keys are
    torch's.

    ``group`` (a process group, or ``None``) is the data line of a mesh whose
    ranks each hold some rows of one batch: in train mode the statistics are
    then the whole batch's, as GSPMD computes them, from the sums and sums
    of squares over the group (Flax's mean-of-squares variance), and the
    running statistics update alike on every rank. The sums enter each
    rank's part of a loss that is the sum over the ranks, so their gradient
    is summed too (:func:`~qdml_tpu_torch.parallel.collectives.psum_parts`).

    The trunks call :meth:`forward_relu`, BatchNorm and the ReLU after it in
    one call: on the card in train mode without a group that is one
    hand-written kernel pair (:func:`~qdml_tpu_torch.quantum.kernels.
    batch_norm_relu`); everywhere else this module's plain path."""

    def __init__(self, num_features: int, decay: float = 0.9, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - decay)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._forward_group(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self._update_running(mean, var)
        return out

    def forward_relu(self, x: torch.Tensor) -> torch.Tensor:
        """``relu(self(x))``. A CUDA tensor in train mode without a group
        takes the fused kernels, forward and backward: the statistics taken
        once, the running statistics updated in the kernel as
        :meth:`_update_running` updates them, the ReLU applied in the same
        pass. The CPU, eval mode and a mesh's group take the plain path."""
        if not self.training or self.group is not None or x.device.type == "cpu":
            return F.relu(self(x))
        from qdml_tpu_torch.quantum.kernels import batch_norm_relu

        y = batch_norm_relu(x, self.weight, self.bias, self.running_mean, self.running_var, self.momentum, self.eps)
        self.num_batches_tracked += 1
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)
        self.num_batches_tracked += 1

    def _forward_group(self, x: torch.Tensor) -> torch.Tensor:
        from qdml_tpu_torch.parallel.collectives import psum_parts

        count = torch.tensor([x.numel() / x.shape[1]], dtype=x.dtype, device=x.device)
        sums = psum_parts(torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]), self.group)
        c = x.shape[1]
        mean, var = sums[:c] / sums[-1], sums[c : 2 * c] / sums[-1]
        var = torch.clamp_min(var - mean * mean, 0.0)  # Flax's clamp
        with torch.no_grad():
            self._update_running(mean.detach(), var.detach())
        shape = (1, c, 1, 1)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * (inv * self.weight).view(shape) + self.bias.view(shape)


def dense(fc: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``fc(x)`` as Flax's ``Dense(dtype)`` computes it, returned in float32:
    the product of ``x`` and the weight in ``dtype``, then the bias added in
    ``dtype`` (``qdml_tpu/models/cnn.py:169``)."""
    if dtype == torch.float32:
        return fc(x)
    y = F.linear(x.to(dtype), fc.weight.to(dtype)) + fc.bias.to(dtype)
    return y.float()


class ConvP128(nn.Module):
    """Per-scenario feature extractor: ``(B, 2, 16, 8) -> (B, features*16*8)``.
    ``bn_decay`` is the BatchNorm running-statistics decay per update (Flax
    momentum; the reference's torch momentum 0.1 is decay 0.9); ``dtype``
    the convs' activation dtype (the module docstring)."""

    def __init__(
        self,
        features: int = 32,
        n_layers: int = 3,
        bn_decay: float = 0.9,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.act_dtype = dtype
        blocks: list[nn.Module] = []
        ch = 2
        for _ in range(n_layers):
            blocks += [
                nn.Conv2d(ch, features, 3, padding=1, bias=False),
                BatchNorm2d(features, decay=bn_decay),
                nn.ReLU(),
            ]
            ch = features
        self.cnn = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.act_dtype
        for i in range(0, len(self.cnn), 3):
            conv, bn = self.cnn[i], self.cnn[i + 1]  # the ReLU at i + 2 is bn.forward_relu's
            x = F.conv2d(x.to(dt), conv.weight.to(dt), None, conv.stride, conv.padding)
            x = bn.forward_relu(x.float())
        return x.flatten(1)


class FCP128(nn.Module):
    """Shared estimation head: ``in_dim -> out_dim`` (4096 -> 2048 at full
    width), computed in ``dtype`` (:func:`dense`), float32 out."""

    def __init__(self, in_dim: int = 4096, out_dim: int = 2048, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_dtype = dtype
        self.FC = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.FC, x, self.act_dtype)


class DCEP128(ConvP128):
    """Monolithic direct channel estimator (reference ``DCE_P128``, SURVEY.md
    C2): ``(B, 2, 16, 8) -> (B, out_dim)``, one ``Conv_P128`` trunk for every
    scenario and the ``FC_P128`` head, as ``qdml_tpu/models/cnn.py:172-185``.
    The survey fixes the layers (3 x [Conv k3 no-bias, BN, ReLU], then
    ``Linear(4096, 2048)``) but not their names, so they are ``ConvP128``'s
    ``cnn.{0,3,6}.weight`` / ``cnn.{1,4,7}.*`` and ``FCP128``'s ``FC.*``.
    ``bn_decay`` keeps the default 0.9 per step: the JAX ``DCEP128`` builds
    its trunk with the default momentum over the flattened grid batch, not
    HDCE's ``0.9 ** n_users``. ``dtype`` is the trunk's and the head's
    activation dtype."""

    def __init__(
        self,
        features: int = 32,
        out_dim: int = 2048,
        image_hw: tuple[int, int] = (16, 8),
        bn_decay: float = 0.9,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__(features, bn_decay=bn_decay, dtype=dtype)
        self.FC = nn.Linear(features * image_hw[0] * image_hw[1], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.FC, super().forward(x), self.act_dtype)


class StackedConvP128(nn.ModuleList):
    """All ``n_scenarios`` trunks: ``(S, B, 2, H, W) -> (S, B, F)``; scenario s
    flows through trunk s only."""

    def __init__(
        self,
        n_scenarios: int = 3,
        features: int = 32,
        bn_decay: float = 0.9,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__([ConvP128(features, bn_decay=bn_decay, dtype=dtype) for _ in range(n_scenarios)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([trunk(x[s]) for s, trunk in enumerate(self)])


class SCP128(nn.Module):
    """Classical scenario classifier: ``(B, 2, 16, 8) -> (B, n_classes)`` log-probs."""

    def __init__(self, n_classes: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 32, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(32, 32, 3, padding=1, bias=False)
        self.FC = nn.Linear(32 * 4 * 2, n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.max_pool2d(torch.relu(self.conv1(x)), 2, 2)
        x = torch.max_pool2d(torch.relu(self.conv2(x)), 2, 2)
        return torch.log_softmax(self.FC(x.flatten(1)), dim=-1)


class QSCPreprocess(nn.Sequential):
    """CNN front end of the quantum classifier: Conv 2->16 + ReLU + maxpool2,
    Conv 16->32 + ReLU + maxpool2, flatten 256, Linear -> n_qubits, tanh."""

    def __init__(self, n_qubits: int = 6):
        super().__init__(
            nn.Conv2d(2, 16, 3, padding=1),
            nn.ReLU(),
            nn.MaxPool2d(2, 2),
            nn.Conv2d(16, 32, 3, padding=1),
            nn.ReLU(),
            nn.MaxPool2d(2, 2),
            nn.Flatten(1),
            nn.Linear(32 * 4 * 2, n_qubits),
            nn.Tanh(),
        )


def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every parameter and BatchNorm statistic of ``module`` from
    ``generator`` (a CPU generator), in place, whatever device it lives on:
    conv and linear weights and biases uniform in ``±1/sqrt(fan_in)`` (torch's
    default bound), BatchNorm scale and running variance in [0.5, 1.5], shift
    and running mean in [-0.1, 0.1]. Returns ``module``."""

    def draw(t: torch.Tensor, lo: float, hi: float) -> None:
        v = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(lo + (hi - lo) * v)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                draw(m.weight, -bound, bound)
                if m.bias is not None:
                    draw(m.bias, -bound, bound)
            elif isinstance(m, nn.BatchNorm2d):
                draw(m.weight, 0.5, 1.5)
                draw(m.bias, -0.1, 0.1)
                draw(m.running_mean, -0.1, 0.1)
                draw(m.running_var, 0.5, 1.5)
    return module


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw ``module``'s weights in place as Flax initialises them, from
    ``generator`` (on any device): conv and linear weights lecun-normal
    (truncated normal on [-2, 2] scaled to variance 1/fan_in, as
    ``nn.initializers.lecun_normal``), biases zero, BatchNorm scale 1, shift
    0, running mean 0 and variance 1. A run from this init is distributed as
    a JAX run from ``init_hdce_state``. Returns ``module``."""
    # lecun_normal's stddev correction for the [-2, 2] truncation
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / trunc_std
                m.weight.copy_(std * truncated_normal(generator, tuple(m.weight.shape)))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module
