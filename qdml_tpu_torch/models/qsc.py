"""Quantum scenario classifier (``qdml_tpu/models/qsc.py``).

CNN front end -> tanh angles -> the variational circuit
(:func:`qdml_tpu_torch.quantum.circuits.run_circuit`, whichever impl the
config names, ``mps`` at bond dimension ``mps_chi``) -> linear head ->
log-softmax. Parameter names follow the
reference ``QSC_P128`` (``preprocess.{0,3,7}.*``, ``qlayer.weights`` of shape
(L, n, 2), ``classifier.*``).

QuantumNAT: in train mode with ``use_quantumnat`` and ``noise_level > 0`` the
circuit runs at ``weights + noise``, so the gradient is taken at the noisy
point while the optimizer updates the clean parameter
(``qdml_tpu/models/qsc.py:83-87``). The noise is passed in or drawn from the
caller's generator.

The front end (``preprocess``, the reference's ``nn.Sequential``) runs on
the card as one hand-written kernel pair
(:func:`~qdml_tpu_torch.quantum.kernels.qsc_front_end`) where
:func:`front_end_on_kernel` finds what the kernel computes: a float32 CUDA
input that needs no gradient of its own, H and W multiples of 4, the
published widths, at most 32 qubits. Everything else, the CPU among it,
runs the ``nn.Sequential``; so does code that calls ``preprocess`` itself,
as the noise-sweep ensemble's ``vmap`` does.

Depolarizing noise (``depolarizing_p > 0``, beyond the reference): the clean
circuit is replaced by the trajectory average of
:func:`~qdml_tpu_torch.quantum.trajectories.run_circuit_trajectories`, whose
Pauli outcomes come from the caller's ``traj_generator``. The trajectory
simulator has the gate-wise ``tensor`` formulation only, so an impl or
backend pinned to another path raises ``ValueError``
(``qdml_tpu/models/qsc.py:89-106``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.models.cnn import SCP128, QSCPreprocess, seeded_init_
from qdml_tpu_torch.quantum import kernels
from qdml_tpu_torch.quantum.circuits import run_circuit
from qdml_tpu_torch.quantum.trajectories import run_circuit_trajectories
from qdml_tpu_torch.utils.device import resolve_device


def _published(pre: nn.Module) -> bool:
    """``pre`` is the published front end, layer for layer: conv 2 -> 16 and
    16 -> 32 (3x3, stride 1, zero padding 1, a bias), each with a ReLU and a
    2x2 max-pool of stride 2, the flatten, a Linear with a bias, tanh."""
    if type(pre) is not QSCPreprocess or len(pre) != 9:
        return False
    conv1, conv2, fc = pre[0], pre[3], pre[7]
    convs = all(
        type(c) is nn.Conv2d and c.bias is not None
        and (c.stride, c.padding, c.dilation, c.groups, c.padding_mode) == ((1, 1), (1, 1), (1, 1), 1, "zeros")
        for c in (conv1, conv2)
    )
    pools = all(
        type(m) is nn.MaxPool2d and (m.kernel_size, m.stride, m.padding, m.dilation, m.ceil_mode) == (2, 2, 0, 1, False)
        for m in (pre[2], pre[5])
    )
    return (
        convs and pools
        and tuple(conv1.weight.shape) == kernels.QSC_FRONT_CONV_SHAPES[0]
        and tuple(conv2.weight.shape) == kernels.QSC_FRONT_CONV_SHAPES[2]
        and type(fc) is nn.Linear and fc.bias is not None
        and [type(pre[i]) for i in (1, 4, 6, 8)] == [nn.ReLU, nn.ReLU, nn.Flatten, nn.Tanh]
        and (pre[6].start_dim, pre[6].end_dim) == (1, -1)
    )


def front_end_on_kernel(pre: nn.Module, x: torch.Tensor) -> bool:
    """Whether ``QSCP128.forward`` runs the front end ``pre`` on ``x`` as the
    hand-written kernel pair: ``x`` a 4-D float32 CUDA tensor that does not
    require grad, its H and W multiples of 4 and the Linear's width theirs,
    ``pre`` the published front end with at most 32 outputs. Reads shapes
    and flags only."""
    if not (x.device.type == "cuda" and x.dtype == torch.float32 and not x.requires_grad and x.dim() == 4):
        return False
    h, w = x.shape[2], x.shape[3]
    return (
        h % 4 == 0 and w % 4 == 0 and _published(pre)
        and pre[7].in_features == 32 * (h // 4) * (w // 4)
        and pre[7].out_features <= kernels.QSC_FRONT_MAX_QUBITS
    )


class QuantumLayer(nn.Module):
    """Holds the circuit weights under the reference name ``weights``."""

    def __init__(self, n_layers: int, n_qubits: int):
        super().__init__()
        self.weights = nn.Parameter(torch.zeros(n_layers, n_qubits, 2))


class QSCP128(nn.Module):
    """``(B, 2, 16, 8) -> (B, n_classes)`` log-probabilities."""

    def __init__(
        self,
        n_qubits: int = 6,
        n_layers: int = 3,
        n_classes: int = 3,
        backend: str = "auto",
        impl: str = "auto",
        input_norm: bool = False,
        use_quantumnat: bool = False,
        noise_level: float = 0.01,
        depolarizing_p: float = 0.0,
        n_trajectories: int = 32,
        mps_chi: int = 8,
    ):
        super().__init__()
        self.mps_chi = mps_chi
        self.n_qubits, self.n_layers = n_qubits, n_layers
        self.backend, self.impl, self.input_norm = backend, impl, input_norm
        self.use_quantumnat, self.noise_level = use_quantumnat, noise_level
        self.depolarizing_p, self.n_trajectories = depolarizing_p, n_trajectories
        self.preprocess = QSCPreprocess(n_qubits)
        self.qlayer = QuantumLayer(n_layers, n_qubits)
        self.classifier = nn.Linear(n_qubits, n_classes)

    def forward(
        self,
        x: torch.Tensor,
        train: bool = False,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        impl: str | None = None,
        traj_generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """The front end runs where :func:`front_end_on_kernel` says. ``train``
        turns QuantumNAT on (when configured): the circuit weights
        get ``noise`` added, or ``noise_level * N(0, 1)`` drawn from
        ``generator`` when no noise is passed. ``impl`` pins the circuit impl
        for this call (the serving engine pins each bucket's warmup
        resolution); otherwise the model's own ``impl`` resolves, with the
        train winner in train mode and the forward winner in eval mode
        (``qdml_tpu/models/qsc.py:117-126``). With ``depolarizing_p > 0`` the
        circuit is the trajectory average, its outcomes drawn from
        ``traj_generator``."""
        if self.input_norm:
            rms = torch.sqrt(torch.mean(x**2, dim=(1, 2, 3), keepdim=True) + 1e-12)
            x = x / rms
        pre = self.preprocess
        if front_end_on_kernel(pre, x):
            angles = kernels.qsc_front_end(
                x.contiguous(), pre[0].weight, pre[0].bias, pre[3].weight, pre[3].bias, pre[7].weight, pre[7].bias
            )
        else:
            angles = pre(x)
        weights = self.qlayer.weights
        if train and self.use_quantumnat and self.noise_level > 0:
            if noise is None:
                dev = weights.device if generator is None else generator.device
                noise = self.noise_level * torch.randn(
                    weights.shape, generator=generator, device=dev
                )
            weights = weights + noise.to(weights.device)
        impl = impl or self.impl
        if self.depolarizing_p > 0.0:
            # an explicit impl wins outright, so impl='tensor' is fine whatever
            # the legacy backend says; with impl auto the backend must allow tensor
            forced_ok = impl == "tensor" or (impl in ("", "auto") and self.backend in ("auto", "tensor"))
            if not forced_ok:
                raise ValueError(
                    f"depolarizing_p={self.depolarizing_p} uses the trajectory simulator "
                    f"(tensor formulation only); backend={self.backend!r}/impl={impl!r} cannot "
                    "be honored — configure 'tensor' (or leave 'auto') for noisy evaluation"
                )
            if traj_generator is None:
                raise ValueError(f"depolarizing_p={self.depolarizing_p} needs a traj_generator")
            expz = run_circuit_trajectories(
                angles, weights, self.n_qubits, self.n_layers, self.depolarizing_p,
                traj_generator, self.n_trajectories,
            )
            return torch.log_softmax(self.classifier(expz), dim=-1)
        expz = run_circuit(
            angles,
            weights,
            self.n_qubits,
            self.n_layers,
            self.backend,
            impl=impl,
            mode="train" if self.training else "infer",
            mps_chi=self.mps_chi,
        )
        return torch.log_softmax(self.classifier(expz), dim=-1)


def build_classifier(
    cfg: ExperimentConfig,
    quantum: bool,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
) -> nn.Module:
    """The scenario classifier the config describes (``QSCP128`` when
    ``quantum``, else ``SCP128``) on ``device``, in eval mode; its weights are
    drawn from ``generator`` when one is given."""
    dev = resolve_device(device)
    q = cfg.quantum
    if quantum:
        clf: nn.Module = QSCP128(
            q.n_qubits, q.n_layers, q.n_classes, q.backend, q.impl, q.input_norm, mps_chi=q.mps_chi
        )
    else:
        clf = SCP128(q.n_classes)
    if generator is not None:
        seeded_init_(clf, generator)
        if quantum:
            # uniform in [0, 2pi), as PennyLane's TorchLayer draws them
            w = clf.qlayer.weights
            with torch.no_grad():
                w.copy_(2.0 * math.pi * torch.rand(w.shape, generator=generator))
    return clf.to(dev).eval()
