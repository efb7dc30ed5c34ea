"""The plain reference of the quantum scenario classifier: the reference
repository's ``QSC_P128`` (``Estimators_QuantumNAT_onchipQNN.py:107-228``)
and its training step (``train_QSC_P128``,
``Runner_P128_QuantumNAT_onchipQNN.py:307-426``: AdamW, QuantumNAT and
gradient pruning off), written from the published description in plain
float32 PyTorch.

Nothing here imports the program under test. Parameters are a dict of
tensors under the names the benchmark gives them (:func:`qsc_specs`), which
are the names of the port's state dict.

- Front end: Conv 2->16 (3x3, padding 1, bias), ReLU, 2x2 max-pool, Conv
  16->32, ReLU, 2x2 max-pool, flattened in C-major order, Linear -> n,
  tanh: the n angles.
- Circuit, as PennyLane defines it: ``AngleEmbedding(rotation="Y")``, an RY
  of the sample's angle on each wire; then each layer an RY and then an RZ
  of that layer's weights on every wire, then CNOT(i, i+1) for i < n-1 and
  CNOT(n-1, 0); the expectation of Pauli Z on each wire. Wire 0 is the most
  significant bit of the basis index, as in PennyLane.
- Head: Linear n -> classes, log-softmax; the loss is the NLL of the
  scenario label, the mean over the whole flattened grid.
- AdamW as PyTorch writes it (decoupled weight decay,
  ``p <- p (1 - lr wd)`` before the Adam update).

Departures from the description, none of them in the mathematics: the
statevector is a complex64 tensor of shape (batch, 2, ..., 2), one axis a
wire, and every gate is written out elementwise (no matrix product, so no
TF32 setting reaches the circuit); the circuit's gradient is autograd's,
where PennyLane's TorchLayer takes the backpropagation of its default
simulator, which is the same derivative. Weights are the benchmark's
seeded draws, not the reference's initialisers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.train import grid_batch


def qsc_specs(n_qubits: int, n_layers: int, n_classes: int, image_hw: tuple[int, int]) -> list[tuple]:
    """The classifier's parameters as (name, shape, init): weights drawn
    lecun-normal (std 1/sqrt(fan_in)), biases zero. The circuit weights
    ``qlayer.weights`` (layers, n, [RY, RZ]) are listed with a placeholder
    init: the benchmark draws them uniform in [0, 2 pi), as PennyLane's
    ``TorchLayer`` does."""
    h, w = image_hw
    flat = 32 * (h // 4) * (w // 4)
    shapes = [("preprocess.0", (16, 2, 3, 3)), ("preprocess.3", (32, 16, 3, 3)), ("preprocess.7", (n_qubits, flat)),
              ("classifier", (n_classes, n_qubits))]
    specs = []
    for name, shape in shapes:
        fan_in = 1
        for d in shape[1:]:
            fan_in *= d
        specs.append((f"{name}.weight", shape, ("normal", fan_in ** -0.5)))
        specs.append((f"{name}.bias", (shape[0],), ("const", 0.0)))
    specs.insert(6, ("qlayer.weights", (n_layers, n_qubits, 2), ("const", 0.0)))
    return specs


def angles(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The front end: (N, 2, H, W) pilot images -> (N, n) angles."""
    x = F.max_pool2d(torch.relu(F.conv2d(x, p["preprocess.0.weight"], p["preprocess.0.bias"], padding=1)), 2)
    x = F.max_pool2d(torch.relu(F.conv2d(x, p["preprocess.3.weight"], p["preprocess.3.bias"], padding=1)), 2)
    return torch.tanh(F.linear(x.flatten(1), p["preprocess.7.weight"], p["preprocess.7.bias"]))


def _pair(psi: torch.Tensor, wire: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The state's halves with ``wire`` at 0 and at 1 (axis 0 is the batch)."""
    return psi.select(wire + 1, 0), psi.select(wire + 1, 1)


def _join(a0: torch.Tensor, a1: torch.Tensor, wire: int) -> torch.Tensor:
    return torch.stack([a0, a1], dim=wire + 1)


def ry(psi: torch.Tensor, wire: int, theta: torch.Tensor) -> torch.Tensor:
    """RY(theta) = [[cos t/2, -sin t/2], [sin t/2, cos t/2]] on ``wire``;
    ``theta`` a scalar or one angle a sample."""
    shape = (-1,) + (1,) * (psi.dim() - 2)
    c = torch.cos(theta / 2).reshape(shape) if theta.dim() else torch.cos(theta / 2)
    s = torch.sin(theta / 2).reshape(shape) if theta.dim() else torch.sin(theta / 2)
    a0, a1 = _pair(psi, wire)
    return _join(c * a0 - s * a1, s * a0 + c * a1, wire)


def rz(psi: torch.Tensor, wire: int, theta: torch.Tensor) -> torch.Tensor:
    """RZ(theta) = diag(exp(-i t/2), exp(i t/2)) on ``wire``."""
    half = theta / 2
    phase = torch.complex(torch.cos(half), torch.sin(half))
    a0, a1 = _pair(psi, wire)
    return _join(a0 * phase.conj(), a1 * phase, wire)


def cnot(psi: torch.Tensor, control: int, target: int) -> torch.Tensor:
    """CNOT: the target's two halves swapped where the control is 1."""
    c0, c1 = _pair(psi, control)
    t = target if target < control else target - 1  # the target's axis once the control's is gone
    flipped = torch.stack([c1.select(t + 1, 1), c1.select(t + 1, 0)], dim=t + 1)
    return _join(c0, flipped, control)


def circuit(a: torch.Tensor, weights: torch.Tensor, n: int, n_layers: int) -> torch.Tensor:
    """(N, n) angles, (layers, n, 2) weights -> (N, n) expectations of Z."""
    psi = torch.zeros((a.shape[0],) + (2,) * n, dtype=torch.complex64, device=a.device)
    psi[(slice(None),) + (0,) * n] = 1.0
    for i in range(n):
        psi = ry(psi, i, a[:, i])
    for layer in range(n_layers):
        for i in range(n):
            psi = ry(psi, i, weights[layer, i, 0])
            psi = rz(psi, i, weights[layer, i, 1])
        for i in range(n):
            psi = cnot(psi, i, (i + 1) % n)
    prob = psi.real ** 2 + psi.imag ** 2
    out = []
    for i in range(n):
        p0, p1 = _pair(prob, i)
        out.append((p0 - p1).flatten(1).sum(1))
    return torch.stack(out, dim=1)


def log_probs(p: dict, x: torch.Tensor, n: int, n_layers: int) -> torch.Tensor:
    """(N, 2, H, W) -> (N, classes) log-probabilities."""
    ev = circuit(angles(p, x), p["qlayer.weights"], n, n_layers)
    return torch.log_softmax(F.linear(ev, p["classifier.weight"], p["classifier.bias"]), dim=-1)


def qsc_loss(p: dict, img: torch.Tensor, n: int, n_layers: int) -> torch.Tensor:
    """``img`` (S, U, B, 2, H, W): the NLL of each row's scenario index, the
    mean over the flattened grid."""
    s, u, b = img.shape[:3]
    labels = torch.arange(s, device=img.device).repeat_interleave(u * b)
    lp = log_probs(p, img.reshape(-1, *img.shape[3:]), n, n_layers)
    return -lp.gather(1, labels[:, None]).mean()


class AdamW:
    """``p <- p (1 - lr wd)``, then ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params: dict, lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = params, lr, weight_decay, betas, eps
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
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr * (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + self.eps))


def follow(params: dict, rows: dict, idxs: list[torch.Tensor], snr_db: float, geom: dict, n: int, n_layers: int,
           lr: float, weight_decay: float) -> dict:
    """Train ``params`` (copied here) for ``len(idxs)`` steps, one (S, U, B)
    batch of indices a step. Returns each step's loss, the first step's
    gradient (``grad1``) and the parameters after the last step
    (``after``)."""
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = AdamW(p, lr=lr, weight_decay=weight_decay)
    names = list(p)
    losses, grad1 = [], None
    for idx in idxs:
        leaves = [p[k].requires_grad_(True) for k in names]
        img, _ = grid_batch(rows, idx, snr_db, geom)
        loss = qsc_loss(p, img, n, n_layers)
        grads = torch.autograd.grad(loss, leaves)
        for k in names:
            p[k] = p[k].detach()
        opt.params = p
        opt.step(dict(zip(names, grads)))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = dict(zip(names, grads))
    return {"losses": losses, "grad1": grad1, "after": p}
