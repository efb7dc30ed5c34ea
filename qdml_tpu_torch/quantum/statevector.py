"""State-vector primitives (``qdml_tpu/quantum/statevector.py``) on torch tensors.

Conventions are the reference's: qubit 0 is the MOST significant bit of the
flat basis index, the statevector is a :class:`CArr` real pair of shape
``(..., 2**n)``, batching is the leading axes, and gradients come from
autograd. Structure tables (``z_signs``, ``cnot_perm``, ``ring_cnot_perm``)
are host numpy, cached per qubit count, exactly as in the JAX package; the
circuits read the ring and the sign table as tensors cached per
``(n, device)`` (:func:`ring_index`, :func:`z_sign_table`), since copying a
host table to the card on every call synchronises the host with it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from qdml_tpu_torch.utils.complexops import CArr
from qdml_tpu_torch.utils.device import resolve_device


def zero_state(
    n: int, batch_shape: tuple[int, ...] = (), device: str | torch.device | None = None
) -> CArr:
    """|0...0> statevector, shape ``batch_shape + (2**n,)``."""
    dev = resolve_device(device)
    re = torch.zeros(batch_shape + (2**n,), dtype=torch.float32, device=dev)
    re[..., 0] = 1.0
    return CArr(re, torch.zeros_like(re))


def _split(psi: CArr, n: int, q: int):
    """Expose qubit ``q``: the halves ``psi_{q=0}``, ``psi_{q=1}`` of shape
    ``(..., 2**q, 2**(n-q-1))`` plus the lead shape for reassembly."""
    lead = psi.re.shape[:-1]
    shape = lead + (2**q, 2, 2 ** (n - q - 1))
    vr, vi = psi.re.reshape(shape), psi.im.reshape(shape)
    return CArr(vr[..., 0, :], vi[..., 0, :]), CArr(vr[..., 1, :], vi[..., 1, :]), lead


def _join(p0: CArr, p1: CArr, lead, n: int) -> CArr:
    re = torch.stack([p0.re, p1.re], dim=-2)
    im = torch.stack([p0.im, p1.im], dim=-2)
    return CArr(re.reshape(lead + (2**n,)), im.reshape(lead + (2**n,)))


def _bcast(theta) -> torch.Tensor:
    """Angle with batch shape ``lead`` -> broadcastable over ``(lead, L, R)``."""
    return torch.as_tensor(theta, dtype=torch.float32)[..., None, None]


def apply_ry(psi: CArr, n: int, q: int, theta) -> CArr:
    """RY(theta) on qubit q; ``theta`` scalar or batched with the lead shape."""
    t = torch.as_tensor(theta, dtype=torch.float32, device=psi.re.device)
    return apply_ry_cs(psi, n, q, torch.cos(t / 2), torch.sin(t / 2))


def apply_ry_cs(psi: CArr, n: int, q: int, c, s) -> CArr:
    """RY from precomputed half-angle (cos, sin): ``[c, -s; s, c]``, real."""
    p0, p1, lead = _split(psi, n, q)
    c, s = _bcast(c), _bcast(s)
    new0 = CArr(c * p0.re - s * p1.re, c * p0.im - s * p1.im)
    new1 = CArr(s * p0.re + c * p1.re, s * p0.im + c * p1.im)
    return _join(new0, new1, lead, n)


def apply_rz(psi: CArr, n: int, q: int, theta) -> CArr:
    """RZ(theta) on qubit q: diag(e^{-i theta/2}, e^{+i theta/2})."""
    t = torch.as_tensor(theta, dtype=torch.float32, device=psi.re.device)
    return apply_rz_cs(psi, n, q, torch.cos(t / 2), torch.sin(t / 2))


def apply_rz_cs(psi: CArr, n: int, q: int, c, s) -> CArr:
    """RZ from precomputed half-angle (cos, sin)."""
    p0, p1, lead = _split(psi, n, q)
    c, s = _bcast(c), _bcast(s)
    new0 = CArr(c * p0.re + s * p0.im, c * p0.im - s * p0.re)  # * e^{-i t/2}
    new1 = CArr(c * p1.re - s * p1.im, c * p1.im + s * p1.re)  # * e^{+i t/2}
    return _join(new0, new1, lead, n)


def apply_perm(psi: CArr, perm) -> CArr:
    """Apply a basis-state permutation: ``psi'[y] = psi[perm[y]]``. ``perm``
    is a long tensor on the state's device (:func:`ring_index`) or host
    indices, which are copied over on each call."""
    if isinstance(perm, torch.Tensor):
        idx = perm
    else:
        idx = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=psi.re.device)
    return CArr(psi.re[..., idx], psi.im[..., idx])


def apply_cnot(psi: CArr, n: int, control: int, target: int) -> CArr:
    """CNOT as a basis permutation (gather on the flat statevector)."""
    return apply_perm(psi, cnot_perm(n, control, target))


@lru_cache(maxsize=None)
def cnot_perm(n: int, control: int, target: int) -> np.ndarray:
    """Source-index permutation for CNOT(control, target): psi'[y] = psi[src[y]]."""
    y = np.arange(2**n)
    cbit = (y >> (n - 1 - control)) & 1
    return y ^ (cbit << (n - 1 - target))


@lru_cache(maxsize=None)
def ring_cnot_perm(n: int) -> np.ndarray:
    """Composed permutation of the entangling ring: CNOT(i, i+1) for i < n-1,
    then CNOT(n-1, 0). Returns ``src`` with ``psi'[y] = psi[src[y]]``.

    The ring needs two wires: at n=1 its last gate would be CNOT(0, 0), which
    is no permutation at all, so n < 2 raises."""
    if n < 2:
        raise ValueError(f"the entangling ring needs n >= 2 qubits, got {n}")
    x = np.arange(2**n)
    out = x.copy()
    for c in range(n - 1):
        cbit = (out >> (n - 1 - c)) & 1
        out = out ^ (cbit << (n - 1 - (c + 1)))
    cbit = out & 1
    out = out ^ (cbit << (n - 1))
    # psi'[f(x)] = psi[x]  =>  src[y] = f^{-1}(y)
    src = np.empty_like(x)
    src[out] = x
    return src


@lru_cache(maxsize=None)
def z_signs(n: int) -> np.ndarray:
    """(2**n, n) PauliZ eigenvalues: +1 where bit q (MSB-first) of b is 0."""
    b = np.arange(2**n)
    bits = (b[:, None] >> (n - 1 - np.arange(n))[None, :]) & 1
    return (1.0 - 2.0 * bits).astype(np.float32)


@lru_cache(maxsize=None)
def ring_index(n: int, device: str) -> torch.Tensor:
    """:func:`ring_cnot_perm` as a long tensor on ``device``, cached per
    ``(n, device)``. Callers must not write into it. Made outside inference
    mode, since autograd cannot save an inference tensor for a later
    backward."""
    with torch.inference_mode(False):
        return torch.as_tensor(ring_cnot_perm(n), dtype=torch.long, device=device)


@lru_cache(maxsize=None)
def z_sign_table(n: int, device: str) -> torch.Tensor:
    """:func:`z_signs` as a float32 tensor on ``device``, cached per
    ``(n, device)``, made outside inference mode. Callers must not write
    into it."""
    with torch.inference_mode(False):
        return torch.as_tensor(z_signs(n), device=device)


def ry_product_state(angles: torch.Tensor, n: int) -> torch.Tensor:
    """Closed-form AngleEmbedding: RY(a_q) per qubit on |0...0> is the REAL
    product state ``amp[x] = prod_q (bit_q(x) ? sin(a_q/2) : cos(a_q/2))``.
    Returns the amplitudes, shape ``angles.shape[:-1] + (2**n,)``."""
    lead = angles.shape[:-1]
    half = 0.5 * angles
    c, s = torch.cos(half), torch.sin(half)
    amp = torch.ones(lead + (1,), dtype=torch.float32, device=angles.device)
    for q in range(n):
        pair = torch.stack([c[..., q], s[..., q]], dim=-1)  # (..., 2)
        amp = (amp[..., :, None] * pair[..., None, :]).reshape(lead + (-1,))
    return amp


def expvals_z(psi: CArr, n: int) -> torch.Tensor:
    """Per-wire <PauliZ_i>: probabilities contracted with the sign matrix."""
    return psi.abs2() @ z_sign_table(n, str(psi.re.device))
