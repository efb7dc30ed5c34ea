"""Bond-dimension-chi matrix-product-state simulation of the reference circuit
(``qdml_tpu/quantum/mps.py``).

Past the statevector windows (n > 14) the full 2^n amplitudes per sample are
the wall; the ring-CNOT + rotation ansatz is a low-entanglement circuit, and
an MPS of bond dimension chi holds it in ``O(n chi^2)`` numbers. Exact when
``chi >= 2^(n/2)``, a controlled approximation below that, with the error
non-increasing in chi.

The scheme is the JAX package's, site for site:

- **Sites** ``(B, l, 2, r)``, qubit 0 leftmost, the batch axis in front
  (JAX ``vmap``s one sample at a time). Bond dimensions grow with the
  static rank bound ``min(chi, rows, cols)`` of each split, so every SVD is
  one batched ``torch.linalg.svd`` of ``(B, 2l, 2r)`` complex64 matrices and
  no structurally zero singular value enters a decomposition.
- **Rotations** are single-site contractions with every gate of the circuit
  built in one vectorized trig shot.
- **Adjacent ring CNOTs** contract two sites, apply the 4x4 gate and split
  back by a truncated SVD, the singular values absorbed right.
- **The wraparound CNOT(n-1, 0)** walks the control down to site 1 with
  adjacent SWAPs, applies the reversed-control CNOT on sites (0, 1) and walks
  it back: 2(n-2) + 1 splits of the same kind.
- **<Z_i>** from one left- and one right-environment sweep, normalized by
  <psi|psi> (truncation loses a little norm).

Each SVD is taken in complex128 and its factors rounded back to
complex64 (JAX takes it in complex64): cuSOLVER's complex64 Jacobi SVD
left the card's <Z> 7.8e-4 from the CPU's at n = 16, chi = 16, and
complex128 brings it to 4.2e-5 (measured on one NVIDIA H100 80GB HBM3, 700 W).
What no precision fixes is shared with JAX's scheme (ROADMAP section C): a
split keeps ``min(chi, rows, cols)`` columns, where the block's rank is
lower the extra ones belong to zero singular values and are whatever the
SVD library completes them with, and since the scheme truncates without
first bringing the rest of the chain to canonical form, those columns
enter later blocks' local spectra. Where a later cut then truncates (chi =
8 at L = 3), the state kept depends on the library: JAX against the port,
and the card against the CPU, differ by up to 0.78 in <Z>.

Differentiation: :class:`_TruncSplit` is the split as an autograd Function
whose backward is JAX's projector rule (``qdml_tpu/quantum/mps.py:76-141``),
never torch's SVD backward, which is NaN on the exactly degenerate spectra
this circuit produces. Its backward is the vector-Jacobian product of the
rule's (real-linear) JVP, taken by autograd at ``dtheta = 0``, so it is the
adjoint under ``Re<a, b>`` in torch's complex-gradient convention without a
hand transpose.

Inputs and outputs are real float32 (bfloat16 angles give float32);
complex64 lives only inside. Plain PyTorch on whichever device its inputs
are on: there is no kernel. On the card every SVD is a cuSOLVER call that
checks its result on the host, so the circuit cannot be captured into a CUDA
graph (``train/scan.py`` declines it).
"""

from __future__ import annotations

from functools import lru_cache

import torch

DEFAULT_CHI = 8

# Broadening of the split backward's kept-vs-discarded spectral gaps
# (x -> x / (x^2 + eps)): finite gradients when a cut lands exactly on a
# degenerate multiplet, relative error O(eps / gap^2) otherwise.
_SVD_EPS = 1e-10

def _svd(theta: torch.Tensor, driver: str | None = None):
    """The SVD of a batch taken in complex128, returned in ``theta``'s
    precision. ``driver`` is ``torch.linalg.svd``'s on the card; None,
    torch's choice (batched Jacobi up to 32 x 32), is the fastest of the
    four there (``chip_smoke.py``'s mps phase times them)."""
    u, s, vh = torch.linalg.svd(theta.to(torch.complex128), full_matrices=False, driver=driver)
    return u.to(theta.dtype), s.to(theta.real.dtype), vh.to(theta.dtype)


class _TruncSplit(torch.autograd.Function):
    """Rank-``k`` split of a batch of matrices ``theta ~ left @ right``:
    ``left = U_k`` (an isometry), ``right = S_k V_k^H = U_k^H theta``.

    The backward differentiates only the spectral projector ``P = U_k U_k^H``
    of ``theta theta^H`` (the consumers of a split are gauge-invariant), whose
    first-order change has denominators only across the kept/discarded cut:

        dU_k = U_d (K o (U_d^H drho U_k)) + (I - U U^H) dtheta V_k S_k^-1,
        K_ji = 1 / (lam_i - lam_j)  (i kept, j discarded, lam = s^2),
        dB   = dU_k^H theta + U_k^H dtheta,

    broadened at the cut (``qdml_tpu/quantum/mps.py:104-139``); the
    null-space term only for tall blocks."""

    @staticmethod
    def forward(ctx, theta: torch.Tensor, k: int):
        u, s, vh = _svd(theta)
        ctx.k = k
        ctx.save_for_backward(theta, u, s, vh)
        return u[..., :k], s[..., :k, None].to(vh.dtype) * vh[..., :k, :]

    @staticmethod
    def backward(ctx, g_left, g_right):
        theta, u, s, vh = ctx.saved_tensors
        k = ctx.k
        uk, ud = u[..., :k], u[..., k:]
        sk = s[..., :k]
        lam = s * s
        diff = lam[..., None, :k] - lam[..., k:, None]  # (B, r - k, k)
        kmat = (diff / (diff * diff + _SVD_EPS)).to(theta.dtype)
        sk_inv = (sk / (sk * sk + _SVD_EPS)).to(theta.dtype)
        vk = vh[..., :k, :].mH  # (B, n, k)
        vk_sk = vk * sk[..., None, :].to(theta.dtype)  # theta^H U_k = V_k S_k
        tall = theta.shape[-2] > theta.shape[-1]

        def jvp(dtheta):
            drho_uk = dtheta @ vk_sk + theta @ (dtheta.mH @ uk)
            du_k = ud @ (kmat * (ud.mH @ drho_uk))
            if tall:
                ndtv = dtheta @ vk
                ndtv = ndtv - u @ (u.mH @ ndtv)
                du_k = du_k + ndtv * sk_inv[..., None, :]
            return du_k, du_k.mH @ theta + uk.mH @ dtheta

        with torch.enable_grad():
            dtheta = torch.zeros_like(theta, requires_grad=True)
            du_k, db = jvp(dtheta)
            g_left = torch.zeros_like(du_k) if g_left is None else g_left
            g_right = torch.zeros_like(db) if g_right is None else g_right
            (g_theta,) = torch.autograd.grad((du_k, db), (dtheta,), (g_left, g_right))
        return g_theta, None


def trunc_split(theta: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(left, right)`` of the rank-``k`` split of ``theta`` (..., m, n):
    ``left`` (..., m, k) with orthonormal columns, ``right`` (..., k, n)."""
    return _TruncSplit.apply(theta, k)


def _split_bond(theta: torch.Tensor, chi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A contracted two-site block ``(B, 2l, 2r)`` back into sites ``(B, l, 2,
    keep)`` and ``(B, keep, 2, r)``, the bond truncated to ``keep = min(chi,
    2l, 2r)`` and the singular values absorbed right."""
    b, rows, cols = theta.shape
    keep = min(chi, rows, cols)
    left, right = trunc_split(theta, keep)
    return left.reshape(b, rows // 2, 2, keep), right.reshape(b, keep, 2, cols // 2)


@lru_cache(maxsize=None)
def _fixed_gates(device: str) -> dict[str, torch.Tensor]:
    """The CNOT, reversed CNOT and SWAP gates and the Z diagonal on
    ``device``, cached per device (a copy to the card waits for it), made
    outside inference mode (autograd saves them). Callers must not write
    into them."""
    with torch.inference_mode(False):
        return {
            "cnot": _gate_cnot().to(device),
            "cnot_rev": _gate_cnot(reversed_control=True).to(device),
            "swap": _gate_swap().to(device),
            "z": torch.tensor([1.0, -1.0], dtype=torch.complex64, device=device),
        }


def _gate_cnot(reversed_control: bool = False) -> torch.Tensor:
    """(2, 2, 2, 2) two-site gate ``[p', q', p, q]``: CNOT with the control
    on the left site (or the right, ``reversed_control``)."""
    g = torch.zeros((2, 2, 2, 2), dtype=torch.complex64)
    for p in range(2):
        for q in range(2):
            if reversed_control:
                g[p ^ q, q, p, q] = 1.0
            else:
                g[p, q ^ p, p, q] = 1.0
    return g


def _gate_swap() -> torch.Tensor:
    g = torch.zeros((2, 2, 2, 2), dtype=torch.complex64)
    for p in range(2):
        for q in range(2):
            g[q, p, p, q] = 1.0
    return g


def _apply_1q(site: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """(B, l, 2, r) site <- a 2x2 gate on its physical index."""
    return torch.einsum("ps,blsr->blpr", gate, site)


def _apply_two_site(a: torch.Tensor, b: torch.Tensor, gate: torch.Tensor, chi: int):
    """A two-site gate on adjacent sites: contract, apply, split to chi."""
    theta = torch.einsum("zlpr,zrqs->zlpqs", a, b)
    theta = torch.einsum("pqxy,zlxys->zlpqs", gate, theta)
    z, l, _, _, s = theta.shape
    return _split_bond(theta.reshape(z, l * 2, 2 * s), chi)


def _apply_cnot_wrap(sites: list[torch.Tensor], chi: int, gates: dict) -> list[torch.Tensor]:
    """CNOT(n-1, 0): SWAP the control from site n-1 down to site 1, the
    reversed-control CNOT on sites (0, 1), SWAP it back."""
    n = len(sites)
    for i in range(n - 1, 1, -1):
        sites[i - 1], sites[i] = _apply_two_site(sites[i - 1], sites[i], gates["swap"], chi)
    sites[0], sites[1] = _apply_two_site(sites[0], sites[1], gates["cnot_rev"], chi)
    for i in range(1, n - 1):
        sites[i], sites[i + 1] = _apply_two_site(sites[i], sites[i + 1], gates["swap"], chi)
    return sites


def _expvals_z(sites: list[torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    """Per-wire <Z_i> (B, n) by environment sweeps, normalized by <psi|psi>;
    ``z`` is the Z diagonal."""
    n = len(sites)
    b = sites[0].shape[0]
    one = torch.ones((b, 1, 1), dtype=sites[0].dtype, device=sites[0].device)
    lenvs = [one]
    for t in sites[:-1]:
        lenvs.append(torch.einsum("zab,zapr,zbps->zrs", lenvs[-1], t.conj(), t))
    renv = one
    evs: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
    norm = None
    for i in range(n - 1, -1, -1):
        t = sites[i]
        evs[i] = torch.einsum("zab,zapr,p,zbps,zrs->z", lenvs[i], t.conj(), z, t, renv)
        if i == n - 1:
            norm = torch.einsum("zab,zapr,zbps,zrs->z", lenvs[i], t.conj(), t, renv)
        renv = torch.einsum("zapr,zbps,zrs->zab", t.conj(), t, renv)
    norm_r = torch.clamp(norm.real, min=1e-30)
    return torch.stack([e.real for e in evs], dim=-1) / norm_r[:, None]


def _layer_gates(weights: torch.Tensor) -> torch.Tensor:
    """Every rotation of the circuit, RZ(w1) @ RY(w0), from one trig shot:
    (L, n, 2) float -> (L, n, 2, 2) complex64."""
    half = 0.5 * weights.float()
    c, s = torch.cos(half), torch.sin(half)
    cy, sy, cz, sz = c[..., 0], s[..., 0], c[..., 1], s[..., 1]
    zero = torch.zeros_like(cy)

    def mat(a, b, c_, d):
        return torch.stack([torch.stack([a, b], -1), torch.stack([c_, d], -1)], -2)

    ry = mat(cy, -sy, sy, cy)
    rz = torch.complex(mat(cz, zero, zero, cz), mat(-sz, zero, zero, sz))
    return rz @ torch.complex(ry, torch.zeros_like(ry))


def mps_circuit(
    angles: torch.Tensor,
    weights: torch.Tensor,
    n_qubits: int,
    n_layers: int,
    chi: int = DEFAULT_CHI,
) -> torch.Tensor:
    """The reference circuit on a bond-chi MPS: angles (..., n) -> <Z>
    (..., n), weights (L, n, 2) shared by the batch
    (``qdml_tpu/quantum/mps.py:278-299``). ``chi`` is ``quantum.mps_chi``:
    ``chi >= 2^(n/2)`` is exact; ``chi < 2`` raises ``ValueError``."""
    if chi < 2:
        raise ValueError(f"mps_chi must be >= 2, got {chi}")
    lead = tuple(angles.shape[:-1])
    flat = angles.reshape(-1, n_qubits)
    dev = angles.device
    half_a = 0.5 * flat.float()
    amp = torch.stack([torch.cos(half_a), torch.sin(half_a)], dim=-1).to(torch.complex64)  # (B, n, 2)
    sites = [amp[:, q].reshape(-1, 1, 2, 1) for q in range(n_qubits)]
    rot = _layer_gates(weights)
    gates = _fixed_gates(str(dev))
    for layer in range(n_layers):
        for q in range(n_qubits):
            sites[q] = _apply_1q(sites[q], rot[layer, q])
        for q in range(n_qubits - 1):
            sites[q], sites[q + 1] = _apply_two_site(sites[q], sites[q + 1], gates["cnot"], chi)
        sites = _apply_cnot_wrap(sites, chi, gates)
    out = _expvals_z(sites, gates["z"])
    out = out.to(angles.dtype if angles.dtype != torch.bfloat16 else torch.float32)
    return out.reshape(*lead, n_qubits)
