"""Pauli-twirl trajectories: the circuit under depolarizing noise
(``qdml_tpu/quantum/trajectories.py``).

After the embedding and after every ansatz layer, each wire of each sample
independently suffers a random Pauli: I with probability 1 - p, X, Y or Z
with p/3 each. The average over trajectories converges to the depolarizing
channel's density-matrix evolution without the 4^n density matrix: the
memory is one statevector per sample and trajectory. The trajectories are a
leading batch axis of one statevector evolution, not a Python loop, and the
circuit body is the clean ``tensor`` impl's, one layer at a time
(:func:`~qdml_tpu_torch.quantum.circuits.apply_ansatz_tensor`), so the two
cannot drift. ``p = 0`` draws the identity everywhere and reproduces the
clean circuit exactly.

The Pauli outcomes come from an explicit ``torch.Generator`` (per sample,
per wire, per noise site, per trajectory), or are passed in as indices ``r``
(0 = I, 1 = X, 2 = Y, 3 = Z): the JAX package draws them with
``jax.random.choice``, which no torch generator reproduces, so a test feeds
JAX's draws to hold the two to the same numbers.

Single-qubit anchor: one twirl maps <Z> to (1 - 4p/3) <Z>, since X Z X = -Z,
Y Z Y = -Z and Z Z Z = Z.
"""

from __future__ import annotations

import torch

from qdml_tpu_torch.quantum import statevector as sv
from qdml_tpu_torch.quantum.circuits import angle_embed, apply_ansatz_tensor
from qdml_tpu_torch.utils.complexops import CArr

# The single-qubit Paulis I, X, Y, Z as one (4, 2, 2) real pair, so an
# outcome index picks its gate by a gather.
_PAULI_RE = ((1.0, 0.0), (0.0, 1.0)), ((0.0, 1.0), (1.0, 0.0)), ((0.0, 0.0), (0.0, 0.0)), ((1.0, 0.0), (0.0, -1.0))
_PAULI_IM = ((0.0, 0.0), (0.0, 0.0)), ((0.0, 0.0), (0.0, 0.0)), ((0.0, -1.0), (1.0, 0.0)), ((0.0, 0.0), (0.0, 0.0))


def _check_p(p) -> None:
    """The Pauli probability must lie in [0, 1] (nan refused): outside it
    the outcome distribution (1 - p, p/3, p/3, p/3) is not one."""
    pv = float(p)
    if not 0.0 <= pv <= 1.0:  # also rejects nan
        raise ValueError(f"depolarizing probability p must be in [0, 1], got {pv}")


def draw_outcomes(generator: torch.Generator, shape: tuple[int, ...], p: float) -> torch.Tensor:
    """Pauli outcome indices of ``shape`` on the generator's device: 0 (I)
    with probability 1 - p, 1, 2, 3 (X, Y, Z) with p/3 each."""
    _check_p(p)
    u = torch.rand(shape, generator=generator, device=generator.device)
    edges = torch.tensor([1.0 - p, 1.0 - 2.0 * p / 3.0, 1.0 - p / 3.0], device=u.device)
    return torch.bucketize(u, edges, right=True)


def apply_random_paulis(psi: CArr, r: torch.Tensor, n: int) -> CArr:
    """One twirl: Pauli ``r[..., q]`` on wire q of every sample of ``psi``
    (..., 2^n); ``r`` (..., n) holds outcome indices with ``psi``'s lead
    shape. Per-sample draws keep the samples' Monte-Carlo errors
    independent, so a batch estimate tightens with the batch."""
    pre = torch.tensor(_PAULI_RE, dtype=torch.float32, device=psi.re.device)
    pim = torch.tensor(_PAULI_IM, dtype=torch.float32, device=psi.re.device)
    for q in range(n):
        g_re, g_im = pre[r[..., q]], pim[r[..., q]]  # (..., 2, 2)
        p0, p1, lead = sv._split(psi, n, q)

        def mac(i: int, j: int, v: CArr) -> CArr:
            a, b = g_re[..., i, j, None, None], g_im[..., i, j, None, None]
            return CArr(a * v.re - b * v.im, a * v.im + b * v.re)

        t00, t01, t10, t11 = mac(0, 0, p0), mac(0, 1, p1), mac(1, 0, p0), mac(1, 1, p1)
        psi = sv._join(CArr(t00.re + t01.re, t00.im + t01.im), CArr(t10.re + t11.re, t10.im + t11.im), lead, n)
    return psi


def run_circuit_trajectories(
    angles: torch.Tensor,
    weights: torch.Tensor,
    n_qubits: int,
    n_layers: int,
    p: float,
    generator: torch.Generator | None = None,
    n_traj: int = 32,
    outcomes: torch.Tensor | None = None,
) -> torch.Tensor:
    """The reference circuit under per-layer depolarizing noise, averaged
    over ``n_traj`` trajectories: angles (..., n) -> per-wire <Z> (..., n).

    Noise sites: after the RY embedding and after each ansatz layer, one
    twirl per site and trajectory. The outcomes are ``outcomes`` (n_traj,
    n_layers + 1, ..., n) when given, else drawn from ``generator``."""
    _check_p(p)
    n, nl = n_qubits, n_layers
    lead = tuple(angles.shape[:-1])
    shape = (n_traj, nl + 1, *lead, n)
    if outcomes is None:
        if generator is None:
            raise ValueError("run_circuit_trajectories needs a generator or the outcomes")
        outcomes = draw_outcomes(generator, shape, p)
    elif tuple(outcomes.shape) != shape:
        raise ValueError(f"outcomes must have shape {shape}, got {tuple(outcomes.shape)}")
    r = outcomes.to(angles.device)
    psi = sv.zero_state(n, (n_traj, *lead), device=angles.device)
    psi = angle_embed(psi, angles.expand(n_traj, *angles.shape), n)
    psi = apply_random_paulis(psi, r[:, 0], n)
    for layer in range(nl):
        psi = apply_ansatz_tensor(psi, weights[layer : layer + 1], n, 1)
        psi = apply_random_paulis(psi, r[:, layer + 1], n)
    return sv.expvals_z(psi, n).mean(dim=0)

