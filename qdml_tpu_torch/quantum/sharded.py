"""The statevector sharded over the mesh's ``model`` ranks (``qdml_tpu/quantum/sharded.py``).

Layout, as in JAX: with K = 2^k ranks on the model line, the k MOST
significant wires are global (their bits, MSB-first, are the rank's index in
the model line) and the other n - k are local, so each rank holds a shard
``(B, 2^(n-k))`` of every state.

The gate math is written as plain functions of the shard and, where a gate
mixes two shards, of the partner's shard, handed in as an argument
(:func:`ry_global`, :func:`rz_global`, :func:`cnot_sharded`,
:func:`expvals_z_local`), so each case is testable in one process. The
layer :func:`run_circuit_sharded` fetches the partner shard (the rank whose
index differs in the gate's bit) through
:func:`~qdml_tpu_torch.parallel.collectives.exchange`:

- RY on a global wire: one exchange, then a linear combination;
- RZ on a global wire: diagonal, the rank's bit picks the phase, no exchange;
- a layer's local wires, RY(w[l, q, 0]) then RZ(w[l, q, 1]) for q >= k: one
  call of :func:`~qdml_tpu_torch.quantum.kernels.apply_rotation_layer` on the
  shard with ``weights[l, k:]`` (the B.3 kernel on the card, its plain
  version on the CPU). Gates on different wires commute, so this equals
  JAX's wire-by-wire order;
- CNOT: both wires local, a permutation (the run of local ring CNOTs is one
  composed permutation); a global control and a local target, a flip where
  the rank's bit is 1; a local control and a global target, an exchange
  taken where the local control bit is 1; both global, an exchange taken
  where the rank's control bit is 1.

The embedding builds the shard of the RY product state directly, with no
exchange: amplitude ``x`` is ``prod_q (bit_q(x) ? sin : cos)(a_q / 2)``, and
the global bits are the rank's. ⟨Z⟩ is each rank's partial sum through
:func:`~qdml_tpu_torch.parallel.collectives.psum_replicated`; angles and
weights enter through
:func:`~qdml_tpu_torch.parallel.collectives.enter_replicated`, so every
rank's gradients equal the one-rank ``tensor`` path's. With k = 0 the call
hands over to that path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from qdml_tpu_torch.config import MeshConfig
from qdml_tpu_torch.parallel import collectives as coll
from qdml_tpu_torch.parallel import mesh as pmesh
from qdml_tpu_torch.quantum import statevector as sv
from qdml_tpu_torch.quantum.kernels import apply_rotation_layer
from qdml_tpu_torch.utils.complexops import CArr


def rank_bits(index: int, k: int) -> tuple[int, ...]:
    """The k global bits, MSB-first, of the rank at ``index`` of the model line."""
    return tuple((index >> (k - 1 - q)) & 1 for q in range(k))


def partner(index: int, k: int, q: int) -> int:
    """The model-line index of the partner for global wire ``q``."""
    return index ^ (1 << (k - 1 - q))


def _bc(theta) -> torch.Tensor:
    """An angle, scalar or batched (B,), broadcastable over (B, 2^n_local)."""
    return theta[..., None] if theta.dim() else theta


def ry_global(local: CArr, other: CArr, theta: torch.Tensor, bit: int) -> CArr:
    """RY(theta) on a global wire from this shard and the partner's: with
    bit 0 this shard holds the wire's 0-amplitudes, ``c*a0 - s*a1``; with bit
    1, ``s*a0 + c*a1``."""
    c, s = torch.cos(_bc(theta) / 2), torch.sin(_bc(theta) / 2)
    s = -s if bit == 0 else s
    return CArr(c * local.re + s * other.re, c * local.im + s * other.im)


def rz_global(local: CArr, theta: torch.Tensor, bit: int) -> CArr:
    """RZ(theta) on a global wire: the phase ``e^{-i theta/2}`` (bit 0) or
    ``e^{+i theta/2}`` (bit 1) on the whole shard."""
    t = _bc(theta) / 2
    c, s = torch.cos(t), torch.sin(t)
    s = -s if bit == 0 else s
    return CArr(c * local.re - s * local.im, c * local.im + s * local.re)


@lru_cache(maxsize=None)
def _flip_index(n_local: int, q: int, device: str) -> torch.Tensor:
    with torch.inference_mode(False):
        idx = np.arange(2**n_local) ^ (1 << (n_local - 1 - q))
        return torch.as_tensor(idx, dtype=torch.long, device=device)


@lru_cache(maxsize=None)
def _local_bit(n_local: int, q: int, device: str) -> torch.Tensor:
    with torch.inference_mode(False):
        bits = (np.arange(2**n_local) >> (n_local - 1 - q)) & 1
        return torch.as_tensor(bits.astype(bool), device=device)


@lru_cache(maxsize=None)
def _local_chain(n_local: int, device: str) -> torch.Tensor:
    """CNOT(c, c+1) for local wires c = 0 .. n_local - 2, in order, as one
    gather index."""
    with torch.inference_mode(False):
        src = np.arange(2**n_local)
        for c in range(n_local - 1):
            src = src[sv.cnot_perm(n_local, c, c + 1)]
        return torch.as_tensor(src, dtype=torch.long, device=device)


def _where(mask, a: CArr, b: CArr) -> CArr:
    return CArr(torch.where(mask, a.re, b.re), torch.where(mask, a.im, b.im))


def cnot_sharded(
    local: CArr, other: CArr | None, k: int, n_local: int, control: int, target: int, bits: tuple[int, ...]
) -> CArr:
    """CNOT(control, target), wires indexed globally (0..k-1 global), on
    this shard; ``other`` is the partner's shard for the target's bit when
    the target is global, else ``None``; ``bits`` this rank's global bits."""
    dev = str(local.re.device)
    c_global, t_global = control < k, target < k
    if not c_global and not t_global:
        return sv.apply_perm(local, sv.cnot_perm(n_local, control - k, target - k))
    if c_global and not t_global:
        if bits[control] == 0:
            return local
        return sv.apply_perm(local, _flip_index(n_local, target - k, dev))
    if not c_global:
        return _where(_local_bit(n_local, control - k, dev), other, local)
    return local if bits[control] == 0 else other


def expvals_z_local(local: CArr, n_local: int, bits: tuple[int, ...]) -> torch.Tensor:
    """This shard's part of the per-wire ⟨Z⟩, (B, k + n_local): the global
    wires' sign times the shard's probability mass, then the local wires'
    signed sums. The parts of the model line sum to ⟨Z⟩."""
    probs = local.abs2()
    local_ev = probs @ sv.z_sign_table(n_local, str(probs.device))
    total = probs.sum(dim=-1, keepdim=True)
    signs = torch.tensor([1.0 - 2.0 * b for b in bits], dtype=probs.dtype, device=probs.device)
    return torch.cat([total * signs, local_ev], dim=-1)


def product_state_shard(angles: torch.Tensor, n_local: int, bits: tuple[int, ...]) -> CArr:
    """This shard of the RY embedding of |0...0>: the global wires' factor
    (cos or sin of each half angle, by the rank's bit) times the local
    wires' product state."""
    k = len(bits)
    half = 0.5 * angles[..., :k]
    factor = torch.ones(angles.shape[:-1] + (1,), dtype=torch.float32, device=angles.device)
    for q, b in enumerate(bits):
        factor = factor * (torch.sin(half[..., q : q + 1]) if b else torch.cos(half[..., q : q + 1]))
    re = factor * sv.ry_product_state(angles[..., k:], n_local)
    return CArr(re, torch.zeros_like(re))


def _fetch(psi: CArr, group, peer: int) -> CArr:
    both = coll.exchange(torch.stack([psi.re, psi.im]), group, peer)
    return CArr(both[0], both[1])


def run_circuit_sharded(
    angles: torch.Tensor,
    weights: torch.Tensor,
    n_qubits: int,
    n_layers: int,
    mesh: pmesh.Mesh | None = None,
    axis_name: str = "model",
) -> torch.Tensor:
    """The reference circuit with the statevector sharded over
    ``mesh``'s ``axis_name`` line (default: the current mesh's, else the
    default model mesh of the world, :func:`default_model_mesh`). Every
    rank of the line calls it with the same ``angles`` (..., n) and
    ``weights`` (L, n, 2) and gets the whole ⟨Z⟩ (..., n). A line of one
    rank hands over to the ``tensor`` path; a line that is not a power of
    two raises."""
    if mesh is None:
        mesh = pmesh.current_mesh() or default_model_mesh(axis_name)
    k_ranks = mesh.shape[axis_name]
    k = int(np.log2(k_ranks))
    if 2**k != k_ranks:
        raise ValueError(f"model axis size {k_ranks} must be a power of two")
    if k == 0:
        from qdml_tpu_torch.quantum.circuits import run_circuit

        return run_circuit(angles, weights, n_qubits, n_layers, impl="tensor")
    n_local = n_qubits - k
    if n_local < 1:
        raise ValueError(f"{n_qubits} qubits over {k_ranks} ranks leave no local wire")
    group = mesh.group(axis_name)
    line = mesh.group_ranks(axis_name)
    index = mesh.coord(axis_name)
    bits = rank_bits(index, k)
    peers = [line[partner(index, k, q)] for q in range(k)]

    lead = angles.shape[:-1]
    angles = coll.enter_replicated(angles.reshape(-1, n_qubits), group)
    weights = coll.enter_replicated(weights, group)
    chain = _local_chain(n_local, str(angles.device))
    psi = product_state_shard(angles, n_local, bits)
    for l in range(n_layers):
        for q in range(k):
            psi = ry_global(psi, _fetch(psi, group, peers[q]), weights[l, q, 0], bits[q])
            psi = rz_global(psi, weights[l, q, 1], bits[q])
        psi = apply_rotation_layer(psi, weights[l, k:], n_local)  # lint: disable=pallas-host-loop(the layer loop exchanges shards between ranks for the global wires before and after each layer's local rotations, so the layers cannot fuse into one launch)
        # the ring: CNOT(c, c+1) for c < n-1, then CNOT(n-1, 0)
        for c in range(k):
            # a global target needs the partner's shard only where the
            # control bit is 1; the partner shares that bit, so both skip
            fetch = c + 1 < k and bits[c] == 1
            other = _fetch(psi, group, peers[c + 1]) if fetch else None
            psi = cnot_sharded(psi, other, k, n_local, c, c + 1, bits)
        psi = sv.apply_perm(psi, chain)
        psi = cnot_sharded(psi, _fetch(psi, group, peers[0]), k, n_local, n_qubits - 1, 0, bits)
    ev = coll.psum_replicated(expvals_z_local(psi, n_local, bits), group)
    return ev.reshape(lead + (n_qubits,))


def default_model_mesh(axis_name: str = "model") -> pmesh.Mesh:
    """The model mesh over the world when no mesh was built: its largest
    power of two of ranks on the model line (``qdml_tpu/quantum/
    sharded.py:250-253``); a world of one rank gives a line of one."""
    n = pmesh.world_size()
    k = 1 << int(np.log2(n))
    return pmesh.make_mesh(MeshConfig(model_axis=k, data_axis=1), device=None)
