"""The reference's variational circuit (``qdml_tpu/quantum/circuits.py``) in torch.

Circuit (reference ``Estimators_QuantumNAT_onchipQNN.py:125-142``):

1. ``AngleEmbedding(inputs, rotation="Y")`` — per-sample RY(angle_i) on wire i,
2. per layer l: RY(w[l,i,0]) then RZ(w[l,i,1]) on each wire, then the
   entangling ring CNOT(i, i+1) for i < n-1 plus CNOT(n-1, 0),
3. measure <PauliZ_i> on every wire.

The impl names are the JAX package's, so a JAX config or checkpoint meta
means the same thing here:

- ``dense`` / ``dense_fused``: the ansatz compiled to one ``(2**n, 2**n)``
  unitary (per-gate kron chain, or the fused layer build) applied to the
  closed-form real product state — two real matmuls plus the sign contraction;
- ``tensor``: gates applied one by one on the ``(batch, 2**n)`` statevector;
- ``pallas``: the port's QSC kernel (:func:`kernels.fused_qsc_expvals`):
  embedding, unitary product and <Z> in one CUDA launch, with the unitary
  built by the unfused :func:`ansatz_unitary` on every call, as in JAX;
- ``pallas_circuit``: the port's whole-circuit kernel
  (:func:`kernels.fused_circuit_expvals`): the L-layer gate chain with the
  statevector resident in shared memory, one launch;
- ``mps``: the bond-chi matrix-product state of :mod:`qdml_tpu_torch.quantum.
  mps` (``quantum.mps_chi``), any n >= 2, the only impl past 14 qubits.

- ``sharded_statevector`` (``sharded`` its alias): the amplitudes split over
  the model line of the current mesh's ranks
  (:mod:`qdml_tpu_torch.quantum.sharded`), B.3 on each shard's local
  wires; on a line of one rank it hands over to ``tensor``.

``auto`` (impl and backend both) takes the measured table of
:mod:`qdml_tpu_torch.quantum.autotune` for the call's shape, then the static
heuristic.
"""

from __future__ import annotations

import numpy as np
import torch

from qdml_tpu_torch.quantum import autotune
from qdml_tpu_torch.quantum import statevector as sv
from qdml_tpu_torch.quantum.mps import DEFAULT_CHI, mps_circuit
# eligibility lives with the dispatcher; re-exported for the callers here
from qdml_tpu_torch.quantum.autotune import (  # noqa: F401
    ImplIneligibleError,
    impl_eligible,
)
from qdml_tpu_torch.utils.complexops import CArr, ceinsum, ckron

VALID_BACKENDS = (
    "auto",
    "tensor",
    "dense",
    "dense_fused",
    "sharded",  # deprecated alias for sharded_statevector
    "sharded_statevector",
    "mps",
    "pallas",
    "pallas_circuit",
    "pallas_tensor",  # deprecated alias for pallas_circuit
)

_IMPL_ALIASES = {"pallas_tensor": "pallas_circuit", "sharded": "sharded_statevector"}


def canonical_impl(name: str) -> str:
    """Normalize an impl/backend name to its canonical spelling; raises
    ``ValueError`` on names outside :data:`VALID_BACKENDS`."""
    if name not in VALID_BACKENDS:
        raise ValueError(f"unknown circuit impl {name!r}; want one of {VALID_BACKENDS}")
    return _IMPL_ALIASES.get(name, name)


def rot_gate(w_ry: torch.Tensor, w_rz: torch.Tensor) -> CArr:
    """Single-qubit RZ(w_rz) @ RY(w_ry), RY applied first. Scalars -> (2, 2)."""
    c0, s0 = torch.cos(w_ry / 2), torch.sin(w_ry / 2)
    c1, s1 = torch.cos(w_rz / 2), torch.sin(w_rz / 2)
    re = torch.stack([torch.stack([c1 * c0, -c1 * s0]), torch.stack([c1 * s0, c1 * c0])])
    im = torch.stack([torch.stack([-s1 * c0, s1 * s0]), torch.stack([s1 * s0, s1 * c0])])
    return CArr(re, im)


def angle_embed(psi: CArr, angles: torch.Tensor, n: int) -> CArr:
    """AngleEmbedding with Y rotations: angles (..., n) per sample."""
    for q in range(n):
        psi = sv.apply_ry(psi, n, q, angles[..., q])
    return psi


def apply_ansatz_tensor(psi: CArr, weights: torch.Tensor, n: int, n_layers: int) -> CArr:
    """Gate-by-gate ansatz on the statevector, trig derived once for the circuit."""
    ring = sv.ring_index(n, str(weights.device))
    half = 0.5 * weights
    cos_t, sin_t = torch.cos(half), torch.sin(half)  # (L, n, 2) each
    for l in range(n_layers):
        for q in range(n):
            psi = sv.apply_ry_cs(psi, n, q, cos_t[l, q, 0], sin_t[l, q, 0])
            psi = sv.apply_rz_cs(psi, n, q, cos_t[l, q, 1], sin_t[l, q, 1])
        psi = sv.apply_perm(psi, ring)
    return psi


def ansatz_unitary(weights: torch.Tensor, n: int, n_layers: int) -> CArr:
    """The ansatz as one (2**n, 2**n) unitary, built gate by gate: layer
    unitary = RingPerm . (u_0 x ... x u_{n-1}) with qubit 0 the most
    significant factor; total = U_{L-1} ... U_0. The unfused construction."""
    ring = sv.ring_index(n, str(weights.device))
    total: CArr | None = None
    for l in range(n_layers):
        u = rot_gate(weights[l, 0, 0], weights[l, 0, 1])  # lint: disable=gate-matrix-in-loop(the unfused construction the dense_fused equivalence tests compare against; the pallas impl builds its U with it once a forward, as JAX's pallas path does (qdml_tpu/quantum/circuits.py:337))
        for q in range(1, n):
            u = ckron(u, rot_gate(weights[l, q, 0], weights[l, q, 1]))  # lint: disable=gate-matrix-in-loop(unfused twin of fused_layer_unitaries: see above)
        # ring perm acts on rows: (P M)[y, :] = M[src[y], :]
        u = CArr(u.re[ring, :], u.im[ring, :])
        total = u if total is None else ceinsum("ij,jk->ik", u, total)
    if total is None:
        raise ValueError("ansatz_unitary needs n_layers >= 1")
    return total


def fused_layer_unitaries(weights: torch.Tensor, n: int, n_layers: int) -> CArr:
    """All L layer unitaries at once: one vectorized trig shot, a real RY kron
    chain batched over layers, the RZ phases from the cached sign table, and
    the cached ring permutation on rows. Returns a ``(L, 2**n, 2**n)`` CArr."""
    half = 0.5 * weights  # (L, n, 2)
    c, s = torch.cos(half), torch.sin(half)
    kron = torch.ones((n_layers, 1, 1), dtype=weights.dtype, device=weights.device)
    d = 1
    for q in range(n):
        m = torch.stack(
            [
                torch.stack([c[:, q, 0], -s[:, q, 0]], dim=-1),
                torch.stack([s[:, q, 0], c[:, q, 0]], dim=-1),
            ],
            dim=-2,
        )  # (L, 2, 2)
        kron = kron[:, :, None, :, None] * m[:, None, :, None, :]
        d *= 2
        kron = kron.reshape(n_layers, d, d)
    signs = sv.z_sign_table(n, str(weights.device))  # (dim, n)
    phase = -0.5 * torch.einsum("iq,lq->li", signs, weights[:, :, 1])  # (L, dim)
    re = torch.cos(phase)[:, :, None] * kron
    im = torch.sin(phase)[:, :, None] * kron
    ring = sv.ring_index(n, str(weights.device))
    return CArr(re[:, ring, :], im[:, ring, :])


def fused_ansatz_unitary(weights: torch.Tensor, n: int, n_layers: int) -> CArr:
    """The full ansatz unitary from :func:`fused_layer_unitaries`."""
    layers = fused_layer_unitaries(weights, n, n_layers)
    total = CArr(layers.re[0], layers.im[0])
    for l in range(1, n_layers):
        total = ceinsum("ij,jk->ik", CArr(layers.re[l], layers.im[l]), total)
    return total


def resolve_backend(backend: str, n_qubits: int) -> str:
    """Resolve ``auto`` to a concrete path WITHOUT measurements — the JAX
    static heuristic (``qdml_tpu/quantum/circuits.py:223-248``): dense up to
    10 qubits, tensor to 14, MPS past that."""
    if backend != "auto":
        return backend
    if n_qubits <= 10:
        return "dense"
    return "tensor" if n_qubits <= 14 else "mps"


def resolve_impl(
    impl: str,
    backend: str,
    n_qubits: int,
    n_layers: int,
    batch: int,
    mode: str = "train",
    platform: str | None = None,
) -> str:
    """Dispatch for one circuit shape (``qdml_tpu/quantum/circuits.py:251-285``).

    Precedence: an explicit ``impl`` wins, then an explicit legacy
    ``backend``, then the measured table's winner for ``(platform, n_qubits,
    n_layers, batch bucket)`` and ``mode`` ("train": forward plus backward,
    "infer": forward only), then :func:`resolve_backend`'s heuristic. A
    fallback caused by a table pathology prints one line per pathology
    (:func:`autotune.emit_fallback`). ``platform`` is the device type of the
    call (default: ``cuda`` when a card is visible)."""
    if impl not in ("", "auto"):
        return canonical_impl(impl)
    if backend != "auto":
        return canonical_impl(backend)
    sel, reason = autotune.lookup_reason(n_qubits, n_layers, batch, mode=mode, platform=platform)
    if sel is not None:
        return sel
    fallback = resolve_backend("auto", n_qubits)
    if reason is not None:
        autotune.emit_fallback(reason, n_qubits, n_layers, batch, mode, fallback, platform)
    return fallback


def run_circuit(
    angles: torch.Tensor,
    weights: torch.Tensor,
    n_qubits: int,
    n_layers: int,
    backend: str = "dense",
    impl: str = "auto",
    mode: str = "train",
    mps_chi: int | None = None,
) -> torch.Tensor:
    """Full reference circuit: angles (..., n) -> per-wire <Z> (..., n).

    With ``impl`` and ``backend`` both ``auto`` the measured table picks the
    impl for this call's batch (``angles.shape[:-1]`` flattened) on the
    angles' device; ``mode`` picks the train or the forward-only winner.
    ``mps_chi`` is the ``mps`` impl's bond dimension (default
    :data:`~qdml_tpu_torch.quantum.mps.DEFAULT_CHI`)."""
    batch = int(np.prod(angles.shape[:-1])) if angles.dim() > 1 else 1
    backend = resolve_impl(
        impl, backend, n_qubits, n_layers, batch, mode=mode, platform=angles.device.type
    )
    if backend in ("dense", "dense_fused"):
        build = fused_ansatz_unitary if backend == "dense_fused" else ansatz_unitary
        u = build(weights, n_qubits, n_layers)
        amp = sv.ry_product_state(angles, n_qubits)
        psi = CArr(amp @ u.re.T, amp @ u.im.T)
        return sv.expvals_z(psi, n_qubits)
    if backend == "pallas":
        from qdml_tpu_torch.quantum.kernels import fused_qsc_expvals

        u = ansatz_unitary(weights, n_qubits, n_layers)
        return fused_qsc_expvals(angles, u.re, u.im, n_qubits)
    if backend == "pallas_circuit":
        from qdml_tpu_torch.quantum.kernels import fused_circuit_expvals

        return fused_circuit_expvals(angles, weights, n_qubits, n_layers)
    if backend == "mps":
        return mps_circuit(angles, weights, n_qubits, n_layers, chi=mps_chi or DEFAULT_CHI)
    if backend == "sharded_statevector":
        from qdml_tpu_torch.quantum.sharded import run_circuit_sharded

        return run_circuit_sharded(angles, weights, n_qubits, n_layers)
    if backend != "tensor":
        raise ValueError(f"unknown backend {backend!r}; want one of {VALID_BACKENDS}")
    psi = sv.zero_state(n_qubits, tuple(angles.shape[:-1]), device=angles.device)
    psi = angle_embed(psi, angles, n_qubits)
    psi = apply_ansatz_tensor(psi, weights, n_qubits, n_layers)
    return sv.expvals_z(psi, n_qubits)


# impls whose member loop was already reported (one line per impl and process)
_LOOP_REPORTED: set[str] = set()


def run_circuit_ensemble(
    angles: torch.Tensor,
    weights: torch.Tensor,
    n_qubits: int,
    n_layers: int,
    backend: str = "dense",
    impl: str = "auto",
    mode: str = "train",
    mps_chi: int | None = None,
) -> torch.Tensor:
    """E circuits of one shape, member m with angles ``angles[m]`` (..., n)
    and weights ``weights[m]`` (L, n, 2): per-wire <Z> (E, ..., n), the
    counterpart of the JAX package's ``vmap`` of :func:`run_circuit` over an
    ensemble axis (``qdml_tpu/train/nat_sweep.py:87-108``).

    The impl resolves as :func:`run_circuit` resolves it at one member's
    shape (its flattened batch), and one that cannot run at ``n_qubits`` on
    this topology raises ``ImplIneligibleError`` (``sharded_statevector``
    without a model line of two ranks, as JAX's eligibility rule has it).
    ``pallas_circuit`` makes ONE member-axis launch of the
    circuit kernel (and one of its adjoint in the backward,
    :func:`kernels.fused_circuit_expvals_ensemble`); every other impl runs
    :func:`run_circuit` once per member, E calls, and says so in one line the
    first time (a member axis for B.1 is ROADMAP B work)."""
    members = angles.shape[0]
    if weights.shape != (members, n_layers, n_qubits, 2):
        raise ValueError(
            f"weights must be (E={members}, {n_layers}, {n_qubits}, 2), got {tuple(weights.shape)}"
        )
    batch = int(np.prod(angles.shape[1:-1])) if angles.dim() > 2 else 1
    resolved = resolve_impl(
        impl, backend, n_qubits, n_layers, batch, mode=mode, platform=angles.device.type
    )
    ok, why = impl_eligible(resolved, n_qubits)
    if not ok:
        raise ImplIneligibleError(why)
    if resolved == "pallas_circuit":
        from qdml_tpu_torch.quantum.kernels import fused_circuit_expvals_ensemble

        return fused_circuit_expvals_ensemble(angles, weights, n_qubits, n_layers)
    if resolved not in _LOOP_REPORTED:
        _LOOP_REPORTED.add(resolved)
        print(f"run_circuit_ensemble: impl {resolved!r} has no member axis; "
              f"{members} calls, one a member", flush=True)
    return torch.stack([
        run_circuit(angles[m], weights[m], n_qubits, n_layers, impl=resolved, mode=mode, mps_chi=mps_chi)
        for m in range(members)
    ])
