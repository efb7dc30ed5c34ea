"""The circuit kernels: CUDA C++ for Hopper, their build, bindings and plain versions.

Counterpart of ``qdml_tpu/quantum/pallas_kernels.py``. Two of its four Pallas
kernels are on the serving and training paths and are ported here:

- :func:`fused_qsc_expvals` (``csrc/qsc_expvals.cu``, replaces ``_qsc_kernel``):
  angles + a precompiled ansatz unitary -> per-wire <Z>; its backward is
  autograd through the plain version, as the JAX backward differentiates its
  XLA twin;
- :func:`fused_circuit_expvals` (``csrc/circuit_expvals.cu``, replaces
  ``_circuit_kernel``): angles + weights -> the L-layer gate chain -> <Z>
  (and the final state); its adjoint backward is a kernel too
  (``csrc/circuit_adjoint.cu``, replaces ``_circuit_bwd``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface the first time it is needed, under
``build/qdml_tpu_torch/`` beside the package and keyed by a hash of the
source, then bound with ``ctypes`` and launched on PyTorch's current stream.

A wrapper takes its kernel's plain PyTorch version only for tensors on the
CPU, and for the shapes the JAX package itself sends to its XLA twin (each
such rule is an ``if`` citing the JAX line). On a CUDA tensor it launches the
kernel or raises. ``launches`` counts kernel launches per wrapper and nothing
else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from qdml_tpu_torch.quantum import statevector as sv
from qdml_tpu_torch.utils.complexops import CArr

KERNELS = ("qsc_expvals", "circuit_expvals", "circuit_adjoint")
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qdml_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per wrapper: a wrapper adds one where it launches its
# kernel, nowhere else (the plain-version routes do not count).
launches = {name: 0 for name in KERNELS}
# nvcc's output (ptxas register/shared-memory report) per freshly built kernel
build_log: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}

# QSC kernel window: the JAX kernel serves dim <= 256 and sends larger
# circuits to its XLA twin (qdml_tpu/quantum/pallas_kernels.py:229-235).
QSC_MAX_QUBITS = 8
# Circuit kernel window: the JAX kernel's upper bound dim <= 4096 and L >= 1
# (pallas_kernels.py:441-442); its n >= 7 lower bound came from the TPU's
# 128-lane roll and does not apply here. The ring needs two wires.
CIRCUIT_MIN_QUBITS = 2
CIRCUIT_MAX_QUBITS = 12


def reset_launch_counts() -> None:
    for name in KERNELS:
        launches[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where the built library of kernel ``name`` lives, keyed by its source."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every kernel in ``names`` whose library is missing, all nvcc
    processes at once. Returns each build's wall seconds (0.0 when it was
    already built). Raises ``RuntimeError`` with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
            time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def _load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if name == "qsc_expvals":
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
    elif name == "circuit_expvals":
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    else:
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
        lib.circuit_adjoint_blocks.restype = ctypes.c_int
        lib.circuit_adjoint_blocks.argtypes = [i32, i32]
    _libs[name] = lib
    return lib


def _check(t: torch.Tensor, what: str, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, the kernel runs on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


# ---------------------------------------------------------------------------
# QSC kernel: angles + U -> <Z>
# ---------------------------------------------------------------------------


def qsc_expvals_plain(
    angles: torch.Tensor, u_re: torch.Tensor, u_im: torch.Tensor, n: int
) -> torch.Tensor:
    """Plain version (the JAX ``_xla_qsc_expvals``): real product state, two
    real matmuls against U^T, sign contraction. angles (B, n) -> (B, n)."""
    amp = sv.ry_product_state(angles, n)
    return sv.expvals_z(CArr(amp @ u_re.T, amp @ u_im.T), n)


def _qsc_launch(angles, u_re, u_im, n: int) -> torch.Tensor:
    dev = angles.device
    batch, dim = angles.shape[0], 1 << n
    if not 1 <= n <= QSC_MAX_QUBITS:
        raise ValueError(f"QSC kernel takes 1 <= n <= {QSC_MAX_QUBITS}, got {n}")
    _check(angles, "angles", (batch, n), dev)
    _check(u_re, "u_re", (dim, dim), dev)
    _check(u_im, "u_im", (dim, dim), dev)
    out = torch.empty((batch, n), dtype=torch.float32, device=dev)
    if batch == 0:
        return out
    fn = _load("qsc_expvals").qsc_expvals_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(angles.data_ptr(), u_re.data_ptr(), u_im.data_ptr(), out.data_ptr(),
                 batch, n, stream)
    _raise_on(err, "qsc_expvals")
    launches["qsc_expvals"] += 1
    return out


class _QSCExpvals(torch.autograd.Function):
    """Kernel forward; backward is autograd through the plain version, as the
    JAX ``_qsc_bwd`` differentiates its XLA twin (pallas_kernels.py:285-288)."""

    @staticmethod
    def forward(ctx, angles, u_re, u_im, n):
        ctx.save_for_backward(angles, u_re, u_im)
        ctx.n = n
        return _qsc_launch(angles, u_re, u_im, n)

    @staticmethod
    def backward(ctx, g):
        saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = qsc_expvals_plain(*saved, ctx.n)
            grads = torch.autograd.grad(out, saved, g)
        return (*grads, None)


def fused_qsc_expvals(
    angles: torch.Tensor, u_re: torch.Tensor, u_im: torch.Tensor, n: int
) -> torch.Tensor:
    """AngleEmbedding + the precompiled ansatz unitary ``U = u_re + i u_im``
    + per-wire <Z>: angles (..., n) -> (..., n), one kernel launch on the card."""
    lead = angles.shape[:-1]
    a2 = angles.reshape(-1, n)
    if a2.device.type == "cpu":
        ev = qsc_expvals_plain(a2, u_re, u_im, n)
    elif n > QSC_MAX_QUBITS:
        # the JAX kernel's window ends at dim 256 (pallas_kernels.py:229-235)
        ev = qsc_expvals_plain(a2, u_re, u_im, n)
    else:
        ev = _QSCExpvals.apply(a2, u_re, u_im, n)
    return ev.reshape(lead + (n,))


# ---------------------------------------------------------------------------
# Circuit kernel: angles + weights -> gate chain -> <Z> (+ final state)
# ---------------------------------------------------------------------------


def circuit_expvals_plain(angles: torch.Tensor, weights: torch.Tensor, n: int, layers: int):
    """Plain version (the JAX ``_xla_circuit``): embed -> gates -> ring -> <Z>.
    angles (B, n), weights (layers, n, 2) -> (expvals (B, n), re, im (B, 2^n))."""
    amp = sv.ry_product_state(angles, n)
    psi = CArr(amp, torch.zeros_like(amp))
    ring = sv.ring_cnot_perm(n)
    for l in range(layers):
        for q in range(n):
            psi = sv.apply_ry(psi, n, q, weights[l, q, 0])
            psi = sv.apply_rz(psi, n, q, weights[l, q, 1])
        psi = sv.apply_perm(psi, ring)
    return sv.expvals_z(psi, n), psi.re, psi.im


def circuit_gate_table(weights: torch.Tensor) -> torch.Tensor:
    """(L, n, 2) weights -> the kernel's (L, n, 4) table: cos, sin of the RY
    half-angle, then of the RZ half-angle."""
    half = 0.5 * weights
    c, s = torch.cos(half), torch.sin(half)
    return torch.stack([c[..., 0], s[..., 0], c[..., 1], s[..., 1]], dim=-1).contiguous()


def _check_circuit_window(n: int, layers: int) -> None:
    if not CIRCUIT_MIN_QUBITS <= n <= CIRCUIT_MAX_QUBITS or layers < 1:
        raise ValueError(
            f"circuit kernels take {CIRCUIT_MIN_QUBITS} <= n <= {CIRCUIT_MAX_QUBITS} "
            f"and layers >= 1, got n={n}, layers={layers}"
        )


def _circuit_launch(angles, weights, n: int, layers: int, with_state: bool):
    dev = angles.device
    batch, dim = angles.shape[0], 1 << n
    _check_circuit_window(n, layers)
    _check(angles, "angles", (batch, n), dev)
    _check(weights, "weights", (layers, n, 2), dev)
    ev = torch.empty((batch, n), dtype=torch.float32, device=dev)
    fre = fim = None
    if with_state:
        fre = torch.empty((batch, dim), dtype=torch.float32, device=dev)
        fim = torch.empty((batch, dim), dtype=torch.float32, device=dev)
    if batch == 0:
        return ev, fre, fim
    cs = circuit_gate_table(weights)
    fn = _load("circuit_expvals").circuit_expvals_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            angles.data_ptr(), cs.data_ptr(), ev.data_ptr(),
            fre.data_ptr() if with_state else None,
            fim.data_ptr() if with_state else None,
            batch, n, layers, int(with_state), stream,
        )
    _raise_on(err, "circuit_expvals")
    launches["circuit_expvals"] += 1
    return ev, fre, fim


def _product_state(factors: torch.Tensor) -> torch.Tensor:
    """(B, n, 2) per-wire factors (bit 0, bit 1) -> the (B, 2^n) product
    state, qubit 0 the most significant bit."""
    amp = torch.ones(factors.shape[:1] + (1,), dtype=factors.dtype, device=factors.device)
    for q in range(factors.shape[1]):
        amp = (amp[:, :, None] * factors[:, None, q, :]).reshape(amp.shape[0], -1)
    return amp


def _halves(t: torch.Tensor, n: int, q: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bit-0 and bit-1 halves of wire ``q``: (B, 2^n) -> 2 x (B, 2^q, 2^(n-q-1))."""
    v = t.reshape(t.shape[0], 1 << q, 2, -1)
    return v[:, :, 0], v[:, :, 1]


def circuit_adjoint_plain(fre, fim, g, angles, weights, n: int, layers: int):
    """Plain version of the adjoint backward (the JAX ``_circuit_bwd``,
    ``pallas_kernels.py:521-552``): from the final state ``fre, fim`` (B, 2^n)
    and the <Z> cotangent ``g`` (B, n) to ``(dangles (B, n), dweights (layers,
    n, 2))``. It walks the layers in reverse, undoing each layer on the state
    (``_undo_layer``) and pulling the cotangent back through it by the gates'
    own derivatives, written out: not autograd through the forward."""
    z = torch.as_tensor(sv.z_signs(n), device=fre.device)
    dprobs = g @ z.T
    psi = CArr(fre, fim)
    lam = CArr(2.0 * fre * dprobs, 2.0 * fim * dprobs)
    inv_ring = np.argsort(sv.ring_cnot_perm(n))
    cs = circuit_gate_table(weights)
    dweights = torch.zeros((layers, n, 2), dtype=torch.float32, device=fre.device)
    for l in reversed(range(layers)):
        psi, lam = sv.apply_perm(psi, inv_ring), sv.apply_perm(lam, inv_ring)
        for q in reversed(range(n)):
            cy, sy, cz, sz = cs[l, q]
            (r0, r1), (i0, i1) = _halves(psi.re, n, q), _halves(psi.im, n, q)
            (x0, x1), (y0, y1) = _halves(lam.re, n, q), _halves(lam.im, n, q)
            # RZ(t): d/dt is -i/2 on the 0-branch, +i/2 on the 1-branch
            dweights[l, q, 1] = 0.5 * ((x0 * i0 - y0 * r0) + (y1 * r1 - x1 * i1)).sum()
            psi = sv.apply_rz_cs(psi, n, q, cz, -sz)
            lam = sv.apply_rz_cs(lam, n, q, cz, -sz)
            (r0, r1), (i0, i1) = _halves(psi.re, n, q), _halves(psi.im, n, q)
            (x0, x1), (y0, y1) = _halves(lam.re, n, q), _halves(lam.im, n, q)
            # RY(t) = [c, -s; s, c]: d/dt (b0, b1) = (-b1, b0) / 2
            dweights[l, q, 0] = 0.5 * ((x1 * r0 - x0 * r1) + (y1 * i0 - y0 * i1)).sum()
            psi = sv.apply_ry_cs(psi, n, q, cy, -sy)
            lam = sv.apply_ry_cs(lam, n, q, cy, -sy)
    # embedding: the embedded state is real, so only lambda's real part flows
    half = 0.5 * angles
    factors = torch.stack([torch.cos(half), torch.sin(half)], dim=-1)  # (B, n, 2)
    dangles = []
    for q in range(n):
        dq = factors.clone()
        dq[:, q] = torch.stack([-0.5 * factors[:, q, 1], 0.5 * factors[:, q, 0]], dim=-1)
        dangles.append((lam.re * _product_state(dq)).sum(-1))
    return torch.stack(dangles, dim=-1), dweights


def _adjoint_launch(fre, fim, g, angles, weights, n: int, layers: int):
    dev = angles.device
    batch, dim = angles.shape[0], 1 << n
    _check_circuit_window(n, layers)
    _check(fre, "fre", (batch, dim), dev)
    _check(fim, "fim", (batch, dim), dev)
    _check(g, "g", (batch, n), dev)
    _check(angles, "angles", (batch, n), dev)
    _check(weights, "weights", (layers, n, 2), dev)
    dangles = torch.empty((batch, n), dtype=torch.float32, device=dev)
    if batch == 0:
        return dangles, torch.zeros((layers, n, 2), dtype=torch.float32, device=dev)
    cs = circuit_gate_table(weights)
    lib = _load("circuit_adjoint")
    partials = torch.empty(
        (lib.circuit_adjoint_blocks(batch, n), layers, n, 2), dtype=torch.float32, device=dev
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.circuit_adjoint_launch(
            fre.data_ptr(), fim.data_ptr(), g.data_ptr(), cs.data_ptr(), angles.data_ptr(),
            dangles.data_ptr(), partials.data_ptr(), batch, n, layers, stream,
        )
    _raise_on(err, "circuit_adjoint")
    launches["circuit_adjoint"] += 1
    # the batch sum over per-block partials, in a fixed order: no atomics
    return dangles, partials.sum(dim=0)


def circuit_adjoint(fre, fim, g, angles, weights, n: int, layers: int):
    """The adjoint backward: one ``circuit_adjoint`` launch on the card, its
    plain version for CPU tensors."""
    if fre.device.type == "cpu":
        return circuit_adjoint_plain(fre, fim, g, angles, weights, n, layers)
    return _adjoint_launch(fre, fim, g, angles, weights, n, layers)


class _CircuitExpvals(torch.autograd.Function):
    """The forward writes the final state; the backward is the adjoint walk
    from it, as the JAX ``_circuit_expvals`` custom_vjp saves only the final
    state (pallas_kernels.py:509-555). ``plain`` takes both plain versions."""

    @staticmethod
    def forward(ctx, angles, weights, n, layers, plain):
        if plain:
            ev, fre, fim = circuit_expvals_plain(angles, weights, n, layers)
        else:
            ev, fre, fim = _circuit_launch(angles, weights, n, layers, with_state=True)
        ctx.save_for_backward(angles, weights, fre, fim)
        ctx.n, ctx.layers, ctx.plain = n, layers, plain
        ctx.mark_non_differentiable(fre, fim)
        return ev, fre, fim

    @staticmethod
    def backward(ctx, g, _g_re, _g_im):
        angles, weights, fre, fim = ctx.saved_tensors
        adjoint = circuit_adjoint_plain if ctx.plain else _adjoint_launch
        dangles, dweights = adjoint(
            fre, fim, g.contiguous(), angles, weights, ctx.n, ctx.layers
        )
        return dangles, dweights, None, None, None


def fused_circuit_expvals(
    angles: torch.Tensor,
    weights: torch.Tensor,
    n: int,
    layers: int,
    return_state: bool = False,
):
    """Full reference circuit — AngleEmbedding + L x (RY/RZ on every wire +
    ring CNOTs) + per-wire <Z> — in one kernel launch on the card.

    angles (..., n), weights (layers, n, 2) -> expvals (..., n); with
    ``return_state`` also the final state's re and im, (..., 2^n) each, which
    carry no gradient. When autograd needs a gradient the forward kernel also
    writes the final state and the backward is one ``circuit_adjoint``
    launch."""
    lead = angles.shape[:-1]
    a2 = angles.reshape(-1, n)
    needs_grad = torch.is_grad_enabled() and (a2.requires_grad or weights.requires_grad)
    # plain versions on the CPU, and where JAX runs its XLA twin instead of
    # the kernel (pallas_kernels.py:441-442); its backward is still the
    # adjoint walk (pallas_kernels.py:521)
    plain = a2.device.type == "cpu" or n > CIRCUIT_MAX_QUBITS or layers < 1
    if needs_grad:
        ev, fre, fim = _CircuitExpvals.apply(a2, weights, n, layers, plain)
    elif plain:
        ev, fre, fim = circuit_expvals_plain(a2, weights, n, layers)
    else:
        ev, fre, fim = _circuit_launch(a2, weights, n, layers, return_state)
    ev = ev.reshape(lead + (n,))
    if not return_state:
        return ev
    return ev, fre.reshape(lead + (-1,)), fim.reshape(lead + (-1,))
