"""The circuit kernels: CUDA C++ for Hopper, their build, bindings and plain versions.

Counterpart of ``qdml_tpu/quantum/pallas_kernels.py``. Two of its four Pallas
kernels are on the serving path and are ported here:

- :func:`fused_qsc_expvals` (``csrc/qsc_expvals.cu``, replaces ``_qsc_kernel``):
  angles + a precompiled ansatz unitary -> per-wire <Z>;
- :func:`fused_circuit_expvals` (``csrc/circuit_expvals.cu``, replaces
  ``_circuit_kernel``): angles + weights -> the L-layer gate chain -> <Z>
  (and the final state).

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

import torch

from qdml_tpu_torch.quantum import statevector as sv
from qdml_tpu_torch.utils.complexops import CArr

KERNELS = ("qsc_expvals", "circuit_expvals")
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
    else:
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
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


def _circuit_launch(angles, weights, n: int, layers: int, with_state: bool):
    dev = angles.device
    batch, dim = angles.shape[0], 1 << n
    if not CIRCUIT_MIN_QUBITS <= n <= CIRCUIT_MAX_QUBITS or layers < 1:
        raise ValueError(
            f"circuit kernel takes {CIRCUIT_MIN_QUBITS} <= n <= {CIRCUIT_MAX_QUBITS} "
            f"and layers >= 1, got n={n}, layers={layers}"
        )
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
    ``return_state`` also the final state's re and im, (..., 2^n) each. The
    kernel is forward only: on the card, tensors that need grad raise (the
    adjoint backward kernel is the training slice, ROADMAP A.6)."""
    lead = angles.shape[:-1]
    a2 = angles.reshape(-1, n)
    if a2.device.type == "cpu":
        ev, fre, fim = circuit_expvals_plain(a2, weights, n, layers)
    elif n > CIRCUIT_MAX_QUBITS or layers < 1:
        # outside the JAX kernel's window its XLA twin runs
        # (pallas_kernels.py:441-442)
        ev, fre, fim = circuit_expvals_plain(a2, weights, n, layers)
    else:
        if torch.is_grad_enabled() and (a2.requires_grad or weights.requires_grad):
            raise NotImplementedError(
                "the circuit kernel is forward only; its adjoint backward kernel "
                "comes with the training slice (ROADMAP A.6)"
            )
        ev, fre, fim = _circuit_launch(a2, weights, n, layers, return_state)
    ev = ev.reshape(lead + (n,))
    if not return_state:
        return ev
    return ev, fre.reshape(lead + (-1,)), fim.reshape(lead + (-1,))
