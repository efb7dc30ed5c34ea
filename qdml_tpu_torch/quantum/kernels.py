"""The circuit kernels: CUDA C++ for Hopper, their build, bindings and plain versions.

Counterpart of ``qdml_tpu/quantum/pallas_kernels.py``. All four of its Pallas
kernels are ported here, each as a CUDA C++ source under ``csrc/``:

- :func:`fused_qsc_expvals` (``csrc/qsc_expvals.cu``, replaces ``_qsc_kernel``):
  angles + a precompiled ansatz unitary -> per-wire <Z>; its backward is
  autograd through the plain version, as the JAX backward differentiates its
  XLA twin;
- :func:`fused_circuit_expvals` (``csrc/circuit_expvals.cu``, replaces
  ``_circuit_kernel``): angles + weights -> the L-layer gate chain -> <Z>
  (and the final state); its adjoint backward is a kernel too
  (``csrc/circuit_adjoint.cu``, replaces ``_circuit_bwd``);
  :func:`fused_circuit_expvals_ensemble` launches the same two kernels once
  for E circuits of one shape (a member axis on the grid, as the JAX
  package's ``vmap`` over the Pallas call adds a grid dimension): the
  noise-sweep ensemble's path;
- :func:`apply_rotation_layer` (``csrc/rotation_layer.cu``, replaces
  ``_layer_kernel_body``): one layer's RY then RZ on every wire of a batch of
  states; its backward is autograd through the plain version;
- :func:`fused_unitary_expvals` (``csrc/unitary_expvals.cu``, replaces
  ``_fused_kernel``): states through a unitary -> per-wire <Z>, the complex
  product computed in the kernel; its backward is autograd through the plain
  version.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface the first time it is needed, under
``build/qdml_tpu_torch/`` beside the package and keyed by a hash of the
source, then bound with ``ctypes`` and launched on PyTorch's current stream.

A wrapper takes its kernel's plain PyTorch version only for tensors on the
CPU, and for the shapes the JAX package itself sends to its XLA twin (each
such rule is an ``if`` citing the JAX line). On a CUDA tensor it launches the
kernel or raises. ``launches`` counts kernel launches per wrapper and nothing
else: one count per kernel source, and one per member-axis entry point
(:data:`COUNTERS`). A launch captured into a CUDA graph runs at every
replay, not when its wrapper is called: it is counted into the tally of
:func:`counting_capture`, and :func:`count_replay` adds that tally on each
replay (:mod:`qdml_tpu_torch.train.scan`). A launch captured outside such
a tally raises, since its replays would go uncounted. Serving workers launch
from several threads at once, so every change to the counts (a launch, a
replay, a reset) is made under one lock.

No dispatch mode sees a ``ctypes`` launch, so each launch wrapper reports
its call (the gate-table prep and the launch, as one op under the kernel's
name) to the telemetry modes active on the thread: the sanitizer
(:mod:`qdml_tpu_torch.telemetry.sanitizer`) checks its outputs, forward
and backward, and the cost counter (:mod:`qdml_tpu_torch.telemetry.cost`)
adds the kernel's formula work. With neither active this costs one read
of the thread's mode stack.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from qdml_tpu_torch.quantum import statevector as sv
from qdml_tpu_torch.utils.complexops import CArr

KERNELS = ("qsc_expvals", "circuit_expvals", "circuit_adjoint", "rotation_layer", "unitary_expvals")
# Launch counters: each kernel's one-call wrappers, then the member-axis
# entry points, which launch the circuit kernels once for a whole ensemble.
ENSEMBLE_COUNTERS = ("circuit_expvals_ensemble", "circuit_adjoint_ensemble")
COUNTERS = KERNELS + ENSEMBLE_COUNTERS
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qdml_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches per wrapper: a wrapper adds one where it launches its
# kernel, nowhere else (the plain-version routes do not count).
launches = {name: 0 for name in COUNTERS}
# nvcc builds started per kernel since the process started (the serving
# engine reads them to show that its request path builds nothing)
builds = {name: 0 for name in KERNELS}
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
# Rotation-layer kernel window: the JAX kernel has no upper cap, and neither
# has this one short of its index width: flat offsets are 64-bit, and B * 2^n
# stays below 2^63 for every int32 batch up to n = 32 (a state of 2^32
# amplitudes is already 32 GB of re+im). Past a tile (2^10-2^14 amplitudes)
# the kernel makes passes through device memory. The JAX kernel's dim >= 128
# floor (pallas_kernels.py:668) came from the TPU's lane rolls and does not
# apply here.
ROTATION_MAX_QUBITS = 32
# Unitary kernel window: U streams through shared memory, so the bound is the
# template instantiations (n a compile-time constant), not on-chip memory; U
# is 2 GB of re+im at n = 14 and 8 GB at n = 15, and the JAX kernel, which
# holds all of U in VMEM, has no practical window past that either.
UNITARY_MAX_QUBITS = 14


# the tallies of the CUDA graphs being captured, innermost last
_capture_tallies: list[dict[str, int]] = []
# guards every read-modify-write of `launches` and of a capture tally
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in COUNTERS:
            launches[name] = 0


def _count(counts: dict[str, int], name: str, n: int = 1) -> None:
    """``counts[name] += n`` under the counters' lock: a read-modify-write
    from several launching threads at once must lose no count."""
    with _count_lock:
        counts[name] += n


@contextlib.contextmanager
def counting_capture():
    """While a CUDA graph is captured: the wrappers' launches go into the
    yielded tally (per counter) instead of :data:`launches`, because the
    captured kernels run at each replay and not now."""
    tally = {name: 0 for name in COUNTERS}
    _capture_tallies.append(tally)
    try:
        yield tally
    finally:
        _capture_tallies.remove(tally)


def count_replay(tally: dict[str, int]) -> None:
    """One replay of a graph whose capture counted ``tally``."""
    for name, n in tally.items():
        _count(launches, name, n)


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
        builds[name] += 1
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
            time.perf_counter(),  # lint: disable=wall-clock-in-jit(nvcc's wall time on the host: _load builds once, before any graph is captured, and no launch reads it)
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0  # lint: disable=wall-clock-in-jit(nvcc's wall time on the host: _load builds once, before any graph is captured, and no launch reads it)
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
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    elif name == "rotation_layer":
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
        for query in (lib.rotation_layer_tile_bits, lib.rotation_layer_reg_bits, lib.rotation_layer_passes):
            query.restype = ctypes.c_int
            query.argtypes = [i32, i32]
    elif name == "unitary_expvals":
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, ptr]
        lib.unitary_expvals_tiles.restype = ctypes.c_int
        lib.unitary_expvals_tiles.argtypes = [i32, i32]
    else:
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.circuit_adjoint_blocks.restype = ctypes.c_int
        lib.circuit_adjoint_blocks.argtypes = [i32, i32]
        lib.circuit_adjoint_occupancy.restype = ctypes.c_int
        lib.circuit_adjoint_occupancy.argtypes = [i32, i32]
        lib.circuit_adjoint_threads.restype = ctypes.c_int
        lib.circuit_adjoint_threads.argtypes = [i32]
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


def _launch(name: str, dev: torch.device, *args, counter: str | None = None) -> None:
    """Call ``<name>_launch(*args, stream)`` on ``dev``'s current stream
    (tensors passed as their data pointers), raise on a CUDA error, count the
    launch under ``counter`` (default: the kernel's name)."""
    fn = getattr(_load(name), f"{name}_launch")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        capturing = torch.cuda.is_current_stream_capturing()
        if capturing and not _capture_tallies:  # lint: disable=jit-mutable-global(read at capture by design: a captured launch counts into the capture's tally once, and count_replay adds it at each replay)
            raise RuntimeError(
                f"{name} launch captured into a CUDA graph outside kernels.counting_capture(): "
                "its replays would go uncounted"
            )
        err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")
    _count(_capture_tallies[-1] if capturing else launches, counter or name)  # lint: disable=jit-mutable-global(read at capture by design: a captured launch counts into the capture's tally once, and count_replay adds it at each replay)


def _observers() -> list:
    """The sanitizers and cost counters active on this thread
    (:mod:`qdml_tpu_torch.telemetry`): dispatch modes with a ``kernel``
    method. The autograd engine carries the mode stack to its device
    threads, so a backward launch sees them too. Empty when none is
    entered."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return [m for m in _get_current_dispatch_mode_stack() if hasattr(m, "kernel")]


@contextlib.contextmanager
def _observed(name: str, work):
    """A launch wrapper's region (its gate-table prep and the launch): with
    observers active, their dispatch modes are off inside it, and at its end
    each sees the call as one op named ``name`` (the sanitizer checks the
    outputs the region appends to the yielded list for NaN; the cost counter
    adds ``work()``, the formula's (bytes, flops)). Without observers,
    nothing."""
    obs = _observers()
    if not obs:
        yield []
        return
    from torch.utils._python_dispatch import _disable_current_modes

    outputs: list = []
    with _disable_current_modes():
        yield outputs
        for m in obs:
            m.kernel(name, [t for t in outputs if t is not None], work())


def _work(name: str, batch: int, n: int, layers: int = 0, members: int = 1, with_state: bool = False):
    from qdml_tpu_torch.telemetry.cost import kernel_work

    return kernel_work(name, batch, n, layers, members, with_state)


def _kernel_fwd_plain_bwd(launch, plain, doc: str) -> type[torch.autograd.Function]:
    """An autograd Function over ``(*tensors, n)`` whose forward is
    ``launch(*tensors, n)`` and whose backward is autograd through
    ``plain(*tensors, n)`` (a tensor or a :class:`CArr`), for every tensor."""

    class _Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            *tensors, n = args
            ctx.save_for_backward(*tensors)
            ctx.n = n
            return launch(*tensors, n)

        @staticmethod
        def backward(ctx, *grads_out):
            saved = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            with torch.enable_grad():
                out = plain(*saved, ctx.n)
                outs = (out.re, out.im) if isinstance(out, CArr) else (out,)
                grads = torch.autograd.grad(outs, saved, grads_out)
            return (*grads, None)

    _Function.__doc__ = doc
    return _Function


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
    # the kernel copies U into shared memory in 16-byte pieces (8 at n = 1)
    align = 4 * min(dim, 4)
    for t, what in ((u_re, "u_re"), (u_im, "u_im")):
        if t.data_ptr() % align:
            raise ValueError(f"{what} must start on a {align}-byte boundary, got address {t.data_ptr():#x}")
    out = torch.empty((batch, n), dtype=torch.float32, device=dev)
    if batch == 0:
        return out
    with _observed("qsc_expvals", lambda: _work("qsc_expvals", batch, n)) as outs:
        _launch("qsc_expvals", dev, angles, u_re, u_im, out, batch, n)
        outs.append(out)
    return out


_QSCExpvals = _kernel_fwd_plain_bwd(
    _qsc_launch, qsc_expvals_plain,
    """Kernel forward; backward is autograd through the plain version, as the
    JAX ``_qsc_bwd`` differentiates its XLA twin (pallas_kernels.py:285-288).""",
)


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
    ring = sv.ring_index(n, str(angles.device))
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


# The member axis is the launch grid's y dimension, at most 65535 blocks.
ENSEMBLE_MAX_MEMBERS = 65535


def _check_members(members: int) -> None:
    if not 1 <= members <= ENSEMBLE_MAX_MEMBERS:
        raise ValueError(
            f"the member-axis circuit kernels take 1 <= E <= {ENSEMBLE_MAX_MEMBERS} members, got {members}"
        )


def _counter(kernel: str, ensemble: bool) -> str:
    """The launch counter: the member-axis entry point's, or the kernel's own."""
    return f"{kernel}_ensemble" if ensemble else kernel


def _circuit_launch_members(angles, weights, n: int, layers: int, with_state: bool, ensemble: bool):
    """One launch of the circuit kernel for E circuits of one shape: angles
    (E, B, n), weights (E, layers, n, 2) -> ev (E, B, n) and, ``with_state``,
    the final states' re, im (E, B, 2^n). Counted under the member-axis
    counter when ``ensemble``, else under the kernel's own (a one-member
    call is E = 1)."""
    dev = angles.device
    members, batch, dim = angles.shape[0], angles.shape[1], 1 << n
    _check_circuit_window(n, layers)
    _check_members(members)
    _check(angles, "angles", (members, batch, n), dev)
    _check(weights, "weights", (members, layers, n, 2), dev)
    ev = torch.empty((members, batch, n), dtype=torch.float32, device=dev)
    fre = fim = None
    if with_state:
        fre = torch.empty((members, batch, dim), dtype=torch.float32, device=dev)
        fim = torch.empty((members, batch, dim), dtype=torch.float32, device=dev)
    if batch == 0:
        return ev, fre, fim
    work = lambda: _work("circuit_expvals", batch, n, layers, members, with_state)  # noqa: E731
    with _observed("circuit_expvals", work) as outs:
        cs = circuit_gate_table(weights)  # (E, layers, n, 4), one call for every member
        _launch("circuit_expvals", dev, angles, cs, ev, fre, fim, batch, n, layers, int(with_state), members,  # lint: disable=host-sync-hot-path(with_state is the caller's Python bool: int() of it is host arithmetic, no device fetch)
                counter=_counter("circuit_expvals", ensemble))
        outs += [ev, fre, fim]
    return ev, fre, fim


def _circuit_launch(angles, weights, n: int, layers: int, with_state: bool):
    """One circuit: angles (B, n), weights (layers, n, 2), a launch of E = 1."""
    ev, fre, fim = _circuit_launch_members(angles[None], weights[None], n, layers, with_state, False)
    return ev[0], *(None if t is None else t[0] for t in (fre, fim))


def circuit_expvals_ensemble_plain(angles: torch.Tensor, weights: torch.Tensor, n: int, layers: int):
    """Plain version of the member-axis forward: :func:`circuit_expvals_plain`
    for each member in turn. angles (E, B, n), weights (E, layers, n, 2) ->
    (expvals (E, B, n), re, im (E, B, 2^n))."""
    outs = [circuit_expvals_plain(a, w, n, layers) for a, w in zip(angles, weights)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


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
    z = sv.z_sign_table(n, str(fre.device))
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


def circuit_adjoint_ensemble_plain(fre, fim, g, angles, weights, n: int, layers: int):
    """Plain version of the member-axis adjoint: :func:`circuit_adjoint_plain`
    for each member in turn. Every argument has a leading member axis E;
    returns ``(dangles (E, B, n), dweights (E, layers, n, 2))``."""
    outs = [circuit_adjoint_plain(*member, n, layers) for member in zip(fre, fim, g, angles, weights)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _adjoint_launch_members(fre, fim, g, angles, weights, n: int, layers: int, ensemble: bool):
    """One launch of the adjoint for E circuits of one shape: every argument
    :func:`_adjoint_launch`'s with a leading member axis E; returns
    ``(dangles (E, B, n), dweights (E, layers, n, 2))``. Counted as
    :func:`_circuit_launch_members` counts."""
    dev = angles.device
    members, batch, dim = angles.shape[0], angles.shape[1], 1 << n
    _check_circuit_window(n, layers)
    _check_members(members)
    _check(fre, "fre", (members, batch, dim), dev)
    _check(fim, "fim", (members, batch, dim), dev)
    _check(g, "g", (members, batch, n), dev)
    _check(angles, "angles", (members, batch, n), dev)
    _check(weights, "weights", (members, layers, n, 2), dev)
    dangles = torch.empty((members, batch, n), dtype=torch.float32, device=dev)
    if batch == 0:
        return dangles, torch.zeros((members, layers, n, 2), dtype=torch.float32, device=dev)
    # per-block partials, which the launch's second kernel sums in a fixed
    # order into each member's dweights: no atomics
    blocks = _load("circuit_adjoint").circuit_adjoint_blocks(batch, n)
    partials = torch.empty((members, blocks, layers, n, 2), dtype=torch.float32, device=dev)
    dweights = torch.empty((members, layers, n, 2), dtype=torch.float32, device=dev)
    work = lambda: _work("circuit_adjoint", batch, n, layers, members)  # noqa: E731
    with _observed("circuit_adjoint", work) as outs:
        cs = circuit_gate_table(weights)
        _launch("circuit_adjoint", dev, fre, fim, g, cs, angles, dangles, partials, dweights, batch, n, layers,
                members, counter=_counter("circuit_adjoint", ensemble))
        outs += [dangles, dweights]
    return dangles, dweights


def _adjoint_launch(fre, fim, g, angles, weights, n: int, layers: int):
    """One circuit: fre, fim (B, 2^n), g and angles (B, n), weights (layers,
    n, 2), a launch of E = 1."""
    dangles, dweights = _adjoint_launch_members(
        fre[None], fim[None], g[None], angles[None], weights[None], n, layers, False
    )
    return dangles[0], dweights[0]


def circuit_adjoint_occupancy(n: int, layers: int) -> tuple[int, int]:
    """``(blocks, threads)``: the adjoint kernel's resident blocks per SM for
    ``n`` and ``layers`` on the current CUDA device
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and its threads per
    block."""
    _check_circuit_window(n, layers)
    lib = _load("circuit_adjoint")
    blocks = lib.circuit_adjoint_occupancy(n, layers)
    if blocks < 0:
        raise RuntimeError(f"circuit_adjoint occupancy query failed with cudaError {-blocks}")
    return blocks, lib.circuit_adjoint_threads(n)


def circuit_adjoint(fre, fim, g, angles, weights, n: int, layers: int):
    """The adjoint backward: one ``circuit_adjoint`` launch on the card, its
    plain version for CPU tensors."""
    if fre.device.type == "cpu":
        return circuit_adjoint_plain(fre, fim, g, angles, weights, n, layers)
    return _adjoint_launch(fre, fim, g, angles, weights, n, layers)


def circuit_adjoint_ensemble(fre, fim, g, angles, weights, n: int, layers: int):
    """The member-axis adjoint backward: one ``circuit_adjoint`` launch for
    all E members on the card (each member's result bit for bit that of
    :func:`circuit_adjoint` on its slices), its plain version for CPU
    tensors. Arguments as :func:`circuit_adjoint`'s with a leading member
    axis."""
    if fre.device.type == "cpu":
        return circuit_adjoint_ensemble_plain(fre, fim, g, angles, weights, n, layers)
    return _adjoint_launch_members(fre, fim, g, angles, weights, n, layers, True)


class _CircuitExpvals(torch.autograd.Function):
    """E circuits of one shape (angles (E, B, n), weights (E, layers, n, 2);
    one circuit is E = 1): the forward is one launch that writes every
    member's final state, the backward one adjoint launch from them, as the
    JAX ``_circuit_expvals`` custom_vjp saves only the final state
    (pallas_kernels.py:509-555) and its ``vmap`` batches it over members.
    ``plain`` takes both plain versions; ``ensemble`` counts the launches
    under the member-axis counters. Not for ``torch.func`` transforms: the
    launch is opaque to them, which is why the member axis is written out
    here instead of vmapped."""

    @staticmethod
    def forward(ctx, angles, weights, n, layers, plain, ensemble):
        if plain:
            ev, fre, fim = circuit_expvals_ensemble_plain(angles, weights, n, layers)
        else:
            ev, fre, fim = _circuit_launch_members(angles, weights, n, layers, True, ensemble)
        ctx.save_for_backward(angles, weights, fre, fim)
        ctx.n, ctx.layers, ctx.plain, ctx.ensemble = n, layers, plain, ensemble
        ctx.mark_non_differentiable(fre, fim)
        return ev, fre, fim

    @staticmethod
    def backward(ctx, g, _g_re, _g_im):
        angles, weights, fre, fim = ctx.saved_tensors
        args = (fre, fim, g.contiguous(), angles, weights, ctx.n, ctx.layers)
        if ctx.plain:
            dangles, dweights = circuit_adjoint_ensemble_plain(*args)
        else:
            dangles, dweights = _adjoint_launch_members(*args, ctx.ensemble)
        return dangles, dweights, None, None, None, None


def _run_circuit(angles, weights, n: int, layers: int, return_state: bool, plain: bool, ensemble: bool):
    """angles (E, B, n), weights (E, layers, n, 2) -> (ev, fre, fim): through
    :class:`_CircuitExpvals` when autograd needs a gradient, else one
    forward launch (or the plain version)."""
    if torch.is_grad_enabled() and (angles.requires_grad or weights.requires_grad):
        return _CircuitExpvals.apply(angles, weights, n, layers, plain, ensemble)
    if plain:
        return circuit_expvals_ensemble_plain(angles, weights, n, layers)
    return _circuit_launch_members(angles, weights, n, layers, return_state, ensemble)


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
    # plain versions on the CPU, and where JAX runs its XLA twin instead of
    # the kernel (pallas_kernels.py:441-442); its backward is still the
    # adjoint walk (pallas_kernels.py:521)
    plain = a2.device.type == "cpu" or n > CIRCUIT_MAX_QUBITS or layers < 1
    ev, fre, fim = _run_circuit(a2[None], weights[None], n, layers, return_state, plain, False)
    ev = ev[0].reshape(lead + (n,))
    if not return_state:
        return ev
    return ev, fre[0].reshape(lead + (-1,)), fim[0].reshape(lead + (-1,))


def fused_circuit_expvals_ensemble(
    angles: torch.Tensor,
    weights: torch.Tensor,
    n: int,
    layers: int,
    return_state: bool = False,
):
    """E circuits of one shape, member m with its own angles ``angles[m]``
    (..., n) and weights ``weights[m]`` (layers, n, 2): per-wire <Z> (E, ...,
    n), in ONE launch of the circuit kernel on the card (member m's result
    bit for bit that of :func:`fused_circuit_expvals` on its slices), and
    when autograd needs a gradient one launch of the adjoint. With
    ``return_state`` also the final states' re and im, (E, ..., 2^n) each.
    CPU tensors take the plain versions, member by member. On the card there
    is no other route: outside the kernels' window (2 <= n <= 12, layers >=
    1, 1 <= E <= 65535) it raises."""
    members = angles.shape[0]
    if weights.shape[:1] != (members,):
        raise ValueError(f"weights {tuple(weights.shape)} and angles {tuple(angles.shape)} differ in members")
    lead = angles.shape[1:-1]
    a3 = angles.reshape(members, -1, n)
    plain = a3.device.type == "cpu"
    if not plain:
        a3, weights = a3.contiguous(), weights.contiguous()
    ev, fre, fim = _run_circuit(a3, weights, n, layers, return_state, plain, True)
    ev = ev.reshape((members, *lead, n))
    if not return_state:
        return ev
    return ev, fre.reshape((members, *lead, -1)), fim.reshape((members, *lead, -1))


# ---------------------------------------------------------------------------
# Rotation-layer kernel: one layer's RY then RZ on every wire of a state
# ---------------------------------------------------------------------------


def rotation_layer_plain(re: torch.Tensor, im: torch.Tensor, weights_l: torch.Tensor, n: int) -> CArr:
    """Plain version (the JAX ``_xla_rotation_layer``, pallas_kernels.py:622):
    RY(w[q, 0]) then RZ(w[q, 1]) on wires q = 0..n-1 of a (B, 2^n) state."""
    psi = CArr(re, im)
    for q in range(n):
        psi = sv.apply_ry(psi, n, q, weights_l[q, 0])
        psi = sv.apply_rz(psi, n, q, weights_l[q, 1])
    return psi


def _check_rotation_window(n: int) -> None:
    if not 1 <= n <= ROTATION_MAX_QUBITS:
        raise ValueError(f"the rotation-layer kernel takes 1 <= n <= {ROTATION_MAX_QUBITS}, got n={n}")


def rotation_layer_plan(batch: int, n: int) -> tuple[int, int, int]:
    """``(tile_bits, reg_bits, passes)`` of the rotation-layer kernel's
    launch at this batch and n: tiles of 2^tile_bits amplitudes, 2^reg_bits
    of them a thread, and the passes through device memory, one launch each
    (``csrc/rotation_layer.cu``, the plan's own exports)."""
    _check_rotation_window(n)
    lib = _load("rotation_layer")
    return (lib.rotation_layer_tile_bits(batch, n), lib.rotation_layer_reg_bits(batch, n),
            lib.rotation_layer_passes(batch, n))


def _rotation_launch(re, im, weights_l, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    dev = re.device
    batch, dim = re.shape[0], 1 << n
    _check_rotation_window(n)
    _check(re, "re", (batch, dim), dev)
    _check(im, "im", (batch, dim), dev)
    _check(weights_l, "weights_l", (n, 2), dev)
    # the kernel loads and stores the state in 16-byte pieces
    for t, what in ((re, "re"), (im, "im")):
        if t.data_ptr() % 16:
            raise ValueError(f"{what} must start on a 16-byte boundary, got address {t.data_ptr():#x}")
    out_re = torch.empty((batch, dim), dtype=torch.float32, device=dev)
    out_im = torch.empty((batch, dim), dtype=torch.float32, device=dev)
    if batch == 0:
        return out_re, out_im
    with _observed("rotation_layer", lambda: _work("rotation_layer", batch, n)) as outs:
        cs = circuit_gate_table(weights_l[None])[0].contiguous()
        _launch("rotation_layer", dev, re, im, cs, out_re, out_im, batch, n)
        outs += [out_re, out_im]
    return out_re, out_im


_RotationLayer = _kernel_fwd_plain_bwd(
    _rotation_launch, rotation_layer_plain,
    """Kernel forward; backward is autograd through the plain version, as the
    JAX ``_rotation_layer_bwd`` differentiates its XLA twin
    (pallas_kernels.py:640-646).""",
)


def apply_rotation_layer(psi: CArr, weights_l: torch.Tensor, n: int) -> CArr:
    """One ansatz rotation layer, RY(w[q, 0]) then RZ(w[q, 1]) on every wire,
    of states ``psi`` (..., 2^n) with ``weights_l`` (n, 2): one kernel call on
    the card (1 <= n <= 32, else ``ValueError``; one launch a pass, two passes
    from n = 13 at small batches and from n = 15); the ring CNOT that follows
    in the ansatz is a permutation, applied outside
    (:func:`~qdml_tpu_torch.quantum.statevector.apply_perm`)."""
    lead = psi.re.shape[:-1]
    dim = psi.re.shape[-1]
    if dim != 1 << n:
        raise ValueError(f"states of width {dim} are not of {n} qubits")
    re, im = psi.re.reshape(-1, dim), psi.im.reshape(-1, dim)
    if re.device.type == "cpu":
        out = rotation_layer_plain(re, im, weights_l, n)
    else:
        # a contiguous view that starts off a 16-byte boundary is copied to
        # fresh storage, which is aligned
        re, im = (t.contiguous() for t in (re, im))
        re, im = (t.clone() if t.data_ptr() % 16 else t for t in (re, im))
        out = CArr(*_RotationLayer.apply(re, im, weights_l.contiguous(), n))
    return CArr(out.re.reshape(lead + (dim,)), out.im.reshape(lead + (dim,)))


# ---------------------------------------------------------------------------
# Unitary kernel: states through a unitary -> <Z>
# ---------------------------------------------------------------------------


def unitary_expvals_plain(
    psi_re: torch.Tensor, psi_im: torch.Tensor, u_re: torch.Tensor, u_im: torch.Tensor, n: int
) -> torch.Tensor:
    """Plain version: ``expvals_z(psi @ U^T)`` with the complex product as
    four real matmuls. psi (B, 2^n), U (2^n, 2^n) -> (B, n)."""
    c_re = psi_re @ u_re.T - psi_im @ u_im.T
    c_im = psi_re @ u_im.T + psi_im @ u_re.T
    return sv.expvals_z(CArr(c_re, c_im), n)


def _unitary_align(n: int) -> int:
    """Bytes the unitary kernel's ``cp.async`` copies need psi and U to start
    on: 16 (8 at n = 1, where a row is two floats)."""
    return 4 * min(1 << n, 4)


def _unitary_launch(psi_re, psi_im, u_re, u_im, n: int) -> torch.Tensor:
    dev = psi_re.device
    batch, dim = psi_re.shape[0], 1 << n
    if not 1 <= n <= UNITARY_MAX_QUBITS:
        raise ValueError(f"the unitary kernel takes 1 <= n <= {UNITARY_MAX_QUBITS}, got n={n}")
    _check(psi_re, "psi_re", (batch, dim), dev)
    _check(psi_im, "psi_im", (batch, dim), dev)
    _check(u_re, "u_re", (dim, dim), dev)
    _check(u_im, "u_im", (dim, dim), dev)
    align = _unitary_align(n)
    for t, what in ((psi_re, "psi_re"), (psi_im, "psi_im"), (u_re, "u_re"), (u_im, "u_im")):
        if t.data_ptr() % align:
            raise ValueError(f"{what} must start on a {align}-byte boundary, got address {t.data_ptr():#x}")
    out = torch.empty((batch, n), dtype=torch.float32, device=dev)
    if batch == 0:
        return out
    # the column tiles' signed sums, summed in a fixed order by the kernel's
    # second pass: scratch only when the columns span several blocks
    tiles = _load("unitary_expvals").unitary_expvals_tiles(batch, n)
    partial = torch.empty((tiles, batch, n), dtype=torch.float32, device=dev) if tiles > 1 else None
    with _observed("unitary_expvals", lambda: _work("unitary_expvals", batch, n)) as outs:
        _launch("unitary_expvals", dev, psi_re, psi_im, u_re, u_im, out, partial, batch, n)
        outs.append(out)
    return out


_UnitaryExpvals = _kernel_fwd_plain_bwd(
    _unitary_launch, unitary_expvals_plain,
    """Kernel forward; backward is autograd through the plain version for
    psi's and U's real and imaginary parts, the counterpart of the JAX
    ``_fused_bwd`` (pallas_kernels.py:135-153), which is XLA code.""",
)


def fused_unitary_expvals(psi: CArr, u: CArr, n: int) -> torch.Tensor:
    """``psi (..., 2^n) -> per-wire <Z> (..., n)`` through the unitary ``u``,
    ``expvals_z(psi @ u^T)``: one kernel call on the card (1 <= n <= 14, else
    ``ValueError``), which computes the complex product, |.|^2 and the sign
    contraction itself (its second pass adds the column tiles' sums)."""
    lead = psi.re.shape[:-1]
    dim = psi.re.shape[-1]
    if dim != 1 << n:
        raise ValueError(f"states of width {dim} are not of {n} qubits")
    re, im = psi.re.reshape(-1, dim), psi.im.reshape(-1, dim)
    if re.device.type == "cpu":
        ev = unitary_expvals_plain(re, im, u.re, u.im, n)
    else:
        # a contiguous view that starts off the kernel's copy boundary (a
        # slice at an odd float) is copied to fresh storage, which is aligned
        align = _unitary_align(n) if 1 <= n <= UNITARY_MAX_QUBITS else 1
        ins = [t.contiguous() for t in (re, im, u.re, u.im)]
        ins = [t.clone() if t.data_ptr() % align else t for t in ins]
        ev = _UnitaryExpvals.apply(*ins, n)
    return ev.reshape(lead + (n,))
