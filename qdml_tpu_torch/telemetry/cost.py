"""Cost accounting: FLOPs, bytes, peak memory, roofline class (``qdml_tpu/telemetry/cost.py``).

A throughput regression has two causes, a slower program or a changed one
(more FLOPs, more bytes), and samples/s alone cannot tell them apart. JAX
reads XLA's analyses of the compiled program; eager PyTorch compiles no
program, so the port counts the work of the run's first real dispatch as it
runs, with :func:`cost_counter`, a dispatch mode that reads shapes only (no
extra step, graph capture or device work):

- ``flops``: ``torch.utils.flop_counter``'s formulas (matrix products and
  convolutions, forward and backward, as ``FlopCounterMode`` counts them)
  plus the hand-written CUDA kernels' own counts (:func:`kernel_work`, the
  formulas the smoke's kernel table bounds with), which their wrappers
  report (:mod:`qdml_tpu_torch.quantum.kernels`). Elementwise ops are not
  counted, as in the MFU of ``bench.py``;
- ``bytes_accessed``: the input and output bytes of every aten op (views
  and allocations excluded) plus the kernels' bytes: XLA's definition per
  op. Eager PyTorch fuses nothing, so this reads more than XLA's fused count
  for the same math would;
- ``peak_temp_bytes``: the card's allocator peak over the counted dispatch
  above what was allocated at its start (on the card only; absent on the
  CPU, as JAX's memory stats are there). The process's high-water mark is
  never reset (``device_memory_snapshot`` and ``cli profile`` read it), so
  the dispatch's own peak is known only where it raises that mark; under an
  earlier, higher mark the field is None.

The record keeps JAX's keys (``available``, ``platform``, ``source``,
``flops``, ``bytes_accessed``, ``peak_temp_bytes``,
``arithmetic_intensity``, ``ridge_intensity``, ``roofline``), which
``report`` reads. The peak table is the port's own: the H100 SXM (the
float32 rate outside the tensor cores, with TF32 off as the port runs;
bfloat16 on the tensor cores, dense; HBM3), and a nominal CPU. The ceiling
follows the program's dtype. A card the table lacks gets ``roofline:
"unknown"``; there is no TPU row and no default ridge.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Iterator

from qdml_tpu_torch.telemetry import spans as _spans

# peak FLOP/s by dtype and the memory rate (bytes/s), by platform label
PLATFORM_PEAKS: dict[str, dict[str, float]] = {
    # NVIDIA H100 SXM data sheet: FP32 (non-tensor-core), BF16 tensor core
    # dense, HBM3 (the figures bench.py's MFU uses)
    "gpu-h100": {"float32": 67e12, "bfloat16": 989e12, "bytes_per_s": 3.35e12},
    # a nominal desktop-class ridge: a coarse label there, the intensity is
    # the portable number
    "cpu": {"float32": 1e11, "bfloat16": 1e11, "bytes_per_s": 1.2e10},
}


def detect_platform(device=None) -> str:
    """The peak table's label for ``device`` (default: the card when torch
    sees one, else the CPU): ``cpu``, ``gpu-h100`` for an H100, else
    ``gpu-<name>``. Never raises."""
    torch = sys.modules.get("torch")
    if torch is None:
        return "unknown"
    try:
        dev = torch.device(device) if device is not None else torch.device(
            "cuda" if torch.cuda.is_available() else "cpu")
        if dev.type != "cuda":
            return dev.type
        name = torch.cuda.get_device_name(dev)
    except (RuntimeError, AssertionError) as e:
        return f"unknown ({type(e).__name__})"
    if "H100" in name:
        return "gpu-h100"
    return "gpu-" + "-".join(name.lower().split())


def _peaks(platform: str, dtype: str = "float32") -> tuple[float, float] | None:
    row = PLATFORM_PEAKS.get(platform)
    if row is None:
        return None
    return row.get(dtype, row["float32"]), row["bytes_per_s"]


def ridge_intensity(platform: str, dtype: str = "float32") -> float | None:
    """Peak FLOP/s over the memory rate at ``dtype``; None off the table."""
    peaks = _peaks(platform, dtype)
    return None if peaks is None else peaks[0] / peaks[1]


# ---------------------------------------------------------------------------
# The hand kernels' work: (bytes, flops) of one call
# ---------------------------------------------------------------------------


def qsc_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (angles in, U re/im in, <Z> out, each once) and flops of one QSC call."""
    dim = 1 << n
    bytes_moved = 4 * (batch * n + 2 * dim * dim + batch * n)
    flops = batch * dim * n + 4 * batch * dim * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def adjoint_work(batch: int, n: int, layers: int) -> tuple[float, float]:
    """Bytes (final state, cotangent, angles and gate table in; dangles and
    dweights out, each once) and flops of one adjoint call: the cotangent's
    start (n + 3 per amplitude), 64 flops per amplitude pair per wire per
    layer (two gradient terms and two rotations undone on psi and lambda),
    and the embedding cotangent as the function needs it, the backward pass
    of the product-state build (``qdml_tpu/quantum/statevector.py:161``):
    about 2 per amplitude to rebuild it and 8 for its backward. The kernel
    itself spends n + 2 per amplitude per wire there, which is not counted."""
    dim = 1 << n
    bytes_moved = 4 * (2 * batch * dim + 2 * batch * n + layers * n * 4 + batch * n + layers * n * 2)
    flops = batch * (dim * (n + 3) + 32 * layers * n * dim + 10 * dim)
    return bytes_moved, flops


def circuit_work(batch: int, n: int, layers: int, with_state: bool = False) -> tuple[float, float]:
    """Bytes (angles and gate table in, <Z> out, and the final state's re and
    im out when it is written) and flops of one circuit call: embedding, 24
    flops per amplitude pair per wire per layer (RY then RZ), and the <Z>
    contraction."""
    dim = 1 << n
    bytes_moved = 4 * (batch * n + layers * n * 4 + batch * n + (2 * batch * dim if with_state else 0))
    flops = batch * dim * n + 12 * batch * layers * n * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def rotation_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (the state's re and im in and out, the gate table in, each once)
    and flops of one rotation layer: about 12 per amplitude per wire (RY's
    two real 2x2 products, 6 flops a component pair, and RZ's complex phase,
    6 more)."""
    dim = 1 << n
    bytes_moved = 4 * (4 * batch * dim + 4 * n)
    flops = 12 * batch * dim * n
    return bytes_moved, flops


def unitary_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (psi re and im and U re and im in, <Z> out, each once) and flops
    of one unitary call, counted as the least the function needs: three real
    B x 2^n x 2^n products (Gauss's trick, as the TPU kernel does it), |c|^2
    (3 per amplitude) and the sign contraction (2n per amplitude)."""
    dim = 1 << n
    bytes_moved = 4 * (2 * batch * dim + 2 * dim * dim + batch * n)
    flops = 3 * 2 * batch * dim * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def bn_relu_work(rows: int, channels: int, plane: int, backward: bool) -> tuple[float, float]:
    """Bytes and flops of one train-mode BatchNorm + ReLU launch over an
    (rows, channels, plane) input, counted as the least the function needs:
    forward x in and y out, the scale, shift and running statistics in, the
    running statistics, mean and inverse std out; 8 flops a value (the sum,
    the squared deviation's 3, the normalisation's 3, the ReLU). Backward x
    and dy in, dx out, scale, shift, mean and inverse std in, their two
    gradients out; 12 flops a value (the pre-ReLU value's 3, the mask, x hat,
    the two sums' 3, dx's 4)."""
    values = rows * channels * plane
    if backward:
        return 4.0 * (3 * values + 6 * channels), 12.0 * values
    return 4.0 * (2 * values + 8 * channels), 8.0 * values


def qsc_front_work(batch: int, n: int, h: int, w: int, backward: bool) -> tuple[float, float]:
    """Bytes and flops of one launch of the quantum classifier's front end
    (conv 2 -> 16 and 16 -> 32, 3x3, each with ReLU and a 2x2 max-pool, the
    Linear to n angles and tanh) over a (batch, 2, h, w) input, counted as
    the least the function needs: forward x and the parameters in, the
    angles out; the forward's flops are its convolutions' and the Linear's,
    two a multiply-add (at 16 x 8 and n = 8: 73,728 + 294,912 + 4,096 a
    sample). Backward x, the parameters and the angles' gradient in, the
    parameters' gradients out; flops the recomputed forward, the Linear's
    weight and input gradients, conv2's weight and input gradients and
    conv1's weight gradient, counted dense (1,044,480 a sample there)."""
    feats = 32 * (h // 4) * (w // 4)
    conv1 = 2 * h * w * 9 * 2 * 16
    conv2 = 2 * (h // 2) * (w // 2) * 9 * 16 * 32
    linear = 2 * feats * n
    params = 16 * 2 * 9 + 16 + 32 * 16 * 9 + 32 + feats * n + n
    if backward:
        return 4.0 * (batch * 2 * h * w + 2 * params + batch * n), float(batch * (2 * conv1 + 3 * conv2 + 3 * linear))
    return 4.0 * (batch * 2 * h * w + params + batch * n), float(batch * (conv1 + conv2 + linear))


def kernel_work(name: str, batch: int, n: int, layers: int = 0, members: int = 1,
                with_state: bool = False) -> tuple[float, float]:
    """(bytes, flops) of one launch of hand kernel ``name`` (E ``members``
    count E times one)."""
    if name == "qsc_expvals":
        b, f = qsc_work(batch, n)
    elif name == "circuit_expvals":
        b, f = circuit_work(batch, n, layers, with_state)
    elif name == "circuit_adjoint":
        b, f = adjoint_work(batch, n, layers)
    elif name == "rotation_layer":
        b, f = rotation_work(batch, n)
    elif name == "unitary_expvals":
        b, f = unitary_work(batch, n)
    else:
        raise ValueError(f"no work formula for kernel {name!r}")
    return members * b, members * f


# ---------------------------------------------------------------------------
# Counting a dispatch
# ---------------------------------------------------------------------------


def cost_counter():
    """A counting dispatch mode: ``with cost_counter() as c: step()``, then
    ``c.flops``, ``c.bytes``, ``c.kernels`` (hand-kernel launches by name) and
    ``c.error`` (why counting stopped, if it did: the op still ran). The
    class is built on first use, so importing this module imports no torch."""
    return _counter_class()()


_COUNTER = None


def _counter_class():
    global _COUNTER
    if _COUNTER is not None:
        return _COUNTER
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils import flop_counter

    # the formula table FlopCounterMode counts with (a module attribute from torch 2.1)
    flop_registry = getattr(flop_counter, "flop_registry", None) or flop_counter.FlopCounterMode().flop_registry

    aten = torch.ops.aten
    composite = torch._C.DispatchKey.CompositeImplicitAutograd
    unread = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
              aten.resize_, aten.set_, aten.detach, aten.alias, aten.lift_fresh}

    def nbytes(tensors) -> int:
        return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))

    class _CostCounter(TorchDispatchMode):
        @classmethod
        def _should_skip_dynamo(cls) -> bool:
            # never under torch.compile: an unwrapped dispatch spares a
            # process's first counting the import of torch._dynamo (seconds
            # at a server's warmup)
            return False

        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.bytes = 0.0
            self.kernels: dict[str, int] = {}
            self.flops_by_op: dict[str, float] = {}
            self.error: str | None = None

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            pk = func.overloadpacket
            # under inference_mode composite ops (conv2d, linear, matmul) reach
            # the mode undecomposed: count their parts, running the op's C++
            # composite kernel (its Python decompositions import sympy)
            if pk not in flop_registry and torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), composite):
                with self:  # the parts dispatch through this mode again
                    return func._op_dk(composite, *args, **kwargs)
            out = func(*args, **kwargs)
            if self.error is not None or func.is_view or pk in unread:
                return out
            try:
                if pk in flop_registry:
                    f = float(flop_registry[pk](*args, **kwargs, out_val=out))
                    self.flops += f
                    self.flops_by_op[str(pk)] = self.flops_by_op.get(str(pk), 0.0) + f
                self.bytes += nbytes(tree_flatten((args, kwargs))[0]) + nbytes(tree_flatten(out)[0])
            except Exception as e:  # lint: disable=broad-except(cost accounting must never fail the op it counts; the failure is recorded on the counter)
                self.error = f"counting {pk} failed: {type(e).__name__}: {e}"
            return out

        def kernel(self, name: str, outputs, work: tuple[float, float] | None = None) -> None:
            """A hand kernel's launch: its formula's bytes and flops."""
            if work is not None:
                self.bytes += work[0]
                self.flops += work[1]
                self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + work[1]
            self.kernels[name] = self.kernels.get(name, 0) + 1

    _COUNTER = _CostCounter
    return _COUNTER


def _record(flops, bytes_accessed, peak_temp, platform: str, dtype: str, source: str) -> dict:
    out: dict[str, Any] = {
        "available": True,
        "platform": platform,
        "source": source,
        "dtype": dtype,
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "peak_temp_bytes": peak_temp,
    }
    ridge = ridge_intensity(platform, dtype)
    if flops and bytes_accessed and ridge is not None:
        ai = flops / bytes_accessed
        out["arithmetic_intensity"] = round(ai, 4)
        out["ridge_intensity"] = round(ridge, 2)
        out["roofline"] = "compute-bound" if ai >= ridge else "memory-bound"
    else:
        if flops and bytes_accessed:
            out["arithmetic_intensity"] = round(flops / bytes_accessed, 4)
        out["roofline"] = "unknown"
    return out


@contextlib.contextmanager
def counting(device, dtype: str = "float32") -> Iterator[dict]:
    """Count the enclosed dispatch; the yielded dict is filled at exit with
    the cost record (``available: false`` with a reason where counting
    failed; never raises for the accounting's sake). ``device`` is where the
    dispatch runs: its platform labels the record, and on the card the
    allocator's peak gives ``peak_temp_bytes`` where the dispatch raised the
    process's high-water mark (None where it stayed under it)."""
    import torch

    dev = torch.device(device)
    platform = detect_platform(dev)
    rec: dict = {}
    cuda = dev.type == "cuda"
    try:
        counter = cost_counter()
    except Exception as e:  # lint: disable=broad-except(cost accounting must never kill the run it measures; the record says available:false with the reason)
        rec.update(available=False, reason=f"counting mode failed: {type(e).__name__}: {e}", platform=platform)
        yield rec
        return
    if cuda:
        base = torch.cuda.memory_allocated(dev)
        mark = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    with counter:
        yield rec
    if counter.error is not None:
        rec.update(available=False, reason=counter.error, platform=platform)
        return
    peak = None
    if cuda:
        top = torch.cuda.max_memory_allocated(dev)
        peak = int(top - base) if top > mark else None
    rec.update(_record(counter.flops, counter.bytes, peak, platform, dtype, "counted"))
    rec["kernels"] = dict(counter.kernels)
    rec["flops_by_op"] = dict(counter.flops_by_op)
    rec["counted_s"] = round(time.perf_counter() - t0, 6)


def analyze(fn, *args, device=None, dtype: str = "float32", **kwargs) -> tuple[Any, dict]:
    """Run ``fn(*args, **kwargs)`` once under :func:`counting` (the call is
    the real dispatch, not an extra one). Returns ``(fn's result, record)``.
    ``device`` defaults to the first tensor argument's."""
    import torch

    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)), torch.device("cpu"))
    with counting(device, dtype) as rec:
        out = fn(*args, **kwargs)
    return out, rec


def achieved_roofline(cost: dict | None, programs_per_sec: float, platform: str | None = None) -> dict | None:
    """Achieved-vs-roofline fraction for a measured program rate: the
    ceiling at the program's intensity is ``min(peak, rate * intensity)``
    (peak at the record's dtype), the achieved rate ``flops *
    programs_per_sec``. Returns ``{"platform", "arithmetic_intensity",
    "achieved_tflops_per_s", "ceiling_tflops_per_s", "fraction", "bound"}``
    or None where the record is unavailable, lacks flops and bytes, or its
    platform is off the table."""
    if not isinstance(cost, dict) or not cost.get("available"):
        return None
    flops, bytes_accessed = cost.get("flops"), cost.get("bytes_accessed")
    if not (isinstance(flops, (int, float)) and isinstance(bytes_accessed, (int, float))
            and flops > 0 and bytes_accessed > 0 and programs_per_sec > 0):
        return None
    platform = platform or cost.get("platform") or detect_platform()
    peaks = _peaks(platform, cost.get("dtype", "float32"))
    if peaks is None:
        return None
    peak, bw = peaks
    intensity = flops / bytes_accessed
    ceiling = min(peak, bw * intensity)
    achieved = flops * programs_per_sec
    return {
        "platform": platform,
        "arithmetic_intensity": round(intensity, 4),
        "achieved_tflops_per_s": round(achieved / 1e12, 6),
        "ceiling_tflops_per_s": round(ceiling / 1e12, 6),
        "fraction": round(achieved / ceiling, 6),
        "bound": "compute" if peak <= bw * intensity else "memory",
    }


@contextlib.contextmanager
def maybe_emit_cost(name: str, device, dtype: str = "float32", sink=None, **tags) -> Iterator[dict | None]:
    """Count the enclosed dispatch and emit one ``cost`` record into the
    explicit or process-global sink; with no active sink nothing is counted
    (yields None), so callers without telemetry see no change."""
    target = sink if sink is not None else _spans.get_sink()
    if target is None or not getattr(target, "active", False):
        yield None
        return
    with counting(device, dtype) as rec:
        yield rec
    target.emit("cost", name=name, **rec, **tags)
