"""The yardstick's arithmetic for the quantum classifier: the hand circuit
kernels' bytes and operations a launch, and the classifier's model FLOPs a
sample.

``circuit_work`` and ``adjoint_work`` are copies of
``qdml_tpu_torch/telemetry/cost.py``'s, copied, not imported, so that a
change to the program cannot change what the benchmark counts. The
classifier's forward counts the front end's convolutions and linear layer,
the circuit gate by gate (what the kernel computes, not a dense 2^n x 2^n
unitary) and the head; a training step counts three times the forward, as
:mod:`port_bench.work` counts the HDCE's.
"""

from __future__ import annotations

from port_bench.work import PEAK_FP32_FLOPS, TRAIN_FLOPS_FACTOR  # noqa: F401

# NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12


def circuit_work(batch: int, n: int, layers: int, with_state: bool = False) -> tuple[float, float]:
    """Bytes (angles and gate table in, <Z> out, and the final state's re and
    im out when it is written) and flops of one circuit call: embedding, 24
    flops per amplitude pair per wire per layer (RY then RZ), and the <Z>
    contraction."""
    dim = 1 << n
    bytes_moved = 4 * (batch * n + layers * n * 4 + batch * n + (2 * batch * dim if with_state else 0))
    flops = batch * dim * n + 12 * batch * layers * n * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def adjoint_work(batch: int, n: int, layers: int) -> tuple[float, float]:
    """Bytes (final state, cotangent, angles and gate table in; dangles and
    dweights out, each once) and flops of one adjoint call: the cotangent's
    start (n + 3 per amplitude), 64 flops per amplitude pair per wire per
    layer (two gradient terms and two rotations undone on psi and lambda),
    and the embedding cotangent as the function needs it, the backward pass
    of the product-state build: about 2 per amplitude to rebuild it and 8
    for its backward."""
    dim = 1 << n
    bytes_moved = 4 * (2 * batch * dim + 2 * batch * n + layers * n * 4 + batch * n + layers * n * 2)
    flops = batch * (dim * (n + 3) + 32 * layers * n * dim + 10 * dim)
    return bytes_moved, flops


def bound_s(work: tuple[float, float]) -> float:
    """The least time one launch of ``work`` (bytes, flops) can take on one
    card: the larger of its bytes over the memory bandwidth and its flops
    over the float32 peak."""
    bytes_moved, flops = work
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS)


def qsc_fwd_flops_per_sample(image_hw: tuple[int, int], n: int, layers: int, classes: int) -> float:
    """One sample's forward: Conv 2->16 (3x3) on the H x W image, Conv
    16->32 on the pooled H/2 x W/2, the Linear from the 32 x H/4 x W/4
    features to n angles, the circuit gate by gate (:func:`circuit_work`'s
    flops of one row) and the Linear n -> classes."""
    h, w = image_hw
    k2 = 9
    conv = 2 * h * w * k2 * 2 * 16 + 2 * (h // 2) * (w // 2) * k2 * 16 * 32
    front = 2 * 32 * (h // 4) * (w // 4) * n
    circ = circuit_work(1, n, layers)[1]
    head = 2 * n * classes
    return float(conv + front + circ + head)
