"""The yardstick's arithmetic: model FLOPs a sample and the card's
published peak.

The FLOP model is a copy of ``qdml_tpu_torch/bench.py``'s
``hdce_fwd_flops_per_sample``, copied, not imported, so that a change to
the program cannot change what the benchmark counts. A training step
counts three times the forward (forward, and a backward of twice its
cost).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rate, at the full 700 W power limit:
# float32 outside the tensor cores (the configurations run float32 with TF32
# off).
PEAK_FP32_FLOPS = 67e12

TRAIN_FLOPS_FACTOR = 3.0


def hdce_fwd_flops_per_sample(image_hw: tuple[int, int], features: int, out_dim: int) -> float:
    """One trunk (three 3x3 convs, the first from the 2 re/im channels) and
    the head, a sample, forward."""
    h, w = image_hw
    f = features
    k2 = 9
    conv = 2 * h * w * k2 * 2 * f + 2 * (2 * h * w * k2 * f * f)
    head = 2 * (f * h * w) * out_dim
    return float(conv + head)
