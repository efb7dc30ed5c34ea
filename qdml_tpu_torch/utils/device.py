"""Device selection for the port: the card by default, the CPU only on request.

Counterpart of ``qdml_tpu/utils/platform.py``. Where the JAX package pins a
backend through its config, the port resolves one ``torch.device`` per entry
point and never carries on quietly on the CPU: a caller that wants the CPU
says ``device="cpu"``.
"""

from __future__ import annotations

import torch


def set_fp32_math() -> None:
    """Full float32 for matmuls and cuDNN convolutions, and float32 sums in
    bfloat16 products.

    cuDNN convolutions default to TF32 on Hopper (about three decimal digits),
    which would break parity with the float32 reference; matmuls already run
    in float32 by default, and this pins both explicitly. cuBLAS may also
    round a bfloat16 product's split-K partial sums to bfloat16 by default;
    the JAX package accumulates its bfloat16 head and convs in float32
    (``qdml_tpu/models/cnn.py:98-106``), so that is turned off too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` without a GPU); an explicit
    ``"cpu"``/``"cuda[:i]"`` is honoured as given. Also sets float32 math."""
    set_fp32_math()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is visible")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; want cuda or cpu")
    return dev
