"""PyTorch/CUDA port of qdml_tpu: RIS channel estimation served on an NVIDIA GPU.

The package mirrors ``qdml_tpu``'s layout module for module and imports
``torch`` and ``numpy`` only — never JAX, Flax or the ``qdml_tpu`` package
itself. Plain tensor work is PyTorch; the two circuit kernels that ``qdml_tpu``
wrote in Pallas for the TPU are hand-written CUDA C++ for Hopper (``csrc/``),
built with ``nvcc`` on first use and bound through ``ctypes``
(:mod:`qdml_tpu_torch.quantum.kernels`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise ``RuntimeError``
(:func:`qdml_tpu_torch.utils.device.resolve_device`).
"""

from qdml_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
