"""The benchmark of the PyTorch and CUDA port, ``qdml_tpu_torch`` (see README.md)."""
