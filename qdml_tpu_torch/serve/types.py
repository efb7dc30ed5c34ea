"""Dispatch accounting (``qdml_tpu/serve/types.py:46-82``).

The request and result records of the serving tier come with its slice
(ROADMAP A.11).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DispatchInfo:
    """What one :meth:`ServeEngine.infer` call dispatched: ``rows`` is the total
    padded rows over every forward of the call (one per chunk for oversize
    batches), so ``n / rows`` is the honest fill and ``rows - n`` the pad
    waste."""

    bucket: int          # padded batch shape dispatched (largest, if chunked)
    n: int               # valid (real) rows served
    rows: int            # total padded rows dispatched across all chunks
    chunks: int = 1      # forward passes this call made
    mode: str = "bucket"  # tier batching mode: "bucket" | "ragged"

    @property
    def fill(self) -> float:
        return self.n / self.rows if self.rows else 0.0

    @property
    def padded(self) -> int:
        return self.rows - self.n
