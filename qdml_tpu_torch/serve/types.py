"""Dispatch accounting (``qdml_tpu/serve/types.py:46``).

The request and result records of the serving tier come with its slice
(ROADMAP A.11).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DispatchInfo:
    """What one :meth:`ServeEngine.infer` call dispatched: ``rows`` is the total
    padded rows over every launch of the forward (one per chunk for oversize
    batches), so ``n / rows`` is the honest fill."""

    bucket: int          # padded batch shape dispatched (largest, if chunked)
    n: int               # valid (real) rows served
    rows: int            # total padded rows dispatched across all chunks
    chunks: int = 1      # forward passes this call made

    @property
    def fill(self) -> float:
        return self.n / self.rows if self.rows else 0.0
