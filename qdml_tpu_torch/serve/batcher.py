"""Batch buckets (``qdml_tpu/serve/batcher.py:50-72``).

The micro-batcher's queue, coalescing and load shedding come with the serving
tier's slice (ROADMAP A.11); the engine needs only the bucket helpers.
"""

from __future__ import annotations

from typing import Sequence


def power_of_two_buckets(max_batch: int) -> tuple[int, ...]:
    """``(1, 2, 4, ..., max_batch)``; max_batch is always the last bucket even
    when it is not a power of two."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n``; oversize falls back to the LARGEST
    bucket (the engine then serves the batch in largest-bucket chunks)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]
