"""Batch buckets and the micro-batcher (``qdml_tpu/serve/batcher.py``).

:class:`MicroBatcher` is a bounded FIFO with two admission policies:

- **coalesce** (``continuous=False``, the bucket mode's): requests wait
  until ``max_batch`` of them are queued (a full bucket flushes at once) or
  the oldest has waited ``max_wait_s`` (a partial batch flushes);
- **continuous** (``continuous=True``, the ragged mode's): ``next_batch``
  returns everything queued, up to ``max_batch``, as soon as anything is:
  a free worker never sleeps on a non-empty queue, and while one dispatch
  runs the next arrivals queue and go together in the next.

Admission sheds typed :class:`~qdml_tpu_torch.serve.types.Overloaded`
results: a full queue and a deadline already past reject at submit, a
deadline that expires while queued sheds at dequeue. The clock is injected
(``clock=``), so every edge case is testable without sleeping.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Sequence

from qdml_tpu_torch.serve.types import (
    DEADLINE_AT_DEQUEUE,
    DEADLINE_AT_SUBMIT,
    QUEUE_FULL,
    Overloaded,
    Request,
)
from qdml_tpu_torch.utils import lockdep


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


class MicroBatcher:
    """Bounded FIFO request queue with max-batch/max-wait coalescing."""

    def __init__(
        self,
        max_batch: int = 64,
        max_wait_s: float = 0.002,
        max_queue: int = 256,
        clock: Callable[[], float] = time.monotonic,
        continuous: bool = False,
    ):
        if max_queue < max_batch:
            raise ValueError(
                f"max_queue ({max_queue}) must hold at least one full batch "
                f"({max_batch})"
            )
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue
        self.clock = clock
        # continuous admission (the ragged engine mode): next_batch returns
        # whatever is queued instead of waiting out the coalescing window.
        # Mutable on purpose — ServeLoop/ReplicaPool sync it from the warmed
        # engine's measured batching mode (the "auto" race resolves at
        # warmup, after the batcher exists).
        self.continuous = bool(continuous)
        self._q: deque[Request] = deque()
        self._lock = lockdep.Lock("MicroBatcher._lock")
        # Wake signal owned by the QUEUE, not any one consumer: a replica
        # pool runs several ServeLoops draining this one batcher, and a
        # submit must be able to wake whichever replica's worker is idle
        # (an Event wakes every waiter; each loop's bounded wait_hint sleep
        # caps the staleness of a racing clear at max_wait_s, exactly the
        # single-loop behavior). Loops wait on this instead of a private
        # event; submit() sets it on every successful enqueue.
        self.wake = threading.Event()

    @property
    def depth(self) -> int:
        with self._lock:  # deque len is GIL-atomic today, but the lock map
            return len(self._q)  # makes the discipline checkable, not lucky

    def submit(self, req: Request, now: float | None = None) -> Overloaded | None:
        """Admit ``req``; returns an :class:`Overloaded` (and does NOT enqueue)
        when the bounded queue is full or the deadline has already passed,
        else ``None``. ``enqueue_ts`` (stamped here, from this batcher's
        clock) is also the request trace's batcher-enqueue boundary — the
        batch_wait/queue_wait phase split (telemetry/tracing.py) is computed
        from it at dequeue, so tracing adds NO extra clock read on submit."""
        now = self.clock() if now is None else now
        req.enqueue_ts = now
        if req.deadline is not None and req.deadline <= now:
            return Overloaded(req.rid, DEADLINE_AT_SUBMIT)
        with self._lock:
            if len(self._q) >= self.max_queue:
                return Overloaded(req.rid, QUEUE_FULL)
            self._q.append(req)
        self.wake.set()
        return None

    def next_batch(
        self, now: float | None = None
    ) -> tuple[list[Request], list[tuple[Request, Overloaded]]]:
        """``(ready, shed)``: up to ``max_batch`` requests when the flush
        policy fires (full batch, or oldest aged past ``max_wait_s``), else
        ``[]``. ``shed`` pairs each queued request whose deadline expired
        before it could be batched with its typed ``Overloaded`` result — the
        REQUEST rides along because the caller must still resolve its future
        (a shed whose future never resolves is a client hung forever)."""
        now = self.clock() if now is None else now
        shed: list[tuple[Request, Overloaded]] = []
        with self._lock:
            if self._q:
                live = deque()
                for r in self._q:
                    if r.deadline is not None and r.deadline <= now:
                        shed.append(
                            (r, Overloaded(r.rid, DEADLINE_AT_DEQUEUE, now - r.enqueue_ts))
                        )
                    else:
                        live.append(r)
                self._q = live
            if not self._q:
                return [], shed
            if not self.continuous:
                full = len(self._q) >= self.max_batch
                aged = (now - self._q[0].enqueue_ts) >= self.max_wait_s
                if not (full or aged):
                    return [], shed
            take = min(len(self._q), self.max_batch)
            return [self._q.popleft() for _ in range(take)], shed

    def wait_hint(self, now: float | None = None) -> float:
        """Seconds until the serve loop should next pump: in coalesce mode,
        until the oldest queued request hits ``max_wait_s``; in continuous
        mode, 0 whenever anything is queued (an idle engine must never sleep
        on a non-empty queue — the one race a submit's wake can lose is a
        worker that checked the queue just before the enqueue, and a zero
        hint closes it). ``max_wait_s`` when the queue is empty (the idle
        sleep bound; submits wake the loop sooner)."""
        now = self.clock() if now is None else now
        with self._lock:
            if not self._q:
                return self.max_wait_s
            if self.continuous:
                return 0.0
            return max(0.0, self.max_wait_s - (now - self._q[0].enqueue_ts))
