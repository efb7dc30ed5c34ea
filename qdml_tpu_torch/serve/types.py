"""Request and result records of the serving tier (``qdml_tpu/serve/types.py:19-117``).

A request is one pilot observation (``x`` of shape ``(n_sub, n_beam, 2)``)
asking for its channel estimate. It resolves to exactly one typed result: a
:class:`Prediction` (the routed estimate and the predicted scenario) or an
:class:`Overloaded` (shed: queue full, deadline passed, breaker open,
shutting down). Overload is a result, not an exception: the callers that
must react to shedding are the ones that would lose an exception raised on
a worker thread. The shed reasons are part of the wire format.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from qdml_tpu_torch.telemetry.tracing import TraceContext

# Overload reasons (the complete set; they are part of the wire format)
QUEUE_FULL = "queue_full"                    # bounded queue at capacity on submit
DEADLINE_AT_SUBMIT = "deadline_at_submit"    # deadline already past on admission
DEADLINE_AT_DEQUEUE = "deadline_at_dequeue"  # expired while queued
SHUTDOWN = "shutdown"                        # server stopping (or its last worker died)
BREAKER_OPEN = "breaker_open"                # circuit breaker browning out new submits


@dataclass
class Request:
    """One in-flight inference request."""

    rid: int | str
    x: np.ndarray                     # (n_sub, n_beam, 2) float32 pilot image
    enqueue_ts: float = 0.0           # batcher clock seconds, stamped on submit
    deadline: float | None = None     # absolute batcher-clock seconds; None = none
    future: Future | None = None      # resolved with Prediction | Overloaded
    # sampled phase trace; None (the default) stamps no clock and allocates nothing
    trace: TraceContext | None = None


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
    mode: str = "bucket"  # tier batching mode: "bucket" | "ragged" ("mixed" across chunks)
    # Traced batches only (summed over chunks): compute = dispatch until the
    # stream's work completes, fetch = the device-to-host copy of the reply.
    # None on the untraced path, which reads no clock for them.
    compute_s: float | None = None
    fetch_s: float | None = None

    @property
    def fill(self) -> float:
        return self.n / self.rows if self.rows else 0.0

    @property
    def padded(self) -> int:
        return self.rows - self.n


@dataclass
class Prediction:
    """Successful result: routed channel estimate and predicted scenario."""

    rid: int | str
    h: np.ndarray                     # (2 * h_dim,) float32 packed re/im estimate
    scenario: int                     # predicted expert id (argmax of the classifier)
    latency_s: float                  # enqueue -> result, batcher clock
    bucket: int                       # padded batch bucket that served it
    batch_n: int                      # real requests in that batch
    # True/False when the request carried a deadline (met or not), else None
    deadline_met: bool | None = None
    # probability of the routed class (exp of the max log-prob)
    confidence: float | None = None
    # the request's phase trace, closed at resolution; None when untraced
    trace: TraceContext | None = None

    @property
    def ok(self) -> bool:
        return True


@dataclass
class Overloaded:
    """Typed load-shedding result."""

    rid: int | str
    reason: str                       # QUEUE_FULL | DEADLINE_* | SHUTDOWN | BREAKER_OPEN
    latency_s: float = 0.0            # time spent queued before shedding

    @property
    def ok(self) -> bool:
        return False
