"""Seeded, deterministic fault injection for the serving tier (``qdml_tpu/serve/faults.py``).

A :class:`FaultPlan` is an explicit schedule: which failure class fires at
which occurrence of its hook site. ``ServeLoop`` / ``ReplicaPool`` take it
as ``faults=``; ``None`` (the default everywhere) reduces every hook site to
one attribute check. The seed shapes only the supervisor's backoff jitter
(:attr:`FaultPlan.rng`), never whether a fault fires, so a run replays
exactly; the draws are ``random.Random``'s, the same as the JAX package's
for the same seed.

Worker-side classes: ``replica_crash`` (a worker dies before dequeuing, the
queue untouched) and ``worker_exception`` (the engine call for one batch
raises :class:`FaultInjected`: the batch's futures resolve with it and the
replica comes back). The socket and file classes are driven from the
client side, which asks the same plan (:meth:`FaultPlan.client_fault_at`).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from qdml_tpu_torch.utils import lockdep

FAULT_CLASSES = (
    "replica_crash",
    "worker_exception",
    "socket_drop",
    "socket_garbage",
    "partial_line",
    "stalled_client",
    "corrupt_swap",
    "autotune_corrupt",
)

# Hook sites the serving components expose. Worker-side sites fire inside
# ServeLoop (the spec's kind picks what happens); client/file sites are
# consumed by the chaos driver, which asks the plan "should this fault fire
# now?" the same way the workers do.
WORKER_SITES = ("worker_loop", "worker_batch")


class FaultInjected(RuntimeError):
    """A deliberately injected fault (chaos harness). Typed so tests and the
    serve loop's failure paths can tell an injected crash from a real one —
    and so nothing anywhere catches it by name to 'fix' the chaos."""

    def __init__(self, kind: str, site: str, seq: int):
        super().__init__(f"injected {kind} at {site}#{seq}")
        self.kind = kind
        self.site = site
        self.seq = seq


@dataclass
class FaultSpec:
    """One scheduled fault: ``kind`` (a :data:`FAULT_CLASSES` member) firing
    at the ``at``-th occurrence of its hook site (0-based), ``times``
    consecutive occurrences (a crash-looping replica is ``times`` large
    enough to exhaust the restart budget). ``replica`` targets one replica
    by name (``serve-replica-1``); ``None`` matches whichever worker reaches
    the site (the per-replica occurrence counter still makes it
    deterministic under a single-replica pool)."""

    kind: str
    at: int = 0
    times: int = 1
    replica: str | None = None

    def __post_init__(self):
        if self.kind not in FAULT_CLASSES:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (have {FAULT_CLASSES})"
            )
        if self.at < 0 or self.times < 1:
            raise ValueError(f"need at >= 0 and times >= 1, got {self}")


# which hook site each worker-side fault class fires at: replica_crash fires
# at the TOP of the worker loop (before any dequeue — the queue is untouched,
# like a killed process); worker_exception fires around the engine call for
# one batch (its futures get the exception).
_SITE_OF = {"replica_crash": "worker_loop", "worker_exception": "worker_batch"}


class FaultPlan:
    """Deterministic fault schedule + per-site occurrence counters.

    Thread-safe: worker threads and the chaos driver share one plan. The
    ``seed`` feeds :attr:`rng` (used by the pool's backoff jitter so chaos
    runs replay exactly); it never decides WHETHER a fault fires — that is
    the explicit ``FaultSpec`` schedule's job.
    """

    def __init__(self, specs: list[FaultSpec] | None = None, seed: int = 0):
        self.specs = list(specs or [])
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self._lock = lockdep.Lock("FaultPlan._lock")
        self._counts: dict[str, int] = {}
        self.fired: list[dict] = []  # audit trail: every fault that fired

    def describe(self) -> dict:
        """The plan as a JSON-able record (a fault-injection run's record)."""
        return {
            "seed": self.seed,
            "faults": [
                {"kind": s.kind, "at": s.at, "times": s.times} for s in self.specs
            ],
        }

    def _fire(self, site: str, replica: str | None) -> tuple[FaultSpec, int] | None:
        """Occurrence counters are PER (site, replica): a fault targeted at
        one replica counts that replica's occasions only, and an untargeted
        spec consumes whichever replica reaches its scheduled occasion —
        both deterministic under the pool topologies chaos runs use."""
        key = (site, replica)
        with self._lock:
            seq = self._counts.get(key, -1) + 1  # this call's occasion
            self._counts[key] = seq
            for s in self.specs:
                if _SITE_OF.get(s.kind) != site:
                    continue
                if s.replica is not None and s.replica != replica:
                    continue
                if s.at <= seq < s.at + s.times:
                    self.fired.append(
                        {"kind": s.kind, "site": site, "seq": seq,
                         "replica": replica}
                    )
                    return s, seq
        return None

    # -- worker-side hooks (ServeLoop) --------------------------------------

    def check_worker_loop(self, replica: str | None = None) -> None:
        """Top of a worker's pump iteration with work pending (BEFORE any
        dequeue): a scheduled ``replica_crash`` raises here, so the queue is
        untouched — the crashed-process shape."""
        hit = self._fire("worker_loop", replica)
        if hit is not None:
            raise FaultInjected(hit[0].kind, "worker_loop", hit[1])

    def check_worker_batch(self, replica: str | None = None) -> None:
        """Around one batch's engine call: a scheduled ``worker_exception``
        raises here — the batch's futures must resolve with the exception."""
        hit = self._fire("worker_batch", replica)
        if hit is not None:
            raise FaultInjected(hit[0].kind, "worker_batch", hit[1])

    # -- client/file-side schedule (chaos driver) ---------------------------

    def client_fault_at(self, kind: str, request_index: int) -> bool:
        """Does the plan schedule client/file fault ``kind`` at this request
        index? (The chaos driver injects socket/file faults itself; the plan
        is the single deterministic schedule both sides read.)"""
        return any(
            s.kind == kind and s.at <= request_index < s.at + s.times
            for s in self.specs
        )


@dataclass
class RestartPolicy:
    """Supervision budget + jittered exponential backoff (ReplicaPool).

    ``delay(k, rng)`` is the sleep before restart ``k`` (0-based):
    ``base * 2^k`` scaled by a uniform jitter in ``[1, 1+jitter]`` — the
    jitter decorrelates a fleet of supervisors restarting at once, and the
    rng is injected (the FaultPlan's seeded one under chaos) so runs replay.
    A slot that has used ``budget`` restarts is quarantined instead — but
    the budget measures crash LOOPS, not lifetime totals: a slot that then
    served healthily for ``reset_after_s`` gets its count reset, so three
    unrelated transient faults spread over days can never quarantine a
    replica the way three crashes in a row do."""

    base_s: float = 0.05
    budget: int = 3
    jitter: float = 0.5
    max_s: float = 2.0
    reset_after_s: float = 30.0

    def delay(self, k: int, rng: random.Random) -> float:
        raw = self.base_s * (2.0 ** k)
        return min(self.max_s, raw) * (1.0 + self.jitter * rng.random())

    def exhausted(self, restarts: int) -> bool:
        return restarts >= self.budget

    def stale(self, since_last_restart_s: float) -> bool:
        """Has the slot been healthy long enough to forget its history?"""
        return since_last_restart_s > self.reset_after_s
