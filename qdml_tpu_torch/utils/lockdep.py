"""Runtime lock-order witness behind ``QDML_LOCKDEP=1`` (``qdml_tpu/utils/lockdep.py``).

:func:`Lock` / :func:`RLock` stand in for ``threading.Lock()`` /
``threading.RLock()`` and take a lock *name* (``Class._attr`` or
``module:NAME``); every lock of the serving tier is made through them.

- **Disabled (default)**: the factory returns the stdlib primitive itself,
  so an acquire costs what it always did. The environment variable is read
  when a lock is made, so a test can set it and make a fresh lock.
- **Enabled (``QDML_LOCKDEP=1``)**: each lock becomes a :class:`_DepLock`
  that records, per thread, the locks held and, process-wide, every
  first-seen order edge (A held while B is acquired) with the stack that
  first showed it. Acquiring B while holding A when the edge B -> A is on
  record raises :class:`LockOrderError` naming both edges and both stacks,
  even if the two orders never actually interleave.

Re-entering an RLock records no edge. :func:`witness_summary` reports
``{"enabled", "locks", "edges", "max_held", "inversions"}``; ``inversions``
is counted before the raise, so it survives a supervised worker whose
fault handling swallows the exception.
"""

from __future__ import annotations

import os
import threading
import traceback

__all__ = [
    "Lock",
    "RLock",
    "LockOrderError",
    "enabled",
    "reset",
    "witness_summary",
    "witnessed_edges",
]


def enabled() -> bool:
    """Whether locks constructed NOW would be witnessed."""
    return os.environ.get("QDML_LOCKDEP") == "1"


class LockOrderError(RuntimeError):
    """Two lock identities were acquired in both orders.

    Carries both edges and the first-seen stack of each, so the report
    names the two call paths that would deadlock against each other."""

    def __init__(
        self,
        first: tuple[str, str],
        second: tuple[str, str],
        first_stack: str,
        second_stack: str,
    ):
        self.first = first
        self.second = second
        self.first_stack = first_stack
        self.second_stack = second_stack
        super().__init__(
            f"lock-order inversion: edge {second[0]} -> {second[1]} "
            f"contradicts previously-seen edge {first[0]} -> {first[1]}\n"
            f"--- first-seen stack for {first[0]} -> {first[1]} ---\n"
            f"{first_stack}"
            f"--- acquiring stack for {second[0]} -> {second[1]} ---\n"
            f"{second_stack}"
        )


# process-global witness state; _guard is a raw stdlib lock and is never
# itself witnessed (leaf by construction — nothing is acquired under it)
_guard = threading.Lock()
_edges: dict[tuple[str, str], str] = {}  # (held, acquired) -> first stack
_names: set[str] = set()
_max_held = 0
# inversions seen, recorded BEFORE the raise: a LockOrderError thrown inside
# a supervised worker thread may be swallowed by that thread's fault
# handling (the supervisor treats it as a crash and restarts), so the
# summary reports this counter, not whether the exception escaped
_inversions: list[str] = []

_tls = threading.local()


def _held() -> list["_DepLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _short_stack(skip: int = 3) -> str:
    return "".join(traceback.format_stack()[:-skip][-8:])


class _DepLock:
    """Witnessing wrapper over a stdlib lock. Same acquire/release/context
    protocol; ``reentrant`` relaxes the re-entry rule (RLock)."""

    __slots__ = ("name", "reentrant", "_inner")

    def __init__(self, name: str, reentrant: bool):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        with _guard:
            _names.add(name)

    # -- witness core --------------------------------------------------------

    def _note_acquire(self) -> None:
        global _max_held
        stack = _held()
        if self.reentrant and any(h is self for h in stack):
            stack.append(self)  # re-entry: legal, no edge
            return
        if stack:
            held_names = [h.name for h in stack]
            my_stack = _short_stack()
            with _guard:
                for held in held_names:
                    if held == self.name:
                        continue
                    edge = (held, self.name)
                    rev = (self.name, held)
                    if rev in _edges:
                        _inversions.append(
                            f"{edge[0]} -> {edge[1]} vs {rev[0]} -> {rev[1]}"
                        )
                        raise LockOrderError(
                            rev, edge, _edges[rev], my_stack
                        )
                    _edges.setdefault(edge, my_stack)
        stack.append(self)
        if len(stack) > _max_held:
            with _guard:
                _max_held = max(_max_held, len(stack))

    def _note_release(self) -> None:
        stack = _held()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # witness BEFORE blocking: the inversion report must fire even when
        # (especially when) the acquire would deadlock for real
        self._note_acquire()
        ok = self._inner.acquire(blocking, timeout)
        if not ok:
            self._note_release()
        return ok

    def release(self) -> None:
        self._inner.release()
        self._note_release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self.reentrant:
            return any(h is self for h in _held())
        return self._inner.locked()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kind = "RLock" if self.reentrant else "Lock"
        return f"<lockdep.{kind} {self.name!r}>"


def Lock(name: str):
    """``threading.Lock()`` (disabled) or a witnessing lock (enabled)."""
    if not enabled():
        return threading.Lock()
    return _DepLock(name, reentrant=False)


def RLock(name: str):
    """``threading.RLock()`` (disabled) or a witnessing re-entrant lock."""
    if not enabled():
        return threading.RLock()
    return _DepLock(name, reentrant=True)


def reset() -> None:
    """Drop all witnessed state (tests; also safe between phases of a run —
    per-thread held stacks are live and not touched)."""
    global _max_held
    with _guard:
        _edges.clear()
        _names.clear()
        _inversions.clear()
        _max_held = 0


def witness_summary() -> dict:
    """The witness record. ``enabled`` reflects the env var NOW;
    counts cover every witnessed lock since the last :func:`reset`.
    ``inversions`` is the gate: each one also raised a LockOrderError at
    the acquisition site, but the counter survives a worker thread's fault
    handling swallowing the exception."""
    with _guard:
        return {
            "enabled": enabled(),
            "locks": len(_names),
            "edges": len(_edges),
            "max_held": _max_held,
            "inversions": len(_inversions),
            "inversion_edges": list(_inversions),
        }


def witnessed_edges() -> list[tuple[str, str]]:
    """Every order edge witnessed since the last :func:`reset`, as
    ``(held, acquired)`` lock names, sorted: the runtime twin of the static
    lock graph's edges."""
    with _guard:
        return sorted(_edges)
