"""Retry-disciplined client of the newline-JSON serving protocol (``qdml_tpu/serve/client.py``).

One :class:`ServeClient` owns one TCP connection and gives every call:

- **deadline propagation**: a request's ``deadline_ms`` rides the wire (the
  server sheds it typed if it cannot be met) and bounds the client-side
  wait;
- **per-request timeouts**: every send and receive runs under a socket
  timeout (``timeout_s``, tightened to the remaining deadline);
- **jittered-backoff retries on idempotent ids**: a connection error or
  timeout reconnects after ``backoff_s * 2^k`` (jittered) and re-sends the
  same id; the server's dedup window re-attaches the retry to the first
  dispatch, so a retried request never runs twice. Ids default to fresh
  uuids.

``reconnects``, ``retries_used`` and ``give_ups`` accumulate on the client
(:meth:`ServeClient.counters`). The protocol is the JAX package's, so this
client speaks to either package's server.
"""

from __future__ import annotations

import json
import random
import socket
import time
import uuid

from qdml_tpu_torch.utils import lockdep


class ServeClientError(ConnectionError):
    """The client exhausted its retries (or the deadline) for one request.
    Typed so harness code can count a give-up without catching the world."""


class ServeClient:
    """One connection + the retry/backoff/deadline discipline around it.

    Thread-safe per request (``_lock`` serializes the request/reply exchange
    on the single connection); use one client per concurrent in-flight
    request — the loadgen socket harness keeps a small pool of them.
    """

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = 10.0,
        retries: int = 3,
        backoff_s: float = 0.05,
        backoff_max_s: float = 2.0,
        jitter: float = 0.5,
        seed: int | None = None,
    ):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self._lock = lockdep.Lock("ServeClient._lock")
        self._sock: socket.socket | None = None
        self._rfile = None
        self._was_connected = False
        self.reconnects = 0
        self.retries_used = 0
        self.give_ups = 0
        # give-ups split by cause: a DEADLINE give-up means the client
        # honored its budget (typed closure inside the SLO — an SLO miss,
        # not a resilience failure); a retries-exhausted give-up against a
        # supposedly-live server is the alarming kind
        self.deadline_give_ups = 0

    # -- connection management ---------------------------------------------

    def _backoff(self, attempt: int) -> float:
        raw = min(self.backoff_max_s, self.backoff_s * (2.0 ** attempt))
        return raw * (1.0 + self.jitter * self._rng.random())

    def _connect(self, timeout_s: float) -> None:
        self.close_connection()
        sock = socket.create_connection((self.host, self.port), timeout=timeout_s)
        sock.settimeout(timeout_s)
        self._sock = sock
        self._rfile = sock.makefile("rb")

    def _ensure_connected(self, timeout_s: float) -> None:
        if self._sock is None:
            self._connect(timeout_s)
            if self._was_connected:
                self.reconnects += 1  # the FIRST connect is not a reconnect
            self._was_connected = True

    def close_connection(self) -> None:
        """Drop the socket (the next call reconnects). Safe to call always."""
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
            self._rfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    close = close_connection

    # -- the retrying exchange ---------------------------------------------

    def call(
        self,
        msg: dict,
        timeout_s: float | None = None,
        deadline_ms: float | None = None,
        idempotent: bool = True,
    ) -> dict:
        """Send one JSON line, return the matching reply dict.

        ``deadline_ms`` (for inference requests) rides the wire and CAPS the
        total client-side budget: once it has passed, the client gives up
        typed instead of retrying a request whose answer is already useless.
        ``idempotent=False`` disables the re-send (the request still gets
        ONE attempt with timeouts; used for verbs with side effects the
        caller wants to observe failing)."""
        timeout_s = self.timeout_s if timeout_s is None else float(timeout_s)
        t0 = time.monotonic()
        budget = None if deadline_ms is None else deadline_ms / 1e3
        if deadline_ms is not None:
            msg = {**msg, "deadline_ms": deadline_ms}
        if "id" not in msg:
            # every exchange gets an id so replies CORRELATE: the server can
            # interleave unsolicited notices (idle_timeout before close) with
            # replies, and a reconnecting client must never take a stale
            # buffered notice as its answer
            msg = {**msg, "id": f"op-{uuid.uuid4().hex[:12]}"}
        payload = (json.dumps(msg) + "\n").encode()
        attempts = (self.retries + 1) if idempotent else 1
        last_err: Exception | None = None
        cause = "retries"
        for attempt in range(attempts):
            remaining = (
                None if budget is None else budget - (time.monotonic() - t0)
            )
            if remaining is not None and remaining <= 0:
                cause = "deadline"
                break  # the deadline is the outer bound on the whole exchange
            per_try = timeout_s if remaining is None else min(timeout_s, remaining)
            try:
                with self._lock:
                    self._ensure_connected(per_try)
                    self._sock.settimeout(per_try)
                    self._sock.sendall(payload)
                    while True:
                        line = self._rfile.readline()
                        if not line:
                            raise ConnectionResetError(
                                "server closed the connection"
                            )
                        try:
                            rep = json.loads(line)
                        except json.JSONDecodeError as e:
                            raise ConnectionResetError(
                                f"unparseable reply framing: {e}"
                            ) from e
                        if isinstance(rep, dict) and rep.get("id") == msg["id"]:
                            break
                        # an unsolicited server notice (e.g. the typed
                        # idle_timeout written before a reap) or a stale
                        # line from before a reconnect: not our reply —
                        # keep reading until ours or EOF
                if (
                    idempotent
                    and rep.get("ok") is False
                    and str(rep.get("reason", "")).startswith("server_error")
                ):
                    # a dispatch that died server-side (worker crash, chaos
                    # fault): the server already forgot the id, so a retry
                    # re-dispatches against the recovered replica — treat it
                    # like a transport failure, backoff included
                    raise ConnectionResetError(rep["reason"])
                return rep
            except (ConnectionError, socket.timeout, TimeoutError, OSError) as e:
                last_err = e
                self.close_connection()
                if attempt + 1 >= attempts:
                    break
                self.retries_used += 1
                # jittered exponential backoff between attempts: the server
                # said nothing (or vanished) — hammering it back is how a
                # retrying fleet turns a blip into an outage
                time.sleep(self._backoff(attempt))
        self.give_ups += 1
        if cause == "deadline":
            self.deadline_give_ups += 1
        err = ServeClientError(
            f"request {msg.get('id')!r} gave up ({cause}) after "
            f"{attempts} attempt(s): "
            f"{type(last_err).__name__ if last_err else 'deadline exhausted'}: "
            f"{last_err}"
        )
        err.cause = cause
        raise err

    # -- protocol verbs -----------------------------------------------------

    def request(
        self,
        x,
        rid: int | str | None = None,
        deadline_ms: float | None = None,
        timeout_s: float | None = None,
        trace: bool = False,
    ) -> dict:
        """One inference request. ``rid`` defaults to a fresh uuid — the
        idempotency key the server dedups retries on; pass your own only if
        it is unique per LOGICAL request (reuse within ``serve.dedup_ttl_s``
        intentionally returns the original result).

        ``trace=True`` sets the optional ``trace`` wire field, forcing a
        phase trace for this request: the reply then
        carries ``trace.phases`` — server-side batch_wait/queue_wait/
        compute/fetch spans, prepended with router pick/wire spans when the
        endpoint is a fleet router. The client-observed wall time is the
        caller's to measure ON ITS OWN CLOCK; it must never be differenced
        against server timestamps (clock skew), only against the reply's
        phase DURATIONS — the loadgen reconciliation does exactly that. A
        retried id keeps its trace: the send is byte-stable per attempt and
        the dedup tiers re-attach to the original traced dispatch."""
        if rid is None:
            rid = uuid.uuid4().hex
        msg = {"id": rid, "x": x if isinstance(x, list) else x.tolist()}
        if trace:
            msg["trace"] = True
        return self.call(msg, timeout_s=timeout_s, deadline_ms=deadline_ms)

    def health(self, timeout_s: float | None = None) -> dict:
        return self.call({"op": "health"}, timeout_s=timeout_s)

    def metrics(self, timeout_s: float | None = None) -> dict:
        return self.call({"op": "metrics"}, timeout_s=timeout_s)

    def events(
        self,
        cursor: dict | None = None,
        limit: int | None = None,
        timeout_s: float | None = None,
    ) -> dict:
        """Event-spine tail: everything
        the endpoint published since ``cursor`` (None = from the buffer
        head), plus the explicit loss ledger. Resume by passing the reply's
        cursor back — ``{"start_seq", "seq"}`` against a serve host, the
        per-source ``cursor`` block verbatim against a router. Idempotent
        (a pure read): retries are safe, the cursor only advances when the
        CALLER passes the new one back."""
        msg: dict = {"op": "events"}
        if cursor is not None:
            msg["cursor"] = cursor
        if limit is not None:
            msg["limit"] = int(limit)
        return self.call(msg, timeout_s=timeout_s)

    def swap(self, tags: dict | None = None, timeout_s: float | None = None) -> dict:
        # NOT idempotent in the retry sense: a swap that timed out may have
        # landed — the caller must re-inspect (health.swap_epoch) rather
        # than have the client blindly re-deploy
        msg: dict = {"op": "swap"}
        if tags is not None:
            msg["tags"] = tags
        return self.call(msg, timeout_s=timeout_s, idempotent=False)

    def scale(self, replicas: int, timeout_s: float | None = None) -> dict:
        """Replica axis: resize the pools INSIDE the existing host(s)
       ."""
        return self.call(
            {"op": "scale", "replicas": int(replicas)},
            timeout_s=timeout_s,
            idempotent=False,
        )

    def counters(self) -> dict:
        """The client-side resilience ledger (folded into socket-loadgen
        summaries): reconnects, retries spent, give-ups."""
        return {
            "reconnects": self.reconnects,
            "retries": self.retries_used,
            "give_ups": self.give_ups,
            "deadline_give_ups": self.deadline_give_ups,
        }

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close_connection()
