"""Backend lifecycle manager (``qdml_tpu/fleet/lifecycle.py``): spawn -> warm -> admit / drain -> retire.

:class:`BackendLifecycle` turns a wanted backend count into warmed
``serve`` processes behind the router, through this state machine::

    spawn ──▶ warming ──▶ admitted ──▶ draining ──▶ retired
                 │
                 └──▶ quarantined   (failed admission: killed, fleet untouched)

Two invariants:

- **a cold backend is never admitted**: :meth:`BackendLifecycle.scale_up`
  launches a real ``serve`` process (``fleet/spawn.py``), waits for the
  banner it prints after warmup, then checks over the live verbs that it
  reports ``warm=true`` and zero request-path work
  (``compile_cache_after_warmup``, which the port fills with
  ``ServeEngine.request_path_work()``: a measurement, a table write or a
  kernel build after warmup) BEFORE :meth:`FleetRouter.add_backend` runs.
  Any failure, a process killed mid-admission included, quarantines the
  standby: it is killed and the serving fleet never saw it.
- **retirement strands nothing**: :meth:`BackendLifecycle.scale_down` is
  drain-then-exit through the router: the victim's vnodes leave the ring
  first (typed ``draining`` state, no fresh work), in-flight forwards
  complete, the host leaves the table (router-side dedup entries keep
  answering retries for their TTL), and only then, after
  ``dedup_grace_s``, does the process get SIGINT.

Every transition emits a ``fleet_lifecycle`` event; the fleet autoscaler
(``control/fleet_scale.py``) drives :meth:`BackendLifecycle.scale_to`, and
the router's front door exposes it as ``{"op": "fleet"}`` (``fleet-scale``).

Thread model: the member table (``_members``, ``_procs``) is read by
status readers while a scale operation writes it, so every touch holds
``_lock``; ``_scale_lock`` runs one scale operation at a time.
"""

from __future__ import annotations

import time

from qdml_tpu_torch.fleet.router import FleetRouter, _emit_event
from qdml_tpu_torch.fleet.spawn import spawn_backend
from qdml_tpu_torch.serve.client import ServeClient, ServeClientError
from qdml_tpu_torch.utils import lockdep

#: transport/shape failures during admission verification — all of them
#: quarantine the standby (a backend that cannot prove it is warm is cold)
_VERIFY_ERRORS = (
    ServeClientError, ConnectionError, TimeoutError, OSError,
    RuntimeError, ValueError, KeyError,
)


class AdmissionFailed(RuntimeError):
    """A spawned standby failed its warm/zero-compile verification."""


def verify_warm(host: str, port: int, timeout_s: float = 10.0) -> dict:
    """The admission criteria, checked over the live verbs (not the banner
    alone: the process must prove it answers): ``health.warm`` must be true
    and every ``compile_cache_after_warmup`` counter zero (request-path work
    after warmup, a measurement, table write or kernel build, would stall
    the serving tail). The key and the messages are JAX's. Returns the
    verified facts; raises :class:`AdmissionFailed`."""
    client = ServeClient(host, port, timeout_s=timeout_s, retries=0)
    try:
        rep = client.health()
        h = (rep.get("health") or {}) if rep.get("ok") else {}
        if not h.get("warm"):
            raise AdmissionFailed(f"{host}:{port} reports warm={h.get('warm')!r}")
        m = (client.metrics().get("metrics")) or {}
    finally:
        client.close_connection()
    cache = m.get("compile_cache_after_warmup")
    if not isinstance(cache, dict):
        raise AdmissionFailed(
            f"{host}:{port} metrics carry no compile_cache_after_warmup"
        )
    nonzero = {k: v for k, v in cache.items() if v}
    if nonzero:
        raise AdmissionFailed(
            f"{host}:{port} has request-path compiles after warmup: {nonzero}"
        )
    return {
        "warm": True,
        "host_id": h.get("host_id"),
        "replicas": h.get("replicas"),
        "compile_cache_after_warmup": cache,
    }


class BackendLifecycle:
    """Supervised elastic membership over one :class:`FleetRouter`.

    ``spawn_overrides`` are the dotted-config CLI flags every spawned
    backend gets (``--train.workdir=...`` included, so it restores the same
    checkpoints as the boot-time fleet). ``spawn_fn``/``verify_fn`` are
    injectable for tests (the default pair launches and verifies real
    ``serve`` subprocesses)."""

    def __init__(
        self,
        router: FleetRouter,
        spawn_overrides: list[str] | tuple[str, ...] = (),
        host: str = "127.0.0.1",
        spawn_timeout_s: float = 600.0,
        verify_timeout_s: float = 10.0,
        drain_wait_s: float = 30.0,
        dedup_grace_s: float = 0.0,
        log_dir: str | None = None,
        spawn_fn=None,
        verify_fn=None,
    ):
        self.router = router
        self.spawn_overrides = tuple(spawn_overrides)
        self.host = host
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.verify_timeout_s = float(verify_timeout_s)
        self.drain_wait_s = float(drain_wait_s)
        self.dedup_grace_s = float(dedup_grace_s)
        self.log_dir = log_dir
        self._spawn_fn = spawn_fn or spawn_backend
        self._verify_fn = verify_fn or verify_warm
        # member table: addr -> {"state", "host_id", ...facts}; procs the
        # lifecycle OWNS (spawned here; boot-time backends are not ours to
        # terminate). Every touch holds _lock.
        self._lock = lockdep.Lock("BackendLifecycle._lock")
        self._members: dict[str, dict] = {}
        self._procs: dict[str, object] = {}
        # one membership change at a time: two concurrent fleet verbs must
        # not interleave their grow/shrink loops
        self._scale_lock = lockdep.Lock("BackendLifecycle._scale_lock")
        self._seq = 0

    # -- bookkeeping ---------------------------------------------------------

    def _record(self, addr: str, state: str, **facts) -> dict:
        with self._lock:
            row = self._members.setdefault(addr, {"addr": addr})
            row.update(state=state, **facts)
            row = dict(row)
        _emit_event("fleet_lifecycle", stage=state, addr=addr,
                    backend=row.get("host_id"))
        return row

    def fleet_size(self) -> int:
        """Serving members (draining hosts are already leaving)."""
        return len([b for b in self.router.backends if not b.draining])

    def status(self) -> dict:
        with self._lock:
            members = {a: dict(r) for a, r in self._members.items()}
            owned = list(self._procs)
        return {
            "backends": self.fleet_size(),
            "backends_draining": sum(
                1 for b in self.router.backends if b.draining
            ),
            "owned": owned,
            "lifecycle": members,
            "fleet": {
                b.host_id: {"addr": b.addr, **self.router.state_row(b)}
                for b in self.router.backends
            },
        }

    # -- spawn-and-warm admission -------------------------------------------

    def scale_up(self) -> dict:
        """Grow the fleet by one WARMED backend. Spawn (banner gates on the
        child's own post-warmup announce), verify over the live verbs, only
        then splice into the ring. Every failure quarantines the standby
        and leaves the serving fleet untouched."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        t0 = time.monotonic()
        log_path = (
            f"{self.log_dir}/backend_elastic_{seq}.log" if self.log_dir else None
        )
        try:
            proc = self._spawn_fn(
                list(self.spawn_overrides), port=0, host=self.host,
                log_path=log_path, timeout_s=self.spawn_timeout_s,
            )
        except (TimeoutError, RuntimeError, OSError) as e:
            rec = self._record(
                f"spawn-{seq}", "quarantined",
                reason=f"spawn: {type(e).__name__}: {e}",
            )
            return {"action": "scale_up", "ok": False, "stage": "spawn",
                    "reason": rec["reason"]}
        addr = f"{proc.host}:{proc.port}"
        with self._lock:
            self._procs[addr] = proc
        self._record(addr, "warming", host_id=proc.host_id,
                     spawn_s=round(time.monotonic() - t0, 3))
        try:
            facts = self._verify_fn(
                proc.host, proc.port, timeout_s=self.verify_timeout_s
            )
        except _VERIFY_ERRORS as e:
            # kill-during-admission lands here: the standby is quarantined
            # (terminated, never admitted) and the fleet keeps serving
            self._quarantine(addr, f"{type(e).__name__}: {e}")
            return {"action": "scale_up", "ok": False, "stage": "quarantined",
                    "addr": addr, "reason": f"{type(e).__name__}: {e}"}
        b = self.router.add_backend(proc.host, proc.port)
        self._record(addr, "admitted", host_id=b.host_id, verified=facts)
        return {
            "action": "scale_up", "ok": True, "stage": "admitted",
            "addr": addr, "backend": b.host_id, "verified": facts,
            "elapsed_s": round(time.monotonic() - t0, 3),
        }

    def _quarantine(self, addr: str, reason: str) -> None:
        with self._lock:
            proc = self._procs.pop(addr, None)
        if proc is not None and proc.alive():
            proc.kill()
        self._record(addr, "quarantined", reason=reason)

    # -- drain-then-retire ---------------------------------------------------

    def _pick_victim(self):
        """Newest lifecycle-owned admitted member first (LIFO — give back
        what we grew before touching the boot-time fleet), else the newest
        non-draining router member."""
        with self._lock:
            owned = [
                a for a, r in self._members.items() if r.get("state") == "admitted"
            ]
        for addr in reversed(owned):
            for b in self.router.backends:
                if b.addr == addr and not b.draining:
                    return b
        candidates = [b for b in self.router.backends if not b.draining]
        if not candidates:
            raise ValueError("no retirable backend")
        return candidates[-1]

    def scale_down(self, key=None) -> dict:
        """Shrink by one: ring-safe drain (no fresh admissions, in-flight
        forwards complete, dedup'd retries keep answering router-side),
        remove from the table, wait ``dedup_grace_s`` for any direct
        client's server-side dedup window, then SIGINT the process if this
        lifecycle spawned it (boot-time backends are left running — their
        supervisor owns them)."""
        victim = self.router._find_backend(key) if key is not None else self._pick_victim()
        addr = victim.addr
        self._record(addr, "draining", host_id=victim.host_id)
        rec = self.router.retire_backend(victim, wait_s=self.drain_wait_s)
        with self._lock:
            proc = self._procs.pop(addr, None)
        if self.dedup_grace_s > 0:
            time.sleep(self.dedup_grace_s)
        terminated = False
        if proc is not None:
            proc.terminate()
            terminated = True
        self._record(addr, "retired", host_id=rec["backend"],
                     drained=rec["drained"], terminated=terminated)
        return {"action": "scale_down", "ok": True, "stage": "retired",
                "addr": addr, "terminated": terminated, **rec}

    # -- the fleet-count lever ----------------------------------------------

    def scale_to(self, backends: int) -> dict:
        """Converge the serving member count to ``backends`` one admission/
        retirement at a time (each one fully verified/drained before the
        next starts). A failed admission aborts the grow loop with the
        failure recorded — a half-warm standby must not be retried blindly
        in a tight loop."""
        n = int(backends)
        if n < 1:
            raise ValueError(f"fleet target must be >= 1, got {n}")
        with self._scale_lock:
            before = self.fleet_size()
            actions: list[dict] = []
            while self.fleet_size() < n:
                rec = self.scale_up()
                actions.append(rec)
                if not rec["ok"]:
                    break
            while self.fleet_size() > n:
                # one retirement at a time under _scale_lock: the
                # dedup-grace sleep ends before the next one starts
                actions.append(self.scale_down())  # lint: disable=blocking-under-lock(scale ops are one-at-a-time by design: _scale_lock is the coarse serializer for admissions/retirements, held only on the control path; the dedup-grace sleep must finish before the next retirement starts)
            after = self.fleet_size()
        return {
            "backends_before": before,
            "backends": after,
            "target": n,
            "ok": after == n,
            "actions": actions,
        }

    def close(self, terminate_owned: bool = True) -> None:
        """Tear down lifecycle-owned processes (harness exit path)."""
        with self._lock:
            procs = dict(self._procs)
            self._procs.clear()
        if terminate_owned:
            for proc in procs.values():
                proc.terminate()
