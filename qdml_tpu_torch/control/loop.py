"""FleetController: the supervised serve -> detect -> adapt -> deploy loop (``qdml_tpu/control/loop.py``).

Each tick polls the live metrics view (the ``{"op": "metrics"}`` payload),
differences the per-scenario counters against the previous poll into
windowed statistics, feeds the drift detectors and the autoscaler, services
a post-deploy watch window, and, once a debounced ``drift_event`` fired,
runs the adaptation pipeline::

    drift_event(scenario s)
      -> finetune_trunk(s)        # only trunk s trains; head and peers frozen
      -> Deployer.canary          # candidate against live on held-out probes
      -> Deployer.deploy          # explicit-tag hot-swap, no request-path work
      -> watch window             # served stats; rollback on a regression
      -> DriftMonitor.reset       # re-arm against the adapted distribution

Two attachments share that logic: in process (:class:`PoolPoller`, holding
the :class:`~qdml_tpu_torch.serve.server.ReplicaPool` and its engine) and
remote (:class:`SocketPoller`, ``control``: the ``metrics``/``swap``/
``scale`` verbs of a running ``serve``, sharing only the workdir; fine-tune
and canary run in the controller's process). Over a fleet the same loop
runs on a :class:`~qdml_tpu_torch.fleet.poller.FleetPoller` (the router's
aggregated verbs), or on a :class:`SocketPoller` pointed at the router's
front door.

The drifted family is synthesized (``family_table``'s drift trajectories),
so ``drift_step_hint`` (default ``serve.drift_step``) tells fine-tune and
canary which family to draw. Every decision is a ``control_event`` record;
``control.dry_run`` reports decisions and takes none.
"""

from __future__ import annotations

import json
import socket
import threading
import time

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.control.autoscale import Autoscaler
from qdml_tpu_torch.control.deploy import Deployer
from qdml_tpu_torch.control.drift import DriftMonitor
from qdml_tpu_torch.control.events import emit_record
from qdml_tpu_torch.telemetry.timeseries import counter_delta

# an adaptation that keeps failing its canary must not retrain forever on
# the same drift episode: after this many failed attempts per scenario the
# stream stays latched and a human reads the control_events
MAX_ADAPT_ATTEMPTS = 3


class PoolPoller:
    """In-process attachment: the live pool, its engine and the workdir."""

    def __init__(self, pool, engine, workdir: str):
        self.pool = pool
        self.engine = engine
        self.workdir = workdir

    def metrics(self) -> dict:
        return self.pool.live_metrics()

    def health(self) -> dict:
        return self.pool.health()

    def swap(self, tags: dict) -> dict:
        return self.engine.swap_from_workdir(self.workdir, tags=tags)

    def scale(self, n: int) -> dict:
        return self.pool.scale_to(n)


class SocketPoller:
    """Remote attachment over the serve socket's JSON verbs, one short-lived
    connection a call; against a router's front door it is the remote fleet
    poller (``fleet`` included)."""

    def __init__(self, host: str, port: int, timeout_s: float = 30.0):
        self.host = host
        self.port = port
        self.timeout_s = float(timeout_s)

    def _verb(self, payload: dict) -> dict:
        with socket.create_connection((self.host, self.port), timeout=self.timeout_s) as sk:
            fh = sk.makefile("rw", encoding="utf-8", newline="\n")
            fh.write(json.dumps(payload) + "\n")
            fh.flush()
            line = fh.readline()
        if not line:
            raise ConnectionError(f"serve endpoint {self.host}:{self.port} closed")
        rep = json.loads(line)
        if not rep.get("ok"):
            raise RuntimeError(f"verb {payload.get('op')!r} failed: {rep.get('reason')}")
        return rep

    def metrics(self) -> dict:
        return self._verb({"op": "metrics"})["metrics"]

    def health(self) -> dict:
        return self._verb({"op": "health"})["health"]

    def events(self, cursor: dict | None = None, limit: int = 512) -> dict:
        """The event-spine tail; pass the previous reply's cursor back."""
        msg: dict = {"op": "events", "limit": int(limit)}
        if cursor is not None:
            msg["cursor"] = cursor
        return self._verb(msg)["events"]

    def swap(self, tags: dict) -> dict:
        return self._verb({"op": "swap", "tags": tags})["swap"]

    def scale(self, n: int) -> dict:
        return self._verb({"op": "scale", "replicas": n})["scale"]

    def fleet(self, backends: int | None = None) -> dict:
        """Backend-count axis (router endpoints): membership status, or,
        with ``backends``, converge the serving member count through the
        router's lifecycle manager. A plain serve host answers the status
        form with ``bad_request`` and a lifecycle-less router answers the
        scaling form with ``fleet_scale_unavailable``; both surface here as
        the typed RuntimeError ``_verb`` raises on ok=false."""
        if backends is None:
            return self._verb({"op": "fleet"})["fleet"]
        return self._verb({"op": "fleet", "backends": int(backends)})["fleet"]


class FleetController:
    """The loop. Construct with a poller, call :meth:`tick` (or :meth:`run`);
    harnesses with ground truth also feed :meth:`observe_parity`. ``device``
    is where fine-tune and canary run: the engine's when one is given, else
    the card unless ``"cpu"``."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        workdir: str,
        poller,
        engine=None,
        sink=None,
        drift_step_hint: int | None = None,
        device=None,
    ):
        ctl = cfg.control
        self.cfg = cfg
        self.workdir = workdir
        self.poller = poller
        self.engine = engine
        self._sink = sink
        self.device = device if device is not None else getattr(engine, "device", None)
        self.dry_run = bool(ctl.dry_run)
        self.drift_step_hint = int(
            drift_step_hint if drift_step_hint is not None else (cfg.serve.drift_step or 1)
        )
        self.min_window = int(ctl.min_window)
        self.monitor = DriftMonitor(
            delta=ctl.ph_delta,
            threshold=ctl.ph_threshold,
            debounce=ctl.debounce,
            min_samples=5,
            sink=sink,
        )
        self.autoscaler = (
            Autoscaler(
                poller.scale,
                min_replicas=ctl.min_replicas,
                max_replicas=ctl.max_replicas,
                queue_high=ctl.queue_high,
                queue_low=ctl.queue_low,
                debounce=ctl.scale_debounce,
                cooldown_ticks=ctl.cooldown_ticks,
                sink=sink,
                dry_run=ctl.dry_run,
            )
            if ctl.autoscale
            else None
        )
        live = engine.live_vars() if engine is not None else (None, None)
        self.deployer = Deployer(
            cfg,
            workdir,
            swap_fn=poller.swap,
            live_hdce_vars=live[0],
            clf_vars=live[1],
            quantum=bool(getattr(engine, "quantum", False)),
            sink=sink,
            dry_run=ctl.dry_run,
            device=self.device,
        )
        self._prev_scenario: dict = {}
        self._prev_dispatch: dict = {}
        # the latest served-NMSE measurement a scenario: the watch compares
        # the adapted scenario's own parity against the canary's reference
        self._latest_parity: dict[int, float] = {}
        self._watch_scenario: int | None = None
        self._attempts: dict[int, int] = {}
        self._prev_slo: dict | None = None
        # dry-run adapt decisions and suspensions are reported once a drift
        # episode (a latched detector would re-report every tick)
        self._dry_reported: set[int] = set()
        self._suspended_reported: set[int] = set()
        self.ticks = 0

    def _emit(self, action: str, **payload) -> dict:
        return emit_record(
            self._sink, "control_event",
            action=action, dry_run=self.dry_run, **payload,
        )

    def observe_parity(self, scenario: int, nmse_db_served: float) -> dict | None:
        """Feed a served-NMSE measurement (dB) for one scenario: the
        ``nmse_parity`` detector and the post-deploy watch's reading."""
        self._latest_parity[int(scenario)] = float(nmse_db_served)
        return self.monitor.observe(scenario, "nmse_parity", nmse_db_served)

    def _window_scenarios(self, m: dict) -> list[dict]:
        """This poll's per-scenario cumulative counters differenced against
        the previous poll into windowed means, fed to the detectors."""
        events = []
        per = m.get("per_scenario") or {}
        for key, cur in per.items():
            prev = self._prev_scenario.get(key, {"n": 0, "conf_sum": 0.0})
            dn, reset = counter_delta(prev.get("n"), cur.get("n"))
            dconf, _ = counter_delta(prev.get("conf_sum"), cur.get("conf_sum"))
            if reset:
                # a restarted backend's counters started over: report it and
                # skip this window's detector feed
                emit_record(
                    self._sink, "counter_reset", source="control_loop",
                    counter=f"per_scenario[{key}].n",
                    prev=prev.get("n", 0), cur=cur.get("n", 0),
                )
            elif dn >= self.min_window and cur.get("conf_sum") is not None:
                ev = self.monitor.observe(int(key), "confidence", dconf / dn)
                if ev:
                    events.append(ev)
        self._prev_scenario = {
            k: {"n": v.get("n", 0), "conf_sum": v.get("conf_sum", 0.0)} for k, v in per.items()
        }
        disp = m.get("dispatch") or {}
        prev_d = self._prev_dispatch
        d_routed, r_reset = counter_delta(prev_d.get("routed_rows"), disp.get("routed_rows"))
        d_over, o_reset = counter_delta(prev_d.get("overflow_rows"), disp.get("overflow_rows"))
        if r_reset or o_reset:
            emit_record(
                self._sink, "counter_reset", source="control_loop",
                counter="dispatch.routed_rows",
                prev=prev_d.get("routed_rows") or 0,
                cur=disp.get("routed_rows") or 0,
            )
        elif d_routed >= self.min_window:
            ev = self.monitor.observe(-1, "overflow_rate", d_over / d_routed)
            if ev:
                events.append(ev)
        self._prev_dispatch = {
            "routed_rows": disp.get("routed_rows"),
            "overflow_rows": disp.get("overflow_rows"),
        }
        return events

    def _windowed_slo(self, slo: dict | None) -> float | None:
        """Attainment over this poll window (cumulative counters
        differenced), like every other detector input."""
        prev = self._prev_slo
        self._prev_slo = dict(slo) if slo else self._prev_slo
        if not slo:
            return None
        dn, reset = counter_delta((prev or {}).get("n"), slo.get("n"))
        dmet, _ = counter_delta((prev or {}).get("met"), slo.get("met"))
        if reset:
            emit_record(
                self._sink, "counter_reset", source="control_loop",
                counter="slo.n",
                prev=(prev or {}).get("n", 0), cur=slo.get("n", 0),
            )
            return None
        return dmet / dn if dn > 0 else None

    def _adapt(self, scenario: int) -> dict:
        """The adaptation pipeline for one drifted scenario."""
        from qdml_tpu_torch.control.finetune import finetune_trunk

        attempts = self._attempts.get(scenario, 0)
        if attempts >= MAX_ADAPT_ATTEMPTS:
            if scenario in self._suspended_reported:
                return {}
            self._suspended_reported.add(scenario)
            return self._emit("adapt_suspended", scenario=scenario, attempts=attempts)
        if self.dry_run:
            if scenario in self._dry_reported:
                return {}
            self._dry_reported.add(scenario)
            return self._emit(
                "adapt", scenario=scenario, skipped="dry_run", drift_step=self.drift_step_hint,
            )
        self._attempts[scenario] = attempts + 1
        ft = finetune_trunk(
            self.cfg, self.workdir, scenario, drift_step=self.drift_step_hint,
            # continual: warm-start from the tree that is serving
            base_tag=self.deployer.live_hdce_tag(),
            device=self.device,
        )
        self._emit("finetune", **ft)
        rep = self.deployer.canary(ft["tag"], scenario, self.drift_step_hint)
        if not rep["passed"]:
            # re-arm: a persisting drift re-fires after fresh debounced windows
            self.monitor.reset(scenario)
            return self._emit("adapt_aborted", scenario=scenario, canary=rep)
        dep = self.deployer.deploy(
            tags={"hdce": ft["tag"]},
            rollback_tags={"hdce": ft["rollback_tag"]},
            ref_db=rep["drifted_probes"]["cand_db"],
        )
        if self.engine is not None:
            self.deployer.set_live(*self.engine.live_vars())
        # the whole bank re-arms (routing shares the classifier); the poll
        # snapshot is kept, so the next window is a window, not a lifetime
        self.monitor.reset()
        # the watch waits for a parity measured after the deploy
        self._watch_scenario = scenario
        self._latest_parity.pop(scenario, None)
        self._attempts[scenario] = 0
        return self._emit("adapted", scenario=scenario, finetune=ft, canary=rep, deploy=dep)

    def tick(self) -> dict:
        """One observe -> decide -> act cycle; what happened."""
        self.ticks += 1
        m = self.poller.metrics()
        out: dict = {"tick": self.ticks, "events": []}
        out["events"].extend(self._window_scenarios(m))
        if self.autoscaler is not None:
            act = self.autoscaler.observe(
                float(m.get("queue_depth_now") or 0.0),
                int(m.get("replicas") or 1),
                self._windowed_slo(m.get("slo")),
            )
            if act:
                out["events"].append(act)
        if self.deployer.watching():
            watch = self.deployer.observe_served(
                self._latest_parity.get(self._watch_scenario)
                if self._watch_scenario is not None
                else None
            )
            if watch:
                out["events"].append(watch)
        else:
            fired = [s for s, _sig in self.monitor.active() if s >= 0]
            for scenario in fired:
                ev = self._adapt(scenario)
                if ev:
                    out["events"].append(ev)
                if self._attempts.get(scenario, 0) < MAX_ADAPT_ATTEMPTS:
                    # one real adaptation a tick; a suspended scenario only
                    # reports and must not starve later drifted scenarios
                    break
        return out

    def run(
        self,
        ticks: int | None = None,
        interval_s: float | None = None,
        stop: threading.Event | None = None,
    ) -> int:
        """Tick until ``ticks`` is exhausted, ``stop`` is set or
        KeyboardInterrupt. Endpoint failures and failed adaptation episodes
        are reported and retried next tick."""
        interval = float(interval_s if interval_s is not None else self.cfg.control.interval_s)
        done = 0
        try:
            while (ticks is None or done < ticks) and not (stop and stop.is_set()):
                try:
                    self.tick()
                except (ConnectionError, OSError, TimeoutError) as e:
                    self._emit("poll_failed", error=str(e))
                except (RuntimeError, ValueError, FileNotFoundError) as e:
                    self._emit("tick_failed", error=f"{type(e).__name__}: {e}")
                done += 1
                if stop is not None:
                    stop.wait(interval)
                else:
                    time.sleep(interval)
        except KeyboardInterrupt:
            pass
        return 0

    def run_in_thread(self, interval_s: float | None = None) -> tuple[threading.Thread, threading.Event]:
        """Background supervision: returns (thread, stop_event)."""
        stop = threading.Event()
        t = threading.Thread(
            target=self.run,
            kwargs={"interval_s": interval_s, "stop": stop},
            daemon=True,
            name="fleet-controller",
        )
        t.start()
        return t, stop


def control_main(
    cfg: ExperimentConfig,
    logger=None,
    workdir: str | None = None,
    ticks: int | None = None,
    device=None,
) -> int:
    """``control``: attach to the running serve endpoint and supervise it
    until interrupted (or for ``ticks`` polls), after printing JAX's header
    line (``qdml_tpu/control/loop.py:478-490``)."""
    sink = None if logger is None else logger.telemetry
    poller = SocketPoller(cfg.serve.host, cfg.serve.port)
    ctrl = FleetController(cfg, workdir, poller, sink=sink, device=device)
    print(
        json.dumps(
            {
                "control": f"{cfg.serve.host}:{cfg.serve.port}",
                "workdir": workdir,
                "dry_run": ctrl.dry_run,
                "interval_s": cfg.control.interval_s,
                "autoscale": ctrl.autoscaler is not None,
                "drift_step_hint": ctrl.drift_step_hint,
            }
        ),
        flush=True,
    )
    return ctrl.run(ticks=ticks)
