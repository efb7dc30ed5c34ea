"""The fleet router's front-door socket (``qdml_tpu/fleet/frontend.py``): the serve protocol, one tier up.

``route`` runs :func:`run_router`: an asyncio loop accepting the newline-JSON
protocol ``serve`` speaks (inference lines and the ``health``, ``metrics``,
``events``, ``swap``, ``scale`` and ``fleet`` verbs) and handing every
message to the :class:`~qdml_tpu_torch.fleet.router.FleetRouter` on an
executor thread (every backend exchange is a blocking ``ServeClient``
call). Clients cannot tell a router from a single host: ``run_loadgen_socket``,
``ServeClient`` and the control plane's ``SocketPoller`` (the JAX package's
as well as the port's) work unchanged.

The two scaling axes: ``{"op": "scale", "replicas": N}`` targets the
fleet-total replica count inside the existing hosts (the router picks the
host), while ``{"op": "fleet", "backends": N}`` changes the backend-process
count through the attached
:class:`~qdml_tpu_torch.fleet.lifecycle.BackendLifecycle`. A router without
one answers the scaling form with the typed ``fleet_scale_unavailable``
reason; the argument-free ``{"op": "fleet"}`` always answers with the
membership view.

Connection hardening is the serve front end's: bounded reads through
:func:`qdml_tpu_torch.serve.server._read_line` (a typed ``idle_timeout``
reply reaps an idle or slow peer), ``bad_json`` on garbage with the
connection kept, typed ``bad_request`` and close on an oversized line
(``serve.conn_timeout_s`` / ``serve.max_line_bytes`` govern both tiers).
Pure protocol: the router holds no model and does no device work.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import uuid

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.fleet.router import FleetRouter, parse_backends
from qdml_tpu_torch.serve.server import _read_line


def router_from_config(cfg: ExperimentConfig, seed: int = 0) -> FleetRouter:
    """Build (but do not start) the router from ``cfg.fleet``; an empty
    ``fleet.backends`` fronts the single local serve endpoint."""
    fl = cfg.fleet
    return FleetRouter(
        parse_backends(fl.backends, default=(cfg.serve.host, cfg.serve.port)),
        balance=fl.balance,
        timeout_s=fl.timeout_s,
        retries=fl.retries,
        eject_failures=fl.eject_failures,
        eject_s=fl.eject_s,
        readmit_probes=fl.readmit_probes,
        poll_interval_s=fl.poll_interval_s,
        failover=fl.failover,
        dedup_ttl_s=fl.dedup_ttl_s,
        seed=seed,
        # the SAME knob the serve tier samples on (deterministic id hash):
        # router and backends agree per request without a config handshake
        trace_sample=cfg.serve.trace_sample,
    )


async def _handle_front(
    reader, writer, router: FleetRouter, conn_timeout_s: float,
    lifecycle=None,
) -> None:
    aloop = asyncio.get_running_loop()

    async def _reply(obj: dict) -> None:
        writer.write((json.dumps(obj) + "\n").encode())
        await writer.drain()

    try:
        while True:
            try:
                line = await _read_line(reader, conn_timeout_s)
            except asyncio.TimeoutError:
                await _reply({"ok": False, "reason": "idle_timeout"})
                break
            except (asyncio.LimitOverrunError, ValueError):
                # framing lost mid-line: typed reply and close, exactly like
                # the serve tier (resyncing would misparse the tail)
                await _reply({
                    "ok": False,
                    "reason": "bad_request: line exceeds serve.max_line_bytes",
                })
                break
            if not line:
                break
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                await _reply({"ok": False, "reason": "bad_json"})
                continue
            if not isinstance(msg, dict):
                await _reply({"id": None, "ok": False,
                              "reason": "bad_request: message must be a JSON object"})
                continue
            op = msg.get("op")
            try:
                if op == "health":
                    rep = {"id": msg.get("id"), "ok": True,
                           "health": router.health()}
                elif op == "metrics":
                    # aggregation polls every live backend: off the event
                    # loop, like the serve tier's histogram merge
                    view = await aloop.run_in_executor(None, router.live_metrics)
                    rep = {"id": msg.get("id"), "ok": True, "metrics": view}
                elif op == "events":
                    # aggregated event-spine tail: the router's own events
                    # plus every live backend's, per-source cursors passed
                    # back verbatim. Off the event loop: it round-trips
                    # every backend.
                    cur = msg.get("cursor")
                    if cur is not None and not isinstance(cur, dict):
                        raise ValueError(
                            f"events cursor must be an object, got {cur!r}"
                        )
                    lim = int(msg.get("limit") or 512)
                    view = await aloop.run_in_executor(
                        None, router.live_events, cur, lim
                    )
                    rep = {"id": msg.get("id"), "ok": True, "events": view}
                elif op == "swap":
                    tags = msg.get("tags")
                    if tags is not None and not (
                        isinstance(tags, dict)
                        and all(isinstance(k, str) and isinstance(v, str)
                                for k, v in tags.items())
                    ):
                        raise ValueError(
                            f"swap tags must be a str->str map, got {tags!r}"
                        )
                    rec = await aloop.run_in_executor(
                        None, router.swap_fanout, tags
                    )
                    rep = {"id": msg.get("id"), "ok": bool(rec["ok"]), "swap": rec}
                    if not rec["ok"]:
                        rep["reason"] = "swap_failed: partial fan-out (see swap.backends)"
                elif op == "scale":
                    # replica axis: resize pools INSIDE the existing hosts
                    n = int(msg["replicas"])
                    rec = await aloop.run_in_executor(None, router.scale_fleet, n)
                    rep = {"id": msg.get("id"), "ok": True, "scale": rec}
                elif op == "fleet":
                    # backend-count axis: membership itself. Status form
                    # (no "backends") always answers; the scaling form
                    # needs an attached lifecycle manager.
                    if "backends" not in msg:
                        status = (
                            lifecycle.status() if lifecycle is not None
                            else {
                                "backends": len(router.live_backends()),
                                "backends_draining": sum(
                                    1 for b in router.backends if b.draining
                                ),
                                "fleet": {
                                    b.host_id: {
                                        "addr": b.addr,
                                        **router.state_row(b),
                                    }
                                    for b in router.backends
                                },
                            }
                        )
                        status["elastic"] = lifecycle is not None
                        rep = {"id": msg.get("id"), "ok": True, "fleet": status}
                    elif lifecycle is None:
                        rep = {
                            "id": msg.get("id"), "ok": False,
                            "reason": "fleet_scale_unavailable: router has "
                                      "no lifecycle manager (fleet.elastic)",
                        }
                    else:
                        n = int(msg["backends"])
                        rec = await aloop.run_in_executor(
                            None, lifecycle.scale_to, n
                        )
                        rep = {"id": msg.get("id"), "ok": bool(rec["ok"]),
                               "fleet": rec}
                        if not rec["ok"]:
                            rep["reason"] = (
                                "fleet_scale_failed: converged to "
                                f"{rec['backends']} of {rec['target']} "
                                "(see fleet.actions)"
                            )
                else:
                    # inference: the router needs an id for dedup + hash
                    # affinity; an anonymous request gets a fresh one for
                    # routing and its reply id restored to what was sent
                    anon = "id" not in msg
                    if anon:
                        msg = {**msg, "id": f"anon-{uuid.uuid4().hex[:12]}"}
                    rep = await aloop.run_in_executor(None, router.request, msg)
                    if anon:
                        rep = {**rep, "id": None}
            except (KeyError, TypeError, ValueError) as e:
                rep = {"id": msg.get("id"), "ok": False,
                       "reason": f"bad_request: {e}"}
            except (ConnectionError, RuntimeError, OSError) as e:
                # a fan-out verb that could reach nobody (or a backend scale
                # rejection): typed, retryable, connection survives
                rep = {"id": msg.get("id"), "ok": False,
                       "reason": f"router_error: {type(e).__name__}: {e}"}
            await _reply(rep)
    except (ConnectionResetError, BrokenPipeError):
        pass  # the peer vanished: nothing stranded, forwards resolve router-side
    finally:
        try:
            writer.close()
        except RuntimeError:
            pass


async def route_async(
    router: FleetRouter,
    host: str,
    port: int,
    ready: "asyncio.Future | None" = None,
    conn_timeout_s: float = 30.0,
    max_line_bytes: int = 8_388_608,
    lifecycle=None,
) -> None:
    """Accept front-door connections until cancelled; resolves ``ready``
    with the bound port (port=0 = ephemeral, the test/dryrun pattern).
    ``lifecycle`` (a :class:`~qdml_tpu_torch.fleet.lifecycle.BackendLifecycle`)
    arms the ``{"op": "fleet"}`` scaling form."""
    server = await asyncio.start_server(
        lambda r, w: _handle_front(
            r, w, router, conn_timeout_s, lifecycle=lifecycle
        ),
        host=host,
        port=port,
        limit=max_line_bytes,
    )
    bound = server.sockets[0].getsockname()[1]
    if ready is not None and not ready.done():
        ready.set_result(bound)
    async with server:
        await server.serve_forever()


def lifecycle_from_config(cfg: ExperimentConfig, router: FleetRouter):
    """The ``fleet.elastic`` wiring: a :class:`BackendLifecycle` whose
    spawned backends get ``fleet.spawn_overrides`` (comma-separated dotted
    flags — ``--train.workdir=...`` included so they restore the serving
    checkpoints, ``--device=cpu`` to keep them off the card). Returns None
    when elasticity is off."""
    if not cfg.fleet.elastic:
        return None
    from qdml_tpu_torch.fleet.lifecycle import BackendLifecycle

    overrides = [
        o.strip() for o in cfg.fleet.spawn_overrides.split(",") if o.strip()
    ]
    return BackendLifecycle(
        router,
        spawn_overrides=overrides,
        spawn_timeout_s=cfg.fleet.spawn_timeout_s,
        drain_wait_s=cfg.fleet.drain_wait_s,
        dedup_grace_s=cfg.fleet.dedup_grace_s,
    )


def run_router(cfg: ExperimentConfig, logger=None) -> None:
    """Blocking entry of ``route``: prime the backend table, announce (the
    bound port, the router's identity, the backend table; JAX's banner
    keys), route until interrupted. No checkpoints, no device: the router is
    pure protocol and the backends own the models. ``fleet.elastic=true``
    attaches a lifecycle manager, arming the ``{"op": "fleet"}`` scaling
    form; its spawned backends are terminated on the way out."""
    router = router_from_config(cfg).start()
    lifecycle = lifecycle_from_config(cfg, router)

    async def _route_announced() -> None:
        aloop = asyncio.get_running_loop()
        ready: asyncio.Future = aloop.create_future()
        task = aloop.create_task(
            route_async(
                router, cfg.fleet.host, cfg.fleet.port, ready,
                conn_timeout_s=cfg.serve.conn_timeout_s,
                max_line_bytes=cfg.serve.max_line_bytes,
                lifecycle=lifecycle,
            )
        )
        await asyncio.wait({task, ready}, return_when=asyncio.FIRST_COMPLETED)
        if task.done():
            return task.result()  # bind failure propagates
        print(
            json.dumps(
                {
                    "routing": f"{cfg.fleet.host}:{ready.result()}",
                    "router_id": f"{socket.gethostname()}-{os.getpid()}",
                    "balance": router.balance,
                    "elastic": lifecycle is not None,
                    "backends": {
                        b.host_id: {"addr": b.addr, "state": b.state.state}
                        for b in router.backends
                    },
                    "backends_live": len(router.live_backends()),
                }
            ),
            flush=True,
        )
        await task

    try:
        asyncio.run(_route_announced())
    except KeyboardInterrupt:
        pass
    finally:
        if lifecycle is not None:
            lifecycle.close()
        router.stop()
        if logger is not None:
            logger.telemetry.write_raw(
                {"kind": "router_summary", **router.router_summary()}
            )
