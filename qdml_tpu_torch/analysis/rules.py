"""The port's lint rules (``qdml_tpu/analysis/rules.py``): the seven
framework-neutral hazard classes, over the port's maps
(:mod:`qdml_tpu_torch.analysis.project`).

Each rule is a callable ``(ModuleContext) -> list[Finding]`` registered in
:data:`RULES` with its id and a one-line rationale. The logic is JAX's rule
for rule, so the two engines report the same findings on the same source;
the messages name the port's helpers. JAX's tracing rules (``jit-mutable-
global`` ... ``trace-in-jit-path``) are not here: their torch counterparts
are not ported yet.

Rules are deliberately precise over exhaustive: a lint that cries wolf gets
disabled; one that encodes the exact shape of a shipped bug gets trusted.
Every heuristic documents what it intentionally does NOT catch.
"""

from __future__ import annotations

import ast
from typing import Callable

from qdml_tpu_torch.analysis import project
from qdml_tpu_torch.analysis.engine import Finding, ModuleContext, dotted_name

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


# ---------------------------------------------------------------------------
# primary-only-collective: a rank-0 guard around a collective
# ---------------------------------------------------------------------------


def rule_primary_only_collective(ctx: ModuleContext) -> list[Finding]:
    """A collective (``torch.distributed``'s, or a port wrapper of one,
    ``project.COLLECTIVE_CALLS``) reached by the primary rank only: every
    other rank never joins and the primary blocks at the collective forever,
    the shape the flight recorder's dump avoids by gathering above its
    guard. Two forms: the collective lexically inside ``if is_primary():``
    (or ``world_rank()``/``dist.get_rank()``, ``project.PRIMARY_GUARDS``),
    and the early-return form (``if not is_primary(): return`` followed by
    a collective). Deliberately NOT caught: guards held in a local
    (``rank = world_rank(); if rank == 0:``) and collectives reached through
    a call into another module."""
    out: list[Finding] = []

    def is_primary_test(test: ast.AST) -> bool:
        for sub in ast.walk(test):
            name = dotted_name(sub.func) if isinstance(sub, ast.Call) else None
            if name and name.rsplit(".", 1)[-1] in project.PRIMARY_GUARDS:
                return True
        return False

    def collectives_in(node: ast.AST):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = dotted_name(sub.func)
                if name and name.rsplit(".", 1)[-1] in project.COLLECTIVE_CALLS:
                    yield sub, name

    for node in ctx.nodes:
        if not isinstance(node, ast.If) or not is_primary_test(node.test):
            continue
        # form 1: collective inside the guarded body (either branch)
        for branch in (node.body, node.orelse):
            for stmt in branch:
                for call, name in collectives_in(stmt):
                    out.append(
                        ctx.finding(
                            "primary-only-collective",
                            call,
                            f"collective {name!r} guarded by a primary-rank "
                            "check: the other ranks never join and the "
                            "primary deadlocks at the collective; run it on "
                            "EVERY rank, guard only the host-side write",
                        )
                    )
        # form 2: `if <primary test>: return/raise` then a collective later
        body_exits = any(isinstance(s, (ast.Return, ast.Raise)) for s in node.body)
        if not body_exits:
            continue
        fn = ctx.enclosing_function(node)
        if fn is None:
            continue
        for call, name in collectives_in(fn):
            if call.lineno > node.body[-1].lineno:
                out.append(
                    ctx.finding(
                        "primary-only-collective",
                        call,
                        f"collective {name!r} after a primary-gated early "
                        f"return (line {node.lineno}): the other ranks leave "
                        "before joining; move the collective above the guard "
                        "(telemetry/numerics.FlightRecorder.dump gathers "
                        "there)",
                    )
                )
    return out


# ---------------------------------------------------------------------------
# serve-lock-discipline: thread-shared state touched outside its lock
# ---------------------------------------------------------------------------


def rule_serve_lock_discipline(ctx: ModuleContext) -> list[Finding]:
    """The lock map (``project.LOCK_MAP``) names the attributes shared
    across threads and the lock that owns each. Any ``self.<attr>`` access
    outside ``with self.<lock>:`` (except in ``__init__``, which
    happens-before sharing) is a data race of the shape a soak test catches
    hanging. Deliberately NOT caught: access through another name than
    ``self``, and locks taken by ``acquire()``/``release()`` pairs."""
    lock_map = project.LOCK_MAP.get(ctx.path)
    if not lock_map:
        return []
    out: list[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, ast.ClassDef) or node.name not in lock_map:
            continue
        attr_locks = lock_map[node.name]
        for fn_node in ast.walk(node):
            if not isinstance(fn_node, _FuncNode) or fn_node.name == "__init__":
                continue
            for sub in ast.walk(fn_node):
                if not (
                    isinstance(sub, ast.Attribute)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self"
                    and sub.attr in attr_locks
                ):
                    continue
                lock = attr_locks[sub.attr]
                if not _under_lock(ctx, sub, lock):
                    out.append(
                        ctx.finding(
                            "serve-lock-discipline",
                            sub,
                            f"self.{sub.attr} accessed outside `with "
                            f"self.{lock}:` in {node.name}.{fn_node.name}: "
                            "thread-shared state must hold its lock (lock "
                            "map: qdml_tpu_torch/analysis/project.py)",
                        )
                    )
    return out


def _under_lock(ctx: ModuleContext, node: ast.AST, lock_attr: str) -> bool:
    cur = ctx.parent.get(node)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                expr = item.context_expr
                if (
                    isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                    and expr.attr == lock_attr
                ):
                    return True
        if isinstance(cur, _FuncNode):
            return False
        cur = ctx.parent.get(cur)
    return False


# ---------------------------------------------------------------------------
# stranded-future: dequeue without guaranteed resolution
# ---------------------------------------------------------------------------


def rule_stranded_future(ctx: ModuleContext) -> list[Finding]:
    """A function that pops requests off a queue AND resolves futures must
    guarantee resolution on every exit path: an exception between the pop
    and ``set_result`` strands the client forever. The check requires a
    ``try`` whose handler or ``finally`` resolves (``set_result``/
    ``set_exception``) in any function that both dequeues
    (``next_batch``/``popleft``/``get_nowait``) and touches ``.future``.
    Deliberately NOT caught: a resolving ``try`` that does not cover the
    pop (any resolving handler in the function counts)."""
    out: list[Finding] = []
    for fn, qual in ctx.functions:
        dequeues = [
            sub
            for sub in ast.walk(fn)
            if isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in ("next_batch", "popleft", "get_nowait")
        ]
        if not dequeues:
            continue
        touches_future = any(
            isinstance(sub, ast.Attribute) and sub.attr == "future"
            for sub in ast.walk(fn)
        )
        if not touches_future:
            continue
        guarded = False
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Try):
                continue
            resolve_zones = list(sub.finalbody)
            for h in sub.handlers:
                resolve_zones.extend(h.body)
            for stmt in resolve_zones:
                for call in ast.walk(stmt):
                    if (
                        isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr in ("set_result", "set_exception")
                    ):
                        guarded = True
        if not guarded:
            out.append(
                ctx.finding(
                    "stranded-future",
                    dequeues[0],
                    f"{qual!r} dequeues requests and resolves futures with no "
                    "try/except/finally that resolves on failure: an exception "
                    "between the pop and set_result hangs the client forever",
                )
            )
    return out


# ---------------------------------------------------------------------------
# broad-except: typed errors silently swallowed
# ---------------------------------------------------------------------------


def rule_broad_except(ctx: ModuleContext) -> list[Finding]:
    """``except:`` / ``except Exception`` / ``except BaseException`` swallow
    the project's typed failures (``DivergenceError`` carries the
    flight-recorder dump; ``KeyboardInterrupt`` under ``BaseException``
    kills ctrl-C). Handlers that unconditionally re-raise (a bare ``raise``
    anywhere in the handler) are inspect-and-forward patterns and are not
    flagged."""
    out: list[Finding] = []
    broad = {"Exception", "BaseException"}
    for node in ctx.nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        names: list[str] = []
        if node.type is None:
            names = ["(bare)"]
        elif isinstance(node.type, ast.Name) and node.type.id in broad:
            names = [node.type.id]
        elif isinstance(node.type, ast.Tuple):
            names = [e.id for e in node.type.elts if isinstance(e, ast.Name) and e.id in broad]
        if not names:
            continue
        if any(isinstance(sub, ast.Raise) and sub.exc is None for sub in ast.walk(node)):
            continue  # inspect-and-re-raise
        swallows = ", ".join(project.TYPED_EXCEPTIONS)
        if names == ["Exception"]:
            swallows = project.TYPED_EXCEPTIONS[0]
        out.append(
            ctx.finding(
                "broad-except",
                node,
                f"broad `except {names[0]}` can swallow typed {swallows}: "
                "narrow to the exceptions this site expects, or suppress with "
                "the reason the catch-all is load-bearing",
            )
        )
    return out


# ---------------------------------------------------------------------------
# retry-without-backoff, unbounded-readline: resilience discipline
# ---------------------------------------------------------------------------


def rule_retry_without_backoff(ctx: ModuleContext) -> list[Finding]:
    """A host-side loop that (a) re-attempts a socket/stream IO call
    (``project.RETRY_IO_CALLS``) inside a ``try``, (b) catches a
    transient-IO error (``ConnectionError``/``OSError``/``TimeoutError``
    family, or a broad except) WITHOUT leaving the loop (no raise/return/
    break in the handler: falling through IS the retry), and (c) contains
    no backoff call (``project.BACKOFF_CALLS``: sleep/wait) anywhere in its
    body. Hammering a struggling peer in a tight loop is how a retrying
    client turns a blip into an outage; the sanctioned shape is
    ``ServeClient.call``'s jittered exponential backoff. Deliberately NOT
    caught: loops whose handler exits (give-up, not retry), IO loops with
    any sleep/wait (the fix), and generic ``.result()``/``.get()`` drains
    (far too common to flag)."""
    out: list[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            continue
        has_backoff = any(
            isinstance(sub, ast.Call)
            and (
                (ctx.canonical(sub.func) or dotted_name(sub.func) or "").rsplit(
                    ".", 1
                )[-1]
                in project.BACKOFF_CALLS
            )
            for sub in ast.walk(node)
        )
        if has_backoff:
            continue
        for t in ast.walk(node):
            if not isinstance(t, ast.Try):
                continue
            io_calls = [
                sub
                for stmt in t.body
                for sub in ast.walk(stmt)
                if isinstance(sub, ast.Call)
                and (
                    (ctx.canonical(sub.func) or dotted_name(sub.func) or "")
                    .rsplit(".", 1)[-1]
                    in project.RETRY_IO_CALLS
                )
            ]
            if not io_calls:
                continue
            retrying = False
            for h in t.handlers:
                names: list[str] = []
                if h.type is None:
                    names = ["Exception"]
                else:
                    for e in ast.walk(h.type):
                        nm = dotted_name(e)
                        if nm:
                            names.append(nm.rsplit(".", 1)[-1])
                transient = any(
                    nm in project.TRANSIENT_IO_EXCEPTIONS
                    or nm in ("Exception", "BaseException")
                    for nm in names
                )
                exits = any(
                    isinstance(sub, (ast.Raise, ast.Return, ast.Break))
                    for sub in ast.walk(h)
                )
                if transient and not exits:
                    retrying = True
            if retrying:
                out.append(
                    ctx.finding(
                        "retry-without-backoff",
                        io_calls[0],
                        "loop retries an IO call after a transient "
                        "connection error with NO sleep/backoff between "
                        "attempts: a tight retry loop turns a peer's blip "
                        "into an outage; back off jittered-exponentially "
                        "between attempts (serve/client.ServeClient.call is "
                        "the sanctioned shape)",
                    )
                )
                break  # one finding per loop: the loop is the unit of fix
    return out


def rule_unbounded_readline(ctx: ModuleContext) -> list[Finding]:
    """A bare ``await reader.readline()`` (or readexactly/readuntil,
    ``project.UNBOUNDED_READ_CALLS``) in a serve-path module: with no
    timeout, one dead or slow-loris peer pins a connection slot (and its
    handler task) forever, the shape ``serve.conn_timeout_s`` exists to
    bound. The sanctioned form awaits ``asyncio.wait_for(...)`` around the
    read (``serve/server._read_line``), which this rule recognizes because
    the ``await``'s direct operand is then ``wait_for``, not the read.
    Scoped to ``serve/`` paths: async reads elsewhere (test clients,
    offline tooling) bound their own lifetimes."""
    path = ctx.path.replace("\\", "/")
    if "serve/" not in path:
        return []
    out: list[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Await) or not isinstance(node.value, ast.Call):
            continue
        callee = (
            ctx.canonical(node.value.func) or dotted_name(node.value.func) or ""
        ).rsplit(".", 1)[-1]
        if callee in project.UNBOUNDED_READ_CALLS:
            out.append(
                ctx.finding(
                    "unbounded-readline",
                    node,
                    f"bare `await ...{callee}()` in a serve path: with no "
                    "timeout one dead peer pins this connection slot "
                    "forever; wrap in asyncio.wait_for with "
                    "serve.conn_timeout_s (serve/server._read_line is the "
                    "sanctioned helper)",
                )
            )
    return out


# ---------------------------------------------------------------------------
# unwindowed-cumulative-rate: lifetime counter / wall-time division
# ---------------------------------------------------------------------------


def rule_unwindowed_cumulative_rate(ctx: ModuleContext) -> list[Finding]:
    """A cumulative run-lifetime counter (``project.CUMULATIVE_COUNTERS``)
    divided by a wall-clock span: the "rate" averages the counter's WHOLE
    lifetime, so a restart makes it garbage and a long run makes it inert
    (a regression in the last minute moves a week-long average by nothing).
    Windowed rates difference snapshots first
    (``telemetry/timeseries.counter_delta``; that module is the sanctioned
    home, ``project.RATE_SANCTIONED_MODULES``). Wall-time denominators are
    direct span-clock reads (``project.WALL_TIME_CALLS``), arithmetic over
    them, or a local name assigned from such an expression (two dataflow
    passes: ``now = time.monotonic()`` then ``elapsed = now - t0``).
    Run-level SUMMARY rates over an explicit full-run span are legitimate
    and sanctioned by suppression at the site. Deliberately NOT caught:
    deltas (``d_completed / dt``: already windowed), divisions by counts
    or config values, and cross-function flows (a span passed as an
    argument)."""
    if ctx.path in project.RATE_SANCTIONED_MODULES:
        return []

    def _clock_call(sub: ast.AST) -> bool:
        if not isinstance(sub, ast.Call):
            return False
        callee = ctx.canonical(sub.func) or dotted_name(sub.func) or ""
        return callee.rsplit(".", 1)[-1] in project.WALL_TIME_CALLS

    # names bound to wall-time spans, two passes for the one-step chain
    span_names: set[str] = set()
    assigns = [node for node in ctx.nodes if isinstance(node, ast.Assign)]
    for _pass in (0, 1):
        for node in assigns:
            clockish = any(
                _clock_call(sub) or (
                    isinstance(sub, ast.Name) and sub.id in span_names
                )
                for sub in ast.walk(node.value)
            )
            if not clockish:
                continue
            # plain-name targets only: `self._t0 = monotonic()` must bind
            # nothing (walking the Attribute target would bind `self` and
            # poison the whole module's dataflow)
            for t in node.targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                for n in elts:
                    if isinstance(n, ast.Name):
                        span_names.add(n.id)

    def _wall_time(expr: ast.AST) -> bool:
        return any(
            _clock_call(sub)
            or (isinstance(sub, ast.Name) and sub.id in span_names)
            for sub in ast.walk(expr)
        )

    def _counter(expr: ast.AST) -> str | None:
        for sub in ast.walk(expr):
            name = None
            if isinstance(sub, ast.Attribute):
                name = sub.attr
            elif isinstance(sub, ast.Name):
                name = sub.id
            if name and name.lstrip("_") in project.CUMULATIVE_COUNTERS:
                return name
        return None

    out: list[Finding] = []
    for node in ctx.nodes:
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div)):
            continue
        counter = _counter(node.left)
        if counter is None or not _wall_time(node.right):
            continue
        out.append(
            ctx.finding(
                "unwindowed-cumulative-rate",
                node,
                f"cumulative counter {counter!r} divided by a wall-clock "
                "span: a lifetime average is garbage after a restart and "
                "inert on a long run; difference snapshots first "
                "(telemetry/timeseries.counter_delta) and divide the DELTA "
                "by the window width; a run-level summary rate over the "
                "full run span is sanctioned by suppression",
            )
        )
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

RULES: dict[str, tuple[Callable[[ModuleContext], list[Finding]], str]] = {
    "primary-only-collective": (
        rule_primary_only_collective,
        "collectives guarded by a rank-0 check (multi-rank deadlock)",
    ),
    "serve-lock-discipline": (
        rule_serve_lock_discipline,
        "thread-shared serve state touched outside its lock",
    ),
    "stranded-future": (
        rule_stranded_future,
        "queue pop without guaranteed future resolution on all exit paths",
    ),
    "broad-except": (
        rule_broad_except,
        "bare/broad except swallowing DivergenceError/KeyboardInterrupt",
    ),
    "retry-without-backoff": (
        rule_retry_without_backoff,
        "IO retry loop with no sleep/backoff between attempts",
    ),
    "unbounded-readline": (
        rule_unbounded_readline,
        "await reader.readline() with no timeout in serve paths",
    ),
    "unwindowed-cumulative-rate": (
        rule_unwindowed_cumulative_rate,
        "cumulative counter divided by wall time outside the sanctioned differencing helpers",
    ),
    # "slow-marker" is data-driven (needs a --durations report) and lives in
    # qdml_tpu_torch.analysis.slowmarkers; the CLI folds it in when given the data.
}


def all_rules() -> list[Callable[[ModuleContext], list[Finding]]]:
    return [fn for fn, _doc in RULES.values()]
