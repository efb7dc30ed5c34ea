"""The port's lint rules (``qdml_tpu/analysis/rules.py``): the seven
framework-neutral hazard classes, and the torch counterparts of ten of
JAX's thirteen tracing rules, over the port's maps
(:mod:`qdml_tpu_torch.analysis.project`).

Each rule is a callable ``(ModuleContext) -> list[Finding]`` registered in
:data:`RULES` with its id and a one-line rationale. The seven neutral rules
are JAX's logic rule for rule, so the two engines report the same findings
on the same source. Each tracing counterpart keeps JAX's id, so a
suppression reads the same in both packages, and reads torch's hazard where
JAX reads XLA's: JAX's jit reachability becomes ``ModuleContext.captured``
(code that runs while a CUDA graph is captured or inside a kernel wrapper),
``pallas_call`` becomes a kernel wrapper, ``jnp`` becomes ``torch``. The
messages name the port's helpers. Three JAX rules have no counterpart and
are not registered: ``train-step-jit-audit`` (torch updates in place, so
there is no donation to declare), ``pallas-interpret-literal`` (the port has
no interpret mode; a wrapper takes its plain version only for a CPU tensor)
and ``collective-outside-shardmap`` (a torch collective takes its process
group explicitly; ``primary-only-collective`` covers the deadlock shape).

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
# The tracing rules' torch counterparts. "Captured" is ModuleContext.captured:
# a function that runs while a CUDA graph is captured (its Python runs once,
# at capture; every replay repeats only the recorded launches) or inside a
# kernel wrapper.
# ---------------------------------------------------------------------------


def _all_args(fn: ast.AST) -> list[ast.arg]:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs] + (
        [a.vararg] if a.vararg else []
    ) + ([a.kwarg] if a.kwarg else [])


def rule_jit_mutable_global(ctx: ModuleContext) -> list[Finding]:
    """A captured function reading a module-level dict/list/set reads it
    once, at capture: the graph records the launches on what the read saw
    then, and every replay runs on that (an entry swapped for a new tensor
    leaves the graph on the old one). Reads of immutable module constants
    (tuples, numbers, strings) are fine and not flagged. Deliberately NOT
    caught: mutables reached through an attribute (``mod.TABLE``)."""
    out: list[Finding] = []
    if not ctx.mutable_globals:
        return out
    for fn in ctx.captured:
        params = {a.arg for a in _all_args(fn)}
        local_stores: set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign):
                targets = sub.targets
            elif isinstance(sub, (ast.AnnAssign, ast.AugAssign)):
                targets = [sub.target]
            else:
                continue
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        local_stores.add(n.id)
        seen: set[str] = set()
        for sub in ast.walk(fn):
            if not (isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load)):
                continue
            name = sub.id
            if (
                name in ctx.mutable_globals
                and name not in params
                and name not in local_stores
                and name not in seen
            ):
                seen.add(name)
                out.append(
                    ctx.finding(
                        "jit-mutable-global",
                        sub,
                        f"captured {ctx.qualname(fn)!r} reads module-level "
                        f"mutable {name!r}: the read happens once, at graph "
                        "capture, and every replay runs on what it saw; pass "
                        "it as an argument or make it immutable",
                    )
                )
    return out


# torch functions that answer on the host (no tensor, no sync): their result
# in an if/while test is plain Python
_TORCH_HOST_PREFIXES = ("is_", "get_", "are_", "set_")
_TORCH_HOST_NAMES = frozenset(
    {"device", "dtype", "Size", "numel", "finfo", "iinfo", "Generator", "no_grad", "enable_grad",
     "inference_mode"}
)
# torch's namespaces whose calls make tensors (others: torch.cuda, .distributed,
# .backends, ... answer on the host)
_TORCH_TENSOR_NAMESPACES = ("torch.nn.functional.", "torch.linalg.", "torch.fft.", "torch.special.")


def _mentions_torch_call(ctx: ModuleContext, node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            callee = ctx.canonical(sub.func) or ""
            if callee.startswith(_TORCH_TENSOR_NAMESPACES):
                return True
            head, _, tail = callee.rpartition(".")
            if head == "torch" and not (tail.startswith(_TORCH_HOST_PREFIXES) or tail in _TORCH_HOST_NAMES):
                return True
    return False


def rule_tracer_branch(ctx: ModuleContext) -> list[Finding]:
    """``if``/``while`` on a tensor made by a torch op inside captured code:
    ``bool(t)`` waits for the card (illegal while a graph is captured, where
    it raises), and the branch the capture took is the one every replay
    runs. Static Python flags (``if probes:`` bound before capture) are NOT
    flagged, only tests that call a torch op or reference a local assigned
    from one. Deliberately NOT caught: tensor methods (``if t.any():``, the
    receiver's type is not known) and tensors that come in as arguments."""
    out: list[Finding] = []
    for fn in ctx.captured:
        device_locals: set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and _mentions_torch_call(ctx, sub.value):
                for t in sub.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            device_locals.add(n.id)
        for sub in ast.walk(fn):
            if not isinstance(sub, (ast.If, ast.While)):
                continue
            test = sub.test
            bad = _mentions_torch_call(ctx, test) or any(
                isinstance(n, ast.Name) and n.id in device_locals
                for n in ast.walk(test)
            )
            if bad:
                kind = "if" if isinstance(sub, ast.If) else "while"
                out.append(
                    ctx.finding(
                        "tracer-branch",
                        sub,
                        f"Python `{kind}` on a tensor inside captured "
                        f"{ctx.qualname(fn)!r}: the test syncs the host (and "
                        "raises under graph capture), and a replay repeats "
                        "the capture's branch; select on the device "
                        "(torch.where) instead",
                    )
                )
    return out


def rule_host_sync_hot_path(ctx: ModuleContext) -> list[Finding]:
    """``.item()`` / ``.cpu()`` / ``.tolist()`` / ``torch.cuda.synchronize()``
    (``project.HOST_SYNC_ATTRS``), ``np.asarray`` and, in captured code,
    ``float/int/bool(t)``: inside captured code a device->host wait raises
    under capture (and on the eager path stalls the launch queue every
    step); inside the serve request path (``project.HOT_HOST_FUNCS``) each
    is a stall that must be deliberate: intentional syncs carry a
    suppression with the reason written next to them. Deliberately NOT
    caught: ``float()``/``int()`` in the request path (host values there are
    plain Python) and syncs in a nested function of a request-path method."""
    out: list[Finding] = []
    hot_host = project.HOT_HOST_FUNCS.get(ctx.path, ())
    targets: list[tuple[ast.AST, str, str]] = []  # (fn, qual, kind)
    for fn, qual in ctx.functions:
        if fn in ctx.captured:
            targets.append((fn, qual, "captured"))
        elif qual in hot_host:
            targets.append((fn, qual, "serve-request-path"))
    for fn, qual, kind in targets:
        nested = {
            sub for sub in ast.walk(fn) if isinstance(sub, _FuncNode) and sub is not fn
        }
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            if any(sub in ast.walk(n) for n in nested) and kind == "serve-request-path":
                continue  # nested defs in host funcs judged on their own merits
            label = None
            callee = ctx.canonical(sub.func)
            if isinstance(sub.func, ast.Attribute) and sub.func.attr in project.HOST_SYNC_ATTRS:
                label = f".{sub.func.attr}()"
            elif callee in ("numpy.asarray", "numpy.array"):
                label = callee.replace("numpy", "np")
            elif (
                kind == "captured"
                and isinstance(sub.func, ast.Name)
                and sub.func.id in project.HOST_SYNC_NAMES
                and sub.args
                and not isinstance(sub.args[0], ast.Constant)
            ):
                label = f"{sub.func.id}()"
            if label:
                out.append(
                    ctx.finding(
                        "host-sync-hot-path",
                        sub,
                        f"host sync {label} in {kind} {qual!r}: a device->host "
                        "wait here stalls the launch queue (and raises under "
                        "graph capture); move it off the hot path or suppress "
                        "with the reason the sync is deliberate",
                    )
                )
    return out


def rule_wall_clock_in_jit(ctx: ModuleContext) -> list[Finding]:
    """``time.time()``/``datetime.now()`` inside captured code runs once, at
    capture: the graph never reads the clock again, so anything it feeds is
    the capture's timestamp at every replay. Timing belongs around the
    dispatch (``telemetry/counters.StepClock``)."""
    out: list[Finding] = []
    for fn in ctx.captured:
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            callee = ctx.canonical(sub.func)
            if not callee:
                continue
            head, _, tail = callee.rpartition(".")
            if tail in project.WALL_CLOCK_CALLS and head.split(".")[0] in (
                "time",
                "datetime",
            ):
                out.append(
                    ctx.finding(
                        "wall-clock-in-jit",
                        sub,
                        f"{callee}() inside captured {ctx.qualname(fn)!r} is "
                        "read once, at graph capture; time the dispatch from "
                        "the host (telemetry/counters.StepClock)",
                    )
                )
    return out


def _cuda_target(node: ast.AST) -> bool:
    """A device argument that names the card: ``"cuda"``/``"cuda:0"`` or
    ``torch.device("cuda...")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.startswith("cuda")
    if isinstance(node, ast.Call) and (dotted_name(node.func) or "").endswith("device") and node.args:
        return _cuda_target(node.args[0])
    return False


def rule_import_time_jnp(ctx: ModuleContext) -> list[Finding]:
    """A tensor made on the card (``device="cuda"``, ``.cuda()``,
    ``.to("cuda")``) or a ``torch.cuda`` call that initialises CUDA, at
    module scope: importing the module opens a CUDA context (before the
    process picks its card, before a world is joined, in host tools such as
    ``lint`` that must hold nothing on a serving card). The port's tests
    import every module without a card. ``torch.cuda.is_available()``/
    ``device_count()``/``is_initialized()`` do not initialise
    (``project.CUDA_QUERY_CALLS``). Device constants belong inside the
    function that uses them (a per-device cache, as
    ``quantum/statevector.ring_index``). Deliberately NOT caught: class
    bodies and a device held in a module-level name."""
    out: list[Finding] = []
    stack: list[ast.AST] = list(ctx.tree.body)
    while stack:
        stmt = stack.pop()
        if isinstance(stmt, (*_FuncNode, ast.ClassDef)):
            continue
        for sub in ast.iter_child_nodes(stmt):
            stack.append(sub)
        if not isinstance(stmt, ast.Call):
            continue
        callee = ctx.canonical(stmt.func) or dotted_name(stmt.func) or ""
        what = None
        if callee.startswith("torch.cuda.") and callee.rsplit(".", 1)[-1] not in project.CUDA_QUERY_CALLS:
            what = f"{callee}() initialises CUDA"
        elif any(kw.arg == "device" and _cuda_target(kw.value) for kw in stmt.keywords):
            what = f"{callee}(device=cuda) makes a tensor on the card"
        elif isinstance(stmt.func, ast.Attribute) and (
            stmt.func.attr == "cuda" or (stmt.func.attr == "to" and stmt.args and _cuda_target(stmt.args[0]))
        ):
            what = f".{stmt.func.attr}() moves a tensor to the card"
        if what:
            out.append(
                ctx.finding(
                    "import-time-jnp",
                    stmt,
                    f"{what} at module import time: a CUDA context as an "
                    "import side effect; build device constants inside the "
                    "function that uses them",
                )
            )
    return out


def _carried(ctx: ModuleContext, call: ast.Call) -> bool:
    """True when the statement holding ``call`` assigns a plain name the
    call also reads (``x = f(x)``, ``x, y = f(x, y)``, ``x += f(x)``): the
    output feeds the next launch. A store into a container (``t["ms"] =
    f(t["args"])``) carries nothing."""
    stmt = ctx.parent.get(call)
    while stmt is not None and not isinstance(stmt, ast.stmt):
        stmt = ctx.parent.get(stmt)
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    else:
        return False
    stored: set[str] = set()
    while targets:
        t = targets.pop()
        if isinstance(t, ast.Name):
            stored.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            targets.extend(t.elts)
        elif isinstance(t, ast.Starred):
            targets.append(t.value)
    read = {
        n.id
        for arg in [*call.args, *(kw.value for kw in call.keywords)]
        for n in ast.walk(arg)
        if isinstance(n, ast.Name)
    }
    return bool(stored & read)


def rule_pallas_host_loop(ctx: ModuleContext) -> list[Finding]:
    """A kernel wrapper (``project.KERNEL_WRAPPER_CALLS``: the raw
    ``_launch`` and the wrappers of ``quantum/kernels.py``) called inside a
    host-side Python ``for``/``while`` with its output carried into the next
    iteration's launch (``psi = apply_rotation_layer(psi, ...)``), the
    per-layer circuit shape: one launch per layer or gate, the state through
    device memory between them. The loop belongs inside the kernel
    (``csrc/circuit_expvals.cu`` runs all layers in one launch). Loops
    inside a nested function are not this function's loops and are not
    flagged. Deliberately NOT caught: launches whose output feeds no later
    launch of the loop (a sweep over shapes, a check per point), loops in
    comprehensions, and wrappers reached through another module's helper."""
    out: list[Finding] = []
    for call in ctx.nodes:
        if not isinstance(call, ast.Call):
            continue
        callee = ctx.canonical(call.func) or dotted_name(call.func) or ""
        if callee.rsplit(".", 1)[-1] not in project.KERNEL_WRAPPER_CALLS or not _carried(ctx, call):
            continue
        cur = ctx.parent.get(call)
        while cur is not None and not isinstance(cur, _FuncNode):
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                out.append(
                    ctx.finding(
                        "pallas-host-loop",
                        call,
                        f"kernel wrapper {callee!r} launched from a host-side "
                        "Python loop: each iteration is a separate launch "
                        "with a device-memory round trip between them; move "
                        "the loop into the kernel (quantum/kernels."
                        "fused_circuit_expvals runs every layer in one "
                        "launch)",
                    )
                )
                break
            cur = ctx.parent.get(cur)
    return out


def rule_gate_matrix_in_loop(ctx: ModuleContext) -> list[Finding]:
    """A gate-matrix constructor (``project.GATE_MATRIX_CONSTRUCTORS``:
    ``quantum/circuits.rot_gate``) called inside a host-side Python
    ``for``/``while`` rebuilds the per-gate matrix every iteration: the
    circuit's trig belongs in one vectorized shot, the layer unitary fused.
    Loops inside a nested function are not host loops here. Deliberately NOT
    caught: ad-hoc ``torch.stack``-built matrices (no name to match) and
    loops that merely APPLY a precomputed matrix, which is the fix."""
    out: list[Finding] = []
    for node in ctx.nodes:
        if not isinstance(node, ast.Call):
            continue
        callee = ctx.canonical(node.func) or dotted_name(node.func) or ""
        if callee.rsplit(".", 1)[-1] not in project.GATE_MATRIX_CONSTRUCTORS:
            continue
        cur = ctx.parent.get(node)
        while cur is not None and not isinstance(cur, _FuncNode):
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                out.append(
                    ctx.finding(
                        "gate-matrix-in-loop",
                        node,
                        f"per-gate matrix constructor {callee!r} called inside "
                        "a Python loop: the gate matrices are rebuilt every "
                        "iteration; derive the whole circuit's trig in one "
                        "vectorized shot and fuse the layer unitary "
                        "(quantum/circuits.py)",
                    )
                )
                break
            cur = ctx.parent.get(cur)
    return out


def rule_data_dependent_shape_in_jit(ctx: ModuleContext) -> list[Finding]:
    """A value-dependent-shape op inside captured code or a serve request
    path (``project.HOT_HOST_FUNCS``): the shape of ``torch.nonzero``/
    ``torch.unique``/one-arg ``torch.where`` (and of boolean-mask indexing)
    depends on runtime VALUES, so torch syncs the host to size the result:
    illegal under graph capture, a stall on every eager step. The hazard
    capacity-bucketed sparse dispatch (``ops/routing.py``) is built to
    avoid: rank with a one-hot cumsum, pack into FIXED-capacity buckets.

    Three shapes are caught: (a) calls to the ``project.DATA_DEP_SHAPE_CALLS``
    torch functions, (b) ``torch.where`` with exactly one argument (the
    3-arg select is the FIX, never flagged), (c) subscripts whose index is a
    comparison (``x[y > 0]``) or a local assigned from one. Deliberately NOT
    caught: the same ops in other host code, tensor methods (``t.nonzero()``),
    integer-array gathers (``x[idx]`` is shape-static), and masks consumed
    by ``torch.where``/arithmetic."""
    out: list[Finding] = []
    hot_host = project.HOT_HOST_FUNCS.get(ctx.path, ())
    fns = [(fn, "captured") for fn, _q in ctx.functions if fn in ctx.captured] + [
        (fn, "serve-request-path") for fn, qual in ctx.functions if qual in hot_host and fn not in ctx.captured
    ]
    for fn, kind in fns:
        mask_locals: set[str] = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Compare):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        mask_locals.add(t.id)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call):
                callee = ctx.canonical(sub.func) or ""
                if callee.startswith("torch."):
                    tail = callee.rsplit(".", 1)[-1]
                    if tail in project.DATA_DEP_SHAPE_CALLS and any(
                        kw.arg == "size" for kw in sub.keywords
                    ):
                        continue  # a static size: the output shape is the literal
                    if tail in project.DATA_DEP_SHAPE_CALLS:
                        out.append(
                            ctx.finding(
                                "data-dependent-shape-in-jit",
                                sub,
                                f"{callee} inside {kind} {ctx.qualname(fn)!r}: "
                                "its output shape depends on runtime values, "
                                "so the host waits for the card to size it "
                                "(raises under graph capture); pack into "
                                "fixed-capacity buckets with computed slots "
                                "(ops/routing.sparse_dispatch)",
                            )
                        )
                    elif tail == "where" and len(sub.args) == 1 and not sub.keywords:
                        out.append(
                            ctx.finding(
                                "data-dependent-shape-in-jit",
                                sub,
                                "one-argument torch.where (the nonzero form) "
                                f"inside {kind} {ctx.qualname(fn)!r} returns "
                                "value-dependent shapes; use the 3-argument "
                                "select, or fixed-capacity slot packing",
                            )
                        )
            elif isinstance(sub, ast.Subscript):
                idx = sub.slice
                masked = isinstance(idx, ast.Compare) or (
                    isinstance(idx, ast.Name) and idx.id in mask_locals
                )
                if masked:
                    out.append(
                        ctx.finding(
                            "data-dependent-shape-in-jit",
                            sub,
                            f"boolean-mask indexing inside {kind} "
                            f"{ctx.qualname(fn)!r} is nonzero + gather (a "
                            "value-dependent shape); select with "
                            "torch.where(mask, a, b), or pack fixed-capacity "
                            "buckets (ops/routing.sparse_dispatch)",
                        )
                    )
    return out


def rule_pad_to_bucket_in_serve(ctx: ModuleContext) -> list[Finding]:
    """A function in a ``serve/`` module that picks a static bucket
    (``pick_bucket``) AND pads data into a fresh zeros/empty allocation via
    slice assignment (``xp[:n] = x``) re-implements the engine's
    pad-to-bucket step outside the one sanctioned path: every such pad is
    compute on rows nobody asked for, and a second pad site dodges the
    DispatchInfo goodput/padding-waste ledger. ``ServeEngine.infer`` carries
    the suppression with the reason written next to it. Deliberately NOT
    caught: picking a bucket without padding, padding without a bucket pick,
    and device-side scatter packing (``ops/routing.py``: the fix)."""
    if "serve/" not in ctx.path.replace("\\", "/"):
        return []
    out: list[Finding] = []
    for fn, qual in ctx.functions:
        picks = [
            sub
            for sub in ast.walk(fn)
            if isinstance(sub, ast.Call)
            and (ctx.canonical(sub.func) or dotted_name(sub.func) or "").rsplit(
                ".", 1
            )[-1] == "pick_bucket"
        ]
        if not picks:
            continue
        allocates = any(
            isinstance(sub, ast.Call)
            and (ctx.canonical(sub.func) or dotted_name(sub.func) or "").rsplit(
                ".", 1
            )[-1] in ("zeros", "empty", "zeros_like", "empty_like", "new_zeros", "new_empty")
            for sub in ast.walk(fn)
        )
        pad_assign = any(
            isinstance(sub, ast.Assign)
            and any(
                isinstance(t, ast.Subscript) and isinstance(t.slice, ast.Slice)
                for t in sub.targets
            )
            for sub in ast.walk(fn)
        )
        if allocates and pad_assign:
            out.append(
                ctx.finding(
                    "pad-to-bucket-in-serve",
                    picks[0],
                    f"{qual!r} picks a static bucket and pads a batch into it "
                    "outside the sanctioned batcher path "
                    "(serve/engine.ServeEngine.infer): route the batch "
                    "through the engine so the pad rows land in the "
                    "DispatchInfo goodput/padding-waste ledger (or serve the "
                    "tier ragged)",
                )
            )
    return out


def rule_trace_in_jit_path(ctx: ModuleContext) -> list[Finding]:
    """A request-tracing call (``project.TRACE_STAMP_CALLS``: TraceContext
    construction, ``trace_sampled``, ``add_phase``) inside captured code (a
    graph capture's step or a kernel wrapper). Tracing is host-side ONLY:
    under capture the stamp is read once and every replay repeats nothing
    of it (``wall-clock-in-jit``'s hazard), and a stamp inside a wrapper
    times the launch's host side, not the kernel. Deliberately NOT caught:
    stamping in host-side serve/router/loadgen code (the sanctioned
    surface) and cross-module call chains."""
    out: list[Finding] = []
    for fn in ctx.captured:
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            callee = ctx.canonical(sub.func) or dotted_name(sub.func) or ""
            if callee.rsplit(".", 1)[-1] not in project.TRACE_STAMP_CALLS:
                continue
            out.append(
                ctx.finding(
                    "trace-in-jit-path",
                    sub,
                    f"request-tracing call {callee!r} in captured "
                    f"{ctx.qualname(fn) or fn.name!r}: tracing is host-side "
                    "only; under graph capture the stamp is read once and "
                    "never replayed; stamp around the dispatch, never inside "
                    "it (serve/server.ServeLoop._serve_one is the sanctioned "
                    "site)",
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
    # the tracing rules' torch counterparts, under JAX's ids
    "jit-mutable-global": (
        rule_jit_mutable_global,
        "captured code reading module-level mutable state (read once, at capture)",
    ),
    "tracer-branch": (
        rule_tracer_branch,
        "Python if/while on a tensor in captured code (a host sync, illegal under capture)",
    ),
    "host-sync-hot-path": (
        rule_host_sync_hot_path,
        ".item()/.cpu()/.tolist()/synchronize in captured code / serve-request paths",
    ),
    "wall-clock-in-jit": (
        rule_wall_clock_in_jit,
        "time.time()/datetime.now() in captured code (read once, at capture)",
    ),
    "import-time-jnp": (
        rule_import_time_jnp,
        "tensors on the card or CUDA initialised at module import time",
    ),
    "pallas-host-loop": (
        rule_pallas_host_loop,
        "kernel wrapper launched from a host-side Python loop over gates/layers",
    ),
    "gate-matrix-in-loop": (
        rule_gate_matrix_in_loop,
        "per-gate matrix construction inside a circuit layer loop",
    ),
    "data-dependent-shape-in-jit": (
        rule_data_dependent_shape_in_jit,
        "torch.nonzero/unique/bool-mask indexing in captured or serve-request code",
    ),
    "pad-to-bucket-in-serve": (
        rule_pad_to_bucket_in_serve,
        "request batch padded to a static bucket outside the sanctioned batcher path",
    ),
    "trace-in-jit-path": (
        rule_trace_in_jit_path,
        "TraceContext construction / phase stamping in captured code or a kernel wrapper",
    ),
    # "slow-marker" is data-driven (needs a --durations report) and lives in
    # qdml_tpu_torch.analysis.slowmarkers; the CLI folds it in when given the data.
}


def all_rules() -> list[Callable[[ModuleContext], list[Finding]]]:
    return [fn for fn, _doc in RULES.values()]
