"""The port's whole-program concurrency pass (``qdml_tpu/analysis/
concurrency.py`` over the port's tree): the static lock-order graph and the
five concurrency rules.

The per-module rules in :mod:`qdml_tpu_torch.analysis.rules` check that
LOCK_MAP'd attributes are touched under *their* lock inside *their* class;
nothing there sees ACROSS locks or modules. This pass builds one model of
the whole scanned tree (every lock construction site, every held-lock
region, an interprocedural call closure: same-class ``self.m()``,
attribute-typed ``self._x.m()``, same-module and imported-module calls)
and derives:

- **lock-order-inversion**: the static acquisition-order graph (edge A->B =
  lock B acquired somewhere while A is held, directly or through the call
  closure) contains a cycle. Two threads walking the cycle from different
  ends deadlock; the runtime twin (:mod:`qdml_tpu_torch.utils.lockdep`)
  witnesses the same edge set under real execution.
- **blocking-under-lock**: a call that can block for unbounded time
  (``time.sleep``, socket/subprocess IO, ``Event.wait``, ``.result()``
  drains, and torch's device fences ``torch.cuda.synchronize``/``.item()``/
  ``.cpu()``/``.tolist()``: ``project.BLOCKING_CALLS``) reachable inside a
  held-lock region. Every peer of that lock serializes behind the slow
  call; sanctioned sites (the hot-swap's off-request-path fence) carry
  reasoned suppressions.
- **sync-io-in-async**: a synchronous blocking call reachable from an
  ``async def`` handler in the serving event-loop files
  (``project.ASYNC_SCOPED_FILES``) without an executor hop: a stalled loop
  stops EVERY connection, not one request. Callables passed into
  ``run_in_executor``/``to_thread`` are the sanctioned escape and are not
  descended into; ``asyncio.*`` calls are awaited loop citizens and exempt.
- **unmapped-shared-state**: an instance attribute written outside
  ``__init__`` from >=2 distinct thread entry points (``Thread(target=...)``
  roots, done-callbacks, async handlers, plus the caller's own thread) in
  the concurrent packages, with NO LOCK_MAP row: the candidate set LOCK_MAP
  should grow from.
- **dead-lock-map-entry**: LOCK_MAP staleness: a mapped file/class/attr/
  lock that no longer exists in the tree silently disarms
  ``serve-lock-discipline``; a rename must update the map.

Findings flow through the SAME suppression/baseline machinery as the
per-module rules (``LintEngine.run`` merges them through ``lint_file``'s
``pre`` before suppression processing), so a reasoned inline disable of
``blocking-under-lock`` works and a stale one is flagged
``dead-suppression`` like any other.

The graph renders to ``qdml_tpu_torch/analysis/lockgraph/`` (DOT + JSON +
a markdown hierarchy table) via :func:`write_lockgraph`; ``lint
--lockgraph-check`` regenerates and compares it, so the documented
hierarchy is generated, never asserted.

Deliberately NOT caught (precision over recall): conditional acquisition
paths are merged (may-hold, not must-hold: a spurious edge is a review
prompt, a missed one is a deadlock); ``.acquire()`` held-ranges are tracked
to the end of the enclosing block, not across early releases in sibling
branches; duck-typed calls through untyped attributes do not resolve
(annotate the ``__init__`` parameter to opt in). Standard library only.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Iterable

from qdml_tpu_torch.analysis import project
from qdml_tpu_torch.analysis.engine import (
    Finding,
    ModuleContext,
    dotted_name,
    iter_python_files,
)

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)

LINT_CMD = "python -m qdml_tpu_torch.cli lint"
# the committed graph, beside the port's baseline and slow allowlist
LOCKGRAPH_DIR = "qdml_tpu_torch/analysis/lockgraph"
# the witness's own guard is a leaf by construction
LOCKDEP_PATH = "qdml_tpu_torch/utils/lockdep.py"
# dead-lock-map-entry anchors file/class-level misses on the map literal here
PROJECT_PATH = "qdml_tpu_torch/analysis/project.py"

# rule id -> one-line doc (folded into `lint --list-rules`)
CONCURRENCY_RULES: dict[str, str] = {
    "lock-order-inversion": (
        "cycle in the static lock acquisition-order graph (deadlock shape)"
    ),
    "blocking-under-lock": (
        "sleep/socket/subprocess/fence/.result() reachable inside a held lock"
    ),
    "sync-io-in-async": (
        "sync blocking call reachable from an async handler without an executor hop"
    ),
    "unmapped-shared-state": (
        "attribute written from >=2 thread entry points with no LOCK_MAP row"
    ),
    "dead-lock-map-entry": (
        "LOCK_MAP names a file/class/attr/lock that no longer exists"
    ),
}

_LOCK_CTORS = {"Lock", "RLock"}
# thread-safe primitives whose internal state needs no LOCK_MAP row
_THREADSAFE_CTORS = {
    "Lock",
    "RLock",
    "Event",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
    "Barrier",
    "Queue",
    "SimpleQueue",
    "local",
}


def _last(name: str | None) -> str:
    return (name or "").rsplit(".", 1)[-1]


# canonically-qualified blockers whose bare tail is too generic to list in
# project.BLOCKING_CALLS (every `x.run()` is not a subprocess)
_BLOCKING_CANONICAL = frozenset({"subprocess.run"})


def _is_blocking(
    ctx: ModuleContext,
    call: ast.Call,
    tail: str,
    table: frozenset[str] = None,  # type: ignore[assignment]
) -> bool:
    """True when ``call`` can block the calling thread for unbounded time.

    ``join`` is exempted for the two string shapes (``os.path.join``,
    ``"sep".join``): a thread/process join it is not; ``asyncio.*`` calls
    are loop citizens, not thread blockers."""
    canon = ctx.canonical(call.func) or dotted_name(call.func) or ""
    if canon in _BLOCKING_CANONICAL:
        return True
    if tail not in (project.BLOCKING_CALLS if table is None else table):
        return False
    if canon.startswith("asyncio."):
        return False
    if tail == "join":
        if canon.endswith("path.join"):
            return False
        if isinstance(call.func, ast.Attribute) and isinstance(
            call.func.value, ast.Constant
        ):
            return False
    return True


@dataclass
class LockDecl:
    """One lock identity: ``Class._attr`` (instance) or ``module:NAME``."""

    lock_id: str
    kind: str            # "lock" | "rlock"
    path: str
    line: int
    cls: str | None      # declaring class, None for module-level
    mapped: bool = False  # appears as a required lock in LOCK_MAP


@dataclass
class _FnInfo:
    """Per-function facts the interprocedural fixpoints consume."""

    key: tuple[str, str]                 # (path, qualname)
    node: ast.AST
    ctx: ModuleContext
    cls: str | None
    # locks this function acquires in its own body: lock_id -> first line
    acquires: dict[str, int] = field(default_factory=dict)
    # blocking calls in its own body: name -> first (line, text)
    blocks: dict[str, int] = field(default_factory=dict)
    # resolved outgoing calls: (callee_key, call line)
    calls: list[tuple[tuple[str, str], int]] = field(default_factory=list)
    # (held lock_id, acquired lock_id, line) direct nesting edges
    edges: list[tuple[str, str, int]] = field(default_factory=list)
    # calls made while >=1 lock is held: (held ids, call node, callee key|None)
    held_calls: list[tuple[tuple[str, ...], ast.Call, tuple[str, str] | None]] = field(
        default_factory=list
    )
    # direct blocking calls under a held lock: (held ids, node, op name)
    held_blocks: list[tuple[tuple[str, ...], ast.Call, str]] = field(
        default_factory=list
    )


class ConcurrencyModel:
    """The whole-program model: locks, held regions, call closure, graph."""

    def __init__(
        self,
        ctxs: list[ModuleContext],
        lock_map: dict[str, dict[str, dict[str, str]]] | None = None,
    ):
        self.ctxs = ctxs
        self.lock_map = project.LOCK_MAP if lock_map is None else lock_map
        self.by_path: dict[str, ModuleContext] = {c.path: c for c in ctxs}
        # dotted module name -> path (the first path wins, as a scan in
        # path order would find it)
        self.by_module: dict[str, str] = {}
        for path in self.by_path:
            self.by_module.setdefault(self._module_dotted(path), path)

        # class registry: name -> (ctx, ClassDef). Class names are unique
        # across this repo; a duplicate keeps the first and the second
        # simply fails attribute-type resolution (conservative: no edges).
        self.classes: dict[str, tuple[ModuleContext, ast.ClassDef]] = {}
        for ctx in ctxs:
            for node in ctx.nodes:
                if isinstance(node, ast.ClassDef):
                    self.classes.setdefault(node.name, (ctx, node))

        self.locks: dict[str, LockDecl] = {}
        self.class_locks: dict[str, dict[str, LockDecl]] = {}   # cls -> attr -> decl
        self.module_locks: dict[str, dict[str, LockDecl]] = {}  # path -> name -> decl
        self._collect_locks()

        # cls -> attr -> class name (for self._x.m() resolution)
        self.attr_types: dict[str, dict[str, str]] = {}
        self._collect_attr_types()

        # function table + per-function facts
        self.fns: dict[tuple[str, str], _FnInfo] = {}
        self._collect_functions()
        for info in self.fns.values():
            self._scan_function(info)

        # interprocedural fixpoints: lock_id -> via chain / op -> via chain
        self.may_acquire: dict[tuple[str, str], dict[str, str]] = {}
        self.may_block: dict[tuple[str, str], dict[str, str]] = {}
        self._fixpoints()

        # the acquisition-order graph: (src, dst) -> list of site dicts
        self.edges: dict[tuple[str, str], list[dict]] = {}
        self._build_edges()

    # -- lock inventory ------------------------------------------------------

    def _lock_ctor_kind(self, ctx: ModuleContext, value: ast.AST) -> str | None:
        """'lock'/'rlock' when ``value`` constructs one (threading.Lock(),
        lockdep.Lock("name"), threading.RLock(), ...), else None."""
        if not isinstance(value, ast.Call):
            return None
        tail = _last(ctx.canonical(value.func) or dotted_name(value.func))
        if tail not in _LOCK_CTORS:
            return None
        return "rlock" if tail == "RLock" else "lock"

    def _collect_locks(self) -> None:
        mapped: set[tuple[str, str]] = set()  # (class, lock_attr)
        for _path, cls_map in self.lock_map.items():
            for cls, attrs in cls_map.items():
                for lock_attr in attrs.values():
                    mapped.add((cls, lock_attr))
        for ctx in self.ctxs:
            if ctx.path == LOCKDEP_PATH:
                continue  # the witness's own guard is a leaf by construction
            mod = os.path.basename(ctx.path).removesuffix(".py")
            # module-level locks
            for node in ctx.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    t = node.targets[0]
                    kind = self._lock_ctor_kind(ctx, node.value)
                    if kind and isinstance(t, ast.Name):
                        decl = LockDecl(
                            f"{mod}:{t.id}", kind, ctx.path, node.lineno, None
                        )
                        self.locks[decl.lock_id] = decl
                        self.module_locks.setdefault(ctx.path, {})[t.id] = decl
            # function-local locks (the port's alone: serve/loadgen's
            # ``mlock = lockdep.Lock("loadgen:mlock")``, taken by the
            # function's closures), under the module's ``mod:NAME`` identity
            # as lockdep names them, so every lockdep name is a node
            for sub in ctx.nodes:
                if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                    continue
                t = sub.targets[0]
                if not isinstance(t, ast.Name) or t.id in self.module_locks.get(ctx.path, {}):
                    continue
                kind = self._lock_ctor_kind(ctx, sub.value)
                if kind and ctx.enclosing_function(sub) is not None:
                    decl = LockDecl(f"{mod}:{t.id}", kind, ctx.path, sub.lineno, None)
                    self.locks[decl.lock_id] = decl
                    self.module_locks.setdefault(ctx.path, {})[t.id] = decl
            # instance locks (any self.X = <lock ctor> inside the class)
            for cnode in ctx.nodes:
                if not isinstance(cnode, ast.ClassDef):
                    continue
                for sub in ast.walk(cnode):
                    if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
                        continue
                    t = sub.targets[0]
                    if not (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        continue
                    kind = self._lock_ctor_kind(ctx, sub.value)
                    if kind is None:
                        continue
                    decl = LockDecl(
                        f"{cnode.name}.{t.attr}",
                        kind,
                        ctx.path,
                        sub.lineno,
                        cnode.name,
                        mapped=(cnode.name, t.attr) in mapped,
                    )
                    self.locks[decl.lock_id] = decl
                    self.class_locks.setdefault(cnode.name, {})[t.attr] = decl

    # -- attribute types -----------------------------------------------------

    @staticmethod
    def _ann_name(ann: ast.AST | None) -> str | None:
        """The class name inside an annotation: C, 'C', C | None, Optional[C]."""
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value.split("|")[0].strip().rsplit(".", 1)[-1] or None
        if isinstance(ann, ast.Name):
            return ann.id
        if isinstance(ann, ast.Attribute):
            return ann.attr
        if isinstance(ann, ast.BinOp):  # C | None
            return ConcurrencyModel._ann_name(ann.left)
        if isinstance(ann, ast.Subscript):  # Optional[C]
            return ConcurrencyModel._ann_name(ann.slice)
        return None

    def _collect_attr_types(self) -> None:
        for ctx in self.ctxs:
            for cnode in ctx.nodes:
                if not isinstance(cnode, ast.ClassDef):
                    continue
                types = self.attr_types.setdefault(cnode.name, {})
                for fn in cnode.body:
                    if not (isinstance(fn, _FuncNode) and fn.name == "__init__"):
                        continue
                    param_types = {
                        a.arg: self._ann_name(a.annotation)
                        for a in fn.args.args + fn.args.kwonlyargs
                    }
                    for sub in ast.walk(fn):
                        if not (
                            isinstance(sub, ast.Assign) and len(sub.targets) == 1
                        ):
                            continue
                        t = sub.targets[0]
                        if not (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            continue
                        v = sub.value
                        name: str | None = None
                        if isinstance(v, ast.Call):
                            name = _last(dotted_name(v.func))
                        elif isinstance(v, ast.Name):
                            name = param_types.get(v.id)
                        if name in self.classes:
                            types[t.attr] = name  # type: ignore[assignment]

    # -- function table ------------------------------------------------------

    def _collect_functions(self) -> None:
        for ctx in self.ctxs:
            for node, qual in ctx.functions:
                cls = qual.rsplit(".", 1)[0] if "." in qual else None
                if cls is not None and cls not in self.classes:
                    cls = None  # nested function, not a method
                self.fns[(ctx.path, qual)] = _FnInfo(
                    key=(ctx.path, qual), node=node, ctx=ctx, cls=cls
                )

    def _module_dotted(self, path: str) -> str:
        return path.removesuffix(".py").removesuffix("/__init__").replace("/", ".")

    def _resolve_call(
        self, info: _FnInfo, call: ast.Call
    ) -> tuple[str, str] | None:
        """(path, qualname) of the callee when it resolves to a scanned
        function; None for stdlib/duck-typed/unresolvable calls."""
        func = call.func
        ctx = info.ctx
        # self.m() -> method of the enclosing class
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
            and func.value.id == "self"
            and info.cls
        ):
            key = (ctx.path, f"{info.cls}.{func.attr}")
            return key if key in self.fns else None
        # self._x.m() -> method of the attribute's resolved class
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Attribute)
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "self"
            and info.cls
        ):
            owner = self.attr_types.get(info.cls, {}).get(func.value.attr)
            if owner:
                octx, _ = self.classes[owner]
                key = (octx.path, f"{owner}.{func.attr}")
                return key if key in self.fns else None
            return None
        # f() / imported f() / mod.f(), and C() / mod.C() as C.__init__ (the
        # port's alone: a lock taken in a constructor called under another
        # lock is an edge, events:_bus_guard -> events:_epoch_lock)
        canon = ctx.canonical(func)
        if canon is None:
            return None
        if "." not in canon:
            cpath, fn_name = ctx.path, canon
        else:
            mod_dotted, _, fn_name = canon.rpartition(".")
            cpath = self.by_module.get(mod_dotted)
            if cpath is None:
                return None
        for key in ((cpath, fn_name), (cpath, f"{fn_name}.__init__")):
            if key in self.fns:
                return key
        return None

    # -- per-function scan ---------------------------------------------------

    def _lock_id_of(self, info: _FnInfo, expr: ast.AST) -> str | None:
        """The lock identity a with-item / .acquire() target names."""
        # with self._lock:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and info.cls
        ):
            decl = self.class_locks.get(info.cls, {}).get(expr.attr)
            return decl.lock_id if decl else None
        # with MODULE_LOCK:
        if isinstance(expr, ast.Name):
            decl = self.module_locks.get(info.ctx.path, {}).get(expr.id)
            return decl.lock_id if decl else None
        return None

    def _scan_function(self, info: _FnInfo) -> None:
        def note_acquire(lid: str, line: int, held: tuple[str, ...]) -> None:
            info.acquires.setdefault(lid, line)
            for h in held:
                if h != lid:
                    info.edges.append((h, lid, line))
                elif self.locks[lid].kind != "rlock":
                    # re-acquiring a non-reentrant lock on the same thread is
                    # an immediate self-deadlock: a self-edge -> cycle
                    info.edges.append((h, lid, line))

        def visit_call(call: ast.Call, held: tuple[str, ...]) -> None:
            tail = _last(dotted_name(call.func))
            # lock method calls: acquire/release on a known lock
            if isinstance(call.func, ast.Attribute) and tail in (
                "acquire",
                "release",
            ):
                lid = self._lock_id_of(info, call.func.value)
                if lid and tail == "acquire":
                    note_acquire(lid, call.lineno, held)
                if lid:
                    return  # never treat lock methods as blocking/callees
            if _is_blocking(info.ctx, call, tail):
                info.blocks.setdefault(tail, call.lineno)
                if held:
                    info.held_blocks.append((held, call, tail))
            callee = self._resolve_call(info, call)
            if callee is not None and callee != info.key:
                info.calls.append((callee, call.lineno))
                if held:
                    info.held_calls.append((held, call, callee))
            elif held and isinstance(call.func, (ast.Name, ast.Attribute)):
                info.held_calls.append((held, call, None))

        def visit(node: ast.AST, held: tuple[str, ...]) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in node.items:
                    # the context expr itself evaluates under the locks
                    # already held, not the one it acquires
                    visit(item.context_expr, new_held)
                    lid = self._lock_id_of(info, item.context_expr)
                    if lid is not None:
                        note_acquire(lid, node.lineno, new_held)
                        if lid not in new_held:
                            new_held = new_held + (lid,)
                for child in node.body:
                    visit(child, new_held)
                return
            if isinstance(node, _FuncNode) and node is not info.node:
                return  # nested defs are their own _FnInfo
            if isinstance(node, ast.Call):
                visit_call(node, held)
            # .acquire() extends the held set for the REST of the enclosing
            # statement list (block-scoped approximation; `with` is the
            # sanctioned shape everywhere in this repo)
            body_fields = ("body", "orelse", "finalbody")
            for name, value in ast.iter_fields(node):
                if name in body_fields and isinstance(value, list):
                    blk_held = held
                    for child in value:
                        visit(child, blk_held)
                        blk_held = _extend_with_acquires(child, blk_held)
                elif isinstance(value, list):
                    for child in value:
                        if isinstance(child, ast.AST):
                            visit(child, held)
                elif isinstance(value, ast.AST):
                    visit(value, held)

        def _extend_with_acquires(
            stmt: ast.AST, held: tuple[str, ...]
        ) -> tuple[str, ...]:
            if not isinstance(stmt, ast.Expr) or not isinstance(
                stmt.value, ast.Call
            ):
                return held
            call = stmt.value
            tail = _last(dotted_name(call.func))
            if tail not in ("acquire", "release") or not isinstance(
                call.func, ast.Attribute
            ):
                return held
            lid = self._lock_id_of(info, call.func.value)
            if lid is None:
                return held
            if tail == "acquire" and lid not in held:
                return held + (lid,)
            if tail == "release":
                return tuple(h for h in held if h != lid)
            return held

        for child in ast.iter_child_nodes(info.node):
            if child in getattr(info.node, "decorator_list", []):
                continue
            visit(child, ())

    # -- interprocedural fixpoints -------------------------------------------

    def _fixpoints(self) -> None:
        for key, info in self.fns.items():
            self.may_acquire[key] = {lid: "" for lid in info.acquires}
            self.may_block[key] = {op: "" for op in info.blocks}
        changed = True
        while changed:
            changed = False
            for key, info in self.fns.items():
                for callee, _line in info.calls:
                    cq = self.fns[callee].ctx.qualname(self.fns[callee].node)
                    for lid, via in self.may_acquire[callee].items():
                        if lid not in self.may_acquire[key]:
                            self.may_acquire[key][lid] = (
                                cq if not via else f"{cq} -> {via}"
                            )
                            changed = True
                    for op, via in self.may_block[callee].items():
                        if op not in self.may_block[key]:
                            self.may_block[key][op] = (
                                cq if not via else f"{cq} -> {via}"
                            )
                            changed = True

    # -- graph ---------------------------------------------------------------

    def _add_edge(self, src: str, dst: str, site: dict) -> None:
        self.edges.setdefault((src, dst), []).append(site)

    def _build_edges(self) -> None:
        for key, info in self.fns.items():
            qual = info.ctx.qualname(info.node)
            for src, dst, line in info.edges:
                self._add_edge(
                    src, dst, {"path": info.ctx.path, "line": line, "fn": qual, "via": ""}
                )
            for held, call, callee in info.held_calls:
                if callee is None:
                    continue
                for lid, via in self.may_acquire[callee].items():
                    cq = self.fns[callee].ctx.qualname(self.fns[callee].node)
                    chain = cq if not via else f"{cq} -> {via}"
                    for h in held:
                        if h == lid and self.locks[lid].kind == "rlock":
                            continue  # RLock re-entry through the closure
                        self._add_edge(
                            h,
                            lid,
                            {
                                "path": info.ctx.path,
                                "line": call.lineno,
                                "fn": qual,
                                "via": chain,
                            },
                        )

    def cycles(self) -> list[list[str]]:
        """Elementary cycles in the acquisition-order graph (SCC-based:
        each SCC with >1 node reports one representative cycle; self-edges
        report themselves)."""
        adj: dict[str, set[str]] = {}
        for (src, dst) in self.edges:
            adj.setdefault(src, set()).add(dst)
            adj.setdefault(dst, set())
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on: set[str] = set()
        stack: list[str] = []
        sccs: list[list[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on.add(v)
            for w in sorted(adj.get(v, ())):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                sccs.append(comp)

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        out: list[list[str]] = []
        for comp in sccs:
            if len(comp) > 1:
                out.append(sorted(comp))
            elif (comp[0], comp[0]) in self.edges:
                out.append(comp)
        return sorted(out)

    # -- helpers -------------------------------------------------------------

    def finding(
        self, rule: str, ctx: ModuleContext, line: int, message: str
    ) -> Finding:
        """A Finding anchored like ctx.finding() but from a raw line."""
        fn = None
        for node, _qual in ctx.functions:
            if (
                getattr(node, "lineno", 1)
                <= line
                <= getattr(node, "end_lineno", 10**9)
            ):
                if fn is None or node.lineno >= fn.lineno:  # innermost
                    fn = node
        return Finding(
            rule=rule,
            path=ctx.path,
            line=line,
            message=message,
            context=ctx.qualname(fn) if fn is not None else "",
            text=ctx.line_text(line),
        )


# ---------------------------------------------------------------------------
# Rules over the model
# ---------------------------------------------------------------------------


def _findings_lock_order(model: ConcurrencyModel) -> list[Finding]:
    out: list[Finding] = []
    for cyc in model.cycles():
        # anchor each cycle at every participating edge's first site: any
        # one of them is the line a fix (or a reasoned suppression) lands on
        ring = " -> ".join(cyc + [cyc[0]])
        sites = []
        for i, a in enumerate(cyc):
            b = cyc[(i + 1) % len(cyc)]
            if (a, b) in model.edges:
                sites.append((a, b, model.edges[(a, b)][0]))
        for a, b, site in sites:
            ctx = model.by_path[site["path"]]
            via = f" (via {site['via']})" if site["via"] else ""
            out.append(
                model.finding(
                    "lock-order-inversion",
                    ctx,
                    site["line"],
                    f"lock-order cycle {ring}: {b} acquired while holding "
                    f"{a} here{via}: another path acquires them in the "
                    "opposite order; two threads walking the cycle from "
                    "different ends deadlock (static lock graph: "
                    f"{LOCKGRAPH_DIR}/)",
                )
            )
    return out


def _findings_blocking_under_lock(model: ConcurrencyModel) -> list[Finding]:
    out: list[Finding] = []
    for key, info in model.fns.items():
        qual = info.ctx.qualname(info.node)
        for held, call, op in info.held_blocks:
            out.append(
                model.finding(
                    "blocking-under-lock",
                    info.ctx,
                    call.lineno,
                    f"{op}() under held lock {held[-1]} in {qual}: every "
                    f"peer of {held[-1]} serializes behind this call; move "
                    "it outside the region or suppress with the reason the "
                    "hold is safe",
                )
            )
        for held, call, callee in info.held_calls:
            if callee is None:
                continue
            blocked = model.may_block.get(callee, {})
            if not blocked:
                continue
            cinfo = model.fns[callee]
            cq = cinfo.ctx.qualname(cinfo.node)
            op, via = sorted(blocked.items())[0]
            chain = cq if not via else f"{cq} -> {via}"
            out.append(
                model.finding(
                    "blocking-under-lock",
                    info.ctx,
                    call.lineno,
                    f"call to {cq} under held lock {held[-1]} in {qual} "
                    f"reaches blocking {op}() (through {chain}): every "
                    f"peer of {held[-1]} serializes behind it",
                )
            )
    return out


def _findings_sync_io_in_async(model: ConcurrencyModel) -> list[Finding]:
    out: list[Finding] = []
    for ctx in model.ctxs:
        if ctx.path not in project.ASYNC_SCOPED_FILES:
            continue
        for node, qual in ctx.functions:
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            info = model.fns[(ctx.path, qual)]

            skip: set[ast.AST] = set()  # executor-hopped subtrees
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and _last(
                    dotted_name(sub.func)
                ) in project.EXECUTOR_CALLS:
                    for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                        for inner in ast.walk(arg):
                            skip.add(inner)

            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call) or sub in skip:
                    continue
                fn_parent = ctx.enclosing_function(sub)
                if fn_parent is not node:
                    continue  # nested defs (incl. lambdas' bodies) are theirs
                tail = _last(dotted_name(sub.func))
                if _is_blocking(ctx, sub, tail, project.ASYNC_BLOCKING_CALLS):
                    out.append(
                        model.finding(
                            "sync-io-in-async",
                            ctx,
                            sub.lineno,
                            f"synchronous {tail}() inside async {qual}: it "
                            "parks the event loop (EVERY connection stalls, "
                            "not this request); hop through "
                            "loop.run_in_executor or an asyncio equivalent",
                        )
                    )
                    continue
                callee = model._resolve_call(info, sub)
                if callee is None:
                    continue
                cinfo = model.fns[callee]
                if isinstance(cinfo.node, ast.AsyncFunctionDef):
                    continue  # awaited coroutine: a loop citizen
                blocked = model.may_block.get(callee, {})
                if blocked:
                    cq = cinfo.ctx.qualname(cinfo.node)
                    op, via = sorted(blocked.items())[0]
                    chain = cq if not via else f"{cq} -> {via}"
                    out.append(
                        model.finding(
                            "sync-io-in-async",
                            ctx,
                            sub.lineno,
                            f"async {qual} calls sync {cq}, which reaches "
                            f"blocking {op}() ({chain}): the event loop "
                            "parks for the duration; hop through "
                            "loop.run_in_executor",
                        )
                    )
    return out


_SHARED_STATE_SCOPES = (
    "qdml_tpu_torch/serve/",
    "qdml_tpu_torch/fleet/",
    "qdml_tpu_torch/control/",
    "qdml_tpu_torch/telemetry/",
)


def _findings_unmapped_shared_state(model: ConcurrencyModel) -> list[Finding]:
    out: list[Finding] = []
    for ctx in model.ctxs:
        if not ctx.path.startswith(_SHARED_STATE_SCOPES):
            continue
        for cnode in ctx.nodes:
            if not isinstance(cnode, ast.ClassDef):
                continue
            mapped_attrs = set(
                model.lock_map.get(ctx.path, {}).get(cnode.name, {})
            )
            lock_attrs = set(model.class_locks.get(cnode.name, ()))
            safe_attrs = {
                a
                for a, t in _ctor_types(ctx, cnode).items()
                if t in _THREADSAFE_CTORS
            }

            methods = {
                n.name: n for n in cnode.body if isinstance(n, _FuncNode)
            }
            roots = _thread_roots(model, ctx, cnode, methods)

            # same-class call closure per root
            def closure(seed: str) -> set[str]:
                seen, frontier = set(), [seed]
                while frontier:
                    m = frontier.pop()
                    if m in seen or m not in methods:
                        continue
                    seen.add(m)
                    for sub in ast.walk(methods[m]):
                        if (
                            isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and isinstance(sub.func.value, ast.Name)
                            and sub.func.value.id == "self"
                            and sub.func.attr in methods
                        ):
                            frontier.append(sub.func.attr)
                return seen

            root_closures = {r: closure(r) for r in roots}
            rooted_methods = set().union(*root_closures.values()) if root_closures else set()

            # writes per entry: each root is one entry; every method NOT in
            # any root closure collectively forms the "caller thread" entry
            writers: dict[str, set[str]] = {}  # attr -> entry labels
            sites: dict[str, tuple[int, str]] = {}  # attr -> (line, method)
            for mname, mnode in methods.items():
                if mname == "__init__":
                    continue
                entries = [
                    f"thread:{r}" for r, cl in root_closures.items() if mname in cl
                ]
                if mname not in rooted_methods:
                    entries.append("caller")
                for sub in ast.walk(mnode):
                    for t in _assign_targets(sub):
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            attr = t.attr
                            if (
                                attr in mapped_attrs
                                or attr in lock_attrs
                                or attr in safe_attrs
                            ):
                                continue
                            writers.setdefault(attr, set()).update(entries)
                            if attr not in sites or sub.lineno < sites[attr][0]:
                                sites[attr] = (sub.lineno, mname)
            for attr, entries in sorted(writers.items()):
                if len(entries) < 2:
                    continue
                line, mname = sites[attr]
                names = ", ".join(sorted(entries))
                out.append(
                    model.finding(
                        "unmapped-shared-state",
                        ctx,
                        line,
                        f"{cnode.name}.{attr} is written from {len(entries)} "
                        f"distinct thread entry points ({names}) but has no "
                        "LOCK_MAP row: add the row (analysis/project.py) so "
                        "serve-lock-discipline guards it, or suppress with "
                        "the reason it is single-threaded after all",
                    )
                )
    return out


def _ctor_types(ctx: ModuleContext, cnode: ast.ClassDef) -> dict[str, str]:
    """attr -> constructor tail for ``self.x = Ctor()`` assignments."""
    out: dict[str, str] = {}
    for sub in ast.walk(cnode):
        if not (isinstance(sub, ast.Assign) and len(sub.targets) == 1):
            continue
        t = sub.targets[0]
        if (
            isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
            and isinstance(sub.value, ast.Call)
        ):
            out[t.attr] = _last(
                ctx.canonical(sub.value.func) or dotted_name(sub.value.func)
            )
    return out


def _thread_roots(
    model: ConcurrencyModel,
    ctx: ModuleContext,
    cnode: ast.ClassDef,
    methods: dict[str, ast.AST],
) -> set[str]:
    """Methods of ``cnode`` that run on another thread: Thread targets,
    done-callbacks, call_soon_threadsafe callables (searched module-wide:
    the pool that spawns the thread may be another class) plus every
    ``async def`` method (the event-loop context)."""
    roots = {
        name
        for name, node in methods.items()
        if isinstance(node, ast.AsyncFunctionDef)
    }
    for sub in ctx.nodes:
        if not isinstance(sub, ast.Call):
            continue
        if _last(dotted_name(sub.func)) not in project.THREAD_ROOT_CALLS:
            continue
        for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
            for inner in ast.walk(arg):
                if (
                    isinstance(inner, ast.Attribute)
                    and inner.attr in methods
                    and isinstance(inner.value, ast.Name)
                ):
                    roots.add(inner.attr)
    return roots


def _findings_dead_lock_map(model: ConcurrencyModel) -> list[Finding]:
    out: list[Finding] = []
    # anchor file/class-level misses at the LOCK_MAP literal itself
    proj_ctx = model.by_path.get(PROJECT_PATH)
    map_line = 1
    if proj_ctx is not None:
        for node in proj_ctx.tree.body:
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
                if isinstance(node, ast.AnnAssign)
                else []
            )
            if any(
                isinstance(t, ast.Name) and t.id == "LOCK_MAP" for t in targets
            ):
                map_line = node.lineno

    def map_finding(message: str) -> Finding | None:
        if proj_ctx is None:
            return None
        return model.finding(
            "dead-lock-map-entry", proj_ctx, map_line, message
        )

    for path, cls_map in sorted(model.lock_map.items()):
        ctx = model.by_path.get(path)
        if ctx is None:
            f = map_finding(
                f"LOCK_MAP names {path!r}, which is not in the scanned tree "
                "(the rename/delete silently disarmed serve-lock-discipline "
                "for every row under it)"
            )
            if f:
                out.append(f)
            continue
        class_nodes = {
            n.name: n for n in ctx.nodes if isinstance(n, ast.ClassDef)
        }
        for cls, attrs in sorted(cls_map.items()):
            cnode = class_nodes.get(cls)
            if cnode is None:
                f = map_finding(
                    f"LOCK_MAP names class {cls!r} in {path}, which no "
                    "longer exists: update or drop the rows"
                )
                if f:
                    out.append(f)
                continue
            assigned = {
                t.attr
                for sub in ast.walk(cnode)
                for t in _assign_targets(sub)
                if isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
            }
            for attr, lock in sorted(attrs.items()):
                if attr not in assigned:
                    out.append(
                        model.finding(
                            "dead-lock-map-entry",
                            ctx,
                            cnode.lineno,
                            f"LOCK_MAP row {cls}.{attr} -> {lock}: "
                            f"self.{attr} is never assigned in {cls}: the "
                            "attribute was renamed/removed and the row is "
                            "dead",
                        )
                    )
                if attr in assigned and lock not in model.class_locks.get(
                    cls, {}
                ):
                    out.append(
                        model.finding(
                            "dead-lock-map-entry",
                            ctx,
                            cnode.lineno,
                            f"LOCK_MAP row {cls}.{attr} -> {lock}: "
                            f"self.{lock} is not constructed as a lock in "
                            f"{cls}: the lock was renamed/removed and the "
                            "row cannot be enforced",
                        )
                    )
    return out


def _assign_targets(node: ast.AST) -> list[ast.expr]:
    """Flattened assignment targets: `self._a, self._b = f()` counts both."""
    if isinstance(node, ast.Assign):
        targets = list(node.targets)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    else:
        return []
    flat: list[ast.expr] = []
    stack = targets
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        else:
            flat.append(t)
    return flat


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def load_contexts(
    root: str, files: Iterable[str]
) -> tuple[list[ModuleContext], list[str]]:
    """Parse ``files`` (repo-relative) into ModuleContexts; unparseable files
    come back as error strings (the per-module pass reports them too: the
    concurrency model just skips them)."""
    ctxs: list[ModuleContext] = []
    errors: list[str] = []
    for relpath in files:
        abspath = os.path.join(root, relpath)
        try:
            with open(abspath, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=relpath)
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(f"{relpath}: {type(e).__name__}: {e}")
            continue
        ctxs.append(ModuleContext(abspath, relpath, source, tree))
    return ctxs, errors


def analyze_modules(
    ctxs: list[ModuleContext],
    lock_map: dict[str, dict[str, dict[str, str]]] | None = None,
) -> tuple[dict[str, list[Finding]], ConcurrencyModel]:
    """Run the whole-program pass over parsed modules. Returns findings
    grouped by path (for the engine to merge BEFORE suppression processing)
    plus the model (for lock-graph rendering)."""
    model = ConcurrencyModel(ctxs, lock_map=lock_map)
    findings: list[Finding] = []
    findings += _findings_lock_order(model)
    findings += _findings_blocking_under_lock(model)
    findings += _findings_sync_io_in_async(model)
    findings += _findings_unmapped_shared_state(model)
    findings += _findings_dead_lock_map(model)
    grouped: dict[str, list[Finding]] = {}
    for f in findings:
        grouped.setdefault(f.path, []).append(f)
    return grouped, model


def analyze_files(
    root: str,
    paths: Iterable[str] | None = None,
    lock_map: dict[str, dict[str, dict[str, str]]] | None = None,
) -> tuple[dict[str, list[Finding]], ConcurrencyModel]:
    paths = list(paths) if paths is not None else list(project.DEFAULT_PATHS)
    files = iter_python_files(root, paths)
    ctxs, _errors = load_contexts(root, files)
    return analyze_modules(ctxs, lock_map=lock_map)


# ---------------------------------------------------------------------------
# Lock-graph artifact (qdml_tpu_torch/analysis/lockgraph/)
# ---------------------------------------------------------------------------


def lockgraph_json(model: ConcurrencyModel) -> dict:
    """Deterministic JSON-able graph record: byte-stable across runs so the
    tier-1 freshness check can literal-compare regenerated vs committed."""
    nodes = [
        {
            "id": d.lock_id,
            "kind": d.kind,
            "path": d.path,
            "line": d.line,
            "class": d.cls,
            "mapped": d.mapped,
        }
        for d in sorted(model.locks.values(), key=lambda d: d.lock_id)
    ]
    edges = []
    for (src, dst), sites in sorted(model.edges.items()):
        uniq = sorted(
            {(s["path"], s["line"], s["fn"], s["via"]) for s in sites}
        )
        edges.append(
            {
                "src": src,
                "dst": dst,
                "sites": [
                    {"path": p, "line": ln, "fn": fn, "via": via}
                    for p, ln, fn, via in uniq
                ],
            }
        )
    return {
        "schema": 1,
        "kind": "lockgraph",
        "tool": f"{LINT_CMD} --lockgraph",
        "nodes": nodes,
        "edges": edges,
        "cycles": model.cycles(),
    }


def _levels(graph: dict) -> dict[str, int]:
    """Longest-path layering of the (acyclic) edge set: level 0 = acquired
    first. Nodes in a cycle (should never be committed) share level -1."""
    cyc_nodes = {n for cyc in graph["cycles"] for n in cyc}
    adj: dict[str, list[str]] = {}
    indeg: dict[str, int] = {n["id"]: 0 for n in graph["nodes"]}
    for e in graph["edges"]:
        if e["src"] in cyc_nodes or e["dst"] in cyc_nodes:
            continue
        adj.setdefault(e["src"], []).append(e["dst"])
        indeg.setdefault(e["src"], indeg.get(e["src"], 0))
        indeg[e["dst"]] = indeg.get(e["dst"], 0) + 1
    level = {n: 0 for n in indeg}
    frontier = sorted(n for n, d in indeg.items() if d == 0)
    while frontier:
        v = frontier.pop()
        for w in adj.get(v, ()):
            level[w] = max(level[w], level[v] + 1)
            indeg[w] -= 1
            if indeg[w] == 0:
                frontier.append(w)
    for n in cyc_nodes:
        level[n] = -1
    return level


def lockgraph_dot(graph: dict) -> str:
    lines = [
        f"// generated by `{LINT_CMD} --lockgraph`: do not edit",
        "digraph lockgraph {",
        "  rankdir=LR;",
        '  node [shape=box, fontname="monospace"];',
    ]
    for n in graph["nodes"]:
        shape = ' style="rounded"' if n["kind"] == "rlock" else ""
        fill = ' fillcolor="lightyellow" style="filled"' if not n["mapped"] else ""
        lines.append(
            f'  "{n["id"]}" [label="{n["id"]}\\n({n["kind"]})"{shape}{fill}];'
        )
    for e in graph["edges"]:
        s = e["sites"][0]
        lines.append(
            f'  "{e["src"]}" -> "{e["dst"]}" '
            f'[label="{s["path"]}:{s["line"]}"];'
        )
    lines.append("}")
    return "\n".join(lines) + "\n"


def lockgraph_markdown(graph: dict) -> str:
    level = _levels(graph)
    by_level: dict[int, list[dict]] = {}
    for n in graph["nodes"]:
        by_level.setdefault(level.get(n["id"], 0), []).append(n)
    out_edges: dict[str, list[dict]] = {}
    for e in graph["edges"]:
        out_edges.setdefault(e["src"], []).append(e)
    lines = [
        "# Lock hierarchy (generated)",
        "",
        f"Generated by `{LINT_CMD} --lockgraph`: do not edit by hand;",
        "`lint --lockgraph-check` compares a regenerated graph against this",
        "directory. Level = longest acquisition chain",
        "leading here: a level-N lock may only be acquired while holding",
        "locks of level < N (edges point acquired-while-holding).",
        "",
        "| level | lock | kind | declared | LOCK_MAP | acquired while holding it |",
        "|---|---|---|---|---|---|",
    ]
    for lvl in sorted(by_level):
        for n in sorted(by_level[lvl], key=lambda n: n["id"]):
            dsts = sorted({e["dst"] for e in out_edges.get(n["id"], ())})
            lines.append(
                f"| {lvl} | `{n['id']}` | {n['kind']} | "
                f"`{n['path']}:{n['line']}` | "
                f"{'yes' if n['mapped'] else 'no'} | "
                f"{', '.join(f'`{d}`' for d in dsts) if dsts else '-'} |"
            )
    lines += [
        "",
        f"Edges: {len(graph['edges'])} · locks: {len(graph['nodes'])} · "
        f"cycles: {len(graph['cycles'])} (the lint gate pins this at 0)",
        "",
    ]
    return "\n".join(lines)


def write_lockgraph(model: ConcurrencyModel, out_dir: str) -> dict:
    graph = lockgraph_json(model)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lockgraph.json"), "w") as fh:
        json.dump(graph, fh, indent=2, sort_keys=True)
        fh.write("\n")
    with open(os.path.join(out_dir, "lockgraph.dot"), "w") as fh:
        fh.write(lockgraph_dot(graph))
    with open(os.path.join(out_dir, "LOCKGRAPH.md"), "w") as fh:
        fh.write(lockgraph_markdown(graph))
    return graph


def check_lockgraph(model: ConcurrencyModel, out_dir: str) -> list[str]:
    """Freshness check: regenerated graph must equal the committed one.
    Returns human-readable mismatch strings (empty = fresh)."""
    problems: list[str] = []
    graph = lockgraph_json(model)
    path = os.path.join(out_dir, "lockgraph.json")
    if not os.path.exists(path):
        return [f"{path}: missing: run `{LINT_CMD} --lockgraph={out_dir}`"]
    with open(path) as fh:
        committed = json.load(fh)
    if committed != graph:
        problems.append(
            f"{path}: stale: the committed lock graph does not match the "
            f"tree (run `{LINT_CMD} --lockgraph={out_dir}` and commit)"
        )
    for name, render in (
        ("lockgraph.dot", lockgraph_dot(graph)),
        ("LOCKGRAPH.md", lockgraph_markdown(graph)),
    ):
        p = os.path.join(out_dir, name)
        if not os.path.exists(p):
            problems.append(f"{p}: missing")
            continue
        with open(p) as fh:
            if fh.read() != render:
                problems.append(f"{p}: stale (regenerate with --lockgraph)")
    return problems
