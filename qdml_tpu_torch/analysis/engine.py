"""The lint engine of the port (a copy of ``qdml_tpu/analysis/engine.py``):
AST module model, suppressions, baseline, orchestration.

The engine parses each file once into a :class:`ModuleContext` carrying the
facts every rule shares (module-level mutable state, import aliases, a
parent map, enclosing functions), then runs the rule set
(:mod:`qdml_tpu_torch.analysis.rules`) over it.

Two allowlist layers keep the gate at zero findings without hiding new
regressions:

- per-line suppressions: ``# lint: disable=rule-id(written reason)`` on the
  offending line. A reason is REQUIRED: a suppression without one does not
  suppress (allowlist with a reason, or fix);
- a checked-in baseline (``qdml_tpu_torch/analysis/lint_baseline.json``):
  fingerprinted grandfathered findings (rule + file + enclosing def +
  normalized source text; line-number free, so unrelated edits do not
  invalidate entries). ``--baseline`` subtracts it; anything NOT in it is a
  *new* finding and fails the gate.

Findings, fingerprints, suppressions and the gate's JSON are the JAX
package's, so the two engines' outputs compare field for field. JAX's
jit reachability (``ModuleContext.traced``) has a torch counterpart,
``ModuleContext.captured``: the functions that run while a CUDA graph is
captured or inside a kernel wrapper, which seed the tracing rules' torch
counterparts. ``LintEngine.run`` runs the whole-program concurrency pass
(:mod:`qdml_tpu_torch.analysis.concurrency`) over the scanned set. Standard
library only.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable


# ---------------------------------------------------------------------------
# Findings
# ---------------------------------------------------------------------------


@dataclass
class Finding:
    """One lint violation, anchored to a source line."""

    rule: str
    path: str           # repo-relative, forward slashes
    line: int           # 1-based
    message: str
    context: str = ""   # enclosing qualname ("Class.method"), "" at module level
    text: str = ""      # stripped source line (fingerprint input)
    suppressed: bool = False
    reason: str | None = None  # suppression/baseline reason when allowlisted

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity for baseline matching: unrelated edits
        that shift lines must not invalidate grandfathered entries, while
        editing the offending line itself (or moving it to another function)
        re-arms the gate."""
        key = f"{self.rule}|{self.path}|{self.context}|{self.text}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "context": self.context,
            "message": self.message,
            "text": self.text,
            "fingerprint": self.fingerprint,
            "suppressed": self.suppressed,
            "reason": self.reason,
        }


# ---------------------------------------------------------------------------
# Per-line suppressions
# ---------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=(?P<items>.+?)\s*$")
_ITEM_RE = re.compile(r"(?P<rule>[\w.-]+)\s*(?:\((?P<reason>.*)\))?", re.DOTALL)


def _split_items(items: str) -> list[str]:
    """Split ``rule-a(reason),rule-b(reason)`` on top-level commas only:
    reasons may themselves contain parenthesized asides and commas."""
    out, depth, cur = [], 0, []
    for ch in items:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [s.strip() for s in out if s.strip()]


def parse_suppressions(source: str) -> dict[int, dict[str, str | None]]:
    """``{line -> {rule-id -> reason}}`` from trailing lint-disable comments.

    Syntax: ``# lint: disable=<rule-a>(<reason>),<rule-b>(<reason>)`` (the
    angle brackets are placeholders; they keep this docstring from parsing
    as a suppression, since the scan is line-based and cannot see string
    literals). The reason is mandatory for the suppression to take effect; a
    missing one is recorded as ``None`` and the engine turns it into a
    ``bare-suppression`` finding instead of honoring it.
    """
    out: dict[int, dict[str, str | None]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules: dict[str, str | None] = {}
        for item in _split_items(m.group("items")):
            im = _ITEM_RE.fullmatch(item)
            if not im:
                continue
            reason = im.group("reason")
            rules[im.group("rule")] = reason.strip() if reason and reason.strip() else None
        if rules:
            out[i] = rules
    return out


# ---------------------------------------------------------------------------
# Module model
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_MUTABLE_CTORS = {"dict", "list", "set", "deque", "defaultdict", "Counter", "OrderedDict"}

_FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class ModuleContext:
    """Parsed module + the shared facts rules consume."""

    def __init__(self, abspath: str, relpath: str, source: str, tree: ast.Module):
        self.abspath = abspath
        self.path = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.suppressions = parse_suppressions(source)

        # every node once, in ast.walk's order: the rules' module-wide scans
        # iterate this list instead of walking the tree again each
        self.nodes: list[ast.AST] = list(ast.walk(tree))
        self.parent: dict[ast.AST, ast.AST] = {}
        for node in self.nodes:
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node

        # function defs with qualnames
        self.functions: list[tuple[ast.AST, str]] = []
        self._qualname: dict[ast.AST, str] = {}
        self._collect_functions(tree, prefix="")
        self._by_name: dict[str, list[ast.AST]] = {}
        for node, _qual in self.functions:
            self._by_name.setdefault(node.name, []).append(node)

        self.aliases = self._collect_aliases()
        self.mutable_globals = self._collect_mutable_globals()
        self.captured = self._collect_captured()

    # -- construction helpers ------------------------------------------------

    def _collect_functions(self, node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FuncNode):
                qual = f"{prefix}{child.name}"
                self.functions.append((child, qual))
                self._qualname[child] = qual
                self._collect_functions(child, prefix=f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                self._collect_functions(child, prefix=f"{prefix}{child.name}.")
            else:
                self._collect_functions(child, prefix=prefix)

    def _collect_aliases(self) -> dict[str, str]:
        """local name -> canonical dotted module/object it refers to."""
        out: dict[str, str] = {}
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def canonical(self, node: ast.AST) -> str | None:
        """Dotted name with the leading alias resolved through the imports
        (``dist.barrier`` -> ``torch.distributed.barrier``)."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        full = self.aliases.get(head, head)
        return f"{full}.{rest}" if rest else full

    def _collect_mutable_globals(self) -> set[str]:
        out: set[str] = set()
        for node in self.tree.body:
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            mutable = isinstance(
                value, (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp, ast.SetComp)
            ) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in _MUTABLE_CTORS
            )
            if not mutable:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
        return out

    def _collect_captured(self) -> set[ast.AST]:
        """Functions that run while a CUDA graph is captured or inside a
        kernel wrapper: the port's counterpart of JAX's jit reachability
        (``qdml_tpu/analysis/engine.py:_collect_traced``). Roots:

        - functions passed by name (anywhere in the call, as through
          ``_step_fn(model, opt)``) into ``project.CAPTURE_ENTRY_POINTS``
          (``make_scan_steps``, ``make_graphed_callables``);
        - the callees of a ``with torch.cuda.graph(...)`` block;
        - ``forward``/``backward`` of ``torch.autograd.Function`` subclasses;
        - the functions that reach ``project.KERNEL_LAUNCH_CALLS`` (the
          kernel wrappers of ``quantum/kernels.py``);

        plus every same-module function a captured function calls by name,
        or, from a method, as ``self.m()`` (fixpoint)."""
        from qdml_tpu_torch.analysis.project import CAPTURE_ENTRY_POINTS, KERNEL_LAUNCH_CALLS

        captured: set[ast.AST] = set()
        by_qual = {qual: node for node, qual in self.functions}

        def callees(fn: ast.AST, call: ast.Call) -> list[ast.AST]:
            if isinstance(call.func, ast.Name):
                return self._by_name.get(call.func.id, [])
            if (
                isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "self"
            ):
                owner = self.qualname(fn).rpartition(".")[0]
                method = by_qual.get(f"{owner}.{call.func.attr}") if owner else None
                return [method] if method is not None else []
            return []

        for node in self.nodes:
            # names passed (possibly through nested calls) into an entry point
            if isinstance(node, ast.Call):
                callee = dotted_name(node.func)
                if callee is not None and callee.rsplit(".", 1)[-1] in CAPTURE_ENTRY_POINTS:
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Name):
                            captured.update(self._by_name.get(sub.id, []))
            # the callees of a graph capture's block
            elif isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and (self.canonical(item.context_expr.func) or "").endswith("cuda.graph")
                for item in node.items
            ):
                fn = self.enclosing_function(node)
                for stmt in node.body:
                    for sub in ast.walk(stmt):
                        if isinstance(sub, ast.Call):
                            captured.update(callees(fn, sub))
            # an autograd Function's forward and backward
            elif isinstance(node, ast.ClassDef) and any(
                (self.canonical(b) or "").endswith("autograd.Function") for b in node.bases
            ):
                for item in node.body:
                    if isinstance(item, _FuncNode) and item.name in ("forward", "backward"):
                        captured.add(item)

        # the kernel wrappers: functions that reach the raw launch, by a call
        # or through a module-level name bound to something that does (the
        # autograd Function _QSCExpvals = _kernel_fwd_plain_bwd(_qsc_launch,
        # ...), which fused_qsc_expvals applies)
        reach = set(KERNEL_LAUNCH_CALLS)
        changed = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id in reach for n in self.nodes
        )
        while changed:
            changed = False
            for node in self.tree.body:
                if isinstance(node, ast.Assign) and any(
                    isinstance(sub, ast.Name) and sub.id in reach for sub in ast.walk(node.value)
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id not in reach:
                            reach.add(t.id)
                            changed = True
            for fn, _qual in self.functions:
                if fn.name in reach:
                    continue
                if any(
                    isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) and sub.id in reach
                    for sub in ast.walk(fn)
                ):
                    reach.add(fn.name)
                    captured.add(fn)
                    changed = True

        # propagate through same-module calls
        frontier = list(captured)
        while frontier:
            fn = frontier.pop()
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    for callee_fn in callees(fn, sub):
                        if callee_fn not in captured:
                            captured.add(callee_fn)
                            frontier.append(callee_fn)
        return captured

    # -- rule helpers --------------------------------------------------------

    def qualname(self, node: ast.AST) -> str:
        return self._qualname.get(node, "")

    def enclosing_function(self, node: ast.AST) -> ast.AST | None:
        cur = self.parent.get(node)
        while cur is not None and not isinstance(cur, _FuncNode):
            cur = self.parent.get(cur)
        return cur

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        fn = self.enclosing_function(node)
        return Finding(
            rule=rule,
            path=self.path,
            line=line,
            message=message,
            context=self.qualname(fn) if fn is not None else "",
            text=self.line_text(line),
        )


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

BASELINE_DEFAULT = os.path.join("qdml_tpu_torch", "analysis", "lint_baseline.json")
GRANDFATHER_REASON = "grandfathered at gate introduction (see README, the port's lint gate)"


def load_baseline(path: str) -> dict[str, dict]:
    """fingerprint -> entry. Missing file = empty baseline."""
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        data = json.load(fh)
    return {e["fingerprint"]: e for e in data.get("entries", [])}


def save_baseline(path: str, findings: list[Finding], previous: dict[str, dict] | None = None) -> int:
    """Write the baseline for ``findings``; reasons from ``previous`` entries
    that still match are preserved (a regenerate must not erase triage
    notes). Returns the entry count."""
    previous = previous or {}
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        old = previous.get(f.fingerprint)
        entries.append(
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "path": f.path,
                "context": f.context,
                "text": f.text,
                "reason": (old or {}).get("reason") or GRANDFATHER_REASON,
            }
        )
    payload = {
        "version": 1,
        "tool": "python -m qdml_tpu_torch.cli lint",
        "note": (
            "Grandfathered findings (fingerprint = rule+file+def+line text; "
            "line-number free). Regenerate with `python -m qdml_tpu_torch.cli "
            "lint --write-baseline`; existing reasons are preserved."
        ),
        "entries": entries,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")
    return len(entries)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclass
class LintResult:
    new: list[Finding] = field(default_factory=list)          # fail the gate
    suppressed: list[Finding] = field(default_factory=list)   # inline-allowlisted
    baselined: list[Finding] = field(default_factory=list)    # grandfathered
    errors: list[str] = field(default_factory=list)           # unparseable files

    @property
    def ok(self) -> bool:
        return not self.new and not self.errors

    def to_json(self) -> dict:
        per_rule: dict[str, int] = {}
        for f in self.new:
            per_rule[f.rule] = per_rule.get(f.rule, 0) + 1
        return {
            "schema": 1,
            "kind": "lint_gate",
            "ok": self.ok,
            "new_findings": len(self.new),
            "suppressed": len(self.suppressed),
            "baselined": len(self.baselined),
            "per_rule": dict(sorted(per_rule.items())),
            "errors": self.errors,
            "findings": [f.to_json() for f in self.new],
        }


def iter_python_files(
    root: str, paths: Iterable[str], missing: list[str] | None = None
) -> list[str]:
    """Repo-relative *.py files under the given paths (files or directories),
    sorted, __pycache__ excluded. Paths that exist as neither are appended to
    ``missing``: a typo'd --paths (or a renamed DEFAULT_PATHS entry) must
    fail the gate, not scan nothing and report green."""
    out: list[str] = []
    for p in paths:
        absp = os.path.join(root, p)
        if os.path.isfile(absp) and p.endswith(".py"):
            out.append(p)
            continue
        if not os.path.isdir(absp):
            if missing is not None:
                missing.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(absp):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.relpath(os.path.join(dirpath, fn), root))
    return sorted(set(out))


class LintEngine:
    """Run the rule set over a file list, apply suppressions and baseline."""

    def __init__(self, root: str, rules: list[Callable[[ModuleContext], list[Finding]]] | None = None):
        self.root = root
        if rules is None:
            from qdml_tpu_torch.analysis.rules import all_rules

            rules = all_rules()
        self.rules = rules
        # the concurrency model from the last whole_program run(), for the
        # CLI's --lockgraph rendering and freshness check
        self.model = None

    def lint_file(
        self, relpath: str, pre: Iterable[Finding] = (), ctx: ModuleContext | None = None
    ) -> tuple[list[Finding], str | None]:
        """Run the per-module rules over one file. ``pre`` carries findings a
        whole-program pass already produced for this path, merged BEFORE
        suppression processing so an inline ``# lint: disable=...`` works on
        them and a stale one is flagged dead-suppression like any other;
        ``ctx`` is the file's parse from that pass, when there was one."""
        if ctx is None:
            abspath = os.path.join(self.root, relpath)
            try:
                with open(abspath, encoding="utf-8") as fh:
                    source = fh.read()
                tree = ast.parse(source, filename=relpath)
            except (OSError, SyntaxError, ValueError) as e:
                return [], f"{relpath}: {type(e).__name__}: {e}"
            ctx = ModuleContext(abspath, relpath, source, tree)
        findings: list[Finding] = []
        seen_lines: set[tuple[str, int]] = set()
        for rule in self.rules:
            for f in rule(ctx):
                # one finding per (rule, line): two hits on one line share a
                # fingerprint, and a duplicate would double-count in the gate
                # while a single baseline entry silently absorbed both
                if (f.rule, f.line) in seen_lines:
                    continue
                seen_lines.add((f.rule, f.line))
                findings.append(f)
        for f in pre:
            if (f.rule, f.line) in seen_lines:
                continue
            seen_lines.add((f.rule, f.line))
            findings.append(f)
        # apply per-line suppressions; reason-less ones become findings
        for f in findings:
            sup = ctx.suppressions.get(f.line, {})
            if f.rule in sup:
                reason = sup[f.rule]
                if reason:
                    f.suppressed = True
                    f.reason = reason
                else:
                    f.message += (
                        "  [a lint-disable comment matched but carries no "
                        "(reason): reasons are mandatory, see README's lint gate]"
                    )
        # Suppressions that never matched anything are dead weight: flag
        # reason-less ones as bare-suppression (the '(reason)' policy stays
        # machine-enforced even when the finding is gone) and reasoned ones
        # as dead-suppression (a stale comment claims a hazard the rule no
        # longer sees: either the code was fixed, so remove it, or the rule
        # cannot see the hazard, so the comment is false documentation).
        for line, rules in ctx.suppressions.items():
            for rule_id, reason in rules.items():
                if any(f.line == line and f.rule == rule_id for f in findings):
                    continue
                if reason is None:
                    findings.append(
                        Finding(
                            rule="bare-suppression",
                            path=ctx.path,
                            line=line,
                            message=(
                                f"lint-disable for {rule_id!r} has no (reason); "
                                "suppressions without a written reason do not count"
                            ),
                            text=ctx.line_text(line),
                        )
                    )
                else:
                    findings.append(
                        Finding(
                            rule="dead-suppression",
                            path=ctx.path,
                            line=line,
                            message=(
                                f"lint-disable for {rule_id!r} matches no "
                                "finding on this line: remove the stale "
                                "comment (or fix the rule if the hazard is real)"
                            ),
                            text=ctx.line_text(line),
                        )
                    )
        return findings, None

    def run(
        self,
        paths: Iterable[str],
        baseline: dict[str, dict] | None = None,
        extra_findings: Iterable[Finding] = (),
        whole_program: bool = True,
        restrict_to: Iterable[str] | None = None,
    ) -> LintResult:
        """``whole_program`` additionally runs the interprocedural
        concurrency pass over the full scanned set: its findings reach each
        file through ``lint_file``'s ``pre``, and its model stays on
        ``self.model`` for the lock graph. ``restrict_to`` filters the
        REPORT to the given repo-relative paths without narrowing the scan:
        ``--changed-only`` needs the whole program to resolve the call
        closure, but only the touched files' findings."""
        result = LintResult()
        all_findings: list[Finding] = list(extra_findings)
        missing: list[str] = []
        files = iter_python_files(self.root, paths, missing=missing)
        pre_by_path: dict[str, list[Finding]] = {}
        parsed: dict[str, ModuleContext] = {}
        if whole_program:
            from qdml_tpu_torch.analysis import concurrency

            ctxs, _errs = concurrency.load_contexts(self.root, files)
            pre_by_path, self.model = concurrency.analyze_modules(ctxs)
            parsed = {c.path: c for c in ctxs}  # an unparseable file is parsed again and reported
        for relpath in files:
            findings, err = self.lint_file(
                relpath, pre=pre_by_path.get(relpath, ()), ctx=parsed.get(relpath.replace(os.sep, "/"))
            )
            if err is not None:
                result.errors.append(err)
            all_findings.extend(findings)
        for p in missing:
            result.errors.append(
                f"{p}: no such file or directory: a gate that scans nothing "
                "must not pass"
            )
        if restrict_to is not None:
            keep = set(restrict_to)
            all_findings = [f for f in all_findings if f.path in keep]
            result.errors = [
                e for e in result.errors if e.split(":", 1)[0] in keep
            ]
        baseline = baseline or {}
        for f in sorted(all_findings, key=lambda f: (f.path, f.line, f.rule)):
            if f.suppressed:
                result.suppressed.append(f)
            elif f.fingerprint in baseline:
                f.reason = baseline[f.fingerprint].get("reason")
                result.baselined.append(f)
            else:
                result.new.append(f)
        return result
