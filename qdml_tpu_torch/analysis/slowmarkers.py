"""The slow-marker rule of the port (``qdml_tpu/analysis/slowmarkers.py``):
every test over the tier-1 wall-clock threshold must be
``@pytest.mark.slow`` or grandfathered in the committed allowlist.

The rule is data-driven: it needs a ``pytest --durations=0`` report from a
real run, so ``python -m qdml_tpu_torch.cli lint`` includes it only when
given ``--durations=FILE``. The port's gate is fed its own tests' report
(``tests/test_torch_*.py``); the JAX package's tests have JAX's allowlist.

The allowlist (``qdml_tpu_torch/analysis/tier1_slow_allowlist.txt``) exists
because "slow" is not the same as "optional": the port's tests that hold a
trainer, a world of ranks or a serving tier against the JAX package exceed
any per-test threshold on a small host yet ARE the tier-1 acceptance
coverage; marking them ``slow`` would deselect the gate itself. New
offenders outside that committed set fail the lint, so unbudgeted slowness
cannot land silently. The logic is JAX's, line for line.
"""

from __future__ import annotations

import ast
import os
import re

from qdml_tpu_torch.analysis.engine import Finding

RULE_ID = "slow-marker"
DEFAULT_THRESHOLD_S = 5.0
DEFAULT_ALLOWLIST = os.path.join("qdml_tpu_torch", "analysis", "tier1_slow_allowlist.txt")

# "12.34s call     tests/test_x.py::test_y[param]" — only the call phase
# counts (setup/teardown time belongs to fixtures, which the marker on the
# test cannot deselect on its own).
_DURATION_RE = re.compile(
    r"^\s*(?P<secs>\d+(?:\.\d+)?)s\s+call\s+(?P<nodeid>\S+)\s*$"
)


def parse_durations(text: str) -> dict[str, float]:
    """nodeid -> call seconds, max over parametrizations."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        m = _DURATION_RE.match(line)
        if not m:
            continue
        nodeid = m.group("nodeid").split("[", 1)[0]  # fold parametrizations
        secs = float(m.group("secs"))
        out[nodeid] = max(secs, out.get(nodeid, 0.0))
    return out


def _decorators_mark_slow(dec_list) -> bool:
    for dec in dec_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        # pytest.mark.slow -> Attribute(attr='slow', value=Attribute(attr='mark'))
        if isinstance(target, ast.Attribute) and target.attr == "slow":
            v = target.value
            if isinstance(v, ast.Attribute) and v.attr == "mark":
                return True
    return False


def has_slow_marker(path: str, test_name: str) -> bool:
    """True when the test function (or its class / module pytestmark) carries
    pytest.mark.slow. Source-level check: no pytest import, no collection."""
    try:
        with open(path) as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return False

    def module_marked() -> bool:
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark" for t in node.targets
            ):
                vals = (
                    node.value.elts if isinstance(node.value, (ast.List, ast.Tuple))
                    else [node.value]
                )
                if _decorators_mark_slow(vals):
                    return True
        return False

    def walk(body, inherited: bool) -> bool | None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name == test_name:
                    return inherited or _decorators_mark_slow(node.decorator_list)
            elif isinstance(node, ast.ClassDef):
                found = walk(
                    node.body, inherited or _decorators_mark_slow(node.decorator_list)
                )
                if found is not None:
                    return found
        return None

    found = walk(tree.body, module_marked())
    return bool(found)


def load_allowlist(path: str | None) -> set[str]:
    if not path or not os.path.exists(path):
        return set()
    out = set()
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if line:
                out.add(line)
    return out


def check_durations(
    root: str,
    durations_text: str,
    threshold_s: float = DEFAULT_THRESHOLD_S,
    allowlist_path: str | None = None,
) -> list[Finding]:
    """Findings (rule ``slow-marker``) for every over-threshold test lacking
    the marker and absent from the allowlist. An empty/unparseable durations
    report is itself a finding: the caller asked for the check but fed it
    nothing (run pytest with ``--durations=0``)."""
    durations = parse_durations(durations_text)
    if not durations:
        return [
            Finding(
                rule=RULE_ID,
                path="(durations report)",
                line=0,
                message=(
                    "no '<secs>s call <nodeid>' lines found — run pytest with "
                    "--durations=0 and feed that output"
                ),
            )
        ]
    allow = load_allowlist(
        allowlist_path
        if allowlist_path is not None
        else os.path.join(root, DEFAULT_ALLOWLIST)
    )
    out: list[Finding] = []
    for nodeid, secs in sorted(durations.items(), key=lambda kv: -kv[1]):
        if secs <= threshold_s:
            continue
        relpath, test_name = nodeid.split("::", 1)
        test_name = test_name.split("::")[-1]
        if has_slow_marker(os.path.join(root, relpath), test_name):
            continue
        if nodeid in allow:
            continue
        out.append(
            Finding(
                rule=RULE_ID,
                path=relpath,
                line=0,
                message=(
                    f"{nodeid} took {secs:.2f}s (> {threshold_s:g}s) without "
                    "@pytest.mark.slow — mark it slow, or add it to "
                    f"{DEFAULT_ALLOWLIST} with a reason"
                ),
                context=test_name,
                text=nodeid,  # stable fingerprint input: the nodeid itself
            )
        )
    return out
