"""``python -m qdml_tpu_torch.cli lint``: the port's lint gate
(``qdml_tpu/analysis/cli.py``).

Host-side tool over source files: no config parsing, no device, no world,
no kernel (dispatched before the CLI's config layer, like ``report``).

    python -m qdml_tpu_torch.cli lint [--paths=P1,P2,...] [--baseline[=FILE]]
        [--write-baseline] [--json=FILE] [--durations=FILE] [--threshold=SECS]
        [--allow=FILE] [--list-rules] [--changed-only]
        [--lockgraph[=DIR]] [--lockgraph-check[=DIR]]

Exit codes: 0 clean (every finding fixed, suppressed with a reason, or
baselined), 1 new findings, 2 usage/parse errors.

- ``--paths`` defaults to ``qdml_tpu_torch`` and ``chip_smoke.py``;
- ``--baseline`` (flag or ``=path``) subtracts the committed baseline
  (default ``qdml_tpu_torch/analysis/lint_baseline.json``); new findings
  still fail;
- ``--write-baseline`` regenerates that file from the current findings
  (inline-suppressed ones stay inline; existing baseline reasons are kept);
  it refuses to write from a scan that had errors;
- ``--durations=FILE`` folds in the slow-marker rule over a
  ``pytest --durations=0`` report (``-`` reads stdin), with ``--threshold``
  (seconds, default 5) and ``--allow`` (default
  ``qdml_tpu_torch/analysis/tier1_slow_allowlist.txt``);
- ``--json=FILE`` writes the machine-readable gate record that
  ``python -m qdml_tpu_torch.cli report --lint=FILE`` reads (JAX's schema);
- ``--changed-only`` restricts the REPORT to git-touched files (staged +
  unstaged + untracked) for fast pre-commit runs; the scan still covers the
  full path set so the whole-program concurrency pass sees every caller;
- ``--lockgraph[=DIR]`` writes the static lock-order graph (default
  ``qdml_tpu_torch/analysis/lockgraph/``: JSON + DOT + markdown
  hierarchy); ``--lockgraph-check[=DIR]`` instead verifies the committed
  graph matches a regenerated one and exits 1 when it is stale. An empty
  ``DIR`` is a usage error.
"""

from __future__ import annotations

import json
import os
import sys

from qdml_tpu_torch.analysis import concurrency
from qdml_tpu_torch.analysis.engine import (
    BASELINE_DEFAULT,
    LintEngine,
    LintResult,
    load_baseline,
    save_baseline,
)
from qdml_tpu_torch.analysis.project import DEFAULT_PATHS

EXIT_OK = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


def repo_root() -> str:
    """The repo the package lives in (qdml_tpu_torch/analysis/cli.py -> repo)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def changed_files(root: str) -> list[str]:
    """Repo-relative .py files git considers touched: staged, unstaged, and
    untracked (`git status --porcelain`; renames report their new name)."""
    import subprocess

    try:
        out = subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True,
            text=True,
            timeout=30,
            check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    files: list[str] = []
    for line in out.splitlines():
        if len(line) < 4:
            continue
        path = line[3:]
        if " -> " in path:  # rename: "R  old -> new"
            path = path.split(" -> ", 1)[1]
        path = path.strip().strip('"')
        if path.endswith(".py"):
            files.append(path)
    return sorted(set(files))


def _format_text(result: LintResult, baseline_path: str | None) -> str:
    lines: list[str] = []
    for f in result.new:
        lines.append(f"{f.location()}: [{f.rule}] {f.message}")
        if f.text:
            lines.append(f"    > {f.text}")
    for err in result.errors:
        lines.append(f"PARSE ERROR: {err}")
    n_sup, n_base = len(result.suppressed), len(result.baselined)
    if result.ok:
        lines.append(
            f"qdml_tpu_torch lint: OK, 0 new findings "
            f"({n_sup} suppressed inline with reasons, {n_base} baselined)"
        )
    else:
        lines.append(
            f"qdml_tpu_torch lint: {len(result.new)} new finding(s) "
            f"({n_sup} suppressed, {n_base} baselined)"
            + (f", {len(result.errors)} parse error(s)" if result.errors else "")
        )
        lines.append(
            "fix each finding, or suppress on the line with "
            "`# lint: disable=<rule>(reason)`"
            + (
                f", or regenerate {baseline_path} with --write-baseline"
                if baseline_path
                else ""
            )
        )
    return "\n".join(lines)


def lint_main(argv: list[str]) -> int:
    paths: list[str] = []
    baseline_path: str | None = None
    write_baseline = False
    json_out: str | None = None
    durations: str | None = None
    threshold = 5.0
    allow: str | None = None
    changed_only = False
    lockgraph_dir: str | None = None
    lockgraph_check: str | None = None
    root = repo_root()
    for arg in argv:
        if arg.startswith("--paths="):
            paths += [p for p in arg.split("=", 1)[1].split(",") if p]
        elif arg == "--baseline":
            baseline_path = os.path.join(root, BASELINE_DEFAULT)
        elif arg.startswith("--baseline="):
            baseline_path = arg.split("=", 1)[1]
        elif arg == "--write-baseline":
            write_baseline = True
        elif arg.startswith("--json="):
            json_out = arg.split("=", 1)[1]
        elif arg.startswith("--durations="):
            durations = arg.split("=", 1)[1]
        elif arg.startswith("--threshold="):
            try:
                threshold = float(arg.split("=", 1)[1])
            except ValueError:
                print(f"lint: --threshold must be a number, got {arg!r}")
                return EXIT_USAGE
        elif arg.startswith("--allow="):
            allow = arg.split("=", 1)[1]
        elif arg == "--changed-only":
            changed_only = True
        elif arg in ("--lockgraph", "--lockgraph-check") or arg.startswith(("--lockgraph=", "--lockgraph-check=")):
            flag, eq, value = arg.partition("=")
            if eq and not value:
                print(f"lint: {flag}= needs a directory")
                return EXIT_USAGE
            target = value or os.path.join(root, *concurrency.LOCKGRAPH_DIR.split("/"))
            if flag == "--lockgraph":
                lockgraph_dir = target
            else:
                lockgraph_check = target
        elif arg == "--list-rules":
            from qdml_tpu_torch.analysis.rules import RULES
            from qdml_tpu_torch.analysis.slowmarkers import RULE_ID

            for rule_id, (_fn, doc) in sorted(RULES.items()):
                print(f"{rule_id:26s} {doc}")
            for rule_id, doc in sorted(concurrency.CONCURRENCY_RULES.items()):
                print(f"{rule_id:26s} {doc}")
            print(f"{RULE_ID:26s} >5s tests must be @pytest.mark.slow (needs --durations)")
            return EXIT_OK
        else:
            print(f"lint: unrecognised argument {arg!r}")
            print(__doc__)
            return EXIT_USAGE
    paths = paths or list(DEFAULT_PATHS)

    extra = []
    if durations is not None:
        from qdml_tpu_torch.analysis.slowmarkers import check_durations

        try:
            if durations == "-":
                text = sys.stdin.read()
            else:
                with open(durations) as fh:
                    text = fh.read()
        except OSError as e:
            print(f"lint: cannot read durations report: {e}")
            return EXIT_USAGE
        extra = check_durations(root, text, threshold_s=threshold, allowlist_path=allow)

    engine = LintEngine(root)
    previous = load_baseline(baseline_path) if baseline_path else {}
    if write_baseline:
        target = baseline_path or os.path.join(root, BASELINE_DEFAULT)
        # Baseline the AST findings only (new + already-baselined: a
        # regenerate keeps matching entries and their reasons). Slow-marker
        # findings are data-driven and grandfather through
        # tier1_slow_allowlist.txt, never the AST baseline; bare-suppression
        # findings are policy violations that must be fixed, not frozen.
        raw = engine.run(paths, baseline=None)
        if raw.errors:
            for e in raw.errors:
                print(f"lint: {e}")
            print("lint: refusing to write a baseline from an incomplete scan")
            return EXIT_FINDINGS
        baselineable = [f for f in raw.new if f.rule != "bare-suppression"]
        skipped = len(raw.new) - len(baselineable)
        n = save_baseline(target, baselineable, previous=load_baseline(target))
        print(f"lint: wrote {n} baseline entr{'y' if n == 1 else 'ies'} to {target}")
        if skipped:
            print(
                f"lint: {skipped} bare-suppression finding(s) NOT baselined: "
                "add the missing (reason)s instead"
            )
        return EXIT_OK
    restrict: list[str] | None = None
    if changed_only:
        restrict = changed_files(root)
        if not restrict and not (lockgraph_dir or lockgraph_check):
            print("qdml_tpu_torch lint: OK, --changed-only and no touched .py files")
            return EXIT_OK
    result = engine.run(
        paths, baseline=previous, extra_findings=extra, restrict_to=restrict
    )
    print(_format_text(result, baseline_path))
    rc = EXIT_OK if result.ok else EXIT_FINDINGS
    if (lockgraph_dir or lockgraph_check) and engine.model is not None:
        if lockgraph_dir:
            graph = concurrency.write_lockgraph(engine.model, lockgraph_dir)
            print(
                f"lint: wrote lock graph to {lockgraph_dir} "
                f"({len(graph['nodes'])} locks, {len(graph['edges'])} edges, "
                f"{len(graph['cycles'])} cycles)"
            )
        if lockgraph_check:
            problems = concurrency.check_lockgraph(engine.model, lockgraph_check)
            for p in problems:
                print(f"lint: {p}")
            if problems:
                rc = EXIT_FINDINGS
            else:
                print(f"lint: lock graph {lockgraph_check} is fresh")
    if json_out:
        payload = result.to_json()
        payload["exit_code"] = rc
        payload["baseline"] = baseline_path
        payload["paths"] = paths
        os.makedirs(os.path.dirname(json_out) or ".", exist_ok=True)
        with open(json_out, "w") as fh:
            json.dump(payload, fh, indent=2)
    return rc


if __name__ == "__main__":
    raise SystemExit(lint_main(sys.argv[1:]))
