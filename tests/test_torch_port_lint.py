"""The port's lint gate (``qdml_tpu_torch/analysis/``) against JAX's engine.

The same sources go through ``qdml_tpu.analysis`` and the port's engine,
rule by rule: JAX's committed fixtures at the same paths (rule, line,
context, text and fingerprint equal), inline sources written under each
package's mapped path (all but the path-keyed fingerprint equal), the
suppression and baseline mechanics, the slow-marker rule and the JSON
artifact. The port's own maps (collectives, rank guards, lock map) are held
to the port's code, and the port's tree passes its gate.
"""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from qdml_tpu.analysis import engine as jengine  # noqa: E402
from qdml_tpu.analysis import project as jproject  # noqa: E402
from qdml_tpu.analysis import slowmarkers as jslow  # noqa: E402
from qdml_tpu.analysis.rules import RULES as JRULES  # noqa: E402
from qdml_tpu_torch.analysis import cli as tcli  # noqa: E402
from qdml_tpu_torch.analysis import engine as tengine  # noqa: E402
from qdml_tpu_torch.analysis import project as tproject  # noqa: E402
from qdml_tpu_torch.analysis import slowmarkers as tslow  # noqa: E402
from qdml_tpu_torch.analysis.rules import RULES as TRULES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXDIR = "tests/fixtures/lint"
FIXTURES = (
    "violations.py", "clean.py", "serve/violations.py", "serve/clean.py",
    "telemetry/rate_violations.py", "telemetry/rate_clean.py",
)
# the seven framework-neutral rules, which are JAX's rule for rule (the ten
# tracing counterparts read torch where JAX reads XLA, and are held against
# JAX's rules on mirrored sources in tests/test_torch_port_tracing_rules.py)
RULE_IDS = (
    "primary-only-collective", "serve-lock-discipline", "stranded-future", "broad-except",
    "retry-without-backoff", "unbounded-readline", "unwindowed-cumulative-rate",
)
TRACING_IDS = (
    "jit-mutable-global", "tracer-branch", "host-sync-hot-path", "wall-clock-in-jit", "import-time-jnp",
    "pallas-host-loop", "gate-matrix-in-loop", "data-dependent-shape-in-jit", "pad-to-bucket-in-serve",
    "trace-in-jit-path",
)


def _keys(findings, fingerprint=True):
    out = []
    for f in findings:
        k = (f.rule, f.line, f.context, f.text)
        out.append(k + ((f.fingerprint,) if fingerprint else ()))
    return sorted(out)


def _both(root, rule_id, relpath_jax, relpath_port=None):
    """One rule's findings from each engine over one file each (without the
    dead-suppression findings a one-rule engine makes of other rules'
    suppressions; the mechanics are compared on their own below)."""
    jf, jerr = jengine.LintEngine(str(root), rules=[JRULES[rule_id][0]]).lint_file(relpath_jax)
    tf, terr = tengine.LintEngine(str(root), rules=[TRULES[rule_id][0]]).lint_file(relpath_port or relpath_jax)
    assert jerr is None and terr is None, (jerr, terr)
    return [f for f in jf if f.rule == rule_id], [f for f in tf if f.rule == rule_id]


def _write(root: Path, relpath: str, src: str) -> None:
    path = root / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))


# ---------------------------------------------------------------------------
# The seven rules against JAX's, on JAX's fixtures (same paths)
# ---------------------------------------------------------------------------


def test_the_seven_rules_and_their_ids():
    assert set(TRULES) == set(RULE_IDS) | set(TRACING_IDS)
    assert set(TRULES) <= set(JRULES)
    # JAX's three tracing rules with no torch counterpart are not registered
    assert set(JRULES) - set(TRULES) == {
        "train-step-jit-audit", "pallas-interpret-literal", "collective-outside-shardmap",
    }
    # the maps the seven rules share with JAX's, unchanged (the port's code
    # uses the same IO calls, counters and clocks)
    for name in ("RETRY_IO_CALLS", "BACKOFF_CALLS", "TRANSIENT_IO_EXCEPTIONS", "UNBOUNDED_READ_CALLS",
                 "CUMULATIVE_COUNTERS", "WALL_TIME_CALLS", "TYPED_EXCEPTIONS"):
        assert getattr(tproject, name) == getattr(jproject, name), name


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("rule_id", RULE_IDS)
def test_rule_matches_jax_on_fixture(rule_id, fixture):
    jf, tf = _both(ROOT, rule_id, f"{FIXDIR}/{fixture}")
    want = _keys(jf)
    if rule_id == "primary-only-collective":
        # the one map difference the fixtures show: JAX's save_checkpoint
        # wraps an orbax save (a collective), the port's is a torch.save
        want = [k for k in want if "save_checkpoint" not in k[3]]
    assert _keys(tf) == want


def test_fixtures_exercise_the_rules():
    """The fixture comparison is not vacuous: each rule but the path-keyed
    lock rule finds something in JAX's violation fixtures."""
    found = {r: 0 for r in RULE_IDS}
    for fixture in FIXTURES:
        for rule_id in RULE_IDS:
            jf, tf = _both(ROOT, rule_id, f"{FIXDIR}/{fixture}")
            found[rule_id] += len(tf)
            if rule_id == "primary-only-collective":
                assert len(jf) == (2 if fixture == "violations.py" else 0)
    assert found == {
        "primary-only-collective": 0, "serve-lock-discipline": 0, "stranded-future": 1,
        "broad-except": 2, "retry-without-backoff": 1, "unbounded-readline": 2,
        "unwindowed-cumulative-rate": 3,
    }


# ---------------------------------------------------------------------------
# Inline sources under each package's mapped path
# ---------------------------------------------------------------------------

LOCK_SOURCES = {
    "serve/batcher.py": """
        import threading

        class MicroBatcher:
            def __init__(self):
                self._q = []              # __init__ is exempt
                self._lock = threading.Lock()

            def good(self):
                with self._lock:
                    return len(self._q)

            def bad(self):
                return self._q.pop()      # outside the lock
        """,
    "serve/server.py": """
        import threading

        class ExitCoordinator:
            def __init__(self):
                self._lock = threading.Lock()
                self._live = 0

            def leave_locked(self):
                with self._lock:
                    self._live -= 1
                    return self._live <= 0

            def leave_racy(self):
                self._live -= 1
                return self._live <= 0
        """,
    "serve/engine.py": """
        import threading

        class ServeEngine:
            def __init__(self):
                self._swap_lock = threading.Lock()
                self._live = (1, 2)
                self._swap_epoch = 0

            def infer_locked(self):
                with self._swap_lock:
                    h, c = self._live
                return h, c

            def infer_torn(self):
                return self._live

            def epoch_racy(self):
                return self._swap_epoch
        """,
    "telemetry/events.py": """
        import threading

        class EventBus:
            def __init__(self):
                self._lock = threading.Lock()
                self._ring = []
                self._seq = 0
                self._dropped = 0

            def publish_locked(self, env):
                with self._lock:
                    self._seq += 1
                    self._ring.append(env)
                    return self._seq

            def publish_racy(self, env):
                self._seq += 1
                self._ring.append(env)
                return self._dropped
        """,
    "fleet/router.py": """
        class Backend:
            def note(self, ms):
                with self._mlock:
                    self._forwarded += 1
                self._latency.append(ms)
        """,
}


@pytest.mark.parametrize("rel", sorted(LOCK_SOURCES))
def test_lock_discipline_matches_jax_under_the_mapped_path(tmp_path, rel):
    _write(tmp_path, f"qdml_tpu/{rel}", LOCK_SOURCES[rel])
    _write(tmp_path, f"qdml_tpu_torch/{rel}", LOCK_SOURCES[rel])
    jf, tf = _both(tmp_path, "serve-lock-discipline", f"qdml_tpu/{rel}", f"qdml_tpu_torch/{rel}")
    assert tf and _keys(tf, fingerprint=False) == _keys(jf, fingerprint=False)
    assert all(f.path == f"qdml_tpu_torch/{rel}" for f in tf)
    # the JAX package's path is out of the port's map, and the port's out of JAX's
    assert _both(tmp_path, "serve-lock-discipline", f"qdml_tpu_torch/{rel}", f"qdml_tpu/{rel}") == ([], [])


def test_lock_discipline_covers_the_sanitizer_code_table(tmp_path):
    """The port's alone: the sanitizer's code table is shared with the
    autograd engine's device threads; the real module keeps it under _lock."""
    _write(tmp_path, "qdml_tpu_torch/telemetry/sanitizer.py", """
        import threading

        class Sanitizer:
            def __init__(self):
                self._lock = threading.Lock()
                self._table = []
                self._codes = {}

            def code(self, key):
                with self._lock:
                    self._table.append(key)
                    return self._codes.setdefault(key, len(self._table))

            def message(self, code):
                return self._table[code - 1]
        """)
    tf = tengine.LintEngine(str(tmp_path), rules=[TRULES["serve-lock-discipline"][0]]).lint_file(
        "qdml_tpu_torch/telemetry/sanitizer.py")[0]
    assert [(f.context, f.text) for f in tf] == [("Sanitizer.message", "return self._table[code - 1]")]
    assert _both(ROOT, "serve-lock-discipline", "qdml_tpu_torch/telemetry/sanitizer.py")[1] == []


def _class_facts(path: Path) -> dict[str, set[str]]:
    """Class name -> the ``self.<attr>`` names it assigns or uses (``with``)."""
    out: dict[str, set[str]] = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ClassDef):
            out.setdefault(node.name, set()).update(
                sub.attr for sub in ast.walk(node)
                if isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name) and sub.value.id == "self"
            )
    return out


@pytest.mark.parametrize("relpath", sorted(tproject.LOCK_MAP))
def test_lock_map_entry_exists_in_the_port(relpath):
    """Every file, class, attribute and lock of the map is real, so a rename
    cannot quietly disarm the rule; each counterpart of JAX's map is kept."""
    path = ROOT / relpath
    assert path.is_file(), relpath
    facts = _class_facts(path)
    for cls, attrs in tproject.LOCK_MAP[relpath].items():
        assert cls in facts, (relpath, cls)
        for attr, lock in attrs.items():
            assert attr in facts[cls] and lock in facts[cls], (relpath, cls, attr, lock)
            init_locks = [
                sub for sub in ast.walk(ast.parse(path.read_text()))
                if isinstance(sub, ast.Assign) and any(
                    isinstance(t, ast.Attribute) and t.attr == lock for t in sub.targets)
            ]
            assert init_locks and "Lock" in ast.unparse(init_locks[0].value), (relpath, lock)
    jkey = relpath.replace("qdml_tpu_torch/", "qdml_tpu/", 1)
    if jkey in jproject.LOCK_MAP:
        for cls, attrs in jproject.LOCK_MAP[jkey].items():
            assert tproject.LOCK_MAP[relpath][cls] == attrs


def test_lock_map_holds_every_jax_entry():
    assert {k.replace("qdml_tpu/", "qdml_tpu_torch/", 1) for k in jproject.LOCK_MAP} <= set(tproject.LOCK_MAP)


PRIMARY_SRC = """
    import torch.distributed as dist
    from qdml_tpu_torch.parallel.mesh import world_rank
    from qdml_tpu_torch.telemetry.core import is_primary

    def guarded(t):
        if is_primary():
            dist.all_reduce(t)

    def early_return(t, parts):
        if not is_primary():
            return
        dist.all_gather(parts, t)

    def by_rank(t):
        if world_rank() == 0:
            dist.barrier()

    def fine(t, path):
        dist.all_reduce(t)
        if is_primary():
            torch.save(t, path)
    """


def test_primary_only_collective_trips_on_the_port_collectives(tmp_path):
    _write(tmp_path, "mod.py", PRIMARY_SRC)
    jf, tf = _both(tmp_path, "primary-only-collective", "mod.py")
    assert [(f.context, f.text) for f in tf] == [
        ("guarded", "dist.all_reduce(t)"),
        ("early_return", "dist.all_gather(parts, t)"),
        ("by_rank", "dist.barrier()"),
    ]
    # JAX's maps know all_gather under is_primary, not torch's all_reduce,
    # barrier or the world_rank guard: where both see a finding, they agree
    assert _keys(jf) == [k for k in _keys(tf) if "all_gather" in k[3]]


def test_flight_recorder_dump_is_clean_for_the_port_only():
    """telemetry/numerics.py's dump gathers on every rank and saves on the
    primary with a plain torch.save: clean under the port's maps, a false
    positive under JAX's (whose save_checkpoint is an orbax collective)."""
    jf, tf = _both(ROOT, "primary-only-collective", "qdml_tpu_torch/telemetry/numerics.py")
    assert tf == []
    assert [f.context for f in jf] == ["FlightRecorder.dump"] and "save_checkpoint" in jf[0].text


def test_rate_rule_sanctions_the_port_differencing_module(tmp_path):
    src = (ROOT / FIXDIR / "telemetry/rate_violations.py").read_text()
    for rel in ("telemetry/timeseries.py", "telemetry/other.py"):
        _write(tmp_path, f"qdml_tpu/{rel}", src)
        _write(tmp_path, f"qdml_tpu_torch/{rel}", src)
        jf, tf = _both(tmp_path, "unwindowed-cumulative-rate", f"qdml_tpu/{rel}", f"qdml_tpu_torch/{rel}")
        assert _keys(tf, fingerprint=False) == _keys(jf, fingerprint=False)
        assert len(tf) == (0 if rel == "telemetry/timeseries.py" else 3)


def test_unbounded_readline_is_scoped_to_serve_paths(tmp_path):
    src = (ROOT / FIXDIR / "serve/violations.py").read_text()
    for rel in ("qdml_tpu_torch/serve/server.py", "qdml_tpu_torch/fleet/router.py"):
        _write(tmp_path, rel, src)
        jf, tf = _both(tmp_path, "unbounded-readline", rel)
        assert _keys(tf) == _keys(jf)
        assert len(tf) == (2 if "/serve/" in rel else 0)


# ---------------------------------------------------------------------------
# Suppressions, baseline, slow markers, the JSON artifact
# ---------------------------------------------------------------------------

SUPPRESSION_SRC = """
    def f():
        try:
            g()
        except Exception:  # lint: disable=broad-except(probe may raise anything; result is advisory)
            pass

    def h():
        try:
            g()
        except Exception:  # lint: disable=broad-except
            pass

    x = 1  # lint: disable=stranded-future
    y = 2  # lint: disable=broad-except(nothing here ever raised)
    z = 3  # lint: disable=rule-a(reason one (nested, commas)),rule-b
    """


def test_suppression_parsing_matches_jax():
    src = textwrap.dedent(SUPPRESSION_SRC)
    assert tengine.parse_suppressions(src) == jengine.parse_suppressions(src)
    sup = tengine.parse_suppressions(src)
    z = src.splitlines().index("z = 3  # lint: disable=rule-a(reason one (nested, commas)),rule-b") + 1
    assert sup[z] == {"rule-a": "reason one (nested, commas)", "rule-b": None}


def test_bare_and_dead_suppressions_match_jax(tmp_path):
    _write(tmp_path, "mod.py", SUPPRESSION_SRC)
    j = jengine.LintEngine(str(tmp_path), rules=[JRULES[r][0] for r in RULE_IDS]).run(["mod.py"], whole_program=False)
    t = tengine.LintEngine(str(tmp_path)).run(["mod.py"])
    assert _keys(t.new) == _keys(j.new) and _keys(t.suppressed) == _keys(j.suppressed)
    rules = sorted(f.rule for f in t.new)
    # h's bare comment leaves its finding standing; x's and rule-b's are bare,
    # y's and rule-a's dead
    assert rules == ["bare-suppression", "bare-suppression", "broad-except", "dead-suppression",
                     "dead-suppression"]
    assert [f.reason for f in t.suppressed] == ["probe may raise anything; result is advisory"]
    assert "reasons are mandatory" in next(f for f in t.new if f.rule == "broad-except").message


def test_baseline_round_trip_rearms_like_jax(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text("def f():\n    try:\n        g()\n    except Exception:\n        pass\n")
    eng = tengine.LintEngine(str(tmp_path))
    raw = eng.run(["mod.py"])
    bl = tmp_path / "baseline.json"
    assert tengine.save_baseline(str(bl), raw.new) == 1
    baseline = tengine.load_baseline(str(bl))
    # one file format: JAX's loader reads the port's baseline to the same entries
    assert jengine.load_baseline(str(bl)) == baseline
    gated = eng.run(["mod.py"], baseline=baseline)
    assert gated.new == [] and len(gated.baselined) == 1 and gated.baselined[0].reason
    # line-number free: shifting the offender keeps it baselined; editing it re-arms
    mod.write_text("import os\n\n\ndef f():\n    try:\n        g()\n    except Exception:\n        pass\n")
    assert eng.run(["mod.py"], baseline=baseline).new == []
    mod.write_text("def f():\n    try:\n        g()\n    except BaseException:\n        pass\n")
    rearmed = eng.run(["mod.py"], baseline=baseline)
    jrearmed = jengine.LintEngine(str(tmp_path), rules=[JRULES["broad-except"][0]]).run(
        ["mod.py"], baseline=baseline, whole_program=False)
    assert _keys(rearmed.new) == _keys(jrearmed.new) and len(rearmed.new) == 1
    # a regenerate keeps a hand-written reason
    entry = next(iter(baseline.values()))
    entry["reason"] = "custom triage note"
    tengine.save_baseline(str(bl), raw.new, previous=baseline)
    assert next(iter(tengine.load_baseline(str(bl)).values()))["reason"] == "custom triage note"


def test_check_durations_matches_jax(tmp_path):
    allow = tmp_path / "allow.txt"
    allow.write_text("tests/test_torch_port_lint.py::test_allowlisted  # 9s, grandfathered\n")
    text = (
        "  30.00s call     tests/test_serve.py::test_empty_queue_flush_is_noop\n"
        "  31.00s call     tests/test_serve.py::test_loadgen_soak_open_loop_with_deadlines\n"
        "  9.00s call     tests/test_torch_port_lint.py::test_allowlisted[a]\n"
        "  3.00s call     tests/test_torch_port_lint.py::test_fast\n"
        "  6.00s setup    tests/test_torch_port_lint.py::test_fixture_heavy\n"
    )
    for t in (text, "no durations here\n"):
        want = jslow.check_durations(str(ROOT), t, allowlist_path=str(allow))
        got = tslow.check_durations(str(ROOT), t, allowlist_path=str(allow))
        assert _keys(got) == _keys(want) and len(got) == 1
    got = tslow.check_durations(str(ROOT), text, allowlist_path=str(allow))
    assert got[0].text == "tests/test_serve.py::test_empty_queue_flush_is_noop"
    assert tslow.DEFAULT_ALLOWLIST.replace("\\", "/") == "qdml_tpu_torch/analysis/tier1_slow_allowlist.txt"
    # the port's default allowlist is committed and parses
    assert tslow.load_allowlist(str(ROOT / tslow.DEFAULT_ALLOWLIST))


def test_json_artifact_keys_and_per_rule_match_jax(tmp_path, capsys):
    from qdml_tpu.analysis.cli import lint_main as jlint_main

    fixture = f"{FIXDIR}/violations.py"
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    assert jlint_main([f"--paths={fixture}", f"--json={jpath}"]) == 1
    assert tcli.lint_main([f"--paths={fixture}", f"--json={tpath}"]) == 1
    capsys.readouterr()
    jgate, tgate = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    assert set(tgate) == set(jgate)
    assert tgate["kind"] == "lint_gate" and tgate["schema"] == 1 and tgate["exit_code"] == 1
    assert tgate["new_findings"] == sum(tgate["per_rule"].values()) == len(tgate["findings"])
    # JAX's per_rule on the seven rules, less the save_checkpoint pair
    want = {r: n for r, n in jgate["per_rule"].items() if r in RULE_IDS and r != "primary-only-collective"}
    assert {r: n for r, n in tgate["per_rule"].items() if r in RULE_IDS} == want
    assert set(tgate["findings"][0]) == set(jgate["findings"][0])


# ---------------------------------------------------------------------------
# The CLI, the port's tree, report --lint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree_gate(tmp_path_factory):
    """The port's gate over its own tree, once: (exit code, stdout, artifact)."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("lint") / "lint.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.lint_main(["--baseline", f"--json={out}"])
    return rc, buf.getvalue(), out


def test_port_tree_is_clean_under_its_baseline(tree_gate):
    rc, text, out = tree_gate
    gate = json.loads(out.read_text())
    assert rc == 0 and "0 new findings" in text, text
    assert gate["ok"] and gate["new_findings"] == 0 and gate["errors"] == []
    assert gate["paths"] == ["qdml_tpu_torch", "chip_smoke.py"]
    assert gate["suppressed"] > 0 and gate["baselined"] == 0
    # the committed baseline is empty: every finding is fixed or suppressed with a reason
    assert tengine.load_baseline(str(ROOT / tengine.BASELINE_DEFAULT)) == {}


def test_port_tree_suppressions_all_carry_reasons():
    from qdml_tpu_torch.analysis.concurrency import CONCURRENCY_RULES

    for path in sorted((ROOT / "qdml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for line, rules in tengine.parse_suppressions(path.read_text()).items():
            for rule_id, reason in rules.items():
                assert reason and (rule_id in TRULES or rule_id in CONCURRENCY_RULES), (path, line, rule_id)


@pytest.fixture(scope="module")
def port_tree():
    """The port's engine over its own tree, once."""
    return tengine.LintEngine(str(ROOT)).run(list(tproject.DEFAULT_PATHS))


@pytest.fixture(scope="module")
def port_tree_neutral():
    """The port's seven neutral rules alone over its tree, per module, once:
    what JAX's same seven rules are held to (both see the tracing and
    concurrency suppressions as dead)."""
    return tengine.LintEngine(str(ROOT), rules=[TRULES[r][0] for r in RULE_IDS]).run(
        list(tproject.DEFAULT_PATHS), whole_program=False)


# the scanned tree in parts: each subpackage, the package's own modules, the smoke
TREE_PARTS = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "qdml_tpu_torch").iterdir()
    if p.is_dir() and any(p.glob("*.py"))
) + ["qdml_tpu_torch/*.py", "chip_smoke.py"]


def _part_paths(part: str) -> list[str]:
    if part.endswith("*.py"):
        return sorted(str(p.relative_to(ROOT)) for p in (ROOT / "qdml_tpu_torch").glob("*.py"))
    return [part]


def test_tree_parts_cover_the_scan():
    parts = [set(tengine.iter_python_files(str(ROOT), _part_paths(p))) for p in TREE_PARTS]
    assert set().union(*parts) == set(tengine.iter_python_files(str(ROOT), tproject.DEFAULT_PATHS))
    assert sum(map(len, parts)) == len(set().union(*parts))


@pytest.mark.parametrize("part", TREE_PARTS)
def test_port_tree_findings_match_jax_engine(port_tree, port_tree_neutral, part):
    """JAX's engine over the port's tree finds what the port's does on the
    seven neutral rules, plus the flight recorder's save_checkpoint (a
    collective in JAX's maps alone); the port's whole gate finds nothing."""
    paths = _part_paths(part)
    files = set(tengine.iter_python_files(str(ROOT), paths))
    j = jengine.LintEngine(str(ROOT), rules=[JRULES[r][0] for r in RULE_IDS]).run(paths, whole_program=False)
    assert j.errors == []
    assert _keys(j.suppressed) == _keys([f for f in port_tree_neutral.suppressed if f.path in files])
    want = [("primary-only-collective", "qdml_tpu_torch/telemetry/numerics.py", "FlightRecorder.dump")]
    mine = [(f.rule, f.path, f.context) for f in port_tree_neutral.new if f.path in files]
    assert sorted((f.rule, f.path, f.context) for f in j.new) == sorted(
        mine + (want if part == "qdml_tpu_torch/telemetry" else []))
    assert port_tree.new == []


@pytest.mark.parametrize("argv, rc", [
    ([f"--paths={FIXDIR}/clean.py"], 0),
    ([f"--paths={FIXDIR}/violations.py"], 1),
    (["--paths=qdml_tpu_torch/serv"], 1),          # a missing path fails the gate
    (["--lockgraph="], 2),                          # a lock graph needs a directory
    (["--lockgraph-check="], 2),
    (["--threshold=fast"], 2),
    (["--no-such-flag"], 2),
    ([f"--durations=/nonexistent/d.log", f"--paths={FIXDIR}/clean.py"], 2),
])
def test_lint_cli_exit_codes(argv, rc, capsys):
    assert tcli.lint_main(argv) == rc
    capsys.readouterr()


def test_write_baseline_refuses_an_incomplete_scan_and_skips_bare(tmp_path, monkeypatch, capsys):
    root = tmp_path / "repo"
    (root / "pkg").mkdir(parents=True)
    (root / "pkg/mod.py").write_text(
        "def f():\n    try:\n        g()\n    except Exception:\n        pass\n\n"
        "x = 1  # lint: disable=broad-except\n"
    )
    monkeypatch.setattr(tcli, "repo_root", lambda: str(root))
    bl = root / "bl.json"
    assert tcli.lint_main(["--paths=pkg,missing", f"--baseline={bl}", "--write-baseline"]) == 1
    assert "refusing" in capsys.readouterr().out and not bl.exists()
    assert tcli.lint_main(["--paths=pkg", f"--baseline={bl}", "--write-baseline"]) == 0
    assert "NOT baselined" in capsys.readouterr().out
    assert [e["rule"] for e in json.loads(bl.read_text())["entries"]] == ["broad-except"]
    assert tcli.lint_main(["--paths=pkg", f"--baseline={bl}"]) == 1  # the bare comment still fails
    capsys.readouterr()


def test_lint_cli_slow_marker_fold_in(tmp_path, capsys):
    dur = tmp_path / "d.log"
    dur.write_text("  30.00s call     tests/test_serve.py::test_empty_queue_flush_is_noop\n")
    out = tmp_path / "lint.json"
    rc = tcli.lint_main([f"--paths={FIXDIR}/clean.py", f"--durations={dur}", "--allow=/nonexistent",
                         f"--json={out}"])
    capsys.readouterr()
    assert rc == 1 and json.loads(out.read_text())["per_rule"] == {"slow-marker": 1}
    dur.write_text("  30.00s call     tests/test_serve.py::test_loadgen_soak_open_loop_with_deadlines\n")
    assert tcli.lint_main([f"--paths={FIXDIR}/clean.py", f"--durations={dur}"]) == 0
    capsys.readouterr()


def test_report_reads_the_port_lint_artifact(tree_gate, tmp_path, capsys):
    from qdml_tpu_torch.telemetry.report import EXIT_REGRESSION, report_main

    bench = {"metric": "sps", "value": 100.0, "platform": "cpu"}
    cur = tmp_path / "c.jsonl"
    cur.write_text(json.dumps(bench) + "\n")
    assert report_main([f"--current={cur}", f"--baseline={cur}", f"--lint={tree_gate[2]}"]) == 0
    bad = tmp_path / "bad.json"
    assert tcli.lint_main([f"--paths={FIXDIR}/violations.py", f"--json={bad}"]) == 1
    gate_out = tmp_path / "gate.json"
    rc = report_main([f"--current={cur}", f"--baseline={cur}", f"--lint={bad}", f"--json={gate_out}"])
    capsys.readouterr()
    assert rc == EXIT_REGRESSION
    gate = json.loads(gate_out.read_text())
    row = next(g for g in gate["gates"] if g["kind"] == "lint")
    assert gate["lint_failed"] is True and row["current"] == json.loads(bad.read_text())["new_findings"]


def test_cli_lint_is_host_side():
    """``cli lint`` loads no kernel module, opens no CUDA context and joins
    no world; --list-rules lists the 17 per-module rules, the five
    concurrency rules and slow-marker."""
    code = (
        "import json, sys, torch\n"
        "from qdml_tpu_torch import cli\n"
        "rc = cli.main(['lint', '--list-rules'])\n"
        "import torch.distributed as dist\n"
        "print(json.dumps({'rc': rc, 'cuda': torch.cuda.is_initialized(),\n"
        "    'kernels': 'qdml_tpu_torch.quantum.kernels' in sys.modules,\n"
        "    'world': dist.is_initialized(),\n"
        "    'jax': sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'qdml_tpu'))}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "cuda": False, "kernels": False, "world": False, "jax": []}
    listed = [ln.split()[0] for ln in lines[:-1]]
    from qdml_tpu_torch.analysis.concurrency import CONCURRENCY_RULES

    assert listed == sorted(TRULES) + sorted(CONCURRENCY_RULES) + ["slow-marker"]
    assert len(TRULES) == 17 and len(CONCURRENCY_RULES) == 5


ANALYSIS_STDLIB = {"__future__", "ast", "contextlib", "dataclasses", "hashlib", "io", "json", "os", "re",
                   "subprocess", "sys", "typing"}


@pytest.mark.parametrize("path", sorted((ROOT / "qdml_tpu_torch/analysis").glob("*.py")), ids=lambda p: p.name)
def test_analysis_modules_import_the_standard_library_only(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] in ANALYSIS_STDLIB or name.startswith("qdml_tpu_torch.analysis"), (
                path.name, name)
