"""The port's whole-program concurrency pass (``qdml_tpu_torch/analysis/
concurrency.py``) against JAX's (``qdml_tpu/analysis/concurrency.py``).

JAX's seven concurrency fixtures go through both analyzers, each under its
own package's path (``qdml_tpu/serve/...`` and ``qdml_tpu_torch/serve/...``)
with its own lock map rows: rule, line, context and text agree finding for
finding, as do the graphs' edges and cycles. Then the mechanics (RLock
re-entry, findings merged before suppression, the lock graph's freshness
check), the port's own tree (cycle-free, equal to the committed
``qdml_tpu_torch/analysis/lockgraph/``, every ``lockdep`` name a node), a
stale lock-map entry, and the runtime witness on the CPU: the edges a
replica crash and a hot swap take under ``QDML_LOCKDEP=1`` are edges of the
static graph.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

pytest.importorskip("torch")

from qdml_tpu.analysis import concurrency as jconc  # noqa: E402
from qdml_tpu.analysis import engine as jengine  # noqa: E402
from qdml_tpu_torch.analysis import concurrency as tconc  # noqa: E402
from qdml_tpu_torch.analysis import engine as tengine  # noqa: E402
from qdml_tpu_torch.analysis import project as tproject  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXDIR = ROOT / "tests" / "fixtures" / "lint" / "concurrency"
RULES = ("lock-order-inversion", "blocking-under-lock", "sync-io-in-async", "unmapped-shared-state",
         "dead-lock-map-entry")

# fixture -> (the path under each package it is presented at, lock map rows
# keyed by that path, the rules it must trip)
FIXTURES = {
    "inversion.py": ("serve/inversion.py", {}, {"lock-order-inversion": 2}),
    "inversion_clean.py": ("serve/ordered.py", {}, {}),
    "blocking.py": ("serve/blocking.py", {}, {"blocking-under-lock": 2}),
    "blocking_clean.py": ("serve/patient.py", {}, {}),
    "async_io.py": ("serve/server.py", {}, {"sync-io-in-async": 2}),
    "shared_state.py": ("serve/shared_state.py", {"Guarded": {"_count": "_lock"}}, {"unmapped-shared-state": 1}),
    "dead_map.py": ("serve/dead_map.py", {"Here": {"_old": "_lock", "_live": "_zap_lock"}, "Gone": {"_x": "_l"}},
                    {"dead-lock-map-entry": 4}),
}


def _ctx(mod, src: str, path: str):
    return mod.ModuleContext(os.path.join("/fake", path), path, src, ast.parse(src))


def _analyze(pkg: str, rel: str, src: str, rows: dict, extra: dict | None = None):
    """One analyzer over ``src`` at ``<pkg>/<rel>`` (plus ``extra`` sources
    by relative path), with ``rows`` as that file's lock map rows; the dead
    map fixture also names a missing file and carries the map's module."""
    conc, eng = (jconc, jengine) if pkg == "qdml_tpu" else (tconc, tengine)
    ctxs = [_ctx(eng, src, f"{pkg}/{rel}")] + [_ctx(eng, s, f"{pkg}/{r}") for r, s in (extra or {}).items()]
    lock_map = {f"{pkg}/{rel}": rows} if rows else {}
    if rel == "serve/dead_map.py":
        lock_map[f"{pkg}/serve/missing.py"] = {"Nobody": {"_y": "_l"}}
        ctxs.append(_ctx(eng, "LOCK_MAP = {}\n", f"{pkg}/analysis/project.py"))
    return conc.analyze_modules(ctxs, lock_map=lock_map)


def _keys(grouped) -> list[tuple]:
    return sorted((f.rule, f.line, f.context, f.text) for fs in grouped.values() for f in fs)


@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_fixture_matches_jax(fixture):
    rel, rows, want = FIXTURES[fixture]
    src = (FIXDIR / fixture).read_text()
    jg, jm = _analyze("qdml_tpu", rel, src, rows)
    tg, tm = _analyze("qdml_tpu_torch", rel, src, rows)
    assert _keys(tg) == _keys(jg)
    assert Counter(f.rule for fs in tg.values() for f in fs) == Counter(want)
    # every finding on the port's side names the port's paths only
    assert all(f.path.startswith("qdml_tpu_torch/") for fs in tg.values() for f in fs)
    assert sorted(tm.edges) == sorted(jm.edges) and tm.cycles() == jm.cycles()
    assert sorted(tm.locks) == sorted(jm.locks)


def test_fixtures_cover_the_five_rules():
    assert set().union(*(set(w) for _r, _m, w in FIXTURES.values())) == set(RULES) == set(tconc.CONCURRENCY_RULES)


def test_sync_io_scope_is_the_port_event_loop_files():
    src = (FIXDIR / "async_io.py").read_text()
    assert tproject.ASYNC_SCOPED_FILES == ("qdml_tpu_torch/serve/server.py", "qdml_tpu_torch/fleet/router.py")
    for rel, n in (("fleet/router.py", 2), ("serve/other.py", 0)):
        jg, _ = _analyze("qdml_tpu", rel, src, {})
        tg, _ = _analyze("qdml_tpu_torch", rel, src, {})
        assert _keys(tg) == _keys(jg) and len(_keys(tg)) == n
    # the JAX package's event-loop file is out of the port's scope
    tg, _ = _analyze("qdml_tpu_torch", "serve/server.py", src, {})
    jg_out, _ = tconc.analyze_modules([_ctx(tengine, src, "qdml_tpu/serve/server.py")], lock_map={})
    assert len(_keys(tg)) == 2 and _keys(jg_out) == []


def test_edges_and_cycle_of_the_inversion_fixture():
    _g, model = _analyze("qdml_tpu_torch", "serve/inversion.py", (FIXDIR / "inversion.py").read_text(), {})
    assert model.cycles() == [["Inverted._a", "Inverted._b"]]
    _g, model = _analyze("qdml_tpu_torch", "serve/ordered.py", (FIXDIR / "inversion_clean.py").read_text(), {})
    assert ("Ordered._a", "Ordered._b") in model.edges and ("Ordered._b", "Ordered._a") not in model.edges


RLOCK_SRC = textwrap.dedent("""
    import threading


    class Gate:
        def __init__(self):
            self._gate = threading.RLock()

        def outer(self):
            with self._gate:
                self.inner()

        def inner(self):
            with self._gate:
                return 1
    """)


def test_static_rlock_reentry_no_self_cycle():
    for pkg in ("qdml_tpu", "qdml_tpu_torch"):
        grouped, model = _analyze(pkg, "serve/gate.py", RLOCK_SRC, {})
        assert model.locks["Gate._gate"].kind == "rlock"
        assert model.cycles() == [] and _keys(grouped) == []
    # the same shape on a plain Lock deadlocks on itself: a self-edge cycle in both
    src = RLOCK_SRC.replace("threading.RLock()", "threading.Lock()")
    jg, jm = _analyze("qdml_tpu", "serve/gate.py", src, {})
    tg, tm = _analyze("qdml_tpu_torch", "serve/gate.py", src, {})
    assert tm.cycles() == jm.cycles() == [["Gate._gate"]] and _keys(tg) == _keys(jg)


SUPPRESSION_SRC = textwrap.dedent("""
    import threading
    import time


    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0

        def f(self):
            with self._lock:
                time.sleep(0.1)  # lint: disable=blocking-under-lock(test: the hold is the point)

        def g(self):
            self.n += 1  # lint: disable=unmapped-shared-state(stale: single entry point, rule never fires here)
    """)


def test_engine_merges_before_suppression_like_jax(tmp_path):
    (tmp_path / "mod.py").write_text(SUPPRESSION_SRC)
    t = tengine.LintEngine(str(tmp_path)).run(["mod.py"])
    j = jengine.LintEngine(str(tmp_path)).run(["mod.py"])
    sup = [f for f in t.suppressed if f.rule == "blocking-under-lock"]
    assert len(sup) == 1 and sup[0].reason.startswith("test:")
    assert Counter(f.rule for f in t.new) == {"dead-suppression": 1}
    assert sorted((f.rule, f.line) for f in t.new) == sorted((f.rule, f.line) for f in j.new)
    # without the whole-program pass, the blocking disable is dead too, and no model is kept
    eng = tengine.LintEngine(str(tmp_path))
    off = eng.run(["mod.py"], whole_program=False)
    assert Counter(f.rule for f in off.new) == {"dead-suppression": 2} and eng.model is None


def test_lockgraph_write_check_and_staleness(tmp_path):
    _g, model = _analyze("qdml_tpu_torch", "serve/ordered.py", (FIXDIR / "inversion_clean.py").read_text(), {})
    _g, jmodel = _analyze("qdml_tpu", "serve/ordered.py", (FIXDIR / "inversion_clean.py").read_text(), {})
    out = tmp_path / "lockgraph"
    assert tconc.check_lockgraph(model, str(out))[0].endswith(f"--lockgraph={out}`")  # missing
    graph = tconc.write_lockgraph(model, str(out))
    assert sorted(p.name for p in out.iterdir()) == ["LOCKGRAPH.md", "lockgraph.dot", "lockgraph.json"]
    assert tconc.check_lockgraph(model, str(out)) == []
    # JAX's record of the same source, but for the paths and the tool
    jgraph = jconc.lockgraph_json(jmodel)
    strip = json.dumps({k: v for k, v in jgraph.items() if k != "tool"}).replace("qdml_tpu/", "qdml_tpu_torch/")
    assert json.loads(strip) == {k: v for k, v in graph.items() if k != "tool"}
    assert graph["tool"] == "python -m qdml_tpu_torch.cli lint --lockgraph"
    stale = dict(graph, nodes=graph["nodes"][:-1])  # a lock vanished from the record
    (out / "lockgraph.json").write_text(json.dumps(stale))
    problems = tconc.check_lockgraph(model, str(out))
    assert len(problems) == 1 and "stale" in problems[0]
    (out / "LOCKGRAPH.md").write_text("edited by hand\n")
    assert len(tconc.check_lockgraph(model, str(out))) == 2


# ---------------------------------------------------------------------------
# The port's own tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_model():
    return tconc.analyze_files(str(ROOT))


def test_port_lock_graph_is_cycle_free_and_fresh(port_model):
    grouped, model = port_model
    assert model.cycles() == []
    assert tconc.check_lockgraph(model, str(ROOT / tconc.LOCKGRAPH_DIR)) == []
    # the pass's findings over the tree are all suppressed inline with a reason
    for path, findings in grouped.items():
        sup = tengine.parse_suppressions((ROOT / path).read_text())
        for f in findings:
            assert sup.get(f.line, {}).get(f.rule), (f.rule, f.location())


def _lockdep_names() -> set[str]:
    names = set()
    for path in sorted((ROOT / "qdml_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name) and node.func.value.id == "lockdep"
                    and node.func.attr in ("Lock", "RLock") and node.args):
                names.add(node.args[0].value)
    return names


def test_every_lockdep_name_is_a_node_of_the_committed_graph():
    graph = json.loads((ROOT / tconc.LOCKGRAPH_DIR / "lockgraph.json").read_text())
    nodes = {n["id"]: n for n in graph["nodes"]}
    names = _lockdep_names()
    assert len(names) >= 28 and names <= set(nodes), sorted(names - set(nodes))
    # the serving engine's locks are witnessed like the rest of the tier (JAX's are)
    assert {"ServeEngine._swap_lock", "ServeEngine._swap_gate", "ServeEngine._dispatch_lock"} <= names
    assert nodes["ServeEngine._swap_gate"]["kind"] == "rlock" and nodes["loadgen:mlock"]["kind"] == "lock"
    # the graph holds JAX's committed edges, rekeyed, and the constructor edge JAX's model misses
    jedges = {(e["src"], e["dst"]) for e in json.loads((ROOT / "results/lockgraph/lockgraph.json").read_text())["edges"]}
    tedges = {(e["src"], e["dst"]) for e in graph["edges"]}
    assert jedges <= tedges and ("events:_bus_guard", "events:_epoch_lock") in tedges - jedges


def test_renamed_lock_attribute_and_class_are_dead_map_entries():
    """A rename in the code under a lock map row: the row goes dead, on the
    class line for a lock attribute, on the port's map literal for a class."""
    rel = "qdml_tpu_torch/serve/breaker.py"
    src = (ROOT / rel).read_text()
    project_src = (ROOT / tconc.PROJECT_PATH).read_text()
    lock_map = {rel: tproject.LOCK_MAP[rel]}
    ctxs = [_ctx(tengine, src.replace("self._lock", "self._state_lock"), rel),
            _ctx(tengine, project_src, tconc.PROJECT_PATH)]
    grouped, _ = tconc.analyze_modules(ctxs, lock_map=lock_map)
    dead = [f for fs in grouped.values() for f in fs if f.rule == "dead-lock-map-entry"]
    assert len(dead) == 3 and {f.path for f in dead} == {rel}
    assert all("self._lock is not constructed as a lock" in f.message for f in dead)
    ctxs[0] = _ctx(tengine, src.replace("class CircuitBreaker", "class Breaker"), rel)
    grouped, _ = tconc.analyze_modules(ctxs, lock_map=lock_map)
    dead = [f for fs in grouped.values() for f in fs if f.rule == "dead-lock-map-entry"]
    map_line = next(i for i, ln in enumerate(project_src.splitlines(), 1) if ln.startswith("LOCK_MAP"))
    assert [(f.path, f.line) for f in dead] == [(tconc.PROJECT_PATH, map_line)]
    assert "class 'CircuitBreaker'" in dead[0].message
    # the real tree and map: nothing dead
    grouped, _ = tconc.analyze_modules([_ctx(tengine, src, rel), ctxs[1]], lock_map=lock_map)
    assert not [f for fs in grouped.values() for f in fs if f.rule == "dead-lock-map-entry"]


def test_torch_fences_are_blocking_calls():
    assert {"synchronize", "item", "cpu", "tolist"} <= tproject.BLOCKING_CALLS
    src = textwrap.dedent("""
        import threading
        import torch


        class Swap:
            def __init__(self):
                self._gate = threading.Lock()

            def fence(self, t):
                with self._gate:
                    torch.cuda.synchronize()
                    n = t.item()
                    return t.cpu(), t.tolist(), n
        """)
    grouped, _ = _analyze("qdml_tpu_torch", "serve/swap.py", src, {})
    found = sorted((f.line, f.message.split("(")[0]) for fs in grouped.values() for f in fs)
    # one finding a call (the engine keeps one a line)
    assert [m for _l, m in found] == ["synchronize", "item", "cpu", "tolist"] and len({ln for ln, _m in found}) == 3
    # JAX's table knows none of torch's fences
    assert _keys(_analyze("qdml_tpu", "serve/swap.py", src, {})[0]) == []


def test_lockdep_witness_on_the_cpu_edges_are_static_edges(tmp_path):
    """The runtime twin: a replica crash and a hot swap in a process of their
    own with QDML_LOCKDEP=1 witness no inversion, and every order edge they
    take is an edge of the committed static graph."""
    env = dict(os.environ, QDML_LOCKDEP="1")
    run = subprocess.run(
        [sys.executable, "-m", "qdml_tpu_torch.scripts.lockdep_witness", "--device=cpu",
         f"--train.workdir={tmp_path / 'ws'}", "--quantum.n_qubits=4", "--quantum.n_layers=1",
         "--serve.workers=2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
    )
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-2000:])
    rec = json.loads(run.stdout.strip().splitlines()[-1])
    assert rec["lockdep"]["inversions"] == 0 and rec["lockdep"]["locks"] > 0 and rec["lockdep"]["edges"] > 0
    assert rec["fired"] and rec["restarts"] >= 1 and rec["swap_epoch"] == 1
    graph = json.loads((ROOT / tconc.LOCKGRAPH_DIR / "lockgraph.json").read_text())
    static = {(e["src"], e["dst"]) for e in graph["edges"]}
    assert {tuple(e) for e in rec["edges"]} <= static
    assert ["ServeEngine._swap_gate", "ServeEngine._swap_lock"] in rec["edges"]
    # without the variable the witness refuses to run
    env.pop("QDML_LOCKDEP")
    run = subprocess.run([sys.executable, "-m", "qdml_tpu_torch.scripts.lockdep_witness", "--device=cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "QDML_LOCKDEP=1" in run.stderr
