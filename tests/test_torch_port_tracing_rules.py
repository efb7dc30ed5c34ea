"""The torch counterparts of JAX's tracing rules (``qdml_tpu_torch/analysis/
rules.py``) against JAX's (``qdml_tpu/analysis/rules.py``).

Each of the ten rules gets a mirrored pair: the same function once under
``@jax.jit`` through JAX's rule and once captured for the port's (handed to
``make_scan_steps``, the K-step runner that captures it into a CUDA graph),
with ``jnp`` where the port has ``torch``: the two report on the same lines
with the same contexts, and the port's clean twin reports nothing. Then the
``captured`` roots one by one, the serve request path, the three JAX rules
with no counterpart, and ``whole_program=False``, which leaves the
per-module results as they were before the concurrency pass.
"""

import ast
import contextlib
import io
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from qdml_tpu.analysis import engine as jengine  # noqa: E402
from qdml_tpu.analysis.rules import RULES as JRULES  # noqa: E402
from qdml_tpu_torch.analysis import cli as tcli  # noqa: E402
from qdml_tpu_torch.analysis import engine as tengine  # noqa: E402
from qdml_tpu_torch.analysis.rules import RULES as TRULES  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# line for line the same skeleton: JAX's jit decorator where the port has a
# comment, JAX's and torch's namespace, and at the end the port's capture
HEAD = {
    "jax": "import time\nimport numpy as np\nimport jax\nimport jax.numpy as jnp\nfrom jax.experimental import pallas as pl\n",
    "torch": ("import time\nimport numpy as np\nimport torch\nfrom qdml_tpu_torch.quantum import kernels as K\n"
              "from qdml_tpu_torch.train.scan import make_scan_steps\n"),
}
DEC = {"jax": "@jax.jit", "torch": "# captured: handed to make_scan_steps below"}
NS = {"jax": "jnp", "torch": "torch"}
TAIL = {"jax": "RUNNER = None", "torch": "RUNNER = make_scan_steps(step, None, None, 4)"}


def _src(body: str, fw: str, launch: str = "") -> str:
    launch = launch or ("pl.pallas_call(kernel, out_shape=x)" if fw == "jax" else "K.apply_rotation_layer")
    return HEAD[fw] + textwrap.dedent(body).format(dec=DEC[fw], ns=NS[fw], tail=TAIL[fw], launch=launch)


# rule -> (a violating body, its clean twin); {dec} decorates the function
# JAX jits and the port captures, {ns} is jnp or torch, {tail} the capture
PAIRS = {
    "jit-mutable-global": ("""
        TABLE = {{"scale": 2.0}}


        {dec}
        def step(x):
            return x * TABLE["scale"]


        {tail}
        """, """
        TABLE = (("scale", 2.0),)


        {dec}
        def step(x):
            return x * TABLE[0][1]


        {tail}
        """),
    "tracer-branch": ("""
        {dec}
        def step(x):
            total = {ns}.sum(x)
            if total > 0:
                return x
            while {ns}.any(x < 0):
                x = x + 1
            return -x


        {tail}
        """, """
        {dec}
        def step(x, probes=False):
            if probes:
                return {ns}.where(x > 0, x, -x)
            return -x


        {tail}
        """),
    "host-sync-hot-path": ("""
        {dec}
        def step(x):
            v = x.item()
            w = float(x)
            return np.asarray(x) * v * w


        {tail}
        """, """
        {dec}
        def step(x, scale):
            w = float(2.0)
            return x * scale * w


        {tail}
        """),
    "wall-clock-in-jit": ("""
        {dec}
        def step(x):
            return x * time.time()


        {tail}
        """, """
        {dec}
        def step(x, t):
            return x * t


        {tail}
        """),
    "data-dependent-shape-in-jit": ("""
        {dec}
        def step(x, y):
            (idx,) = {ns}.nonzero(x > 0)
            ids = {ns}.unique(y)
            pos = {ns}.where(x > 0)
            mask = y > 0
            return x[mask], x[y < 0], idx, ids, pos


        {tail}
        """, """
        {dec}
        def step(x, y):
            return {ns}.where(y > 0, x, 0.0)


        {tail}
        """),
    "trace-in-jit-path": ("""
        {dec}
        def step(x, rid):
            ctx = TraceContext(rid)
            ctx.add_phase("step", 0.0)
            return x


        {tail}
        """, """
        {dec}
        def step(x, rid):
            return x


        {tail}
        """),
    "gate-matrix-in-loop": ("""
        def ansatz(w, n_layers):
            out = []
            for l in range(n_layers):
                out.append(rot_gate(w[l, 0], w[l, 1]))
            return out
        """, """
        def ansatz(w, n_layers):
            u = rot_gate(w[:, 0], w[:, 1])
            return [u] * n_layers
        """),
    "pallas-host-loop": ("""
        def per_layer(x, w, n_layers, kernel):
            for l in range(n_layers):
                x = {launch}(x)
            return x
        """, """
        def sweep(x, w, ns, kernel):
            outs = []
            for n in ns:
                outs.append({launch}(x))
            return outs
        """),
}
# the port's launches take their arguments
LAUNCH = {"pallas-host-loop": ("K.apply_rotation_layer", "x, w[l], 14", "x, w[0], n")}


def _ctx(mod, src: str, path: str = "pkg/mod.py"):
    return mod.ModuleContext(f"/fake/{path}", path, src, ast.parse(src))


def _run(rule_id: str, fw: str, src: str, path: str = "pkg/mod.py") -> list[tuple[int, str]]:
    mod, rules = (jengine, JRULES) if fw == "jax" else (tengine, TRULES)
    return sorted((f.line, f.context) for f in rules[rule_id][0](_ctx(mod, src, path)))


def _pair(rule_id: str, clean: bool = False) -> tuple[str, str]:
    body = PAIRS[rule_id][int(clean)]
    if rule_id == "pallas-host-loop":
        port_args = LAUNCH[rule_id][2 if clean else 1]
        return _src(body, "jax"), _src(body.replace("{launch}(x)", "{launch}(" + port_args + ")"), "torch",
                                       launch=LAUNCH[rule_id][0])
    return _src(body, "jax"), _src(body, "torch")


@pytest.mark.parametrize("rule_id", sorted(PAIRS))
def test_rule_matches_jax_on_a_mirrored_pair(rule_id):
    jsrc, tsrc = _pair(rule_id)
    assert len(jsrc.splitlines()) == len(tsrc.splitlines())
    want = _run(rule_id, "jax", jsrc)
    assert want and _run(rule_id, "torch", tsrc) == want
    _jclean, tclean = _pair(rule_id, clean=True)
    assert _run(rule_id, "torch", tclean) == []


IMPORT_TIME = {
    "jax": "import jax.numpy as jnp\nX = jnp.zeros(3)\n\n\ndef f():\n    return jnp.ones(2)\n",
    "torch": "import torch\nX = torch.zeros(3, device='cuda')\n\n\ndef f():\n    return torch.ones(2, device='cuda')\n",
}


def test_import_time_rule_matches_jax_and_names_the_card():
    want = _run("import-time-jnp", "jax", IMPORT_TIME["jax"])
    assert want == [(2, "")] and _run("import-time-jnp", "torch", IMPORT_TIME["torch"]) == want
    bad = textwrap.dedent("""
        import torch
        A = torch.ones(2).cuda()
        B = torch.empty(4, device=torch.device("cuda:0"))
        C = torch.zeros(2).to("cuda")
        torch.cuda.set_device(0)
        if torch.cuda.is_available():
            D = torch.zeros(1, device="cuda")
        """)
    assert [line for line, _c in _run("import-time-jnp", "torch", bad)] == [3, 4, 5, 6, 8]
    clean = textwrap.dedent("""
        import torch
        A = torch.ones(2)
        HAVE = torch.cuda.is_available() and torch.cuda.device_count() > 0
        E = torch.zeros(2, device="cpu")


        class K:
            BUF = torch.zeros(1, device="cuda")  # a class body is not walked (JAX's rule skips it too)
        """)
    assert _run("import-time-jnp", "torch", clean) == []


def test_pad_to_bucket_is_scoped_to_serve_and_matches_jax():
    body = textwrap.dedent("""
        import numpy as np


        def pad_batch(x, buckets):
            b = pick_bucket(len(x), buckets)
            xp = np.zeros((b,) + x.shape[1:], np.float32)
            xp[: len(x)] = x
            return xp


        def label(x, buckets):
            return pick_bucket(len(x), buckets)
        """)
    want = _run("pad-to-bucket-in-serve", "jax", body, "qdml_tpu/serve/batching.py")
    assert want == [(6, "pad_batch")]
    assert _run("pad-to-bucket-in-serve", "torch", body, "qdml_tpu_torch/serve/batching.py") == want
    # the port's rule reads serve/ modules only; JAX's reads every module
    assert _run("pad-to-bucket-in-serve", "torch", body, "qdml_tpu_torch/fleet/router.py") == []


def test_host_sync_on_the_serve_request_path_and_torch_fences():
    src = textwrap.dedent("""
        import numpy as np
        import torch


        class ServeEngine:
            def infer(self, x):
                h = self.forward(x)
                n = int(len(x))
                return h.item(), np.asarray(h), n

            def warmup(self):
                return self.forward(0).item()
        """)
    want = _run("host-sync-hot-path", "jax", src, "qdml_tpu/serve/engine.py")
    assert want == [(10, "ServeEngine.infer")] * 2
    assert _run("host-sync-hot-path", "torch", src, "qdml_tpu_torch/serve/engine.py") == want
    fences = textwrap.dedent("""
        import torch
        from qdml_tpu_torch.train.scan import make_scan_steps


        def step(x):
            torch.cuda.synchronize()
            y = x.cpu()
            z = x.tolist()
            return bool(x), y, z


        RUNNER = make_scan_steps(step, None, None, 4)
        """)
    assert [line for line, _c in _run("host-sync-hot-path", "torch", fences)] == [7, 8, 9, 10]


def test_pallas_host_loop_counts_only_carried_launches():
    src = textwrap.dedent("""
        from qdml_tpu_torch.quantum import kernels as K


        def layers(psi, w, n_layers, n):
            for l in range(n_layers):
                psi = K.apply_rotation_layer(psi, w[l], n)
            return psi


        def pairs(a, w, n_layers):
            for l in range(n_layers):
                ev, fre, fim = K.fused_circuit_expvals(a, w, 6, l, return_state=True)
                a, w = K.circuit_adjoint(fre, fim, ev, a, w, 6, l)
            return a


        def sweep(t, x, ns):
            for n in ns:
                t["ms"] = K.fused_unitary_expvals(x[n], t["u"], n)
                raw = _launch("rotation_layer", x, n)
            return t


        def comprehension(x, w, ns):
            return [K.apply_rotation_layer(x, w, n) for n in ns]
        """)
    assert _run("pallas-host-loop", "torch", src) == [(7, "layers"), (14, "pairs")]


# ---------------------------------------------------------------------------
# The captured set, root by root
# ---------------------------------------------------------------------------


def _captured(src: str) -> set[str]:
    ctx = _ctx(tengine, textwrap.dedent(src))
    return {ctx.qualname(fn) for fn in ctx.captured}


def test_captured_root_make_scan_steps_through_a_step_maker():
    assert _captured("""
        from qdml_tpu_torch.train.scan import make_scan_steps


        def loss(model, batch):
            return model(batch)


        def train_step(model, opt, batch):
            return loss(model, batch)


        def _step_fn(model, opt):
            def step(batch, noise):
                return train_step(model, opt, batch)
            return step


        def host_only(x):
            return x


        def make(model, opt, data, k):
            return make_scan_steps(_step_fn(model, opt), data, opt, k)
        """) == {"_step_fn", "train_step", "loss"}  # the nested step is walked as _step_fn's body, as JAX's


def test_captured_root_graph_block_and_graphed_callables():
    assert _captured("""
        import torch


        def _stack(outs):
            return outs


        class Runner:
            def _steps(self, idx):
                return _stack([self.step_fn(i) for i in idx])

            def _capture(self, graph, idx):
                with torch.cuda.graph(graph):
                    out = self._steps(idx)
                return out

            def replay(self, graph):
                graph.replay()


        def fwd(x):
            return x


        def host(x):
            return x


        G = torch.cuda.make_graphed_callables(fwd, (None,))
        """) == {"Runner._steps", "_stack", "fwd"}


def test_captured_root_autograd_function_and_kernel_wrappers():
    assert _captured("""
        import torch


        def _launch(name, dev, *args):
            return _load(name)


        def _load(name):
            return name


        def _qsc_launch(a):
            return _launch("qsc_expvals", None, a)


        def fused_qsc_expvals(a):
            return _qsc_launch(a)


        def qsc_expvals_plain(a):
            return a


        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, a):
                return qsc_expvals_plain(a)

            @staticmethod
            def backward(ctx, g):
                return g

            def helper(self):
                return 0
        """) == {"_launch", "_load", "_qsc_launch", "fused_qsc_expvals", "qsc_expvals_plain", "_Fn.forward",
                 "_Fn.backward"}


def test_nothing_is_captured_without_a_root():
    assert _captured("""
        import torch


        def step(x):
            return torch.any(x).item()


        def run(xs):
            return [step(x) for x in xs]
        """) == set()


def test_the_port_tree_captured_paths():
    """On the port itself: the trainers' steps, the runner's capture, the
    kernel wrappers and the autograd Functions are captured; the host loops
    that call them are not."""
    def caps(rel):
        ctx = _ctx(tengine, (ROOT / rel).read_text(), rel)
        return {ctx.qualname(fn) for fn in ctx.captured}

    assert {"_step_fn", "hdce_train_step", "hdce_loss"} <= caps("qdml_tpu_torch/train/hdce.py")
    assert "train_hdce" not in caps("qdml_tpu_torch/train/hdce.py")
    scan = caps("qdml_tpu_torch/train/scan.py")
    assert "ScanSteps._steps" in scan and "ScanSteps.__call__" not in scan
    kern = caps("qdml_tpu_torch/quantum/kernels.py")
    assert {"_launch", "fused_qsc_expvals", "fused_circuit_expvals", "apply_rotation_layer",
            "fused_unitary_expvals", "circuit_adjoint", "_CircuitExpvals.forward"} <= kern
    assert "build" in kern  # through _launch -> _load: its clock reads carry reasoned suppressions


# ---------------------------------------------------------------------------
# The registry, --list-rules and whole_program=False
# ---------------------------------------------------------------------------


def test_rules_without_a_counterpart_are_not_listed():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.lint_main(["--list-rules"]) == 0
    listed = [ln.split()[0] for ln in buf.getvalue().splitlines()]
    assert len(listed) == 17 + 5 + 1 and listed[-1] == "slow-marker"
    for rule_id in ("train-step-jit-audit", "pallas-interpret-literal", "collective-outside-shardmap"):
        assert rule_id in JRULES and rule_id not in listed
    assert set(PAIRS) | {"import-time-jnp", "pad-to-bucket-in-serve"} <= set(listed)


NEUTRAL = ("primary-only-collective", "serve-lock-discipline", "stranded-future", "broad-except",
           "retry-without-backoff", "unbounded-readline", "unwindowed-cumulative-rate")
FIXTURES = ("tests/fixtures/lint/violations.py", "tests/fixtures/lint/serve/violations.py",
            "tests/fixtures/lint/telemetry/rate_violations.py", "tests/fixtures/lint/clean.py")


def _fkeys(findings):
    return sorted((f.rule, f.path, f.line, f.context, f.text, f.suppressed) for f in findings)


def test_whole_program_false_is_the_per_module_run():
    """``run(whole_program=False)`` is the file-by-file run the gate made
    before the concurrency pass (``lint_file`` alone, no model kept); the
    whole-program run adds concurrency findings and nothing else."""
    eng = tengine.LintEngine(str(ROOT), rules=[TRULES[r][0] for r in NEUTRAL])
    off = eng.run(list(FIXTURES), whole_program=False)
    assert eng.model is None and off.errors == []
    per_file = [f for rel in FIXTURES for f in eng.lint_file(rel)[0]]
    assert _fkeys(off.new + off.suppressed) == _fkeys(per_file)
    on = eng.run(list(FIXTURES))
    assert eng.model is not None
    extra = set(_fkeys(on.new + on.suppressed)) - set(_fkeys(off.new + off.suppressed))
    from qdml_tpu_torch.analysis.concurrency import CONCURRENCY_RULES

    assert all(k[0] in CONCURRENCY_RULES for k in extra)
    assert set(_fkeys(off.new + off.suppressed)) <= set(_fkeys(on.new + on.suppressed))
