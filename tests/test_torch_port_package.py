"""The port stands alone: no JAX, the card by default, kernels built from source.

``qdml_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
package (checked in a fresh interpreter and by an AST scan); every entry
point raises without a GPU unless the caller asks for the CPU; the kernel
wrappers take their plain versions only for CPU tensors and validate what
they are handed.
"""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import qdml_tpu_torch  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "qdml_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "qdml_tpu")
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the mesh slice's modules, which the whole-package import must bring in
MESH_MODULES = tuple(f"qdml_tpu_torch.{m}" for m in (
    "parallel", "parallel.mesh", "parallel.collectives", "parallel.multihost", "parallel.dp",
    "parallel.federated", "parallel.selfcheck", "quantum.sharded",
))
# the fleet slice's modules: host code, which imports no JAX either
FLEET_MODULES = tuple(f"qdml_tpu_torch.{m}" for m in (
    "fleet", "fleet.router", "fleet.spawn", "fleet.lifecycle", "fleet.poller", "fleet.frontend",
    "control.fleet_scale",
))
# the telemetry slice's modules: the device half of qdml_tpu/telemetry/
TELEMETRY_MODULES = tuple(f"qdml_tpu_torch.telemetry.{m}" for m in (
    "core", "manifest", "counters", "spans", "numerics", "sanitizer", "cost", "report",
))
# the host half: the flight deck (events, plan, monitor) and the native IO
# runtime behind the .npy grid loader
HOST_MODULES = tuple(f"qdml_tpu_torch.{m}" for m in (
    "telemetry.events", "telemetry.capacity", "telemetry.burnrate", "telemetry.timeseries", "telemetry.attach",
    "runtime", "runtime.native_io",
))
# the lint gate over the port's own tree: standard library only
ANALYSIS_MODULES = tuple(f"qdml_tpu_torch.analysis{m}" for m in (
    "", ".engine", ".project", ".rules", ".slowmarkers", ".cli", ".concurrency",
))


def test_import_everything_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys, qdml_tpu_torch\n"
        "for m in pkgutil.walk_packages(qdml_tpu_torch.__path__, 'qdml_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        f"assert set({MESH_MODULES!r}) <= set(sys.modules)\n"
        f"assert set({FLEET_MODULES!r}) <= set(sys.modules)\n"
        f"assert set({TELEMETRY_MODULES!r}) <= set(sys.modules)\n"
        f"assert set({HOST_MODULES!r}) <= set(sys.modules)\n"
        f"assert set({ANALYSIS_MODULES!r}) <= set(sys.modules)\n"
        "print(len([m for m in sys.modules if m.startswith('qdml_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 105  # every module of the seventeen slices was imported


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name}:{node.lineno} imports {name}"


def test_every_module_has_a_jax_counterpart_or_is_the_kernels():
    """Same layout as the JAX package: each port module sits at the path of
    its counterpart, except the kernel module and its CUDA sources."""
    for path in PKG.rglob("*.py"):
        rel = path.relative_to(PKG)
        if rel.name == "__init__.py" or rel == Path("quantum/kernels.py"):
            continue
        if rel == Path("interop.py"):
            assert (ROOT / "qdml_tpu/train/torch_interop.py").exists()
            continue
        if rel == Path("utils/device.py"):
            assert (ROOT / "qdml_tpu/utils/platform.py").exists()
            continue
        if rel == Path("scripts/quantum_microbench.py"):
            assert (ROOT / "scripts/r3_quantum_microbench.py").exists()
            continue
        if rel == Path("bench.py"):  # the JAX package's bench is the repo root's
            assert (ROOT / "bench.py").exists()
            continue
        if rel == Path("parallel/collectives.py"):  # XLA inserts JAX's collectives
            continue
        if rel == Path("parallel/selfcheck.py"):  # the rank programs, JAX's a test worker
            assert (ROOT / "tests/multihost_worker.py").exists()
            continue
        if rel == Path("scripts/lockdep_witness.py"):  # the lockdep block of JAX's chaos dryrun
            assert (ROOT / "scripts/chaos_dryrun.py").exists()
            continue
        if rel in (Path("scripts/fleet_phase_alone.py"), Path("scripts/warmup_cost.py"),
                   Path("scripts/profiler_drops.py")):
            continue  # measurements of the port's own smoke, serving warmup and profiler sessions
        assert (ROOT / "qdml_tpu" / rel).exists(), rel
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu")) == [
        "bn_relu.cu", "circuit_adjoint.cu", "circuit_expvals.cu", "qsc_expvals.cu", "qsc_front.cu",
        "rotation_layer.cu", "unitary_expvals.cu",
    ]


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(monkeypatch):
    _no_gpu(monkeypatch)
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.quantum.statevector import zero_state
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.train.hdce import build_hdce, init_hdce_state, train_hdce
    from qdml_tpu_torch.train.qsc import train_classifier

    cfg = tconfig.ExperimentConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, {}, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_hdce(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_classifier(cfg, quantum=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zero_state(2)
    from qdml_tpu_torch.data import baselines, channels, datasets
    from qdml_tpu_torch.eval.sweep import SweepModels, run_snr_sweep
    from qdml_tpu_torch.scripts import quantum_microbench

    geom = channels.ChannelGeometry()
    for entry in (lambda: train_hdce(cfg), lambda: train_classifier(cfg, True),
                  lambda: init_hdce_state(cfg), lambda: GridData.synthesize(cfg.data),
                  lambda: datasets.generate_datapair(4, 128, -1, 10.0, 0),
                  lambda: datasets.sweep_batch(cfg.data, 0, 0, 4, 10.0),
                  lambda: datasets.save_npy_cache("unused", cfg.data),
                  lambda: baselines.beam_delay_profile(geom),
                  lambda: run_snr_sweep(cfg, SweepModels(None, None)),
                  lambda: quantum_microbench.run(4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qdml_tpu_torch.resolve_device("cuda")
    assert qdml_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_resolve_device_sets_fp32_math():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    qdml_tpu_torch.resolve_device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_wrappers_validate_before_launch(monkeypatch):
    """The launch path checks shape, dtype and contiguity before it touches
    the library (which cannot be built or loaded here)."""
    monkeypatch.setattr(tk, "_load", lambda name: pytest.fail("reached the loader"))
    a = torch.zeros(4, 6)
    u = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="shape"):
        tk._qsc_launch(a, torch.zeros(32, 64), u, 6)
    with pytest.raises(TypeError, match="float32"):
        tk._qsc_launch(a.double(), u, u, 6)
    with pytest.raises(ValueError, match="contiguous"):
        tk._qsc_launch(a, u.t(), u, 6)
    with pytest.raises(ValueError, match="1 <= n"):
        tk._qsc_launch(torch.zeros(4, 9), torch.zeros(512, 512), torch.zeros(512, 512), 9)
    with pytest.raises(ValueError, match="layers"):
        tk._circuit_launch(torch.zeros(4, 8), torch.zeros(0, 8, 2), 8, 0, False)
    with pytest.raises(ValueError, match="n=13"):
        tk._circuit_launch(torch.zeros(4, 13), torch.zeros(1, 13, 2), 13, 1, False)
    with pytest.raises(ValueError, match="shape"):
        tk._circuit_launch(torch.zeros(4, 8), torch.zeros(2, 8), 8, 2, False)


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(-1, 1, (3, 5)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-3, 3, (2, 5, 2)), dtype=torch.float32)
    tk.reset_launch_counts()
    ev, re, im = tk.fused_circuit_expvals(a, w, 5, 2, return_state=True)
    pev, pre, pim = tk.circuit_expvals_plain(a, w, 5, 2)
    assert torch.equal(ev, pev) and torch.equal(re, pre) and torch.equal(im, pim)
    assert tk.fused_circuit_expvals(a[None], w, 5, 2).shape == (1, 3, 5)  # lead axes kept
    assert tk.launches == {name: 0 for name in tk.COUNTERS}
    assert set(tk.KERNELS) == {
        "qsc_expvals", "circuit_expvals", "circuit_adjoint", "rotation_layer", "unitary_expvals"
    }


def test_library_path_is_keyed_by_source_and_lives_in_build():
    for name in tk.SOURCES:
        path = tk.library_path(name)
        assert path.parent == ROOT / "build" / "qdml_tpu_torch"
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert (tk.CSRC / f"{name}.cu").exists()
    assert tk.library_path("qsc_expvals") != tk.library_path("circuit_expvals")
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_cuda_sources_declare_their_c_interface():
    for name in tk.KERNELS:
        text = (tk.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in text
        assert "cudaGetLastError()" in text
        assert "Replaces the TPU kernel" in text


def test_config_defaults_match_the_jax_config():
    from qdml_tpu import config as jconfig

    t, j = tconfig.ExperimentConfig(), jconfig.ExperimentConfig()
    assert (t.image_hw, t.h_out_dim) == (j.image_hw, j.h_out_dim)
    for sect in ("data", "model", "quantum", "train", "serve", "mesh", "fleet", "control"):
        for field, value in vars(getattr(t, sect)).items():
            assert getattr(getattr(j, sect), field) == value, (sect, field)


def test_submodules_import():
    mods = [m.name for m in pkgutil.walk_packages(qdml_tpu_torch.__path__, "qdml_tpu_torch.")]
    for name in mods:
        importlib.import_module(name)
    assert "qdml_tpu_torch.quantum.kernels" in mods and "qdml_tpu_torch.serve.engine" in mods
    assert set(MESH_MODULES) <= set(mods)
    assert set(FLEET_MODULES) <= set(mods)
    assert set(TELEMETRY_MODULES) <= set(mods)
    assert set(ANALYSIS_MODULES) <= set(mods)
    for name in ("data.channels", "data.datasets", "train.optim", "train.qsc", "train.checkpoint",
                 "ops.quantumnat", "ops.grad_prune", "models.losses", "utils.metrics", "cli",
                 "data.baselines", "eval.sweep", "eval.report", "eval.loss_curves",
                 "scripts.quantum_microbench"):
        assert f"qdml_tpu_torch.{name}" in mods, name
