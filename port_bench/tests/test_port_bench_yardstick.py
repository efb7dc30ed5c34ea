"""The yardstick's copy agrees with what it was copied from: the FLOP model
with ``qdml_tpu_torch/bench.py``; and the check that no JAX is loaded
compares top-level names whole."""

from __future__ import annotations

import pytest

from port_bench import harness, work


@pytest.mark.parametrize("preset", ["default", "dp_8q"])
def test_flop_model_matches_the_ports_bench(preset):
    from qdml_tpu_torch import bench, config

    cfg = config.ExperimentConfig() if preset == "default" else config.preset(preset)
    assert work.hdce_fwd_flops_per_sample(cfg.image_hw, cfg.model.features, cfg.h_out_dim) == \
        bench.hdce_fwd_flops_per_sample(cfg)


def test_the_peak_matches_the_smokes():
    import chip_smoke

    assert work.PEAK_FP32_FLOPS == chip_smoke.PEAK_FP32_FLOPS


@pytest.mark.parametrize("loaded,found", [
    (["qdml_tpu_torch", "qdml_tpu_torch.serve.engine", "torch"], []),
    (["qdml_tpu", "qdml_tpu.config"], ["qdml_tpu", "qdml_tpu.config"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax.linen", "jax", "jaxlib.xla_client"]),
    (["jax_like", "flaxen", "qdml_tpu_torchvision"], []),
])
def test_forbidden_modules_compare_top_level_names_whole(loaded, found):
    assert harness.forbidden_modules(loaded) == found


def test_a_cpu_run_loads_no_jax(tmp_path):
    import subprocess
    import sys

    from .conftest import REPO, TINY

    script = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from port_bench import harness\n"
        "harness.run_cell('hdce_train.p128_6q', 3, 0.2, False, time.perf_counter(), device='cpu',\n"
        f"                 extra={TINY!r}, log=lambda m: None)\n"
        "print(harness.forbidden_modules())\n"
    )
    env = {"QDML_TORCH_QSC_AUTOTUNE_TABLE": str(tmp_path / "t.json"), "PATH": "/usr/bin:/bin"}
    got = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300, env=env)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
