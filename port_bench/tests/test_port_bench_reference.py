"""The plain reference agrees with ``qdml_tpu_torch`` at a small size on
the CPU: the HDCE loss and its gradients, the Adam updates, BatchNorm's
running statistics, and the batch built from the grid."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import checks, harness, inputs
from port_bench.reference import models, train
from port_bench.reference.optim import Adam

from .conftest import TINY

CPU = torch.device("cpu")


def _cfg():
    return harness.experiment_config(harness.config_file("p128_6q"), TINY)


def test_grid_batch_matches_griddata():
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train.hdce import grid_images

    cfg = _cfg()
    geom = harness.geometry(cfg)
    rows = inputs.make_grid(geom, 3, 3, 32, 11, CPU)
    idx = torch.as_tensor(inputs.step_indices(1, 3, 3, 8, 32, 11)[0])
    ours_img, ours_label = train.grid_batch(rows, idx, 10.0, geom)
    batch = GridData(cfg.data, rows, cached=False).batch(idx, torch.tensor(10.0))
    torch.testing.assert_close(ours_label, batch["h_label"])
    theirs = grid_images(batch).reshape(ours_img.shape)
    torch.testing.assert_close(ours_img, theirs)


@pytest.mark.parametrize("n_users", [3, 2])
def test_three_steps_match_the_ports_trainer(n_users):
    """The reference's losses, first gradient, parameters and BatchNorm
    running statistics (which decay by 0.9 ** n_users a step) after three
    steps against the port's per-step trainer from the same weights."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import hdce

    cfg = harness.experiment_config(harness.config_file("p128_6q"), {**TINY, "data.n_users": n_users})
    geom = harness.geometry(cfg)
    s, u = cfg.data.n_scenarios, cfg.data.n_users
    rows = inputs.make_grid(geom, s, u, 32, 5, CPU)
    idx = [torch.as_tensor(i) for i in inputs.step_indices(3, s, u, 8, 32, 5)]
    specs = models.hdce_specs(s, cfg.model.features, cfg.image_hw, cfg.h_out_dim)
    w0 = inputs.make_weights(specs, 5, "weights", CPU)
    names = models.trainable(specs)
    ref = train.follow(w0, names, rows, idx, 10.0, geom, cfg.train.lr)
    data = GridData(cfg.data, rows, cached=False)
    model, opt = hdce.make_trainer(cfg, CPU, steps_per_epoch=100)
    model.load_state_dict(w0)
    model.train()
    params = dict(model.named_parameters())
    losses = []
    for i, ix in enumerate(idx):
        losses.append(float(hdce.hdce_train_step(model, opt, data.batch(ix, 10.0))["loss"]))
        if i == 0:
            for k in names:
                torch.testing.assert_close(opt.opt.state[params[k]]["exp_avg"] / 0.1, ref["grad1"][k],
                                           rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    # entries with no gradient to speak of move by the sign of their
    # round-off: the check leaves them out, as here
    rms = np.median([float(g.norm()) / g.numel() ** 0.5 for g in ref["grad1"].values()])
    for k in names:
        moving = ref["grad1"][k].abs() >= checks.STILL_LEAF * rms
        torch.testing.assert_close(params[k].detach()[moving], ref["after"][k][moving], rtol=1e-4, atol=1e-6)
    buffers = dict(model.named_buffers())
    assert sorted(ref["stats"]) == sorted(models.running(specs))
    for k, v in ref["stats"].items():
        assert not torch.equal(v, w0[k])
        torch.testing.assert_close(buffers[k], v, rtol=1e-5, atol=1e-6)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(5, 4, generator=g)
    grads = [torch.randn(5, 4, generator=g) for _ in range(3)]
    ours = {"w": p0.clone()}
    opt = Adam(ours, lr=1e-3)
    theirs = p0.clone().requires_grad_(True)
    topt = torch.optim.Adam([theirs], lr=1e-3, eps=1e-8)
    for gr in grads:
        opt.step({"w": gr})
        theirs.grad = gr.clone()
        topt.step()
    torch.testing.assert_close(ours["w"], theirs.detach(), rtol=1e-6, atol=1e-7)


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in (Path(models.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("qdml_tpu_torch", "qdml_tpu", "jax", "flax"), (path, name)
