"""The port's optimizers, schedule, gradient pruning and QuantumNAT perturbation
against the JAX package (optax), on the CPU.

The same gradient sequence (numpy, seeded) drives the port's optimizer and
the JAX package's ``get_optimizer`` for 32 updates at one step per epoch, so
the schedule halves the rate at the 30-epoch boundary inside the run.
Parameters must agree to rtol 1e-5 / atol 1e-6: float32 rounding of the
same update formulas, grouped differently. Pruning masks and ratios must be
equal, ties at the cutoff included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from qdml_tpu.config import QuantumConfig as JQuantumConfig  # noqa: E402
from qdml_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from qdml_tpu.ops.grad_prune import gradient_prune  # noqa: E402
from qdml_tpu.train import optim as joptim  # noqa: E402
from qdml_tpu_torch.config import QuantumConfig, TrainConfig  # noqa: E402
from qdml_tpu_torch.ops.grad_prune import gradient_prune_  # noqa: E402
from qdml_tpu_torch.ops.quantumnat import perturb  # noqa: E402
from qdml_tpu_torch.train import optim as toptim  # noqa: E402

SHAPES = {"a": (4, 3), "b": (5,)}


def _run_both(optimizer, steps, quantum=None, jquantum=None, lr=1e-2):
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    kw = dict(optimizer=optimizer, lr=lr, lr_decay_epochs=30, weight_decay=0.05, momentum=0.8)
    tx = joptim.get_optimizer(JTrainConfig(**kw), 1, jquantum)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tparams = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = toptim.get_optimizer(TrainConfig(**kw), tparams.values(), 1, quantum)
    for g in grads:
        upd, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    return tparams, jp, opt


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_optimizer_updates_match_optax_across_the_decay_boundary(optimizer):
    tparams, jp, opt = _run_both(optimizer, steps=32)
    assert opt.count == 32
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd"])
def test_first_updates_match_optax(optimizer):
    for steps in (1, 2, 3):
        tparams, jp, _ = _run_both(optimizer, steps)
        for k in SHAPES:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_schedule_matches_the_jax_schedule():
    cfg, jcfg = TrainConfig(lr=1e-3, lr_floor=1e-6), JTrainConfig(lr=1e-3, lr_floor=1e-6)
    sched, jsched = toptim.lr_schedule(cfg, 7), joptim.lr_schedule(jcfg, 7)
    for step in (0, 6, 7, 209, 210, 211, 420, 7 * 30 * 12, 10**7):
        np.testing.assert_allclose(sched(step), float(jsched(step)), rtol=1e-6)
    assert sched(10**7) == 1e-6


def test_optimizer_refusals():
    with pytest.raises(ValueError, match=r"moments_dtype must be one of \('float32', 'bfloat16'\), got 'bf16'"):
        toptim.get_optimizer(TrainConfig(moments_dtype="bf16"), [torch.zeros(1)], 1)
    with pytest.raises(NotImplementedError, match="rmsprop"):
        toptim.get_optimizer(TrainConfig(optimizer="rmsprop"), [torch.zeros(1)], 1)
    with pytest.raises(ValueError, match="quantile"):
        toptim.get_optimizer(
            TrainConfig(), [torch.zeros(1)], 1,
            QuantumConfig(use_gradient_pruning=True, gradient_prune_mode="quantile", gradient_threshold=1.0),
        )


def _prune_cases():
    rng = np.random.default_rng(5)
    ties = np.array([0.1, -0.1, 0.1, 0.3, -0.05, 0.1], np.float32)
    return [
        ("absolute", 0.5, {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": ties}),
        ("absolute", 0.1, {"a": ties.reshape(2, 3), "b": np.full(3, 0.1, np.float32)}),
        ("quantile", 0.5, {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": ties}),
        ("quantile", 0.4, {"a": ties.reshape(2, 3), "b": np.full(4, 0.1, np.float32)}),
        ("quantile", 0.9, {"a": np.full((3, 3), 0.25, np.float32)}),
        ("quantile", 0.0, {"a": rng.standard_normal(7).astype(np.float32)}),
        ("quantile", 0.3, {"a": rng.standard_normal(10).astype(np.float32)}),
    ]


@pytest.mark.parametrize("case", range(len(_prune_cases())))
def test_gradient_prune_matches_jax(case):
    mode, threshold, grads = _prune_cases()[case]
    tx = gradient_prune(threshold, mode)
    jgrads = {k: jnp.asarray(v) for k, v in grads.items()}
    pruned, st = tx.update(jgrads, tx.init(jgrads))
    tgrads = {k: torch.tensor(v) for k, v in grads.items()}
    ratio = gradient_prune_(list(tgrads.values()), threshold, mode)
    for k in grads:
        np.testing.assert_array_equal(tgrads[k].numpy(), np.asarray(pruned[k]))
    np.testing.assert_allclose(float(ratio), float(st.prune_ratio), rtol=0, atol=1e-7)


def test_optimizer_prunes_before_the_update_like_optax():
    q = dict(use_gradient_pruning=True, gradient_prune_mode="quantile", gradient_threshold=0.5)
    tparams, jp, opt = _run_both("adamw", 3, QuantumConfig(**q), JQuantumConfig(**q))
    assert float(opt.prune_ratio) == pytest.approx(8 / 17, abs=1e-6)
    for k in SHAPES:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_perturb_adds_scaled_noise_to_selected_float_entries():
    params = {"w": torch.zeros(3, 2), "b": torch.ones(4), "idx": torch.arange(3)}
    gen = torch.Generator().manual_seed(3)
    out = perturb(params, gen, 0.1, where=lambda name, t: name != "b")
    noise = torch.randn((3, 2), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(out["w"], 0.1 * noise)
    assert out["b"] is params["b"] and out["idx"] is params["idx"]
    every = perturb(params, torch.Generator().manual_seed(3), 0.1)
    assert not torch.equal(every["b"], params["b"])
