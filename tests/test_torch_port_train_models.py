"""The port's models in train mode against the JAX package, on the CPU.

- HDCE with BatchNorm in train mode: the fused step's loss, every gradient
  and the updated running statistics, from the same weights carried across
  by ``qdml_tpu_torch.interop``. This is the test that catches the two
  BatchNorm traps: torch's momentum convention (the port's decay is
  ``0.9 ** n_users``) and torch's unbiased running variance (Flax keeps the
  biased one). Tolerance rtol 1e-4 / atol 1e-5 (float32 convs and a long head
  product summed in another order); the running variance to rtol 1e-5.
- QSC under QuantumNAT with an explicit noise tensor eps: the port's noisy
  step equals JAX's gradient of the clean model at ``qweights + eps``, applied
  by AdamW to the CLEAN parameters. Same tolerances.
- The Flax-style init draws lecun-normal weights.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from qdml_tpu.config import DataConfig as JDataConfig  # noqa: E402
from qdml_tpu.config import ExperimentConfig as JExperimentConfig  # noqa: E402
from qdml_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from qdml_tpu.models.losses import nll_loss as jnll  # noqa: E402
from qdml_tpu.models.qsc import QSCP128 as JQSCP128  # noqa: E402
from qdml_tpu.train import hdce as jhdce  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig  # noqa: E402
from qdml_tpu_torch.models.cnn import BatchNorm2d, ConvP128, flax_init_  # noqa: E402
from qdml_tpu_torch.models.qsc import QSCP128  # noqa: E402
from qdml_tpu_torch.train import hdce as thdce  # noqa: E402
from qdml_tpu_torch.train import qsc as tqsc  # noqa: E402
from qdml_tpu_torch.train.optim import get_optimizer  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _geometry(n_users):
    kw = dict(n_ant=16, n_sub=8, n_beam=4, n_users=n_users)
    return (
        JExperimentConfig(data=JDataConfig(**kw), model=JModelConfig(features=8)),
        ExperimentConfig(data=DataConfig(**kw), model=ModelConfig(features=8)),
    )


def _grid_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    d = cfg.data
    s, u = d.n_scenarios, d.n_users
    return {
        "yp_img": rng.standard_normal((s, u, b, d.n_sub, d.n_beam, 2)).astype(np.float32),
        "h_label": rng.standard_normal((s, u, b, 2 * d.h_dim)).astype(np.float32),
        "h_perf": rng.standard_normal((s, u, b, 2 * d.h_dim)).astype(np.float32),
    }


@pytest.mark.parametrize("n_users", [1, 3])
def test_hdce_train_mode_step_matches_flax(n_users):
    jcfg, tcfg = _geometry(n_users)
    model, state = jhdce.init_hdce_state(jcfg, steps_per_epoch=1)
    batch = _grid_batch(jcfg, b=6, seed=n_users)
    s, u, b = batch["yp_img"].shape[:3]
    x = jnp.asarray(batch["yp_img"]).reshape(s, u * b, *batch["yp_img"].shape[3:])
    # carried-over running statistics that are not the init's (0, 1)
    stats = jax.tree.map(
        lambda v: v + 0.3 * np.random.default_rng(7).uniform(0.5, 1.5, v.shape).astype(np.float32),
        jax.device_get(state.batch_stats),
    )

    def loss_fn(params):
        out, upd = model.apply(
            {"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats"]
        )
        pred = out.reshape(s, u, b, -1)
        loss = jnp.mean(jhdce.cell_nmse(pred, jnp.asarray(batch["h_label"])))
        return loss, (upd["batch_stats"], jnp.mean(jhdce.cell_nmse(pred, jnp.asarray(batch["h_perf"]))))

    (jloss, (jstats, jperf)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)

    port = thdce.init_hdce_state(tcfg, device="cpu")
    assert port.trunks[0].cnn[1].momentum == pytest.approx(1 - 0.9**n_users)
    port.load_state_dict(
        interop.hdce_state_dict_from_flax(
            {"params": jax.device_get(state.params), "batch_stats": stats}, tcfg.image_hw
        ),
    )
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    loss, perf = thdce.hdce_loss(port.train(), tbatch)
    loss.backward()
    _close(loss.item(), float(jloss))
    _close(perf.item(), float(jperf))
    want = interop.hdce_state_dict_from_flax(
        {"params": jax.device_get(jgrads), "batch_stats": jax.device_get(jstats)}, tcfg.image_hw
    )
    sd = port.state_dict(keep_vars=True)
    for name, p in port.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        _close(p.grad, want[name], atol=ATOL * max(scale, 1.0))
    for name in want:
        if name.endswith("running_mean"):
            _close(sd[name], want[name])
        elif name.endswith("running_var"):
            _close(sd[name], want[name], rtol=1e-5, atol=1e-6)


def test_batchnorm_keeps_the_biased_variance_with_flax_decay():
    bn = BatchNorm2d(3, decay=0.7).train()
    x = torch.randn(5, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    _close(bn.running_var, 0.7 * 1.0 + 0.3 * var, rtol=1e-6, atol=1e-7)
    _close(bn.running_mean, 0.3 * x.mean(dim=(0, 2, 3)), rtol=1e-6, atol=1e-7)
    ref = torch.nn.BatchNorm2d(3, momentum=0.3).train()
    ref(x)  # torch keeps the unbiased variance: n/(n-1) = 20/19 larger
    assert not torch.allclose(ref.running_var, bn.running_var, rtol=1e-3)
    ref.load_state_dict(bn.state_dict())
    with torch.no_grad():  # eval mode is torch's own
        _close(bn.eval()(x), ref.eval()(x), rtol=0, atol=0)


def test_flax_init_draws_lecun_normal():
    trunk = flax_init_(ConvP128(features=64), torch.Generator().manual_seed(1))
    w = trunk.cnn[3].weight.detach()  # (64, 64, 3, 3): fan_in 576
    np.testing.assert_allclose(float(w.std()), (1 / 576) ** 0.5, rtol=0.05)
    assert float(w.abs().max()) <= 2 * (1 / 576) ** 0.5 / 0.87962566103423978 + 1e-6
    bn = trunk.cnn[1]
    assert torch.equal(bn.weight, torch.ones(64)) and torch.equal(bn.running_var, torch.ones(64))


def _image(batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, 16, 8, 2)).astype(np.float32)


@pytest.mark.parametrize("impl,n", [("pallas_circuit", 4), ("dense", 5)])
def test_qsc_quantumnat_step_matches_jax_at_the_noisy_point(impl, n):
    layers, b = 3, 8
    x = _image(b, seed=n)
    labels = np.random.default_rng(n + 1).integers(0, 3, b).astype(np.int32)
    eps = (0.01 * np.random.default_rng(n + 2).standard_normal((layers, n, 2))).astype(np.float32)
    jmodel = JQSCP128(n_qubits=n, n_layers=layers, impl=impl)  # the CLEAN model
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(n), jnp.asarray(x))["params"])

    def loss(p):
        noisy = {**p, "qweights": p["qweights"] + eps}
        return jnll(jmodel.apply({"params": noisy}, jnp.asarray(x), train=True), jnp.asarray(labels))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    tx = optax.adamw(1e-3, weight_decay=0.01)
    upd, _ = tx.update(jgrads, tx.init(params), params)
    jnew = interop.qsc_state_dict_from_flax(jax.device_get(optax.apply_updates(params, upd)))

    port = QSCP128(n, layers, impl=impl, use_quantumnat=True, noise_level=0.01)
    port.load_state_dict(interop.qsc_state_dict_from_flax(params))
    clean = port.qlayer.weights.detach().clone()
    tcfg = TrainConfig(optimizer="adamw")
    opt = get_optimizer(tcfg, port.parameters(), steps_per_epoch=1)
    batch = {
        "yp_img": torch.tensor(x)[None, None],
        "indicator": torch.tensor(labels, dtype=torch.long)[None, None],
    }
    tloss = tqsc.classifier_loss(port, batch, noise=torch.tensor(eps))
    tloss.backward()
    _close(tloss.item(), float(jloss))
    want_g = interop.qsc_state_dict_from_flax(jax.device_get(jgrads))
    for name, p in port.named_parameters():
        _close(p.grad, want_g[name])
    assert torch.equal(port.qlayer.weights.detach(), clean)  # the noise never touched it
    opt.step()
    for name, p in port.named_parameters():
        # The last layer's RZ commutes with the Z readout: its gradient is
        # zero up to rounding, which Adam's first step turns into +-lr in
        # either framework. Those entries are held to 2 lr, the rest tightly.
        live = want_g[name].abs() > 1e-6
        _close(p.detach()[live], jnew[name][live])
        _close(p.detach()[~live], jnew[name][~live], rtol=0, atol=2e-3)


def test_quantumnat_noise_only_in_train_mode():
    port = QSCP128(4, 2, impl="dense", use_quantumnat=True, noise_level=0.5)
    x = torch.tensor(_image(3, seed=0)).permute(0, 3, 1, 2)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        clean = port(x)
        assert torch.equal(port(x, train=False, noise=torch.ones(2, 4, 2)), clean)
        noisy = port(x, train=True, generator=gen)
        assert not torch.allclose(noisy, clean)
        port.use_quantumnat = False
        assert torch.equal(port(x, train=True, generator=gen), clean)


def test_training_classifier_build_is_seeded_and_flax_drawn():
    cfg = dataclasses.replace(ExperimentConfig(), quantum=dataclasses.replace(
        ExperimentConfig().quantum, n_qubits=4, n_layers=2, use_quantumnat=True))
    a = tqsc.build_classifier(cfg, True, device="cpu").state_dict()
    b = tqsc.build_classifier(cfg, True, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["qlayer.weights"]
    assert float(w.min()) >= 0.0 and float(w.max()) < 2 * np.pi
    assert torch.equal(a["preprocess.0.bias"], torch.zeros(16))
