"""The port's noise-sweep ensemble against the JAX package's, on the CPU.

The ensemble (n=4 qubits, L=2 layers, E=3 members at sigma 0, 0.05, 0.1)
starts from the JAX package's ``init_sweep`` weights carried across member by
member, and sees the JAX loader's batches. The JAX step draws its QuantumNAT
noise with ``jax.random`` from per-member keys, which no torch generator
reproduces, so the test recomputes those draws from the same keys (the
circuit-weight leaf of ``perturb``'s split) and feeds them to the port's
step. Per-step losses then agree to rtol 2e-4 (float32 convs and circuit
sums in another order, over 3 steps), the parameters to 1e-5 + 1e-4|p|
except where a gradient is zero up to rounding (the last layer's RZ
weights, which commute with the Z readout), which AdamW turns into up to
lr a step either way. The member-axis circuit's plain versions are held to
E single-member plain calls, the per-member quantile pruning to the JAX
transform ``vmap``ped over members, and one AdamW over stacked parameters to
E separate ones, bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.config import DataConfig as JDataConfig  # noqa: E402
from qdml_tpu.config import ExperimentConfig as JExperimentConfig  # noqa: E402
from qdml_tpu.config import QuantumConfig as JQuantumConfig  # noqa: E402
from qdml_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from qdml_tpu.data.channels import ChannelGeometry as JGeometry  # noqa: E402
from qdml_tpu.data.datasets import DMLGridLoader as JLoader  # noqa: E402
from qdml_tpu.data.datasets import save_npy_cache  # noqa: E402
from qdml_tpu.ops.grad_prune import gradient_prune as jgradient_prune  # noqa: E402
from qdml_tpu.train import nat_sweep as jsweep  # noqa: E402
from qdml_tpu_torch import cli, interop  # noqa: E402
from qdml_tpu_torch.config import DataConfig, ExperimentConfig, QuantumConfig, TrainConfig  # noqa: E402
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData  # noqa: E402
from qdml_tpu_torch.models.qsc import QSCP128  # noqa: E402
from qdml_tpu_torch.ops.grad_prune import gradient_prune_  # noqa: E402
from qdml_tpu_torch.quantum import circuits as tcirc  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from qdml_tpu_torch.train import nat_sweep as tsweep  # noqa: E402
from qdml_tpu_torch.train import qsc as tqsc  # noqa: E402

DATA = dict(n_ant=16, n_sub=16, n_beam=8, data_len=40)
TRAIN = dict(batch_size=8, n_epochs=2, print_freq=1000)
LEVELS = (0.0, 0.05, 0.1)
N, L = 4, 2


def _cfgs(train=None, **quantum):
    qkw = dict(n_qubits=N, n_layers=L, noise_sweep=LEVELS, **quantum)
    tkw = {**TRAIN, **(train or {})}
    jcfg = JExperimentConfig(data=JDataConfig(**DATA), quantum=JQuantumConfig(**qkw), train=JTrainConfig(**tkw))
    tcfg = ExperimentConfig(data=DataConfig(**DATA), quantum=QuantumConfig(**qkw), train=TrainConfig(**tkw))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("npy")
    save_npy_cache(str(path), JDataConfig(**DATA), chunk=40)
    return str(path)


def _member_states(jparams):
    host = jax.device_get(jparams)
    return [
        interop.qsc_state_dict_from_flax(jax.tree.map(lambda x, m=m: np.asarray(x)[m], host))
        for m in range(len(LEVELS))
    ]


def _jax_noise(jparams, rngs):
    """The unit normal draws ``perturb`` makes for each member's circuit
    weights from its key: ``split(key, n_leaves)``, the qweights leaf's key."""
    member = jax.tree.map(lambda x: x[0], jparams)
    leaves = jax.tree_util.tree_leaves_with_path(member)
    idx = [i for i, (path, _) in enumerate(leaves) if jsweep._is_qweight(path, None)]
    assert len(idx) == 1
    shape = leaves[idx[0]][1].shape
    draws = [jax.random.normal(jax.random.split(rngs[m], len(leaves))[idx[0]], shape, jnp.float32)
             for m in range(len(LEVELS))]
    return torch.from_numpy(np.array(jnp.stack(draws)))


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(batch[k])) for k in ("yp_img", "indicator")}


def _close_params(got, want, lr, steps, what):
    """1e-5 + 1e-4|p|, except at most 1% of entries (rounding-dominated
    gradients) within the AdamW bound of ``steps`` updates."""
    bound = 1.1 * steps * lr + 1e-5
    outside = total = 0
    for k, w in want.items():
        diff = (got[k] - w).abs()
        assert diff.max().item() <= bound, (what, k, diff.max().item())
        outside += int((diff > 1e-5 + 1e-4 * w.abs()).sum())
        total += w.numel()
    assert outside <= 0.01 * total, (what, outside, total)


@pytest.mark.parametrize("prune", [None, "quantile"])
def test_sweep_steps_match_jax_with_its_noise(prune):
    qkw = dict(use_gradient_pruning=True, gradient_prune_mode="quantile", gradient_threshold=0.5) if prune else {}
    jcfg, tcfg = _cfgs(**qkw)
    geom = JGeometry.from_config(jcfg.data)
    loader = JLoader(jcfg.data, jcfg.train.batch_size, "train", geom)
    model, tx, jparams, jopt, jsigmas = jsweep.init_sweep(jcfg, LEVELS, loader.steps_per_epoch)
    jstep = jsweep.make_sweep_train_step(model, tx, probes=False)
    tmodel, params, opt, sigmas = tsweep.init_sweep(
        tcfg, LEVELS, loader.steps_per_epoch, torch.device("cpu"), _member_states(jparams)
    )
    rng = jax.random.PRNGKey(7)
    for step, batch in zip(range(3), loader.epoch(0)):
        rng, sub = jax.random.split(rng)
        rngs = jax.random.split(sub, len(LEVELS))
        noise = _jax_noise(jparams, rngs)
        jparams, jopt, jm = jstep(jparams, jopt, rngs, jsigmas, batch)
        tm = tsweep.sweep_train_step(tmodel, params, opt, sigmas, _torch_batch(batch), noise)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=2e-4, err_msg=f"step {step}")
    want = _member_states(jparams)
    for m in range(len(LEVELS)):
        _close_params(tsweep.member_state(params, m), want[m], tcfg.train.lr, 3, f"member {m}")


def test_sigma0_member_equals_the_single_model_step(cache):
    _, tcfg = _cfgs()
    data = GridData.from_npy_cache(cache, tcfg.data, device="cpu")
    loader = DMLGridLoader(data, tcfg.train.batch_size, "train")
    states = tsweep.member_states(tcfg, len(LEVELS))
    model, params, opt, sigmas = tsweep.init_sweep(tcfg, LEVELS, loader.steps_per_epoch, torch.device("cpu"), states)
    single, sopt = tqsc.make_trainer(tcfg, True, "cpu", loader.steps_per_epoch, init_state=states[0])
    for batch in list(loader.epoch(0))[:3]:
        noise = torch.randn((len(LEVELS), L, N, 2))
        got = tsweep.sweep_train_step(model, params, opt, sigmas, batch, noise)["loss"][0]
        want = tqsc.classifier_train_step(single, sopt, batch)["loss"]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    for k, v in single.state_dict().items():
        torch.testing.assert_close(params[k][0].detach(), v, rtol=1e-5, atol=1e-6, msg=k)


def test_per_member_quantile_pruning_matches_jax_vmapped():
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((3, 5, 4)).astype(np.float32),
             "b": (rng.standard_normal((3, 7)) * np.array([[1.0], [1e-3], [10.0]])).astype(np.float32)}
    tx = jgradient_prune(0.5, "quantile")
    jout, jstate = jax.vmap(lambda g: tx.update(g, tx.init(g)))(jax.tree.map(jnp.asarray, grads))
    tgrads = [torch.from_numpy(grads[k].copy()) for k in ("a", "b")]
    ratio = gradient_prune_(tgrads, 0.5, "quantile", members=True)
    for k, t in zip(("a", "b"), tgrads):
        np.testing.assert_array_equal(t.numpy(), np.asarray(jout[k]), err_msg=k)
    np.testing.assert_allclose(ratio.numpy(), np.asarray(jstate.prune_ratio), rtol=0, atol=1e-7)
    # the global quantile over all members would prune member 1 (gradients
    # 1000x smaller) almost whole: per member, each keeps about half
    assert (ratio.numpy() < 0.6).all()


def test_one_adamw_over_stacked_params_equals_separate_ones():
    rng = np.random.default_rng(4)
    init = torch.from_numpy(rng.standard_normal((3, 2, 5)).astype(np.float32))
    grads = [torch.from_numpy(rng.standard_normal((3, 2, 5)).astype(np.float32)) for _ in range(4)]
    stacked = init.clone().requires_grad_(True)
    separate = [init[m].clone().requires_grad_(True) for m in range(3)]
    kw = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    one = torch.optim.AdamW([stacked], **kw)
    many = [torch.optim.AdamW([p], **kw) for p in separate]
    for g in grads:
        stacked.grad = g.clone()
        one.step()
        for m, (p, o) in enumerate(zip(separate, many)):
            p.grad = g[m].clone()
            o.step()
    for m in range(3):
        assert torch.equal(stacked[m].detach(), separate[m].detach())


def test_member_axis_plain_versions_equal_single_member_calls():
    rng = np.random.default_rng(5)
    E, B, n, layers = 3, 5, 4, 2
    a = torch.from_numpy(rng.uniform(-1, 1, (E, B, n)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 2 * np.pi, (E, layers, n, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((E, B, n)).astype(np.float32))
    ev, fre, fim = tk.circuit_expvals_ensemble_plain(a, w, n, layers)
    da, dw = tk.circuit_adjoint_ensemble_plain(fre, fim, g, a, w, n, layers)
    for m in range(E):
        sev, sre, sim = tk.circuit_expvals_plain(a[m], w[m], n, layers)
        sda, sdw = tk.circuit_adjoint_plain(sre, sim, g[m], a[m], w[m], n, layers)
        for got, want in ((ev[m], sev), (fre[m], sre), (fim[m], sim), (da[m], sda), (dw[m], sdw)):
            assert torch.equal(got, want)
    # the public entry point and its autograd Function against autograd
    # through the single-member entry point
    a1, w1 = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (tk.fused_circuit_expvals_ensemble(a1, w1, n, layers) * g).sum().backward()
    a2, w2 = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    sum((tk.fused_circuit_expvals(a2[m], w2[m], n, layers) * g[m]).sum() for m in range(E)).backward()
    torch.testing.assert_close(a1.grad, a2.grad, rtol=0, atol=0)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=0, atol=0)
    assert set(tk.launches.values()) == {0}  # CPU tensors: the plain versions


def test_run_circuit_ensemble_dispatch_and_eligibility(capsys):
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 4)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 2 * np.pi, (2, 2, 4, 2)).astype(np.float32))
    want = torch.stack([tcirc.run_circuit(a[m], w[m], 4, 2, impl="dense") for m in range(2)])
    for impl in ("pallas_circuit", "pallas", "tensor", "dense", "mps"):
        got = tcirc.run_circuit_ensemble(a, w, 4, 2, impl=impl)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6, msg=impl)
    out = capsys.readouterr().out
    assert "impl 'pallas' has no member axis" in out and "pallas_circuit" not in out
    tcirc.run_circuit_ensemble(a, w, 4, 2, impl="pallas")
    assert "no member axis" not in capsys.readouterr().out  # one line per impl
    wide = torch.zeros((2, 3, 13)), torch.zeros((2, 1, 13, 2))
    with pytest.raises(tcirc.ImplIneligibleError):
        tcirc.run_circuit_ensemble(*wide, 13, 1, impl="pallas_circuit")
    with pytest.raises(tcirc.ImplIneligibleError, match="needs >= 2 devices"):  # one rank
        tcirc.run_circuit_ensemble(a, w, 4, 2, impl="sharded_statevector")
    with pytest.raises(ValueError):
        tcirc.run_circuit_ensemble(a, w[:1], 4, 2, impl="dense")


def test_resume_repeats_the_noise_and_refuses_other_levels(cache, tmp_path):
    _, tcfg = _cfgs(train=dict(n_epochs=2))
    data = GridData.from_npy_cache(cache, tcfg.data, device="cpu")
    _, straight = tsweep.train_nat_sweep(tcfg, data=data, workdir=str(tmp_path / "a"))
    wd = str(tmp_path / "b")
    _, first = tsweep.train_nat_sweep(_cfgs(train=dict(n_epochs=1))[1], data=data, workdir=wd)
    _, rest = tsweep.train_nat_sweep(_cfgs(train=dict(n_epochs=2, resume=True))[1], data=data, workdir=wd)
    for key in straight:
        assert len(first[key]) == 1 and len(rest[key]) == 1
        np.testing.assert_allclose(np.stack(first[key] + rest[key]), np.stack(straight[key]), rtol=1e-6, err_msg=key)
    with pytest.raises(ValueError, match="noise_levels mismatch"):
        tsweep.train_nat_sweep(_cfgs(train=dict(n_epochs=3, resume=True))[1], noise_levels=(0.0, 0.2, 0.1),
                               data=data, workdir=wd)
    # the epoch's draws depend on (seed, epoch) alone
    assert torch.equal(tsweep.epoch_noise(tcfg, 1, 4, 3), tsweep.epoch_noise(tcfg, 1, 4, 3))
    assert not torch.equal(tsweep.epoch_noise(tcfg, 0, 4, 3), tsweep.epoch_noise(tcfg, 1, 4, 3))


def test_tags_and_member_best_meta(cache, tmp_path):
    _, tcfg = _cfgs()
    data = GridData.from_npy_cache(cache, tcfg.data, device="cpu")
    params, hist = tsweep.train_nat_sweep(tcfg, data=data, workdir=str(tmp_path))
    acc = np.stack(hist["val_acc"])  # (epochs, E)
    mb, meta = tckpt.restore_checkpoint(str(tmp_path), "nat_sweep_member_best")
    assert meta["noise_levels"] == list(LEVELS) and meta["member_best_from_epoch"] == 0
    np.testing.assert_allclose(meta["member_best_acc"], acc.max(axis=0))
    assert meta["member_best_epoch"] == [int(e) for e in acc.argmax(axis=0)]
    assert meta["quantum"] == {"n_qubits": N, "n_layers": L, "n_classes": 3, "input_norm": False}
    assert set(mb["params"]) == set(params) and mb["params"]["qlayer.weights"].shape == (3, L, N, 2)
    best, bmeta = tckpt.restore_checkpoint(str(tmp_path), "nat_sweep_best")
    assert bmeta["val_acc"] == acc.max() and bmeta["sigma"] == LEVELS[bmeta["member"]]
    QSCP128(N, L).load_state_dict(best["params"])  # one member, one model
    last, lmeta = tckpt.restore_checkpoint(str(tmp_path), "nat_sweep_last")
    for k, v in params.items():
        assert torch.equal(last["params"][k], v.detach())
    assert lmeta["noise_levels"] == list(LEVELS)


def test_cli_nat_sweep_on_the_cpu(tmp_path, capsys):
    rc = cli.main([
        "nat-sweep", "--device=cpu", "--data.data_len=24", "--train.batch_size=8", "--train.n_epochs=1",
        "--quantum.n_qubits=4", "--quantum.n_layers=2", "--quantum.noise_sweep=(0.0,0.1)",
        f"--train.workdir={tmp_path}",
    ])
    assert rc == 0
    wd = tmp_path / "Pn_128" / "default"
    for tag in ("nat_sweep_best", "nat_sweep_last", "nat_sweep_resume", "nat_sweep_member_best"):
        assert (wd / f"{tag}.pt").exists(), tag
    last = json.loads((wd / "nat-sweep.metrics.jsonl").read_text().splitlines()[-1])
    assert {"train_loss_sigma0", "val_acc_sigma0.1"} <= set(last)
    assert "nat-sweep done" in capsys.readouterr().out
    # K steps a dispatch is the default (K = 1); a negative K is refused
    assert json.loads((wd / "nat-sweep.metrics.jsonl").read_text().splitlines()[0])["kind"] == "scan_dispatch"
    with pytest.raises(ValueError, match="scan_steps"):
        cli.main(["nat-sweep", "--device=cpu", "--train.scan_steps=-1"])
