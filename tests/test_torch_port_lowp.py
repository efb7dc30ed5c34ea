"""The port's low-precision levers against the JAX package's, on the CPU.

- ``model.dtype=bfloat16``: ``ConvP128``, ``StackedConvP128``, ``FCP128``,
  ``HDCE`` and ``DCEP128`` on weights carried across from the Flax modules
  at ``dtype=jnp.bfloat16`` give JAX's bfloat16 outputs. Both frameworks
  round at the same places but sum in other orders, and in train mode the
  BatchNorm statistics (Flax's one-pass variance, torch's two-pass) can tip
  a value to the next bfloat16 step at the following conv, so the bound is
  bfloat16's: the largest difference within 1e-2 of the largest output
  (measured: up to 1.7e-3 in eval mode, 3.9e-3 = one bfloat16 step in
  train mode). In eval mode the bf16 port sits at least twice as close to
  JAX's bf16 as the float32 port does, so the casts are where Flax puts
  them.
- 2-epoch HDCE and DCE histories in bfloat16 on a ``save_npy_cache`` grid,
  from JAX's init, within rtol 2e-3 of JAX's (measured: 2.4e-4); bfloat16
  sits within 1e-2 of float32 in the same framework, and not on it.
- ``train.moments_dtype=bfloat16``: :class:`AdamLowp` step for step against
  ``scale_by_adam_lowp`` (mu bfloat16, nu float32, parameters within
  1e-6), and its nu decays after a spike as float32 Adam's does.
- ``cexp_i_ramp`` and ``channels_from_draws`` at ``trig_impl="split"``
  against JAX's given the same draws, and split against direct within
  float32 rounding of the largest phase.
- The rejection of unknown ``model.dtype``, ``rng_impl``, ``trig_impl`` and
  ``moments_dtype`` values with JAX's messages, the adamw/sgd warning, and
  the CLI flags on a tiny run.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.data import channels as jch  # noqa: E402
from qdml_tpu.data.datasets import save_npy_cache  # noqa: E402
from qdml_tpu.models import cnn as jcnn  # noqa: E402
from qdml_tpu.train import dce as jdce  # noqa: E402
from qdml_tpu.train import hdce as jhdce  # noqa: E402
from qdml_tpu.train import optim as joptim  # noqa: E402
from qdml_tpu.utils import complexops as jco  # noqa: E402
from qdml_tpu_torch import cli, interop  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.data import channels as tch  # noqa: E402
from qdml_tpu_torch.data.datasets import GridData  # noqa: E402
from qdml_tpu_torch.models import cnn as tcnn  # noqa: E402
from qdml_tpu_torch.train import optim as toptim  # noqa: E402
from qdml_tpu_torch.train.dce import build_dce, train_dce  # noqa: E402
from qdml_tpu_torch.train.hdce import HDCE, build_hdce, init_hdce_state, train_hdce  # noqa: E402
from qdml_tpu_torch.utils import complexops as tco  # noqa: E402

BF16 = jnp.bfloat16
DATA = dict(n_ant=16, n_sub=8, n_beam=4, data_len=40)
TRAIN = dict(batch_size=8, n_epochs=2, print_freq=1000)


def _randomize(tree, rng):
    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(a.shape[-4:-1]) if a.ndim >= 4 else a.shape[-2]
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _trunk_sd(conv_vars) -> dict:
    """A Flax ``ConvP128``'s variables as the port ``ConvP128``'s state dict
    (through the DCE interop, with a placeholder head)."""
    feats = np.asarray(conv_vars["params"]["ConvBlock_0"]["Conv_0"]["kernel"]).shape[-1]
    head = {"Dense_0": {"kernel": np.zeros((feats * 16 * 8, 1), np.float32), "bias": np.zeros(1, np.float32)}}
    sd = interop.dce_state_dict_from_flax(
        {"params": {"ConvP128_0": conv_vars["params"], "FCP128_0": head},
         "batch_stats": {"ConvP128_0": conv_vars["batch_stats"]}}
    )
    return {k: v for k, v in sd.items() if k.startswith("cnn.")}


def _module_case(name, dtype, rng):
    """(flax module, its variables, flax input, port module, port input)."""
    tdt = torch.bfloat16 if dtype == BF16 else torch.float32
    x = rng.standard_normal((12, 16, 8, 2)).astype(np.float32)
    if name == "conv":
        jm = jcnn.ConvP128(8, dtype=dtype)
        v = _randomize(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 8, 2)))), rng)
        tm = tcnn.ConvP128(8, dtype=tdt)
        tm.load_state_dict(_trunk_sd(v))
        return jm, v, x, tm, _nchw(x)
    if name == "stacked":
        jh = jhdce.HDCE(3, 8, out_dim=8, dtype=dtype)
        full = _randomize(jax.device_get(jh.init(jax.random.PRNGKey(0), jnp.zeros((3, 2, 16, 8, 2)))), rng)
        sd = interop.hdce_state_dict_from_flax(full)
        jm = jcnn.StackedConvP128(3, 8, dtype=dtype)
        v = {c: full[c]["StackedConvP128_0"] for c in full}
        tm = tcnn.StackedConvP128(3, 8, dtype=tdt)
        tm.load_state_dict({k[len("trunks."):]: t for k, t in sd.items() if k.startswith("trunks.")})
        xs = np.stack([x, x[::-1], 0.5 * x])
        return jm, v, xs, tm, _nchw(xs)
    if name == "fc":
        jm = jcnn.FCP128(48, dtype=dtype)
        v = _randomize(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 256)))), rng)
        tm = tcnn.FCP128(256, 48, dtype=tdt)
        dense = v["params"]["Dense_0"]
        tm.load_state_dict({"FC.weight": torch.tensor(np.asarray(dense["kernel"]).T.copy()),
                            "FC.bias": torch.tensor(np.asarray(dense["bias"]))})
        xf = rng.standard_normal((12, 256)).astype(np.float32)
        return jm, v, xf, tm, torch.from_numpy(xf)
    if name == "hdce":
        jm = jhdce.HDCE(3, 8, out_dim=512, dtype=dtype)
        v = _randomize(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((3, 2, 16, 8, 2)))), rng)
        tm = HDCE(3, 8, 512, dtype=tdt)
        tm.load_state_dict(interop.hdce_state_dict_from_flax(v))
        xs = np.stack([x, x[::-1], 0.5 * x])
        return jm, v, xs, tm, _nchw(xs)
    jm = jcnn.DCEP128(8, out_dim=64, dtype=dtype)
    v = _randomize(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 8, 2)))), rng)
    tm = tcnn.DCEP128(8, 64, (16, 8), dtype=tdt)
    tm.load_state_dict(interop.dce_state_dict_from_flax(v))
    return jm, v, x, tm, _nchw(x)


def _apply(name, jm, v, x, train):
    """The Flax module's output, a trunk's features in the port's NCHW
    flattening order."""
    has_bn = "batch_stats" in v
    if train and has_bn:
        out = np.asarray(jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])[0])
    else:
        out = np.asarray(jm.apply(v, jnp.asarray(x), train=False) if has_bn else jm.apply(v, jnp.asarray(x)))
    if name in ("conv", "stacked"):  # NHWC flattening -> NCHW
        lead = out.shape[:-1]
        out = np.moveaxis(out.reshape(*lead, 16, 8, -1), -1, -3).reshape(*lead, -1)
    return out


@pytest.mark.parametrize("name", ["conv", "stacked", "fc", "hdce", "dce"])
@pytest.mark.parametrize("train", [False, True])
def test_bf16_module_forward_matches_flax_bf16(name, train):
    seed = ["conv", "stacked", "fc", "hdce", "dce"].index(name)
    jm, v, x, tm, xt = _module_case(name, BF16, np.random.default_rng(seed))
    want = _apply(name, jm, v, x, train)
    tm.train(train)
    with torch.no_grad():
        got = tm(xt)
    assert got.dtype == torch.float32 and all(p.dtype == torch.float32 for p in tm.parameters())
    err = float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())
    assert err <= 1e-2, (name, train, err)
    if not train:
        # the same weights in float32 sit further from JAX's bf16 output
        tm32 = _module_case(name, jnp.float32, np.random.default_rng(seed))[3].eval()
        with torch.no_grad():
            err32 = float(np.abs(tm32(xt).numpy() - want).max()) / float(np.abs(want).max())
        assert err < err32 / 2, (name, err, err32)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("npy")
    save_npy_cache(str(path), jconfig.DataConfig(**DATA), chunk=40)
    return str(path)


def _cfgs(dtype="bfloat16", moments="float32"):
    jcfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(**DATA), model=jconfig.ModelConfig(features=8, dtype=dtype),
        train=jconfig.TrainConfig(**TRAIN, moments_dtype=moments),
    )
    tcfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**DATA), model=tconfig.ModelConfig(features=8, dtype=dtype),
        train=tconfig.TrainConfig(**TRAIN, moments_dtype=moments),
    )
    return jcfg, tcfg


def _run(which, tcfg, data, init):
    fn = train_hdce if which == "hdce" else train_dce
    return fn(tcfg, data=data, init_state=init)


@pytest.mark.parametrize("which", ["hdce", "dce"])
def test_bf16_two_epoch_history_matches_jax_bf16(which, cache):
    jcfg, tcfg = _cfgs()
    jmod = jhdce if which == "hdce" else jdce
    _, jhist = (jmod.train_hdce if which == "hdce" else jmod.train_dce)(jcfg)
    _, state = (jmod.init_hdce_state if which == "hdce" else jmod.init_dce_state)(jcfg, 4)
    carry = interop.hdce_state_dict_from_flax if which == "hdce" else interop.dce_state_dict_from_flax
    init = carry({"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)},
                 tcfg.image_hw)
    data = GridData.from_npy_cache(cache, tcfg.data, device="cpu")
    model, hist = _run(which, tcfg, data, init)
    assert set(hist) == set(jhist)
    for key in jhist:
        assert len(hist[key]) == 2
        np.testing.assert_allclose(hist[key], jhist[key], rtol=2e-3, err_msg=key)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    # bfloat16 is not float32 in the same framework, and not far from it
    _, hist32 = _run(which, _cfgs("float32")[1], data, init)
    gap = max(abs(a / b - 1) for k in hist for a, b in zip(hist[k], hist32[k]))
    assert 0 < gap < 1e-2, gap


def test_serving_builds_stay_float32_and_training_builds_take_the_dtype():
    cfg = tconfig.from_args(["--model.dtype=bfloat16", "--model.features=4"])
    hdce = build_hdce(cfg, "cpu")
    assert hdce.head.act_dtype == torch.float32 and all(t.act_dtype == torch.float32 for t in hdce.trunks)
    assert build_dce(cfg, "cpu").act_dtype == torch.float32
    trained = init_hdce_state(cfg, "cpu")
    assert trained.head.act_dtype == torch.bfloat16 and all(t.act_dtype == torch.bfloat16 for t in trained.trunks)
    assert set(trained.state_dict()) == set(hdce.state_dict())


SHAPES = {"w": (32, 16), "b": (16,), "c": (3, 2, 3, 3)}


def test_adam_lowp_matches_scale_by_adam_lowp_step_for_step():
    rng = np.random.default_rng(3)
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    cfg, jcfg = tconfig.TrainConfig(moments_dtype="bfloat16"), jconfig.TrainConfig(moments_dtype="bfloat16")
    params = {k: torch.tensor(v, requires_grad=True) for k, v in init.items()}
    opt = toptim.get_optimizer(cfg, params.values(), steps_per_epoch=3)
    assert isinstance(opt.opt, toptim.AdamLowp)
    tx = joptim.get_optimizer(jcfg, steps_per_epoch=3)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    for _ in range(6):
        grads = {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        for k, p in params.items():
            p.grad = torch.tensor(grads[k])
        opt.step()
        upd, js = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)
    jadam = js[0]
    for k, p in params.items():
        st = opt.opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        assert jadam.mu[k].dtype == BF16 and jadam.nu[k].dtype == jnp.float32
        np.testing.assert_array_equal(st["exp_avg"].float().numpy(), np.asarray(jadam.mu[k], np.float32))
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(jadam.nu[k]), rtol=1e-6)
    # a saved state comes back in its storage dtypes
    saved = opt.state_dict()
    opt2 = toptim.get_optimizer(cfg, [torch.zeros(s, requires_grad=True) for s in SHAPES.values()], 3)
    opt2.load_state_dict(saved)
    for p in opt2.params:
        st = opt2.opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 6
    assert opt2.count == 6


def test_adam_lowp_nu_tracks_decaying_gradients():
    """The port's analog of JAX's ``test_adam_lowp_nu_tracks_decaying_gradients``:
    after one |g| = 1 spike and 1500 steps of |g| = 0.01, the float32 nu of
    the bf16-moments Adam decays as float32 Adam's does, and the last updates
    agree."""
    dim, n_steps = 64, 1500
    grads = [torch.ones(dim)] + [torch.full((dim,), 0.01)] * n_steps
    runs = {}
    for name, cls in (("ref", torch.optim.Adam), ("low", toptim.AdamLowp)):
        p = torch.zeros(dim, requires_grad=True)
        opt = cls([p], lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        for g in grads:
            before = p.detach().clone()
            p.grad = g.clone()
            opt.step()
        runs[name] = (opt.state[p]["exp_avg_sq"].float().numpy(), (before - p.detach()).numpy())
    nu_ref, nu_low = runs["ref"][0], runs["low"][0]
    assert nu_ref.mean() < 5e-4
    np.testing.assert_allclose(nu_low, nu_ref, rtol=1e-2)
    np.testing.assert_allclose(runs["low"][1], runs["ref"][1], atol=2e-2)


@pytest.mark.parametrize("n", [8, 12, 16, 64, 7, 1])
def test_cexp_i_ramp_matches_jax_and_the_direct_form(n):
    theta = np.random.default_rng(n).uniform(-3, 3, (5, 4)).astype(np.float32)
    got = tco.cexp_i_ramp(torch.from_numpy(theta), n)
    want = jco.cexp_i_ramp(jnp.asarray(theta), n)
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), rtol=0, atol=2e-6)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), rtol=0, atol=2e-6)
    direct = tco.cexp_i(torch.from_numpy(theta)[..., None] * torch.arange(n, dtype=torch.float32))
    # the direct form rounds each phase theta * k to float32 first
    atol = 4 * 2.0**-24 * float(np.abs(theta).max()) * max(n, 1)
    np.testing.assert_allclose(got.re.numpy(), direct.re.numpy(), rtol=0, atol=atol)
    np.testing.assert_allclose(got.im.numpy(), direct.im.numpy(), rtol=0, atol=atol)


def _jax_channel_draws(seed, scen, user, idx, jgeom):
    """JAX's own channel draws, replayed from its key derivation."""

    def one(s, u, i):
        key = jch.make_sample_key(seed, s, u, i)
        k_h = jax.random.split(key, 3)[0]
        k_f, k_tau, k_gain = jax.random.split(k_h, 3)
        return {
            "trunc": jax.random.truncated_normal(k_f, -2.0, 2.0, (jch.MAX_PATHS,)),
            "expo": jax.random.exponential(k_tau, (jch.MAX_PATHS,)),
            "gain": jax.random.normal(k_gain, (jch.MAX_PATHS, 2)),
        }

    return {k: torch.tensor(np.asarray(v)) for k, v in jax.vmap(one)(scen, user, idx).items()}


def test_split_channels_match_jax_split_given_the_same_draws():
    geom = dict(n_ant=32, n_sub=16, n_beam=8)
    rng = np.random.default_rng(7)
    n = 12
    scen = rng.integers(0, 3, n).astype(np.int32)
    user = rng.integers(0, 3, n).astype(np.int32)
    idx = rng.integers(0, 1000, n).astype(np.int32)
    seed = jnp.uint32(2026)
    draws = _jax_channel_draws(seed, jnp.asarray(scen), jnp.asarray(user), jnp.asarray(idx),
                               jch.ChannelGeometry(**geom))
    out = {}
    for trig in ("split", "direct"):
        jg = jch.ChannelGeometry(**geom, trig_impl=trig)
        keys = jax.vmap(lambda s, u, i: jax.random.split(jch.make_sample_key(seed, s, u, i), 3)[0])(
            jnp.asarray(scen), jnp.asarray(user), jnp.asarray(idx))
        want = jax.vmap(lambda k, s, u: jch.sample_channel(k, s, u, jg))(keys, jnp.asarray(scen), jnp.asarray(user))
        got = tch.channels_from_draws(draws, torch.tensor(scen), torch.tensor(user),
                                      tch.ChannelGeometry(**geom, trig_impl=trig))
        tol = 1e-6 * float(np.abs(np.asarray(want.re)).max())
        np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), rtol=0, atol=tol, err_msg=trig)
        np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), rtol=0, atol=tol, err_msg=trig)
        out[trig] = got
    np.testing.assert_allclose(out["split"].re.numpy(), out["direct"].re.numpy(), rtol=0, atol=1e-5)
    assert not np.array_equal(out["split"].re.numpy(), out["direct"].re.numpy())
    cfg = tconfig.DataConfig(trig_impl="split", rng_impl="rbg")
    g = tch.ChannelGeometry.from_config(cfg)
    assert (g.trig_impl, g.rng_impl) == ("split", "rbg")


@pytest.mark.parametrize("field,value", [("rng_impl", "philox"), ("trig_impl", "fast")])
def test_unknown_data_knobs_raise_jax_s_message(field, value):
    with pytest.raises(ValueError) as want:
        jch.ChannelGeometry(**{field: value})
    with pytest.raises(ValueError) as got:
        tch.ChannelGeometry.from_config(tconfig.DataConfig(**{field: value}))
    assert str(got.value) == str(want.value)


def test_unknown_model_dtype_and_moments_raise_as_jax_does():
    with pytest.raises(KeyError) as want:
        jcnn.activation_dtype("bf16")
    with pytest.raises(KeyError) as got:
        tconfig.from_args(["--model.dtype=bf16"])
    assert str(got.value) == str(want.value)
    assert tconfig.activation_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError) as want:
        joptim.get_optimizer(jconfig.TrainConfig(moments_dtype="fp16"), 1)
    with pytest.raises(ValueError) as got:
        toptim.get_optimizer(tconfig.TrainConfig(moments_dtype="fp16"), [torch.zeros(1)], 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_bf16_moments_with_adamw_or_sgd_warn_and_keep_float32(optimizer):
    with pytest.warns(UserWarning) as want:
        joptim.get_optimizer(jconfig.TrainConfig(optimizer=optimizer, moments_dtype="bfloat16"), 1)
    with pytest.warns(UserWarning) as got:
        opt = toptim.get_optimizer(tconfig.TrainConfig(optimizer=optimizer, moments_dtype="bfloat16"),
                                   [torch.zeros(2, requires_grad=True)], 1)
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert not isinstance(opt.opt, toptim.AdamLowp)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        toptim.get_optimizer(tconfig.TrainConfig(moments_dtype="bfloat16"), [torch.zeros(1)], 1)


def test_cli_takes_the_low_precision_flags(tmp_path):
    flags = ["--device=cpu", "--data.n_ant=16", "--data.n_sub=8", "--data.n_beam=4", "--data.data_len=16",
             "--model.features=4", "--train.batch_size=4", "--train.n_epochs=1", f"--train.workdir={tmp_path}",
             "--model.dtype=bfloat16", "--train.moments_dtype=bfloat16", "--data.trig_impl=split",
             "--data.rng_impl=rbg"]
    for cmd in ("train-hdce", "train-dce"):
        assert cli.main([cmd, *flags]) == 0
    tags = sorted(p.name for p in tmp_path.rglob("*.pt"))
    assert {"hdce_best.pt", "dce_best.pt"} <= set(tags)
