"""The port's models against the Flax modules, on the CPU, with weights carried
across by ``qdml_tpu_torch.interop``.

Small size (features 8, S=3, n_ant=16 so the head is 512 wide, B <= 16);
every Flax parameter and BatchNorm statistic is redrawn from a numpy seed so
that no default initialisation hides a mapping error. Tolerance rtol 1e-4 /
atol 1e-5: float32 convs and a 1024-long dot product summed in another order.
The state dicts are also held key for key (``np.array_equal``) against
``qdml_tpu.train.torch_interop.export_*``, whose HDCE export is fixed at the
reference's 32 features.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.models.cnn import SCP128 as JSCP128  # noqa: E402
from qdml_tpu.models.qsc import QSCP128 as JQSCP128  # noqa: E402
from qdml_tpu.train.hdce import HDCE as JHDCE  # noqa: E402
from qdml_tpu.train.torch_interop import export_hdce, export_qsc, export_sc  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.models.cnn import SCP128, seeded_init_  # noqa: E402
from qdml_tpu_torch.models.qsc import QSCP128  # noqa: E402
from qdml_tpu_torch.train.hdce import HDCE  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _randomize(tree, seed, positive=("var", "scale")):
    """Redraw every leaf from a numpy seed: variances and scales in [0.5, 1.5],
    kernels with standard deviation 1/sqrt(fan_in) (outputs stay O(1)), the
    rest with standard deviation 0.3."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict) or hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in positive:
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        std = 0.3
        if name == "kernel":  # conv (..., kh, kw, I, O) or dense (I, O)
            std = 1.0 / np.sqrt(np.prod(a.shape[-4:-1]) if a.ndim >= 4 else a.shape[-2])
        return (std * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def _image(batch, seed):
    return np.random.default_rng(seed).standard_normal((batch, 16, 8, 2)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _flax_hdce(features, out_dim, seed):
    model = JHDCE(n_scenarios=3, features=features, out_dim=out_dim)
    xs = jnp.zeros((3, 2, 16, 8, 2))
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), xs, train=False))
    return model, _randomize(variables, seed)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_hdce_matches_flax():
    model, variables = _flax_hdce(features=8, out_dim=512, seed=1)
    x = _image(12, seed=2)
    xs = np.stack([x, x[::-1], 0.5 * x])  # (S, B, 16, 8, 2): a distinct input per trunk
    want = model.apply(variables, jnp.asarray(xs), train=False)
    port = HDCE(n_scenarios=3, features=8, out_dim=512).eval()
    port.load_state_dict(interop.hdce_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port(torch.stack([_nchw(v) for v in xs]))
    assert got.shape == (3, 12, 512)
    _close(got, want)


def test_conv_trunk_matches_flax():
    model, variables = _flax_hdce(features=8, out_dim=512, seed=3)
    x = _image(5, seed=4)
    from qdml_tpu.models.cnn import ConvP128 as JConvP128

    trunk_p = jax.tree.map(lambda a: a[1], variables["params"]["StackedConvP128_0"]["VmapConvP128_0"])
    trunk_s = jax.tree.map(lambda a: a[1], variables["batch_stats"]["StackedConvP128_0"]["VmapConvP128_0"])
    want = JConvP128(features=8).apply({"params": trunk_p, "batch_stats": trunk_s}, jnp.asarray(x))
    port = HDCE(n_scenarios=3, features=8, out_dim=512).eval()
    port.load_state_dict(interop.hdce_state_dict_from_flax(variables))
    with torch.no_grad():
        feats = port.trunks[1](_nchw(x))  # C-major flatten; Flax flattens H-major
    want_cmajor = np.asarray(want).reshape(5, 16, 8, 8).transpose(0, 3, 1, 2).reshape(5, -1)
    _close(feats, want_cmajor)


def test_sc_matches_flax():
    x = _image(16, seed=5)
    model = JSCP128(n_classes=3)
    params = _randomize(jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"], 6)
    want = model.apply({"params": params}, jnp.asarray(x))
    port = SCP128(3).eval()
    port.load_state_dict(interop.sc_state_dict_from_flax(params))
    with torch.no_grad():
        got = port(_nchw(x))
    _close(got, want)


@pytest.mark.parametrize("impl,n", [("pallas", 4), ("pallas_circuit", 7)])
@pytest.mark.parametrize("input_norm", [False, True])
def test_qsc_matches_flax(impl, n, input_norm):
    x = _image(16, seed=7)
    model = JQSCP128(n_qubits=n, n_layers=3, impl=impl, input_norm=input_norm)
    params = _randomize(jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"], 8)
    want = jax.jit(lambda p, v: model.apply({"params": p}, v))(params, jnp.asarray(x))
    port = QSCP128(n_qubits=n, n_layers=3, impl=impl, input_norm=input_norm).eval()
    port.load_state_dict(interop.qsc_state_dict_from_flax(params))
    with torch.no_grad():
        got = port(_nchw(x))
    _close(got, want)


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _same_keys_and_values(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_state_dicts_match_jax_exports_key_for_key():
    _, variables = _flax_hdce(features=32, out_dim=64, seed=9)
    conv_sds, fc_sd = export_hdce(variables)
    sd = interop.hdce_state_dict_from_flax(variables)
    for s, want in enumerate(conv_sds):
        _same_keys_and_values(_strip(sd, f"trunks.{s}."), want)
    _same_keys_and_values(_strip(sd, "head."), fc_sd)
    x = jnp.zeros((1, 16, 8, 2))
    sc = _randomize(jax.device_get(JSCP128().init(jax.random.PRNGKey(1), x))["params"], 10)
    _same_keys_and_values(interop.sc_state_dict_from_flax(sc), export_sc(sc))
    qsc = _randomize(
        jax.device_get(JQSCP128(n_qubits=4, n_layers=2, impl="dense").init(jax.random.PRNGKey(2), x))["params"], 11
    )
    _same_keys_and_values(interop.qsc_state_dict_from_flax(qsc), export_qsc(qsc))


def test_port_state_dict_names_are_the_reference_names():
    port = HDCE(n_scenarios=3, features=8, out_dim=512)
    keys = set(port.state_dict())
    for s in range(3):
        for idx in (0, 3, 6):
            assert f"trunks.{s}.cnn.{idx}.weight" in keys
            assert f"trunks.{s}.cnn.{idx + 1}.running_var" in keys
    assert {"head.FC.weight", "head.FC.bias"} <= keys
    assert set(SCP128().state_dict()) == {"conv1.weight", "conv2.weight", "FC.weight", "FC.bias"}
    qkeys = set(QSCP128(4, 2).state_dict())
    assert {"preprocess.0.weight", "preprocess.3.bias", "preprocess.7.weight", "qlayer.weights",
            "classifier.weight"} <= qkeys


def test_seeded_init_is_reproducible():
    a = seeded_init_(HDCE(3, 8, 64), torch.Generator().manual_seed(5)).state_dict()
    b = seeded_init_(HDCE(3, 8, 64), torch.Generator().manual_seed(5)).state_dict()
    c = seeded_init_(HDCE(3, 8, 64), torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.FC.weight"], c["head.FC.weight"])
    assert (a["trunks.0.cnn.1.running_var"] >= 0.5).all()
