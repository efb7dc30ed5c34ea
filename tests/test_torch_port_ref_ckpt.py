"""Reference ``.pth`` checkpoints in the port (``qdml_tpu_torch.train.torch_interop``)
against the JAX package's ``qdml_tpu.train.torch_interop``, on the CPU.

- ``.pth`` files written by JAX's ``export_reference_dir`` load through the
  port's ``import_reference_dir`` into exactly the state dicts
  ``qdml_tpu_torch.interop`` carries from the same Flax trees, and the
  port's modules on them give JAX's forwards (rtol 1e-4 / atol 1e-5, float32
  convs in another order).
- The port's ``export_reference_dir`` is read back by JAX's
  ``import_reference_dir`` into the original numpy trees, exactly.
- The loader quirks: the three wrapper formats, the ``module.`` prefix, the
  stale ``QSC_optimized_best.pth`` and ``..._epoch99_DML_SC.pth`` names.
- ``export-torch`` then ``import-torch`` on the CPU: the tags come back equal,
  the QSC's meta read from its weights' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.models.cnn import SCP128 as JSC  # noqa: E402
from qdml_tpu.models.qsc import QSCP128 as JQSC  # noqa: E402
from qdml_tpu.train import torch_interop as jti  # noqa: E402
from qdml_tpu.train.hdce import HDCE as JHDCE  # noqa: E402
from qdml_tpu_torch import cli, interop  # noqa: E402
from qdml_tpu_torch.models.cnn import SCP128  # noqa: E402
from qdml_tpu_torch.models.qsc import QSCP128  # noqa: E402
from qdml_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from qdml_tpu_torch.train import torch_interop as tti  # noqa: E402
from qdml_tpu_torch.train.hdce import HDCE  # noqa: E402

OUT = 64  # the head's width, cut from 2048 for time (the trunks are full width: the reference files' 32 features)


def _randomize(tree, rng):
    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":  # unit-scale activations: the tolerances below are relative
            fan_in = np.prod(a.shape[-4:-1]) if a.ndim >= 4 else a.shape[-2]
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.2 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, 16, 8, 2))
    hdce = _randomize(jax.device_get(JHDCE(n_scenarios=3, features=32, out_dim=OUT).init(
        key, jnp.zeros((3, 1, 16, 8, 2)), train=False)), rng)
    sc = _randomize(jax.device_get(JSC(n_classes=3).init(key, x0, train=False))["params"], rng)
    qsc = _randomize(jax.device_get(JQSC(n_qubits=4, n_layers=2).init(key, x0, train=False))["params"], rng)
    return {"hdce": hdce, "sc": sc, "qsc": qsc}


def _assert_trees_equal(got, want, where=""):
    if hasattr(want, "items"):
        assert set(got) == set(want), where
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=where)


def test_jax_exports_load_into_the_port_with_jax_forwards(trees, tmp_path):
    jti.export_reference_dir(str(tmp_path), hdce_vars=trees["hdce"], sc_params=trees["sc"],
                             qsc_params=trees["qsc"], batch_size=8, snr_db=10)
    got = tti.import_reference_dir(str(tmp_path), batch_size=8, snr_db=10)
    want = {
        "hdce": interop.hdce_state_dict_from_flax(trees["hdce"]),
        "sc": interop.sc_state_dict_from_flax(trees["sc"]),
        "qsc": interop.qsc_state_dict_from_flax(trees["qsc"]),
    }
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name]), name
        for k in want[name]:
            assert torch.equal(got[name][k], want[name][k]), (name, k)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 16, 8, 2)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    hdce = HDCE(3, 32, OUT)
    hdce.load_state_dict(got["hdce"])
    xs = np.stack([x] * 3)
    np.testing.assert_allclose(
        hdce.eval()(xt.expand(3, *xt.shape)).detach().numpy(),
        np.asarray(JHDCE(n_scenarios=3, features=32, out_dim=OUT).apply(trees["hdce"], xs, train=False)),
        rtol=1e-4, atol=1e-5)
    sc = SCP128()
    sc.load_state_dict(got["sc"])
    np.testing.assert_allclose(sc(xt).detach().numpy(),
                               np.asarray(JSC(n_classes=3).apply({"params": trees["sc"]}, x)), rtol=1e-4, atol=1e-5)
    qsc = QSCP128(4, 2, impl="dense")
    qsc.load_state_dict(got["qsc"])
    np.testing.assert_allclose(
        qsc(xt).detach().numpy(),
        np.asarray(JQSC(n_qubits=4, n_layers=2, impl="dense").apply({"params": trees["qsc"]}, x)),
        rtol=1e-4, atol=1e-5)


def test_port_exports_read_back_by_jax_exactly(trees, tmp_path):
    written = tti.export_reference_dir(
        str(tmp_path),
        hdce_state=interop.hdce_state_dict_from_flax(trees["hdce"]),
        sc_state=interop.sc_state_dict_from_flax(trees["sc"]),
        qsc_state=interop.qsc_state_dict_from_flax(trees["qsc"]),
        batch_size=16, snr_db=5,
    )
    names = sorted(p.rsplit("/", 1)[1] for p in written)
    assert names == sorted([
        "Conv0_16_5dB_best_DML.pth", "Conv1_16_5dB_best_DML.pth", "Conv2_16_5dB_best_DML.pth",
        "Linear_16_5dB_best_DML.pth", "16_5dB_best_DML_SC.pth", "QSC_OPT_16_5dB_best_DML.pth",
        "QSC_optimized_best.pth",
    ])
    back = jti.import_reference_dir(str(tmp_path), batch_size=16, snr_db=5)
    _assert_trees_equal(back["hdce"], trees["hdce"], "hdce")
    _assert_trees_equal(back["sc"]["params"], trees["sc"], "sc")
    _assert_trees_equal(back["qsc"]["params"], trees["qsc"], "qsc")
    # the reference's wrappers, as its own loaders read them
    assert set(torch.load(tmp_path / "Conv0_16_5dB_best_DML.pth", weights_only=True)) == {"conv"}
    assert set(torch.load(tmp_path / "Linear_16_5dB_best_DML.pth", weights_only=True)) == {"linear"}
    assert set(torch.load(tmp_path / "16_5dB_best_DML_SC.pth", weights_only=True)) == {"cnn"}
    assert set(torch.load(tmp_path / "QSC_optimized_best.pth", weights_only=True)) == {"model_state_dict"}
    assert "qlayer.weights" in torch.load(tmp_path / "QSC_OPT_16_5dB_best_DML.pth", weights_only=True)


@pytest.mark.parametrize("wrap", ["fallback", "state_dict", "raw"])
@pytest.mark.parametrize("prefix", ["", "module."])
def test_normalize_accepts_the_three_formats_and_the_module_prefix(tmp_path, wrap, prefix):
    sd = {f"{prefix}conv1.weight": torch.arange(6.0).reshape(2, 3), f"{prefix}FC.bias": torch.ones(3)}
    obj = {"cnn": sd} if wrap == "fallback" else {"state_dict": sd} if wrap == "state_dict" else sd
    path = tmp_path / "x.pth"
    torch.save(obj, path)
    got = tti.load_pth(str(path), fallback_key="cnn")
    assert set(got) == {"conv1.weight", "FC.bias"}
    assert torch.equal(got["conv1.weight"], torch.arange(6.0).reshape(2, 3))
    want = jti.normalize_state_dict(obj, fallback_key="cnn")
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_stale_reference_names_are_probed(trees, tmp_path):
    qsc = interop.qsc_state_dict_from_flax(trees["qsc"])
    sc = interop.sc_state_dict_from_flax(trees["sc"])
    tti.save_pth(str(tmp_path / "QSC_optimized_best.pth"), {f"module.{k}": v for k, v in qsc.items()},
                 "model_state_dict")
    tti.save_pth(str(tmp_path / tti.reference_sc_ckpt_name(256, 10, "epoch99")), sc, "cnn")
    got = tti.import_reference_dir(str(tmp_path))
    assert set(got) == {"sc", "qsc"}
    for want, name in ((qsc, "qsc"), (sc, "sc")):
        for k in want:
            assert torch.equal(got[name][k], want[k]), (name, k)
    # JAX's importer reads the same files
    assert set(jti.import_reference_dir(str(tmp_path))) == {"sc", "qsc"}
    assert tti.reference_ckpt_name("Conv1", 256, 10, "epoch3") == jti.reference_ckpt_name("Conv1", 256, 10, "epoch3")
    assert tti.import_reference_dir(str(tmp_path / "empty")) == {}


def test_cli_export_then_import_round_trips(tmp_path, capsys):
    ws = tmp_path / "ws"
    base = ["--device=cpu", f"--train.workdir={ws}", "--data.data_len=24", "--train.batch_size=8",
            "--train.n_epochs=1", "--train.print_freq=1000", "--quantum.n_qubits=4", "--quantum.n_layers=2"]
    for cmd in ("train-hdce", "train-sc", "train-qsc"):
        assert cli.main([cmd, *base]) == 0
    pth = tmp_path / "pth"
    assert cli.main(["export-torch", *base, f"--out={pth}"]) == 0
    assert len(list(pth.glob("*.pth"))) == 7
    fresh = ["--device=cpu", f"--train.workdir={tmp_path / 'fresh'}", "--train.batch_size=8"]
    assert cli.main(["import-torch", *fresh, f"--out={pth}"]) == 0
    assert "imported ['hdce', 'qsc', 'sc']" in capsys.readouterr().out
    src, dst = ws / "Pn_128" / "default", tmp_path / "fresh" / "Pn_128" / "default"
    for name in ("hdce", "sc", "qsc"):
        a, _ = tckpt.restore_params(str(src), f"{name}_best")
        b, meta = tckpt.restore_params(str(dst), f"{name}_best")
        assert set(a["params"]) == set(b["params"]), name
        for k, v in a["params"].items():
            assert torch.equal(b["params"][k], v), (name, k)
        assert meta["source"] == str(pth)
    _, qmeta = tckpt.restore_params(str(dst), "qsc_best")
    assert qmeta["quantum"] == {"n_qubits": 4, "n_layers": 2, "n_classes": 3, "backend": "dense", "input_norm": False}


def test_import_refuses_weights_that_do_not_fit_and_entry_points_need_a_card(tmp_path, monkeypatch):
    sc = SCP128().state_dict()
    bad = {**sc, "FC.weight": torch.zeros(3, 7)}
    tti.save_pth(str(tmp_path / tti.reference_sc_ckpt_name(8, 10, "best")), bad, "cnn")
    with pytest.raises(RuntimeError, match="size mismatch"):
        cli.main(["import-torch", "--device=cpu", f"--train.workdir={tmp_path / 'ws'}", "--train.batch_size=8",
                  f"--out={tmp_path}"])
    assert not (tmp_path / "ws").exists()  # nothing written
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("import-torch", "export-torch", "train-dce", "nat-sweep", "profile"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main([cmd, f"--train.workdir={tmp_path / 'none'}", f"--out={tmp_path / 'none'}"])
