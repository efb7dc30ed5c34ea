"""The port's monolithic DCE against the JAX package's, on the CPU.

- The module: ``DCEP128`` on weights carried across from a Flax ``DCEP128``
  (``qdml_tpu_torch.interop.dce_state_dict_from_flax``) gives JAX's outputs
  within rtol 1e-4 / atol 1e-5 in eval mode and in train mode (batch
  statistics), and its train-mode BatchNorm update moves the running
  statistics as Flax's does, with decay 0.9 (the JAX ``DCEP128`` builds its
  trunk with the default momentum, not HDCE's ``0.9 ** n_users``).
- The trainer: 2 epochs of ``train_dce`` on the ``.npy`` cache the JAX
  package's ``save_npy_cache`` wrote, from JAX's ``init_dce_state`` weights,
  give JAX's ``train_dce`` history to rtol 2e-4 (float32 convs and head
  products summed in another order over 8 Adam steps); tags, resume and the
  ``train-dce`` command.
- The sweep: ``batch_metrics``' ``err_dce`` on JAX's own sweep batch equals
  the JAX ``make_sweep_step``'s to rtol 1e-4, and ``eval`` restores a
  trained DCE and reports its curve under the JAX key ``dce``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.data import baselines as jbl  # noqa: E402
from qdml_tpu.data import channels as jch  # noqa: E402
from qdml_tpu.data import datasets as jds  # noqa: E402
from qdml_tpu.data.datasets import save_npy_cache  # noqa: E402
from qdml_tpu.models.cnn import DCEP128 as JDCE  # noqa: E402
from qdml_tpu.models.cnn import SCP128 as JSC  # noqa: E402
from qdml_tpu.train import dce as jdce  # noqa: E402
from qdml_tpu.train.hdce import HDCE as JHDCE  # noqa: E402
from qdml_tpu_torch import cli, interop  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.data import channels as tch  # noqa: E402
from qdml_tpu_torch.data.datasets import GridData  # noqa: E402
from qdml_tpu_torch.eval import sweep as tsweep  # noqa: E402
from qdml_tpu_torch.models.cnn import DCEP128  # noqa: E402
from qdml_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from qdml_tpu_torch.train.dce import build_dce, train_dce  # noqa: E402
from qdml_tpu_torch.utils.complexops import CArr  # noqa: E402

DATA = dict(n_ant=16, n_sub=8, n_beam=4, data_len=40)
TRAIN = dict(batch_size=8, n_epochs=2, print_freq=1000)
GEOM = dict(n_ant=16, n_sub=16, n_beam=8)


def _cfgs(**train):
    tkw = {**TRAIN, **train}
    jcfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(**DATA), model=jconfig.ModelConfig(features=8), train=jconfig.TrainConfig(**tkw)
    )
    tcfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**DATA), model=tconfig.ModelConfig(features=8), train=tconfig.TrainConfig(**tkw)
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("npy")
    save_npy_cache(str(path), jconfig.DataConfig(**DATA), chunk=40)
    return str(path)


def _randomize(tree, rng):
    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(a.shape[:-1])
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


def test_dce_forward_matches_flax_on_carried_weights():
    rng = np.random.default_rng(0)
    jm = JDCE(features=8, out_dim=64)
    variables = _randomize(jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16, 8, 2)))), rng)
    x = rng.standard_normal((6, 16, 8, 2)).astype(np.float32)
    tm = DCEP128(8, 64, (16, 8))
    sd = interop.dce_state_dict_from_flax(variables, (16, 8))
    assert set(sd) == set(tm.state_dict())
    assert {k.split(".")[0] for k in sd} == {"cnn", "FC"}
    tm.load_state_dict(sd)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    want = np.asarray(jm.apply(variables, x, train=False))
    np.testing.assert_allclose(tm.eval()(xt).detach().numpy(), want, rtol=1e-4, atol=1e-5)
    want_train, upd = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    got_train = tm.train()(xt).detach().numpy()
    np.testing.assert_allclose(got_train, np.asarray(want_train), rtol=1e-4, atol=1e-5)
    moved = interop.dce_state_dict_from_flax({"params": variables["params"], "batch_stats": upd["batch_stats"]})
    for k, v in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), moved[k].numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
    assert all(m.momentum == pytest.approx(0.1) for m in tm.modules() if isinstance(m, torch.nn.BatchNorm2d))


def test_train_dce_history_matches_jax(cache):
    jcfg, tcfg = _cfgs()
    _, jhist = jdce.train_dce(jcfg)
    _, state = jdce.init_dce_state(jcfg, steps_per_epoch=4)
    init = interop.dce_state_dict_from_flax(
        {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}, tcfg.image_hw
    )
    model, hist = train_dce(tcfg, data=GridData.from_npy_cache(cache, tcfg.data, device="cpu"), init_state=init)
    assert set(hist) == set(jhist) == {"train_loss", "val_nmse"}
    for key in jhist:
        assert len(hist[key]) == 2
        np.testing.assert_allclose(hist[key], jhist[key], rtol=2e-4, err_msg=key)
    assert not model.training


def test_dce_tags_resume_and_cli(cache, tmp_path, capsys):
    _, tcfg = _cfgs(n_epochs=3)
    data = GridData.from_npy_cache(cache, tcfg.data, device="cpu")
    _, hist = train_dce(tcfg, data=data, workdir=str(tmp_path / "a"))
    wd = str(tmp_path / "b")
    _, first = train_dce(_cfgs(n_epochs=1)[1], data=data, workdir=wd)
    assert tckpt.latest_tag(wd, "dce") == "dce_best"
    _, rest = train_dce(_cfgs(n_epochs=3, resume=True)[1], data=data, workdir=wd)
    for key in hist:
        np.testing.assert_allclose(first[key] + rest[key], hist[key], rtol=1e-6, err_msg=key)
    rc = cli.main([
        "train-dce", "--device=cpu", "--data.n_ant=16", "--data.n_sub=8", "--data.n_beam=4",
        "--data.data_len=24", "--model.features=4", "--train.batch_size=8", "--train.n_epochs=1",
        f"--train.workdir={tmp_path / 'c'}",
    ])
    assert rc == 0
    out = tmp_path / "c" / "Pn_32" / "default"
    for tag in ("dce_best", "dce_last", "dce_resume"):
        assert (out / f"{tag}.pt").exists() and (out / f"{tag}.meta.json").exists()
    assert "val_nmse" in json.loads((out / "train-dce.metrics.jsonl").read_text().splitlines()[-1])
    assert "train-dce done" in capsys.readouterr().out


def test_sweep_err_dce_matches_jax_step():
    from qdml_tpu.eval.sweep import make_sweep_step
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.hdce import build_hdce

    bs = 12
    jcfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(**GEOM), model=jconfig.ModelConfig(features=8),
        eval=jconfig.EvalConfig(batch_size=bs),
    )
    tcfg = tconfig.ExperimentConfig(data=tconfig.DataConfig(**GEOM), model=tconfig.ModelConfig(features=8))
    rng = np.random.default_rng(5)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, 16, 8, 2))
    hdce_vars = _randomize(jax.device_get(
        JHDCE(n_scenarios=3, features=8, out_dim=512).init(key, jnp.zeros((3, 1, 16, 8, 2)), train=False)), rng)
    sc_vars = {"params": _randomize(jax.device_get(JSC(n_classes=3).init(key, x0, train=False))["params"], rng)}
    dce_vars = _randomize(jax.device_get(JDCE(features=8, out_dim=512).init(key, x0, train=False)), rng)
    jgeom = jch.ChannelGeometry.from_config(jcfg.data)
    profile = jbl.beam_delay_profile(jgeom)
    step = make_sweep_step(jcfg, jgeom, hdce_vars, sc_vars, None, profile, dce_vars=dce_vars)

    hdce = build_hdce(tcfg, "cpu")
    hdce.load_state_dict(interop.hdce_state_dict_from_flax(hdce_vars))
    sc = build_classifier(tcfg, False, "cpu")
    sc.load_state_dict(interop.sc_state_dict_from_flax(sc_vars["params"]))
    dce = build_dce(tcfg, "cpu")
    dce.load_state_dict(interop.dce_state_dict_from_flax(dce_vars))
    models = tsweep.SweepModels(hdce, sc, None, dce)
    tgeom = tch.ChannelGeometry.from_config(tcfg.data)
    for start, count_base, snr in ((600, 0, 5.0), (600, 24, 15.0)):
        want = {k: float(v) for k, v in step(jnp.asarray(start), jnp.asarray(count_base), jnp.float32(snr)).items()}
        i = count_base + jnp.arange(bs)
        jb = jds.make_network_batch(jnp.uint32(jcfg.data.seed), i % 3, (i // 3) % 3, start + i, jnp.float32(snr), jgeom)
        batch = {
            "yp_img": torch.tensor(np.asarray(jb["yp_img"])),
            "h_ls": CArr(torch.tensor(np.asarray(jb["h_ls"].re)), torch.tensor(np.asarray(jb["h_ls"].im))),
            "h_perf_c": CArr(torch.tensor(np.asarray(jb["h_perf_c"].re)), torch.tensor(np.asarray(jb["h_perf_c"].im))),
            "indicator": torch.tensor(np.asarray(jb["indicator"])).long(),
        }
        got = {k: float(v) for k, v in
               tsweep.batch_metrics(models, batch, snr, torch.tensor(np.asarray(profile)), tgeom).items()}
        assert set(got) == set(want) and "err_dce" in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_eval_restores_a_trained_dce_and_reports_its_curve(tmp_path):
    ws, res = tmp_path / "ws", tmp_path / "res"
    base = ["--device=cpu", f"--train.workdir={ws}", "--data.data_len=40", "--data.n_ant=16",
            "--model.features=8", "--train.batch_size=8", "--train.n_epochs=1", "--train.print_freq=1000",
            "--quantum.n_qubits=4", "--quantum.n_layers=2"]
    for cmd in ("train-hdce", "train-sc", "train-dce"):
        assert cli.main([cmd, *base]) == 0
    assert cli.main(["eval", *base, f"--eval.results_dir={res}", "--eval.test_len=32", "--eval.batch_size=16"]) == 0
    out = json.loads((res / "quantum_classical_comparison.json").read_text())
    assert set(out["nmse_db"]) == {"ls", "mmse", "mmse_oracle", "dce", "hdce_classical"}
    assert len(out["nmse_db"]["dce"]) == len(out["snr"]) and np.isfinite(out["nmse_db"]["dce"]).all()
    assert "DCE (monolithic)" in (res / "results_table.md").read_text()
