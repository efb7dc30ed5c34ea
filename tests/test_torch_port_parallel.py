"""The port's mesh (``qdml_tpu_torch/parallel/``) against the JAX package's.

- ``make_mesh`` lays ranks out as JAX lays devices for the same
  ``MeshConfig``, with its ``data_axis=-1`` rule and its error;
  ``training_mesh``'s errors word for word (``tests/test_parallel.py:291-321``).
- ``process_batch_slice`` / ``process_grid_slice``: the rectangles and the
  rejections of JAX's for stub worlds of one process a ``(fed, data)`` cell
  (``:266-415``). A port rank is one process, so the JAX layouts whose
  devices of one cell span processes cannot arise.
- gloo worlds: one HDCE step from JAX's ``init_hdce_state`` weights (carried
  by ``qdml_tpu_torch.interop``) on JAX's first batch, against JAX's
  ``make_hdce_train_step`` on a JAX mesh of the same shape: data-parallel
  (2 ranks), federated (3 ranks) and the tensor-parallel head (data 1 x
  model 2), at JAX's tolerances (``:160-202``: loss rtol 1e-5, parameters
  rtol 1e-4 / atol 1e-6 after the step), but for the entries whose gradient
  is within 1e-5 of zero: there the first Adam step is decided by the
  gradient's float32 summation order (the port's one-rank step and JAX's
  differ there too), and they are held to twice the rate
  (:func:`_assert_first_step_close`).
- ``sharded_16q`` at ``n_layers=1``, ``data_len=48``, ``batch_size=4``: one
  classifier step on 4 ranks (the statevector split over the model line)
  against the same step on one rank (``:125-139``).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.data.datasets import DMLGridLoader as JLoader  # noqa: E402
from qdml_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from qdml_tpu.parallel import multihost as jmultihost  # noqa: E402
from qdml_tpu.parallel import replicate as jreplicate  # noqa: E402
from qdml_tpu.parallel import shard_grid_batch as jshard_grid_batch  # noqa: E402
from qdml_tpu.parallel import shard_hdce_state as jshard_hdce_state  # noqa: E402
from qdml_tpu.train.hdce import init_hdce_state as jinit_hdce  # noqa: E402
from qdml_tpu.train.hdce import make_hdce_train_step  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from qdml_tpu_torch.parallel import multihost  # noqa: E402
from qdml_tpu_torch.parallel.selfcheck import read_ranks, spawn_world  # noqa: E402

LAYOUTS = [  # (world, fed, data, model)
    (8, 1, -1, 1), (8, 1, 2, 4), (6, 3, -1, 1), (8, 1, -1, 4), (4, 1, 1, 4), (3, 3, 1, 1), (8, 2, 2, 2),
]


@pytest.mark.parametrize("world,fed,data,model", LAYOUTS)
def test_make_mesh_lays_ranks_out_as_jax_lays_devices(world, fed, data, model):
    jcfg = jconfig.MeshConfig(fed_axis=fed, data_axis=data, model_axis=model)
    tcfg = tconfig.MeshConfig(fed_axis=fed, data_axis=data, model_axis=model)
    jm = jmake_mesh(jcfg, jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(world):
        tm = pmesh.make_mesh(tcfg, world=world, rank=r)
        assert tm.shape == dict(jm.shape)
        np.testing.assert_array_equal(tm.devices, ids - ids.min())
        if tm.member:
            assert tuple(tm.coords().values()) == tuple(int(i) for i in np.argwhere(tm.devices == r)[0])
            for axis in pmesh.AXES:
                line = tm.group_ranks(axis)
                assert len(line) == tm.shape[axis] and r in line


def test_make_mesh_refuses_a_layout_bigger_than_the_world():
    cfg = dict(fed_axis=3, data_axis=2, model_axis=2)
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(jconfig.MeshConfig(**cfg), jax.devices()[:8])
    with pytest.raises(ValueError) as terr:
        pmesh.make_mesh(tconfig.MeshConfig(**cfg), world=8, rank=0)
    assert str(terr.value) == str(jerr.value) == "mesh 3x2x2 needs 12 devices, have 8"


def test_training_mesh_errors_word_for_word(monkeypatch):
    from qdml_tpu.parallel.mesh import training_mesh as jtraining_mesh

    def both(**mesh):
        j = dataclasses.replace(jconfig.ExperimentConfig(), mesh=jconfig.MeshConfig(**mesh))
        t = dataclasses.replace(tconfig.ExperimentConfig(), mesh=tconfig.MeshConfig(**mesh))
        with pytest.raises(ValueError) as jerr:
            jtraining_mesh(j)
        with pytest.raises(ValueError) as terr:
            pmesh.training_mesh(t, "cpu")
        assert str(terr.value) == str(jerr.value)
        return str(terr.value)

    assert "axis names" in both(data_axis_name="dp")
    assert pmesh.training_mesh(tconfig.ExperimentConfig(), "cpu") is None  # one rank: no mesh
    # an 8-rank world, laid out without its groups
    monkeypatch.setattr(pmesh, "world_size", lambda: 8)
    monkeypatch.setattr(pmesh, "make_mesh", lambda cfg, device=None: pmesh.Mesh(
        {"fed": cfg.fed_axis, "data": 8 // cfg.fed_axis, "model": 1}, 0, torch.device("cpu")))
    assert "n_scenarios" in both(fed_axis=2)
    assert pmesh.current_mesh() is None


def _stub_jax_mesh(fed, data, model):
    """JAX's stub mesh with one process a (fed, data) cell: the port's
    layout, where a cell's model line shares its rows."""
    devs = np.empty((fed, data, model), dtype=object)
    for (f, d, m), _ in np.ndenumerate(devs):
        devs[f, d, m] = SimpleNamespace(process_index=f * data + d)
    return SimpleNamespace(shape={"fed": fed, "data": data, "model": model}, devices=devs,
                           axis_names=("fed", "data", "model"))


@pytest.mark.parametrize("fed,data,model,bs,n_scen,use_fed", [
    (3, 2, 1, 8, 3, True), (3, 1, 1, 8, 3, True), (1, 6, 1, 12, 3, False), (1, 2, 2, 8, 3, False),
    (1, 4, 1, 8, 3, True), (3, 2, 2, 8, 3, True),
])
def test_grid_rectangles_match_jax(monkeypatch, fed, data, model, bs, n_scen, use_fed):
    monkeypatch.setattr(jax, "process_count", lambda: fed * data)
    jm = _stub_jax_mesh(fed, data, model)
    for r in range(fed * data * model):
        tm = pmesh.make_mesh(tconfig.MeshConfig(fed_axis=fed, data_axis=data, model_axis=model),
                             world=fed * data * model, rank=r)
        monkeypatch.setattr(jax, "process_index", lambda r=r: r // model)
        got = multihost.process_grid_slice(bs, n_scen, tm, use_fed)
        assert got == jmultihost.process_grid_slice(bs, n_scen, jm, use_fed)
        if not use_fed or fed == 1:
            assert multihost.process_batch_slice(bs, tm) == jmultihost.process_batch_slice(bs, jm)


@pytest.mark.parametrize("fed,data,bs,n_scen,match", [
    (2, 1, 8, 3, "scenarios do not shard evenly"), (3, 2, 9, 3, "not divisible by the mesh data axis"),
    (1, 3, 8, 3, "not divisible by 3 processes"),
])
def test_grid_rectangles_reject_as_jax_does(monkeypatch, fed, data, bs, n_scen, match):
    monkeypatch.setattr(jax, "process_count", lambda: fed * data)
    monkeypatch.setattr(jax, "process_index", lambda: 0)
    tm = pmesh.make_mesh(tconfig.MeshConfig(fed_axis=fed, data_axis=data), world=fed * data, rank=0)
    with pytest.raises(ValueError) as jerr:
        jmultihost.process_grid_slice(bs, n_scen, _stub_jax_mesh(fed, data, 1), fed > 1)
    with pytest.raises(ValueError) as terr:
        multihost.process_grid_slice(bs, n_scen, tm, fed > 1)
    assert match in str(terr.value) and str(terr.value) == str(jerr.value)


# --- one HDCE step in gloo worlds, against JAX's step on a mesh of the same shape

DATA = dict(n_ant=16, n_sub=8, n_beam=4, data_len=64)
STEP_MESHES = {  # name: (ranks, MeshConfig fields)
    "dp": (2, dict(fed_axis=1, data_axis=2, model_axis=1)),
    "federated": (3, dict(fed_axis=3, data_axis=1, model_axis=1)),
    "tensor_parallel": (2, dict(fed_axis=1, data_axis=1, model_axis=2)),
}


@pytest.fixture(scope="module")
def jax_setup():
    cfg = jconfig.ExperimentConfig(
        data=jconfig.DataConfig(**DATA), model=jconfig.ModelConfig(features=16),
        train=jconfig.TrainConfig(batch_size=16, n_epochs=1),
    )
    loader = JLoader(cfg.data, 16)
    batch = next(iter(loader.epoch(0)))
    model, state = jinit_hdce(cfg, loader.steps_per_epoch)
    return cfg, model, state, batch


def _torch_cfg():
    return tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**DATA), model=tconfig.ModelConfig(features=16),
        train=tconfig.TrainConfig(batch_size=16, n_epochs=1),
    )


def _flax_sd(state, image_hw):
    return interop.hdce_state_dict_from_flax(
        {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)}, image_hw,
    )


@pytest.fixture(scope="module", params=sorted(STEP_MESHES))
def step_world(request, jax_setup, tmp_path_factory):
    name = request.param
    nproc, mesh_kw = STEP_MESHES[name]
    _, _, state, batch = jax_setup
    tcfg = _torch_cfg()
    tmp = tmp_path_factory.mktemp(f"hdce_{name}")
    torch_batch = {k: torch.tensor(np.asarray(batch[k])) for k in ("yp_img", "h_label", "h_perf")}
    (tmp / "in").mkdir()
    torch.save({"cfg": tcfg, "mesh": mesh_kw, "state": _flax_sd(state, tcfg.image_hw), "batch": torch_batch},
               tmp / "in" / "hdce.pt")
    rcs = spawn_world(nproc, ["-m", "qdml_tpu_torch.parallel.selfcheck", "hdce-step", f"--in={tmp / 'in'}",
                              f"--out={tmp / 'out'}", "--device=cpu"], tmp / "logs", timeout_s=120)
    assert rcs == [0] * nproc, [(tmp / "logs" / f"rank{r}.log").read_text()[-2000:] for r in range(nproc)]
    return name, [r["steps"][0] for r in read_ranks(tmp / "out", nproc)], torch.load(tmp / "out" / "state.pt")


def test_hdce_step_on_a_world_matches_jax_on_that_mesh(step_world, jax_setup):
    name, ranks, new_state = step_world
    cfg, model, state, batch = jax_setup
    _, mesh_kw = STEP_MESHES[name]
    nproc = STEP_MESHES[name][0]
    jm = jmake_mesh(jconfig.MeshConfig(**mesh_kw), jax.devices()[:nproc])
    step = make_hdce_train_step(model, state.tx)
    if name == "dp":
        jstate, jbatch = jreplicate(state, jm), jshard_grid_batch(batch, jm)
    else:
        jstate = jshard_hdce_state(state, jm, tensor_parallel=name == "tensor_parallel")
        jbatch = jshard_grid_batch(batch, jm, fed=name == "federated")
    jnew, jm_out = step(jstate, jbatch)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(jm_out["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["loss_perf"], float(jm_out["loss_perf"]), rtol=1e-5)
    want = _flax_sd(jnew, _torch_cfg().image_hw)
    assert list(new_state) == list(want)
    _assert_first_step_close(new_state, want, _flax_sd(state, _torch_cfg().image_hw), _torch_cfg().train.lr)


def _assert_first_step_close(got: dict, want: dict, init: dict, lr: float, min_strict: float = 0.99) -> None:
    """Parameters after one Adam step at JAX's tolerances (rtol 1e-4, atol
    1e-6). Adam's first step moves a parameter by lr * g / (|g| + eps), which
    amplifies a gradient's rounding by lr * eps / g^2: under |g| = 1e-5 (a
    step under 0.999 lr; an exactly-zero gradient among them, as the last
    layer's RZ weights have under the Z readout) float32 sums in another
    order (torch's or XLA's, over ranks or whole) decide the step, so those
    entries are held to 2 lr."""
    strict = total = 0
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        g, v = got[k].numpy(), v.numpy()
        lr_sized = np.abs(v - init[k].numpy()) > 0.999 * lr
        if k.endswith(("running_mean", "running_var")):
            lr_sized = np.ones_like(v, dtype=bool)
        np.testing.assert_allclose(g[lr_sized], v[lr_sized], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g[~lr_sized], v[~lr_sized], rtol=0, atol=2 * lr, err_msg=k)
        strict, total = strict + lr_sized.sum(), total + lr_sized.size
    assert strict > min_strict * total  # the share of entries held at the strict tolerance


# --- sharded_16q: one classifier step on 4 ranks against one rank


def test_sharded_16q_step_on_four_ranks_matches_one_rank(tmp_path):
    from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
    from qdml_tpu_torch.train.qsc import classifier_train_step, make_trainer

    cfg = tconfig.from_args([
        "--preset=sharded_16q", "--data.data_len=48", "--train.batch_size=4", "--quantum.n_layers=1",
    ])
    batch = next(iter(DMLGridLoader(GridData.synthesize(cfg.data, "cpu"), 4).epoch(0)))
    batch = {k: batch[k] for k in ("yp_img", "indicator")}
    model, opt = make_trainer(cfg, True, "cpu", 1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    (tmp_path / "in").mkdir()
    torch.save({"cfg": cfg, "state": init, "batch": batch}, tmp_path / "in" / "qsc.pt")
    rcs = spawn_world(4, ["-m", "qdml_tpu_torch.parallel.selfcheck", "qsc-step", f"--in={tmp_path / 'in'}",
                          f"--out={tmp_path / 'out'}", "--device=cpu"], tmp_path / "logs", timeout_s=120)
    assert rcs == [0] * 4, [(tmp_path / "logs" / f"rank{r}.log").read_text()[-2000:] for r in range(4)]
    loss = classifier_train_step(model, opt, batch)["loss"]  # one rank: the tensor path
    ranks = [r["steps"][0] for r in read_ranks(tmp_path / "out", 4)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
    got = torch.load(tmp_path / "out" / "state.pt")
    # the classifier's gradients are small (a fifth of its entries step by
    # under 0.999 lr), so its gradients are held too, at the circuit's
    # tolerance (rtol 1e-3) and atol 1e-5 of each tensor's largest entry
    for k, p in model.named_parameters():
        g, want = got["grads"][k].numpy(), p.grad.numpy()
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=1e-5 * np.abs(want).max(), err_msg=k)
    _assert_first_step_close(got["state"], model.state_dict(), init, cfg.train.lr, min_strict=0.75)
