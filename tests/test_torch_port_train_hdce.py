"""The port's HDCE training run against the JAX package's, on the CPU, plus
checkpoints, resume and the ``train-hdce`` command.

Both runs see the same data and start from the same weights: the port reads
the ``.npy`` cache the JAX package's ``save_npy_cache`` wrote for the same
data config (over which its loader yields JAX's ``DMLGridLoader`` batches),
and starts from JAX's ``init_hdce_state`` weights carried across by
``qdml_tpu_torch.interop``. After 2 epochs (8 Adam steps, BatchNorm in train
mode) the histories must agree to rtol 2e-4: float32 convs and head products
summed in another order, compounded over 8 steps.
"""

import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.config import DataConfig as JDataConfig  # noqa: E402
from qdml_tpu.config import ExperimentConfig as JExperimentConfig  # noqa: E402
from qdml_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from qdml_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from qdml_tpu.data.datasets import save_npy_cache  # noqa: E402
from qdml_tpu.train import hdce as jhdce  # noqa: E402
from qdml_tpu_torch import cli, interop  # noqa: E402
from qdml_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig  # noqa: E402
from qdml_tpu_torch.data.datasets import GridData  # noqa: E402
from qdml_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from qdml_tpu_torch.train.hdce import train_hdce  # noqa: E402

DATA = dict(n_ant=16, n_sub=8, n_beam=4, data_len=40)
TRAIN = dict(batch_size=8, n_epochs=2, print_freq=1000)


def _cfgs(**train):
    jcfg = JExperimentConfig(
        data=JDataConfig(**DATA), model=JModelConfig(features=8), train=JTrainConfig(**{**TRAIN, **train})
    )
    tcfg = ExperimentConfig(
        data=DataConfig(**DATA), model=ModelConfig(features=8), train=TrainConfig(**{**TRAIN, **train})
    )
    return jcfg, tcfg


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("npy")
    save_npy_cache(str(path), JDataConfig(**DATA), chunk=40)
    return str(path)


def test_train_hdce_history_matches_jax(cache):
    jcfg, tcfg = _cfgs()
    _, jhist = jhdce.train_hdce(jcfg)
    _, state = jhdce.init_hdce_state(jcfg, steps_per_epoch=4)
    init = interop.hdce_state_dict_from_flax(
        {"params": jax.device_get(state.params), "batch_stats": jax.device_get(state.batch_stats)},
        tcfg.image_hw,
    )
    data = GridData.from_npy_cache(cache, tcfg.data, device="cpu")
    model, hist = train_hdce(tcfg, data=data, init_state=init)
    assert set(hist) == set(jhist)
    for key in jhist:
        assert len(hist[key]) == 2
        np.testing.assert_allclose(hist[key], jhist[key], rtol=2e-4, err_msg=key)
    assert not model.training


def test_checkpoints_and_resume_continue_the_same_history(cache, tmp_path):
    _, tcfg = _cfgs(n_epochs=3)
    data = GridData.from_npy_cache(cache, tcfg.data, device="cpu")
    straight, hist = train_hdce(tcfg, data=data, workdir=str(tmp_path / "a"))
    wd = str(tmp_path / "b")
    _, first = train_hdce(_cfgs(n_epochs=1)[1], data=data, workdir=wd)
    assert tckpt.latest_tag(wd, "hdce") == "hdce_best"
    payload, meta = tckpt.restore_checkpoint(wd, "hdce_resume")
    assert meta["epoch"] == 0 and meta["best"] == first["val_nmse"][0]
    assert payload["opt"]["count"] == 4
    _, rest = train_hdce(_cfgs(n_epochs=3, resume=True)[1], data=data, workdir=wd)
    assert len(rest["train_loss"]) == 2
    for key in hist:
        np.testing.assert_allclose(first[key] + rest[key], hist[key], rtol=1e-6, err_msg=key)
    last, _ = tckpt.restore_checkpoint(wd, "hdce_last")
    for k, v in straight.state_dict().items():
        torch.testing.assert_close(last["params"][k], v, rtol=1e-6, atol=1e-7)


def test_restore_refuses_missing_and_corrupt_tags(tmp_path):
    with pytest.raises(tckpt.CheckpointNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path), "hdce_best")
    assert tckpt.latest_tag(str(tmp_path), "hdce") is None
    (tmp_path / "hdce_last.pt").write_bytes(b"not a checkpoint")
    with pytest.raises(tckpt.CheckpointRestoreError):
        tckpt.restore_checkpoint(str(tmp_path), "hdce_last")
    assert tckpt.latest_tag(str(tmp_path), "hdce") == "hdce_last"


def test_cli_train_hdce_on_the_cpu_writes_its_tags(tmp_path, capsys):
    rc = cli.main([
        "train-hdce", "--device=cpu", "--data.n_ant=16", "--data.n_sub=8", "--data.n_beam=4",
        "--data.data_len=24", "--model.features=4", "--train.batch_size=8",
        "--train.n_epochs=1", f"--train.workdir={tmp_path}", "--name=tiny",
    ])
    assert rc == 0
    wd = tmp_path / "Pn_32" / "tiny"
    for tag in ("hdce_best", "hdce_last", "hdce_resume"):
        assert (wd / f"{tag}.pt").exists() and (wd / f"{tag}.meta.json").exists()
    lines = (wd / "train-hdce.metrics.jsonl").read_text().splitlines()
    assert "val_nmse" in json.loads(lines[-1])
    assert "train-hdce done" in capsys.readouterr().out
    assert cli.main(["train-nope"]) == 2
    with pytest.raises(KeyError):
        cli.main(["train-sc", "--device=cpu", "--train.nope=1"])
    assert not os.path.exists(tmp_path / "Pn_128")
