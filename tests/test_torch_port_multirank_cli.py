"""The port's CLI under worlds of several ranks on the CPU (gloo), against one rank.

- ``train-hdce --preset=dp_8q`` on 2 ranks (started through
  ``python -m torch.distributed.run --standalone``) and ``--preset=federated``
  on 3 ranks: the logged loss histories equal the one-rank run's of the same
  config (rtol 1e-5 on the train loss, 1e-4 on the validation NMSE, whose
  sums are reduced over the ranks); rank 0 alone writes the logs and the
  checkpoints, in the one-rank layout, and they restore on one rank.
- ``eval --preset=federated`` on 3 ranks (each rank one scenario's trunk,
  routing over ``fed``) writes the one-rank results (rtol 1e-4).
- A second federated run with ``train.resume=true`` resumes every rank from
  rank 0's checkpoint and continues the one-rank history.

No rank imports JAX; the ranks log to files (``spawn_world``).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from qdml_tpu_torch import cli  # noqa: E402
from qdml_tpu_torch.config import from_args  # noqa: E402
from qdml_tpu_torch.parallel.selfcheck import spawn_world  # noqa: E402
from qdml_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from qdml_tpu_torch.train.hdce import build_hdce  # noqa: E402

SMALL = [
    "--device=cpu", "--data.n_ant=16", "--data.data_len=40", "--model.features=4",
    "--train.batch_size=8", "--train.print_freq=1000",
]


def _history(path):
    return [json.loads(line) for line in open(path) if '"epoch"' in line and "train_loss" in line]


def _world(tmp, nproc, args, launcher=False):
    rcs = spawn_world(nproc, ["-m", "qdml_tpu_torch.cli", *args], tmp / "logs", timeout_s=180, launcher=launcher)
    logs = sorted((tmp / "logs").glob("*.log"))
    assert rcs == [0] * len(rcs), [f.read_text()[-3000:] for f in logs]
    return [f.read_text() for f in logs]


def _compare(got, want):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    np.testing.assert_allclose([h["train_loss"] for h in got], [h["train_loss"] for h in want], rtol=1e-5)
    np.testing.assert_allclose([h["val_nmse"] for h in got], [h["val_nmse"] for h in want], rtol=1e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One-rank and multi-rank runs of both presets (plus the SC eval needs)."""
    out = {}
    for preset, nproc, launcher in (("dp_8q", 2, True), ("federated", 3, False)):
        tmp = tmp_path_factory.mktemp(preset)
        args = ["train-hdce", *SMALL, f"--preset={preset}", "--train.n_epochs=2"]
        assert cli.main([*args, f"--train.workdir={tmp / 'one'}"]) == 0
        logs = _world(tmp / "w", nproc, [*args, f"--train.workdir={tmp / 'many'}"], launcher=launcher)
        out[preset] = (tmp, logs)
    return out


@pytest.mark.parametrize("preset", ["dp_8q", "federated"])
def test_multirank_training_matches_one_rank_and_rank0_writes(runs, preset):
    tmp, logs = runs[preset]
    one, many = tmp / "one" / "Pn_128" / preset, tmp / "many" / "Pn_128" / preset
    _compare(_history(many / "train-hdce.metrics.jsonl"), _history(one / "train-hdce.metrics.jsonl"))
    assert sorted(p.name for p in many.iterdir()) == sorted(p.name for p in one.iterdir())
    done = [log for log in logs if "train-hdce done" in log]
    assert len(done) == 1  # rank 0 alone reports (and writes)
    cfg = from_args([*SMALL[1:], f"--preset={preset}"])  # SMALL[0] is --device
    for tag in ("hdce_best", "hdce_last", "hdce_resume"):
        got, meta = tckpt.restore_checkpoint(str(many), tag)
        want, want_meta = tckpt.restore_checkpoint(str(one), tag)
        assert list(got["params"]) == list(want["params"]) and meta["epoch"] == want_meta["epoch"]
        for k, v in want["params"].items():
            torch.testing.assert_close(got["params"][k], v, rtol=1e-4, atol=1e-5)
    model = build_hdce(cfg, "cpu")  # restores on one rank
    model.load_state_dict(tckpt.restore_params(str(many), "hdce_best")[0]["params"])


def test_federated_eval_on_three_ranks_matches_one_rank(runs, tmp_path):
    tmp, _ = runs["federated"]
    ev = [*SMALL, "--preset=federated", "--eval.test_len=60", "--eval.batch_size=20",
          "--eval.snr_grid=5,15"]
    # the classifier both evals restore beside the 3-rank HDCE
    assert cli.main(["train-sc", *SMALL, "--preset=federated", "--train.n_epochs=1",
                     f"--train.workdir={tmp / 'many'}"]) == 0
    assert cli.main(["eval", *ev, f"--train.workdir={tmp / 'many'}", f"--eval.results_dir={tmp_path / 'one'}"]) == 0
    _world(tmp_path / "w", 3, ["eval", *ev, f"--train.workdir={tmp / 'many'}",
                               f"--eval.results_dir={tmp_path / 'many'}"])
    got = json.loads((tmp_path / "many" / "quantum_classical_comparison.json").read_text())
    want = json.loads((tmp_path / "one" / "quantum_classical_comparison.json").read_text())
    assert got["snr"] == want["snr"] and set(got["nmse_db"]) == set(want["nmse_db"])
    for curve in want["nmse_db"]:
        np.testing.assert_allclose(got["nmse_db"][curve], want["nmse_db"][curve], rtol=1e-4, err_msg=curve)
    for clf in want["acc"]:
        np.testing.assert_allclose(got["acc"][clf], want["acc"][clf], rtol=1e-6, err_msg=clf)


def test_federated_resume_continues_from_rank0_checkpoint(runs, tmp_path):
    tmp, _ = runs["federated"]
    args = ["train-hdce", *SMALL, "--preset=federated"]
    assert cli.main([*args, "--train.n_epochs=3", f"--train.workdir={tmp_path / 'straight'}"]) == 0
    wd = tmp_path / "resumed"
    _world(tmp_path / "w1", 3, [*args, "--train.n_epochs=2", f"--train.workdir={wd}"])
    _world(tmp_path / "w2", 3, [*args, "--train.n_epochs=3", "--train.resume=true", f"--train.workdir={wd}"])
    got = _history(wd / "Pn_128" / "federated" / "train-hdce.metrics.jsonl")
    want = _history(tmp_path / "straight" / "Pn_128" / "federated" / "train-hdce.metrics.jsonl")
    _compare(got, want)
