"""Worlds of ranks that share ``cuda:0`` over host-staged gloo: the card twins
of ``test_torch_port_sharded.py`` and ``test_torch_port_parallel.py``.

They need a CUDA GPU (B.3 is CUDA C++ with no CPU mode) and skip without
one; the check is made inside each test. JAX is not imported, so they run
where the port runs without it: the sharded worlds are held against the port's one-rank
``tensor`` path, itself held to JAX on the CPU, and the data-parallel HDCE
step against the port's one-rank step on the CPU. Run on the card with
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_multirank_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData  # noqa: E402
from qdml_tpu_torch.parallel.selfcheck import read_ranks, spawn_world  # noqa: E402
from qdml_tpu_torch.quantum.circuits import run_circuit  # noqa: E402
from qdml_tpu_torch.train.hdce import hdce_train_step, make_trainer  # noqa: E402

pytestmark = pytest.mark.cuda
GLOO = {"QDML_TORCH_DIST_BACKEND": "gloo"}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are CUDA C++ with no CPU mode)")


def _world(tmp, nproc, step):
    rcs = spawn_world(nproc, ["-m", "qdml_tpu_torch.parallel.selfcheck", step, f"--in={tmp / 'in'}",
                              f"--out={tmp / 'out'}", "--device=cuda:0"], tmp / "logs", env=GLOO, timeout_s=300)
    assert rcs == [0] * nproc, [(tmp / "logs" / f"rank{r}.log").read_text()[-2000:] for r in range(nproc)]
    return [r["steps"][0] for r in read_ranks(tmp / "out", nproc)]


@pytest.mark.parametrize("k_devices", [2, 4])
def test_sharded_world_on_the_card_matches_the_tensor_path(tmp_path, k_devices):
    _card()
    n, layers, batch = 12, 2, 16
    rng = np.random.default_rng(k_devices)
    a = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32)
    (tmp_path / "in").mkdir()
    torch.save({"cases": [{"n": n, "layers": layers, "angles": a, "weights": w}]}, tmp_path / "in" / "circuit.pt")
    ranks = _world(tmp_path, k_devices, "circuit")
    a_ref, w_ref = a.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = run_circuit(a_ref, w_ref, n, layers, impl="tensor")
    (want**2).sum().backward()
    for r in ranks:
        got = r["cases"][0]
        assert got["device"] == "cuda:0" and got["rotation_layer_launches_per_forward"] == layers
        np.testing.assert_allclose(got["ev"], want.detach().numpy(), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["g_angles"], a_ref.grad.numpy(), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["g_weights"], w_ref.grad.numpy(), rtol=1e-3, atol=1e-4)


def test_data_parallel_hdce_step_on_the_card_matches_one_rank(tmp_path):
    _card()
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16, n_sub=8, n_beam=4, data_len=64),
        model=tconfig.ModelConfig(features=16), train=tconfig.TrainConfig(batch_size=16, n_epochs=1),
    )
    batch = next(iter(DMLGridLoader(GridData.synthesize(cfg.data, "cpu"), 16).epoch(0)))
    batch = {k: batch[k] for k in ("yp_img", "h_label", "h_perf")}
    model, opt = make_trainer(cfg, "cpu", 1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    (tmp_path / "in").mkdir()
    torch.save({"cfg": cfg, "mesh": dict(fed_axis=1, data_axis=2, model_axis=1), "state": init, "batch": batch},
               tmp_path / "in" / "hdce.pt")
    ranks = _world(tmp_path, 2, "hdce-step")
    loss = float(hdce_train_step(model, opt, batch)["loss"])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
    got, lr = torch.load(tmp_path / "out" / "state.pt"), cfg.train.lr
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            continue
        # the first Adam step moves an entry by about lr; one whose gradient
        # is within 1e-5 of zero moves by what its summation order decides,
        # and is held to 2 lr (test_torch_port_parallel._assert_first_step_close)
        g, v = got[k].numpy(), v.numpy()
        strict = np.abs(v - init[k].numpy()) > 0.999 * lr
        if k.endswith(("running_mean", "running_var")):
            strict[...] = True
        np.testing.assert_allclose(g[strict], v[strict], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g[~strict], v[~strict], rtol=0, atol=2 * lr, err_msg=k)
