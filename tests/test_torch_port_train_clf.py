"""The port's classifier training runs against the JAX package's, on the CPU.

Classical SC and quantum QSC (impl ``pallas`` at n=4, impl ``pallas_circuit``
at n=4 and n=7, where JAX runs its Pallas kernels in interpret mode and the
port the kernels' plain versions, the circuit's backward being the adjoint
walk on both sides). Both runs see the same data (the port reads the ``.npy``
cache JAX's ``save_npy_cache`` wrote) and start from JAX's
``init_sc_state`` weights carried across by ``qdml_tpu_torch.interop``; the
quantum runs take AdamW, as both trainers force. After 2 epochs (8 steps)
the losses must agree to rtol 2e-4 (float32 convs and circuit sums in
another order, compounded over 8 steps) and the validation accuracy to one
prediction in 36.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.config import DataConfig as JDataConfig  # noqa: E402
from qdml_tpu.config import ExperimentConfig as JExperimentConfig  # noqa: E402
from qdml_tpu.config import QuantumConfig as JQuantumConfig  # noqa: E402
from qdml_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from qdml_tpu.data.datasets import save_npy_cache  # noqa: E402
from qdml_tpu.train import qsc as jqsc  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.config import DataConfig, ExperimentConfig, QuantumConfig, TrainConfig  # noqa: E402
from qdml_tpu_torch.data.datasets import GridData  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.train.qsc import train_classifier  # noqa: E402

DATA = dict(n_ant=16, n_sub=16, n_beam=8, data_len=40)
TRAIN = dict(batch_size=8, n_epochs=2, print_freq=1000)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = tmp_path_factory.mktemp("npy")
    save_npy_cache(str(path), JDataConfig(**DATA), chunk=40)
    return str(path)


@pytest.mark.parametrize(
    "quantum,impl,n", [(False, None, 0), (True, "pallas", 4), (True, "pallas_circuit", 4), (True, "pallas_circuit", 7)]
)
def test_train_classifier_history_matches_jax(cache, quantum, impl, n):
    qkw = dict(n_qubits=n, n_layers=2, impl=impl) if quantum else {}
    jcfg = JExperimentConfig(
        data=JDataConfig(**DATA), quantum=JQuantumConfig(**qkw), train=JTrainConfig(**TRAIN)
    )
    tcfg = ExperimentConfig(
        data=DataConfig(**DATA), quantum=QuantumConfig(**qkw), train=TrainConfig(**TRAIN)
    )
    _, jhist = jqsc.train_classifier(jcfg, quantum=quantum)
    _, state = jqsc.init_sc_state(jcfg, quantum, steps_per_epoch=4)
    convert = interop.qsc_state_dict_from_flax if quantum else interop.sc_state_dict_from_flax
    init = convert(jax.device_get(state.params))
    tk.reset_launch_counts()
    model, hist = train_classifier(
        tcfg, quantum, data=GridData.from_npy_cache(cache, tcfg.data, device="cpu"), init_state=init
    )
    assert set(hist) == set(jhist) == {"train_loss", "val_loss", "val_acc"}
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=2e-4, err_msg=key)
    np.testing.assert_allclose(hist["val_acc"], jhist["val_acc"], rtol=0, atol=1 / 36 + 1e-9)
    assert set(tk.launches.values()) == {0}  # CPU tensors: the plain versions
