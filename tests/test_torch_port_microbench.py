"""The port's circuit micro-benchmark against the JAX script's rows, on the CPU.

``qdml_tpu_torch.scripts.quantum_microbench`` at B=16: its JSON carries the
JAX script's keys (``scripts/r3_quantum_microbench.py:89-104``), and each
row's <Z> on the script's inputs matches the JAX package's ``run_circuit``
(rows ``dense``, ``pallas``, ``tensor``; Pallas in interpret mode) or the
script's ``old_pallas`` composition through ``fused_unitary_expvals`` within
1e-5 (float32 sums of a 64-amplitude state in another order).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax.numpy as jnp  # noqa: E402

from qdml_tpu.quantum import statevector as jsv  # noqa: E402
from qdml_tpu.quantum.circuits import angle_embed, ansatz_unitary, run_circuit  # noqa: E402
from qdml_tpu.quantum.pallas_kernels import fused_unitary_expvals  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.scripts import quantum_microbench as mb  # noqa: E402

BATCH = 16


def _jax_rows(angles, w):
    n, layers = mb.N, mb.L
    rows = {b: run_circuit(angles, w, n, layers, b) for b in ("dense", "pallas", "tensor")}
    psi = angle_embed(jsv.zero_state(n, (angles.shape[0],)), angles, n)
    rows["pallas_old"] = fused_unitary_expvals(psi, ansatz_unitary(w, n, layers), n)
    return {k: np.asarray(v) for k, v in rows.items()}


def test_rows_match_the_jax_script():
    tk.reset_launch_counts()
    res, outs = mb.run(BATCH, "cpu")
    assert set(tk.launches.values()) == {0}  # CPU tensors: plain versions
    keys = {"backend", "batch", "n", "layers"} | {
        f"fwd_{row}_{unit}" for row in ("dense", "pallas", "tensor", "pallas_old") for unit in ("us", "sps")
    }
    assert set(res) == keys
    assert (res["backend"], res["batch"], res["n"], res["layers"]) == ("cpu", BATCH, 6, 3)
    assert all(res[k] > 0 for k in keys if k.startswith("fwd_"))
    # the JAX script's inputs: default_rng(0), angles first, then weights
    rng = np.random.default_rng(0)
    angles = rng.uniform(-1, 1, (BATCH, mb.N)).astype(np.float32)
    w = rng.uniform(-3, 3, (mb.L, mb.N, 2)).astype(np.float32)
    ta, tw = mb.inputs(BATCH, torch.device("cpu"))
    np.testing.assert_array_equal(ta.numpy(), angles)
    np.testing.assert_array_equal(tw.numpy(), w)
    want = _jax_rows(jnp.asarray(angles), jnp.asarray(w))
    assert set(outs) == set(want)
    for row, out in outs.items():
        assert out.shape == (BATCH, mb.N)
        np.testing.assert_allclose(out.numpy(), want[row], rtol=0, atol=1e-5, err_msg=row)


def test_main_writes_the_json(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(mb, "BATCH", 4)  # the script's shape, cut for CPU time
    out = tmp_path / "sub" / "mb.json"
    assert mb.main([str(out), "--device=cpu"]) == 0
    res = json.loads(out.read_text())
    assert res["batch"] == 4 and "fwd_pallas_old_us" in res
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
