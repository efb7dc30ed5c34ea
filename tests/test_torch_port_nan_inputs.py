"""The sanitizer's NaN rule against the JAX package's checkify, on the CPU.

JAX's checkify trips when the output of a primitive in its
``nan_primitives`` holds a NaN, whatever the primitive's inputs held. The
port's sanitizer follows that rule for every aten op outside its
``_NO_NAN`` set and at the hand kernels' boundary:

- a request whose pilots hold a NaN raises ``DivergenceError`` naming the
  bucket in the port's checked engine where JAX's checked engine raises;
- a NaN in a checked HDCE step's batch trips the flight recorder in both;
- a bare op on a NaN input trips, with the op named, where JAX's checkify
  trips on the same op; data movement and masking (``where``, ``cat``,
  copies) do not, so the ragged batches' NaN pad rows still pass (the pad
  test of ``tests/test_torch_port_sanitizer.py``);
- a hand kernel's boundary trips on a NaN its inputs carried in.
"""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import checkify  # noqa: E402

from qdml_tpu.telemetry import DivergenceError as JDivergenceError  # noqa: E402
from qdml_tpu.telemetry import FlightRecorder as JFlightRecorder  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.telemetry import DivergenceError, FlightRecorder  # noqa: E402
from qdml_tpu_torch.telemetry.sanitizer import Sanitizer, error_message  # noqa: E402
from test_torch_port_sanitizer import DATA, _batch, _cfg, _engines, _tables, _trainer  # noqa: E402,F401

F = torch.nn.functional


def _requests(n: int, seed: int = 11) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 16, 8, 2)).astype(np.float32)


# ---------------------------------------------------------------------------
# serve.checkify: a NaN pilot in a request
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    import tempfile

    from qdml_tpu_torch.serve import batching_autotune

    with tempfile.TemporaryDirectory() as tmp:
        old = os.environ.get(batching_autotune.ENV_TABLE)
        os.environ[batching_autotune.ENV_TABLE] = os.path.join(tmp, "batching.json")
        batching_autotune.invalidate_cache()
        try:
            jeng, eng = _engines(True)
            jeng.warmup()
            eng.warmup()
            yield jeng, eng
        finally:
            if old is None:
                os.environ.pop(batching_autotune.ENV_TABLE, None)
            else:
                os.environ[batching_autotune.ENV_TABLE] = old
            batching_autotune.invalidate_cache()


@pytest.mark.parametrize("where", ["one_pilot", "whole_request", "last_row"])
def test_a_nan_pilot_request_raises_in_both_checked_engines(engines, where):
    jeng, eng = engines
    x = _requests(3)
    if where == "one_pilot":
        x[1, 4, 2, 0] = np.nan
    elif where == "whole_request":
        x[0] = np.nan
    else:
        x[2, 15, 7, 1] = np.nan
    with pytest.raises(JDivergenceError, match="serve checkify tripped on bucket 4: nan generated by primitive"):
        jeng.infer(x)
    with pytest.raises(DivergenceError) as ei:
        eng.infer(x)
    assert str(ei.value).startswith("serve checkify tripped on bucket 4: nan generated by primitive: aten.")
    # the engine keeps serving, and a clean batch does not trip
    h, _, _, _ = eng.infer(np.nan_to_num(x, nan=0.0))
    assert np.isfinite(h).all()


def test_the_nan_pilot_trips_at_the_first_op_that_computes_with_it(engines):
    _, eng = engines
    x = _requests(2)
    x[0, 0, 0, 0] = np.nan
    with pytest.raises(DivergenceError) as ei:
        eng.infer(x)
    # JAX names conv_general_dilated; the port names its first convolution
    # (aten.conv2d under inference mode, where the op is not decomposed)
    assert re.search(r"nan generated by primitive: aten\.(conv2d|convolution)\.$", str(ei.value)), str(ei.value)


def test_a_nan_in_a_valid_ragged_row_trips_and_pads_do_not(_tables):
    _, eng = _engines(True, batching="ragged")
    eng.warmup()
    xp = _requests(64, seed=12)
    xp[5:] = np.nan  # pads: masked to zeros before any compute
    h = eng.forward_tier(xp.copy(), 5)[0]
    assert torch.isfinite(h).all()
    xp[4, 3, 3, 1] = np.nan  # a valid row
    with pytest.raises(DivergenceError, match=r"bucket 64: nan generated by primitive: aten\.(conv2d|convolution)\."):
        eng.forward_tier(xp, 5)


# ---------------------------------------------------------------------------
# train.checkify: a NaN in a checked HDCE step's batch
# ---------------------------------------------------------------------------


def _jax_hdce_trip(tmp_path, pos) -> str:
    from qdml_tpu.config import DataConfig, ExperimentConfig, EvalConfig, ModelConfig, TrainConfig
    from qdml_tpu.data.datasets import DMLGridLoader as JLoader
    from qdml_tpu.train.hdce import init_hdce_state, make_hdce_train_step

    jcfg = ExperimentConfig(data=DataConfig(**DATA), model=ModelConfig(features=8),
                            train=TrainConfig(batch_size=8, checkify=True),
                            eval=EvalConfig(results_dir=str(tmp_path / "jax")))
    loader = JLoader(jcfg.data, 8)
    batch = next(iter(loader.epoch(0)))
    model, state = init_hdce_state(jcfg, loader.steps_per_epoch)
    step = make_hdce_train_step(model, state.tx, probes=True, checkify_errors=True)
    bad = dict(batch)
    yp = np.asarray(bad["yp_img"]).copy()
    yp[pos] = np.nan
    bad["yp_img"] = yp
    rec = JFlightRecorder("unit", jcfg, workdir=None)
    rec.note_good(state.params)
    state, m = step(state, bad)
    with pytest.raises(JDivergenceError) as ei:
        rec.on_step(0, m, loss=float(np.asarray(m["loss"])), params=state.params)
    return ei.value.reason


@pytest.mark.parametrize("pos", [(0, 0, 0, 0, 0, 0), (2, 1, 5, 7, 3, 1)], ids=["first", "inner"])
def test_a_nan_in_a_checked_hdce_batch_trips_in_both(tmp_path, pos):
    jreason = _jax_hdce_trip(tmp_path, pos)
    # JAX pads the image in front of its convolution, and pad is one of its
    # nan_primitives; the port's convolution pads inside the op
    assert jreason == "checkify: nan generated by primitive: pad.", jreason
    cfg = _cfg(**{"train.checkify": True, "eval.results_dir": tmp_path / "port"})
    model, _, make = _trainer("hdce", cfg)
    bad = dict(_batch(cfg))
    bad["yp_img"] = bad["yp_img"].clone()
    bad["yp_img"][pos] = float("nan")
    rec = FlightRecorder("unit", cfg)
    rec.note_good(model.state_dict)
    m = make(True)(bad, None)
    with pytest.raises(DivergenceError) as ei:
        rec.on_step(0, m, loss=float(m["loss"]), params=model.state_dict)
    assert ei.value.reason == "checkify: nan generated by primitive: aten.convolution."
    bundle = json.load(open(os.path.join(ei.value.dump_dir, "bundle.json")))
    assert bundle["reason"] == ei.value.reason


# ---------------------------------------------------------------------------
# single ops: the port's sanitizer against JAX's checkify on the same input
# ---------------------------------------------------------------------------


def _jax_trips(fn, *args) -> str | None:
    err, _ = checkify.checkify(fn, errors=checkify.nan_checks)(*args)
    return err.get()


def _nan_input(shape=(1, 2, 5, 5), seed=0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[7] = np.nan
    return x


def test_a_bare_conv2d_on_a_nan_input_trips_in_both():
    x = _nan_input()
    w = np.random.default_rng(1).standard_normal((3, 2, 3, 3)).astype(np.float32)
    jmsg = _jax_trips(lambda a, b: jax.lax.conv(a, b, (1, 1), "SAME"), x, w)
    assert "nan generated by primitive: conv_general_dilated" in jmsg
    s = Sanitizer()
    with s:
        F.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=1)
    assert error_message(s) == "nan generated by primitive: aten.convolution."


@pytest.mark.parametrize("op,jop,name,jname", [
    (lambda a: a + 1.0, lambda a: jnp.add(a, 1.0), "aten.add", "add"),
    (lambda a: a * 2.0, lambda a: jnp.multiply(a, 2.0), "aten.mul", "mul"),
    (lambda a: a.reshape(2, 25) @ torch.ones(25, 3), lambda a: a.reshape(2, 25) @ jnp.ones((25, 3)), "aten.mm",
     "dot_general"),
    (lambda a: torch.exp(a), lambda a: jnp.exp(a), "aten.exp", "exp"),
    (lambda a: torch.tanh(a), lambda a: jnp.tanh(a), "aten.tanh", "tanh"),
], ids=["add", "mul", "matmul", "exp", "tanh"])
def test_a_nan_input_trips_the_op_that_computes_with_it(op, jop, name, jname):
    x = _nan_input()
    jmsg = _jax_trips(jop, x)
    assert jmsg is not None and f"nan generated by primitive: {jname}" in jmsg, jmsg
    s = Sanitizer()
    with s:
        op(torch.from_numpy(x))
    assert error_message(s) == f"nan generated by primitive: {name}."


@pytest.mark.parametrize("op", [
    lambda a: a.clone(),
    lambda a: torch.cat([a, a]),
    lambda a: torch.where(torch.isnan(a), torch.zeros(()), a),
    lambda a: a.permute(0, 2, 3, 1).contiguous(),
    lambda a: a.to(torch.float64),
], ids=["clone", "cat", "where", "permute_contiguous", "to_copy"])
def test_data_movement_and_masks_do_not_trip(op):
    s = Sanitizer()
    with s:
        op(torch.from_numpy(_nan_input()))
    assert error_message(s) is None


def test_a_hand_kernels_boundary_trips_on_a_nan_input():
    a = torch.full((2, 3), float("nan"))  # the kernel's input carries the NaN in
    s = Sanitizer()
    with s:
        with tk._observed("circuit_expvals", lambda: (0.0, 0.0)) as outs:
            outs.append(a * 2.0)  # inside the region no aten op is checked
    assert error_message(s) == "nan generated by primitive: circuit_expvals."


def test_the_circuits_plain_version_trips_on_a_nan_angle():
    angles = torch.zeros(4, 4)
    angles[1, 2] = float("nan")
    w = torch.full((2, 4, 2), 0.3)
    s = Sanitizer()
    with s:
        ev = tk.fused_circuit_expvals(angles, w, 4, 2)
    assert torch.isnan(ev[1]).any() and torch.isfinite(ev[0]).all()
    assert error_message(s).startswith("nan generated by primitive: aten.")
