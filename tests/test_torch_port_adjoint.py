"""The circuit's adjoint backward against the JAX package, on the CPU.

``circuit_adjoint_plain`` (the plain version of ``csrc/circuit_adjoint.cu``)
is held against ``jax.vjp`` of JAX's ``fused_circuit_expvals``, whose
backward is the adjoint walk ``_circuit_bwd`` at every n: at n = 2, 4, 5 the
JAX forward is its XLA twin, at n = 7 the Pallas kernel in interpret mode.
It is also held against autograd through ``circuit_expvals_plain``. Inputs
come from a numpy seed. Tolerance atol 1e-5 on cotangents of order 1-10: the
float32 rounding of 2nL rotations taken in another order.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.quantum import pallas_kernels as jpk  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402

ATOL = 1e-5


def _inputs(n, layers, batch, seed):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-1, 1, (batch, n)).astype(np.float32)
    weights = rng.uniform(-3, 3, (layers, n, 2)).astype(np.float32)
    g = rng.standard_normal((batch, n)).astype(np.float32)
    return angles, weights, g


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("n", [2, 4, 5, 7])
def test_adjoint_plain_matches_jax_vjp(n, layers):
    a, w, g = _inputs(n, layers, batch=6, seed=10 * n + layers)
    fwd = partial(jpk.fused_circuit_expvals, n_qubits=n, n_layers=layers)
    _, vjp = jax.vjp(fwd, jnp.asarray(a), jnp.asarray(w))
    ja, jw = jax.jit(vjp)(jnp.asarray(g))
    _, fre, fim = tk.circuit_expvals_plain(torch.tensor(a), torch.tensor(w), n, layers)
    da, dw = tk.circuit_adjoint_plain(
        fre, fim, torch.tensor(g), torch.tensor(a), torch.tensor(w), n, layers
    )
    assert da.shape == (6, n) and dw.shape == (layers, n, 2)
    _close(da, ja)
    _close(dw, jw)


@pytest.mark.parametrize("n,layers", [(3, 2), (6, 3)])
def test_adjoint_plain_matches_autograd_of_plain_forward(n, layers):
    a, w, g = _inputs(n, layers, batch=5, seed=n + layers)
    at, wt = torch.tensor(a, requires_grad=True), torch.tensor(w, requires_grad=True)
    (tk.circuit_expvals_plain(at, wt, n, layers)[0] * torch.tensor(g)).sum().backward()
    with torch.no_grad():
        _, fre, fim = tk.circuit_expvals_plain(torch.tensor(a), torch.tensor(w), n, layers)
    da, dw = tk.circuit_adjoint_plain(
        fre, fim, torch.tensor(g), torch.tensor(a), torch.tensor(w), n, layers
    )
    _close(da, at.grad)
    _close(dw, wt.grad)


def test_wrapper_gradient_on_cpu_is_the_plain_adjoint_and_counts_nothing():
    """On CPU tensors the wrapper's autograd.Function runs both plain
    versions (the adjoint walk, as the JAX custom_vjp does) and launches
    nothing; lead axes are kept and the returned state carries no grad."""
    n, layers = 4, 2
    a, w, g = _inputs(n, layers, batch=6, seed=3)
    tk.reset_launch_counts()
    at = torch.tensor(a.reshape(2, 3, n), requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    ev, fre, fim = tk.fused_circuit_expvals(at, wt, n, layers, return_state=True)
    assert ev.shape == (2, 3, n) and fre.shape == (2, 3, 16) and not fre.requires_grad
    (ev * torch.tensor(g.reshape(2, 3, n))).sum().backward()
    da, dw = tk.circuit_adjoint(
        fre.reshape(6, -1), fim.reshape(6, -1), torch.tensor(g), torch.tensor(a),
        torch.tensor(w), n, layers,
    )
    assert torch.equal(at.grad.reshape(6, n), da) and torch.equal(wt.grad, dw)
    assert tk.launches == {"qsc_expvals": 0, "circuit_expvals": 0, "circuit_adjoint": 0}


def test_adjoint_launch_validates_before_loading(monkeypatch):
    monkeypatch.setattr(tk, "_load", lambda name: pytest.fail("reached the loader"))
    n, b = 4, 3
    ok = dict(
        fre=torch.zeros(b, 16), fim=torch.zeros(b, 16), g=torch.zeros(b, n),
        angles=torch.zeros(b, n), weights=torch.zeros(2, n, 2),
    )
    with pytest.raises(ValueError, match="shape"):
        tk._adjoint_launch(**{**ok, "fre": torch.zeros(b, 8)}, n=n, layers=2)
    with pytest.raises(TypeError, match="float32"):
        tk._adjoint_launch(**{**ok, "g": torch.zeros(b, n, dtype=torch.float64)}, n=n, layers=2)
    with pytest.raises(ValueError, match="n=13"):
        tk._adjoint_launch(**ok, n=13, layers=2)
