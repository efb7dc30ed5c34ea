"""The rotation-layer and unitary kernels' wrappers against the JAX package, on the CPU.

The same numpy inputs go through the JAX package's ``apply_rotation_layer``
and ``fused_unitary_expvals`` (Pallas in interpret mode where JAX runs its
kernel, its XLA fallback below 128 lanes, as ``tests/test_pallas.py`` runs
them) and through the port's plain versions and public wrappers, which take
the plain versions for CPU tensors. Tolerances: values 1e-6 (one layer of
float32 gate updates, or a 2^n-term sum, in another order), gradients 1e-5
(autograd through the plain versions against ``jax.vjp`` through JAX's
custom VJPs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.quantum import pallas_kernels as jpk  # noqa: E402
from qdml_tpu.quantum.circuits import ansatz_unitary as j_ansatz_unitary  # noqa: E402
from qdml_tpu.utils.complexops import CArr as JCArr  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.utils.complexops import CArr  # noqa: E402


def _t(x):
    return torch.tensor(np.asarray(x))


def _grads_torch(fn, inputs, cot):
    xs = [_t(x).requires_grad_(True) for x in inputs]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [_t(c) for c in cot])
    return [x.grad.numpy() for x in xs], [o.detach().numpy() for o in outs]


@pytest.mark.parametrize("n", [3, 6, 7, 8, 15, 16])
def test_rotation_layer_matches_jax(n):
    """n=3, 6 take JAX's XLA branch (dim < 128), n=7, 8 its Pallas kernel;
    n=15, 16 (two batch rows, for time) lie past the port kernel's old
    n <= 14 cap, which JAX's kernel never had."""
    rng = np.random.default_rng(n)
    batch = 5 if n <= 8 else 2
    re = rng.standard_normal((batch, 1 << n)).astype(np.float32)
    im = rng.standard_normal((batch, 1 << n)).astype(np.float32)
    norm = np.sqrt((re**2 + im**2).sum(-1, keepdims=True))
    re, im = re / norm, im / norm  # unit-norm states, as the circuit's
    w = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    g_re = rng.standard_normal((batch, 1 << n)).astype(np.float32)
    g_im = rng.standard_normal((batch, 1 << n)).astype(np.float32)

    def jfn(a, b, w_):
        out = jpk.apply_rotation_layer(JCArr(a, b), w_, n)
        return out.re, out.im

    (j_re, j_im), vjp = jax.vjp(jfn, jnp.asarray(re), jnp.asarray(im), jnp.asarray(w))
    j_grads = vjp((jnp.asarray(g_re), jnp.asarray(g_im)))

    for name, fn in (
        ("plain", lambda a, b, w_: tuple(tk.rotation_layer_plain(a, b, w_, n))),
        ("wrapper", lambda a, b, w_: tuple(tk.apply_rotation_layer(CArr(a, b), w_, n))),
    ):
        grads, (t_re, t_im) = _grads_torch(fn, (re, im, w), (g_re, g_im))
        np.testing.assert_allclose(t_re, np.asarray(j_re), rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(t_im, np.asarray(j_im), rtol=0, atol=1e-6, err_msg=name)
        for k, (got, want) in enumerate(zip(grads, j_grads)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5, err_msg=f"{name} grad {k}")


@pytest.mark.parametrize("n", [2, 4, 6])
def test_unitary_expvals_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    batch = 7
    re = rng.standard_normal((batch, 1 << n)).astype(np.float32)
    im = rng.standard_normal((batch, 1 << n)).astype(np.float32)
    norm = np.sqrt((re**2 + im**2).sum(-1, keepdims=True))
    re, im = re / norm, im / norm
    w = rng.uniform(-3, 3, (2, n, 2)).astype(np.float32)
    u = j_ansatz_unitary(jnp.asarray(w), n, 2)
    ur, ui = np.asarray(u.re), np.asarray(u.im)
    g = rng.standard_normal((batch, n)).astype(np.float32)

    def jfn(a, b, c, d):
        return jpk.fused_unitary_expvals(JCArr(a, b), JCArr(c, d), n)

    j_ev, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (re, im, ur, ui)))
    j_grads = vjp(jnp.asarray(g))
    for name, fn in (
        ("plain", lambda a, b, c, d: tk.unitary_expvals_plain(a, b, c, d, n)),
        ("wrapper", lambda a, b, c, d: tk.fused_unitary_expvals(CArr(a, b), CArr(c, d), n)),
    ):
        grads, (ev,) = _grads_torch(fn, (re, im, ur, ui), (g,))
        np.testing.assert_allclose(ev, np.asarray(j_ev), rtol=0, atol=1e-6, err_msg=name)
        for k, (got, want) in enumerate(zip(grads, j_grads)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5, err_msg=f"{name} grad {k}")


def test_wrappers_keep_lead_axes_and_do_not_count_on_cpu():
    rng = np.random.default_rng(0)
    n = 4
    re = torch.tensor(rng.standard_normal((2, 3, 16)), dtype=torch.float32)
    im = torch.tensor(rng.standard_normal((2, 3, 16)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32)
    tk.reset_launch_counts()
    out = tk.apply_rotation_layer(CArr(re, im), w, n)
    assert out.re.shape == (2, 3, 16)
    flat = tk.rotation_layer_plain(re.reshape(6, 16), im.reshape(6, 16), w, n)
    assert torch.equal(out.re.reshape(6, 16), flat.re)
    u = CArr(torch.eye(16), torch.zeros(16, 16))
    ev = tk.fused_unitary_expvals(CArr(re, im), u, n)
    assert ev.shape == (2, 3, n)
    assert set(tk.launches.values()) == {0}
    with pytest.raises(ValueError, match="not of 5 qubits"):
        tk.apply_rotation_layer(CArr(re, im), torch.zeros(5, 2), 5)
    with pytest.raises(ValueError, match="not of 3 qubits"):
        tk.fused_unitary_expvals(CArr(re, im), u, 3)


def test_launch_paths_validate_before_loading(monkeypatch):
    """The launch paths check the window, shapes, dtype, contiguity and (the
    unitary kernel's) alignment before they touch the library (which cannot
    be built here)."""
    monkeypatch.setattr(tk, "_load", lambda name: pytest.fail("reached the loader"))
    z = torch.zeros(3, 16)
    w = torch.zeros(4, 2)
    # n = 0 and past the 64-bit index's n = 32 raise; n = 15 passes the
    # checks (it reaches the loader, the test's tripwire)
    with pytest.raises(ValueError, match="1 <= n <= 32"):
        tk._rotation_launch(torch.zeros(1, 1), torch.zeros(1, 1), torch.zeros(0, 2), 0)
    with pytest.raises(ValueError, match="1 <= n <= 32"):
        tk._rotation_launch(torch.zeros(1, 1), torch.zeros(1, 1), torch.zeros(33, 2), 33)
    with pytest.raises(pytest.fail.Exception, match="reached the loader"):
        tk._rotation_launch(torch.zeros(1, 1 << 15), torch.zeros(1, 1 << 15), torch.zeros(15, 2), 15)
    # the rotation kernel's 16-byte loads and stores
    with pytest.raises(ValueError, match="16-byte boundary"):
        tk._rotation_launch(torch.zeros(3 * 16 + 1)[1:].view(3, 16), z, w, 4)
    with pytest.raises(ValueError, match="shape"):
        tk._rotation_launch(z, z, torch.zeros(3, 2), 4)
    with pytest.raises(TypeError, match="float32"):
        tk._rotation_launch(z.double(), z, w, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tk._rotation_launch(torch.zeros(16, 3).t(), z, w, 4)
    u = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="1 <= n <= 14"):
        tk._unitary_launch(torch.zeros(1, 1 << 15), torch.zeros(1, 1 << 15), u, u, 15)
    with pytest.raises(ValueError, match="1 <= n <= 14"):
        tk._unitary_launch(torch.zeros(1, 1), torch.zeros(1, 1), u, u, 0)
    with pytest.raises(ValueError, match="shape"):
        tk._unitary_launch(z, z, torch.zeros(8, 16), u, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tk._unitary_launch(z, z, u.t(), u, 4)
    # the unitary kernel's cp.async copies: 16-byte starts (8 at n = 1)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tk._unitary_launch(torch.zeros(3 * 16 + 1)[1:].view(3, 16), z, u, u, 4)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tk._unitary_launch(z, z, u, torch.zeros(16 * 16 + 2)[2:].view(16, 16), 4)
    with pytest.raises(ValueError, match="8-byte boundary"):
        tk._unitary_launch(torch.zeros(3 * 2 + 1)[1:].view(3, 2), torch.zeros(3, 2), torch.zeros(2, 2), torch.zeros(2, 2), 1)
