"""The port's quantum layer against the JAX package, on the CPU.

Same inputs, drawn from a numpy seed, go through ``qdml_tpu.quantum`` and
``qdml_tpu_torch.quantum``: the statevector primitives (atol 1e-6), every
eager ``run_circuit`` impl (atol 1e-5), and the plain versions of the two
ported kernels against the JAX kernels, which run here as the JAX tests run
them (Pallas interpret mode on the CPU backend; tolerance atol 1e-5, the
float32 rounding of a few hundred operations in another order).
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu.quantum import circuits as jcirc  # noqa: E402
from qdml_tpu.quantum import pallas_kernels as jpk  # noqa: E402
from qdml_tpu.quantum import statevector as jsv  # noqa: E402
from qdml_tpu.utils import complexops as jco  # noqa: E402
from qdml_tpu_torch.quantum import circuits as tcirc  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.quantum import statevector as tsv  # noqa: E402
from qdml_tpu_torch.utils import complexops as tco  # noqa: E402


def _inputs(n, layers, batch, seed):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-1, 1, (batch, n)).astype(np.float32)
    weights = rng.uniform(-3, 3, (layers, n, 2)).astype(np.float32)
    return angles, weights


def _state(n, batch, seed):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal((batch, 2**n)).astype(np.float32)
    im = rng.standard_normal((batch, 2**n)).astype(np.float32)
    norm = np.sqrt((re**2 + im**2).sum(-1, keepdims=True))  # unit states, as a circuit's are
    return re / norm, im / norm


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_structure_tables_match(n):
    np.testing.assert_array_equal(tsv.z_signs(n), jsv.z_signs(n))
    np.testing.assert_array_equal(tsv.ring_cnot_perm(n), jsv.ring_cnot_perm(n))
    for c in range(n):
        t = (c + 1) % n
        np.testing.assert_array_equal(tsv.cnot_perm(n, c, t), jsv.cnot_perm(n, c, t))


def test_ring_needs_two_wires():
    with pytest.raises(ValueError, match="n >= 2"):
        tsv.ring_cnot_perm(1)


@pytest.mark.parametrize("gate", ["ry", "rz", "ry_cs", "rz_cs"])
@pytest.mark.parametrize("batched", [False, True])
def test_single_qubit_gates_match(gate, batched):
    n, batch = 5, 4
    re, im = _state(n, batch, seed=1)
    rng = np.random.default_rng(2)
    theta = rng.uniform(-3, 3, (batch,) if batched else ()).astype(np.float32)
    for q in range(n):
        if gate.endswith("_cs"):
            c, s = np.cos(theta / 2), np.sin(theta / 2)
            jfn = jsv.apply_ry_cs if gate == "ry_cs" else jsv.apply_rz_cs
            tfn = tsv.apply_ry_cs if gate == "ry_cs" else tsv.apply_rz_cs
            want = jfn(jco.CArr(jnp.asarray(re), jnp.asarray(im)), n, q, jnp.asarray(c), jnp.asarray(s))
            got = tfn(tco.CArr(torch.tensor(re), torch.tensor(im)), n, q, torch.tensor(c), torch.tensor(s))
        else:
            jfn = jsv.apply_ry if gate == "ry" else jsv.apply_rz
            tfn = tsv.apply_ry if gate == "ry" else tsv.apply_rz
            want = jfn(jco.CArr(jnp.asarray(re), jnp.asarray(im)), n, q, jnp.asarray(theta))
            got = tfn(tco.CArr(torch.tensor(re), torch.tensor(im)), n, q, torch.tensor(theta))
        _close(got.re, want.re, 1e-6)
        _close(got.im, want.im, 1e-6)


def test_perm_expvals_product_state_match():
    n, batch = 6, 3
    re, im = _state(n, batch, seed=4)
    angles, _ = _inputs(n, 1, batch, seed=5)
    perm = jsv.ring_cnot_perm(n)
    jpsi, tpsi = jco.CArr(jnp.asarray(re), jnp.asarray(im)), tco.CArr(torch.tensor(re), torch.tensor(im))
    _close(tsv.apply_perm(tpsi, perm).re, jsv.apply_perm(jpsi, jnp.asarray(perm)).re, 0)
    _close(tsv.apply_cnot(tpsi, n, 2, 4).im, jsv.apply_cnot(jpsi, n, 2, 4).im, 0)
    _close(tsv.expvals_z(tpsi, n), jsv.expvals_z(jpsi, n), 1e-6)
    _close(tsv.ry_product_state(torch.tensor(angles), n), jsv.ry_product_state(jnp.asarray(angles), n), 1e-6)
    z = tsv.zero_state(n, (2,), device="cpu")
    jz = jsv.zero_state(n, (2,))
    _close(z.re, jz.re, 0)
    _close(z.im, jz.im, 0)


@pytest.mark.parametrize("builder", ["ansatz_unitary", "fused_ansatz_unitary"])
@pytest.mark.parametrize("n", [2, 4])
def test_unitaries_match(builder, n):
    _, w = _inputs(n, 3, 1, seed=6)
    got = getattr(tcirc, builder)(torch.tensor(w), n, 3)
    want = getattr(jcirc, builder)(jnp.asarray(w), n, 3)
    _close(got.re, want.re, 1e-6)
    _close(got.im, want.im, 1e-6)


@pytest.mark.parametrize("impl", ["dense", "dense_fused", "tensor"])
@pytest.mark.parametrize("n", [2, 4, 6, 8])
def test_run_circuit_eager_impls_match(impl, n):
    layers, batch = 2, 5
    a, w = _inputs(n, layers, batch, seed=7 + n)
    got = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), n, layers, impl)
    jfn = jax.jit(partial(jcirc.run_circuit, n_qubits=n, n_layers=layers, backend=impl))
    _close(got, jfn(jnp.asarray(a), jnp.asarray(w)), 1e-5)


@pytest.mark.parametrize("impl", ["pallas", "pallas_circuit", "pallas_tensor"])
def test_kernel_impls_on_cpu_take_the_plain_version(impl):
    n, layers, batch = 4, 2, 6
    a, w = _inputs(n, layers, batch, seed=11)
    tk.reset_launch_counts()
    got = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), n, layers, impl=impl)
    want = tcirc.run_circuit(torch.tensor(a), torch.tensor(w), n, layers, "dense")
    _close(got, want, 1e-5)
    assert tk.launches == {name: 0 for name in tk.COUNTERS}


def test_dispatch_names_and_heuristic_match():
    for name in jcirc.VALID_BACKENDS:
        assert tcirc.canonical_impl(name) == jcirc.canonical_impl(name)
    for n in (2, 6, 10, 11, 14, 15):
        assert tcirc.resolve_backend("auto", n) == jcirc.resolve_backend("auto", n)
    assert tcirc.resolve_impl("pallas_tensor", "dense", 6, 3, 64) == "pallas_circuit"
    assert tcirc.resolve_impl("auto", "tensor", 6, 3, 64) == "tensor"
    with pytest.raises(ValueError):
        tcirc.canonical_impl("nope")
    for impl in ("sharded", "sharded_statevector"):  # one rank: the tensor path
        a, w = torch.rand(2, 4), torch.rand(1, 4, 2)
        torch.testing.assert_close(tcirc.run_circuit(a, w, 4, 1, impl=impl), tcirc.run_circuit(a, w, 4, 1, impl="tensor"))


@pytest.mark.parametrize("n", [4, 6])
def test_qsc_plain_matches_jax_kernel_with_gradients(n):
    layers, batch = 3, 9
    a, w = _inputs(n, layers, batch, seed=20 + n)
    g = np.random.default_rng(30 + n).standard_normal((batch, n)).astype(np.float32)
    u = jcirc.ansatz_unitary(jnp.asarray(w), n, layers)
    ur, ui = np.asarray(u.re), np.asarray(u.im)

    def jloss(a_, ur_, ui_):
        return jnp.sum(jpk.fused_qsc_expvals(a_, jco.CArr(ur_, ui_), n) * g)

    want = jax.jit(partial(jpk.fused_qsc_expvals, n_qubits=n))(jnp.asarray(a), u)
    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(a), jnp.asarray(ur), jnp.asarray(ui)
    )

    ts = [torch.tensor(x, requires_grad=True) for x in (a, ur, ui)]
    got = tk.fused_qsc_expvals(*ts, n)
    _close(got.detach(), want, 1e-5)
    (got * torch.tensor(g)).sum().backward()
    for t, jg in zip(ts, jgrads):
        _close(t.grad, jg, 1e-5)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("n", [3, 7, 8])
def test_circuit_plain_matches_jax_kernel(n, layers):
    batch = 16 if n < 8 else 8
    a, w = _inputs(n, layers, batch, seed=40 + n + layers)
    jfwd = jax.jit(partial(jpk._circuit_forward, n=n, layers=layers, bf16=False))
    jev, jre, jim = jfwd(jnp.asarray(a), jnp.asarray(w))
    ev, re, im = tk.fused_circuit_expvals(torch.tensor(a), torch.tensor(w), n, layers, return_state=True)
    _close(ev, jev, 1e-5)
    _close(re, jre, 1e-5)
    _close(im, jim, 1e-5)


def test_circuit_gate_table_layout():
    _, w = _inputs(3, 2, 1, seed=50)
    cs = tk.circuit_gate_table(torch.tensor(w)).numpy()
    assert cs.shape == (2, 3, 4)
    _close(cs[..., 0], np.cos(w[..., 0] / 2), 1e-7)
    _close(cs[..., 1], np.sin(w[..., 0] / 2), 1e-7)
    _close(cs[..., 2], np.cos(w[..., 1] / 2), 1e-7)
    _close(cs[..., 3], np.sin(w[..., 1] / 2), 1e-7)


def test_complexops_packing_matches():
    rng = np.random.default_rng(60)
    re, im = rng.standard_normal((2, 3, 128)).astype(np.float32)
    want = jco.yp_to_image(jco.CArr(jnp.asarray(re), jnp.asarray(im)))
    got = tco.yp_to_image(tco.CArr(torch.tensor(re), torch.tensor(im)))
    _close(got, want, 0)
    h = tco.pack_h(tco.CArr(torch.tensor(re), torch.tensor(im)))
    _close(h, jco.pack_h(jco.CArr(jnp.asarray(re), jnp.asarray(im))), 0)
    back = tco.unpack_h(h)
    _close(back.re, re, 0)
    _close(back.im, im, 0)
