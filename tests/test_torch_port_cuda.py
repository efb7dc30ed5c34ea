"""The five CUDA kernels against their plain versions, on the card.

These tests need a CUDA GPU and nvcc; without a card they skip (the check is
made inside the fixture, never at import). Run them on the card with

    python -m pytest -m cuda tests/test_torch_port_cuda.py -q

``chip_smoke.py`` makes the same comparisons over a wider grid of shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qdml_tpu_torch.quantum import circuits  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.utils.complexops import CArr  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are CUDA C++ with no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,batch", [(4, 37), (6, 64), (8, 300)])
def test_qsc_kernel_matches_plain(dev, n, batch):
    rng = np.random.default_rng(n)
    w = torch.tensor(rng.uniform(0, 2 * np.pi, (3, n, 2)), dtype=torch.float32, device=dev)
    u = circuits.ansatz_unitary(w, n, 3)
    a = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32, device=dev)
    before = tk.launches["qsc_expvals"]
    got = tk.fused_qsc_expvals(a, u.re.contiguous(), u.im.contiguous(), n)
    torch.cuda.synchronize()
    assert tk.launches["qsc_expvals"] == before + 1
    want = tk.qsc_expvals_plain(a, u.re, u.im, n)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,layers,batch", [(3, 1, 37), (8, 3, 64), (12, 3, 5)])
def test_circuit_kernel_matches_plain(dev, n, layers, batch):
    rng = np.random.default_rng(n + layers)
    w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32, device=dev)
    ev, re, im = tk.fused_circuit_expvals(a, w, n, layers, return_state=True)
    torch.cuda.synchronize()
    pev, pre, pim = tk.circuit_expvals_plain(a, w, n, layers)
    for got, want in ((ev, pev), (re, pre), (im, pim)):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("n,layers,batch", [(2, 1, 3), (8, 3, 2304), (12, 5, 7)])
def test_circuit_adjoint_kernel_matches_plain(dev, n, layers, batch):
    """Tolerance: 2e-5 of the largest cotangent plus 1e-6 (fp32 rounding over
    2nL rotations and a batch sum taken in another order)."""
    rng = np.random.default_rng(10 * n + layers)
    w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((batch, n)), dtype=torch.float32, device=dev)
    _, fre, fim = tk.fused_circuit_expvals(a, w, n, layers, return_state=True)
    before = tk.launches["circuit_adjoint"]
    got = tk.circuit_adjoint(fre, fim, g, a, w, n, layers)
    torch.cuda.synchronize()
    assert tk.launches["circuit_adjoint"] == before + 1
    want = tk.circuit_adjoint_plain(fre, fim, g, a, w, n, layers)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=2e-5 * y.abs().max().item() + 1e-6)
    again = tk.circuit_adjoint(fre, fim, g, a, w, n, layers)
    assert torch.equal(again[1], got[1])  # no atomics: the same sum every run


def test_circuit_autograd_launches_forward_and_adjoint(dev):
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(-1, 1, (64, 8)), dtype=torch.float32, device=dev, requires_grad=True)
    w = torch.tensor(rng.uniform(-3, 3, (3, 8, 2)), dtype=torch.float32, device=dev, requires_grad=True)
    g = torch.tensor(rng.standard_normal((64, 8)), dtype=torch.float32, device=dev)
    tk.reset_launch_counts()
    (tk.fused_circuit_expvals(a, w, 8, 3) * g).sum().backward()
    torch.cuda.synchronize()
    assert tk.launches == {name: int(name in ("circuit_expvals", "circuit_adjoint")) for name in tk.KERNELS}
    a2, w2 = a.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    (tk.circuit_expvals_plain(a2, w2, 8, 3)[0] * g).sum().backward()
    torch.testing.assert_close(a.grad, a2.grad, rtol=0, atol=2e-5 * a2.grad.abs().max().item())
    torch.testing.assert_close(w.grad, w2.grad, rtol=0, atol=2e-5 * w2.grad.abs().max().item())


def _states(rng, batch, n, dev):
    re = rng.standard_normal((batch, 1 << n))
    im = rng.standard_normal((batch, 1 << n))
    norm = np.sqrt((re**2 + im**2).sum(-1, keepdims=True))
    return CArr(*(torch.tensor(x / norm, dtype=torch.float32, device=dev) for x in (re, im)))


@pytest.mark.parametrize("n,batch", [(1, 3), (7, 11), (8, 2304), (14, 5)])
def test_rotation_layer_kernel_matches_plain(dev, n, batch):
    """Tolerance: 1e-6 on unit-norm states (one layer of fp32 gate updates,
    fused multiply-adds in the kernel)."""
    rng = np.random.default_rng(20 + n)
    psi = _states(rng, batch, n, dev)
    w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
    before = tk.launches["rotation_layer"]
    got = tk.apply_rotation_layer(psi, w, n)
    torch.cuda.synchronize()
    assert tk.launches["rotation_layer"] == before + 1
    want = tk.rotation_layer_plain(psi.re, psi.im, w, n)
    torch.testing.assert_close(got.re, want.re, rtol=0, atol=1e-6)
    torch.testing.assert_close(got.im, want.im, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="1 <= n <= 14"):
        tk.apply_rotation_layer(_states(rng, 1, 15, dev), torch.zeros(15, 2, device=dev), 15)


@pytest.mark.parametrize("n,batch", [(1, 3), (6, 2304), (9, 40), (12, 33)])
def test_unitary_kernel_matches_plain(dev, n, batch):
    """Tolerance: 5e-6 on unit-norm states (sums over 2^n terms, each a
    2^n-term product, in another order than the plain matmuls')."""
    rng = np.random.default_rng(30 + n)
    psi = _states(rng, batch, n, dev)
    w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
    u = circuits.ansatz_unitary(w, n, 3) if n >= 2 else circuits.rot_gate(w[0, 0, 0], w[0, 0, 1])
    before = tk.launches["unitary_expvals"]
    got = tk.fused_unitary_expvals(psi, u, n)
    torch.cuda.synchronize()
    assert tk.launches["unitary_expvals"] == before + 1
    want = tk.unitary_expvals_plain(psi.re, psi.im, u.re, u.im, n)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-6)
    again = tk.fused_unitary_expvals(psi, u, n)
    assert torch.equal(again, got)  # no atomics: the same sums every run


def test_rotation_and_unitary_gradients_match_plain(dev):
    rng = np.random.default_rng(1)
    psi = _states(rng, 19, 8, dev)
    w = torch.tensor(rng.uniform(-3, 3, (8, 2)), dtype=torch.float32, device=dev)
    grads = []
    for fn in (lambda p, w_: tk.apply_rotation_layer(p, w_, 8), lambda p, w_: tk.rotation_layer_plain(p.re, p.im, w_, 8)):
        xs = [t.clone().requires_grad_(True) for t in (psi.re, psi.im, w)]
        out = fn(CArr(xs[0], xs[1]), xs[2])
        (out.re.sum() + 2 * out.im.sum()).backward()
        grads.append([t.grad for t in xs])
    for gk, gp in zip(*grads):
        torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-6)
    u = circuits.ansatz_unitary(torch.tensor(rng.uniform(-3, 3, (3, 6, 2)), dtype=torch.float32, device=dev), 6, 3)
    psi = _states(rng, 19, 6, dev)
    grads = []
    for fn in (lambda a, b, c, d: tk.fused_unitary_expvals(CArr(a, b), CArr(c, d), 6),
               lambda a, b, c, d: tk.unitary_expvals_plain(a, b, c, d, 6)):
        xs = [t.clone().requires_grad_(True) for t in (psi.re, psi.im, u.re, u.im)]
        fn(*xs).sum().backward()
        grads.append([t.grad for t in xs])
    for gk, gp in zip(*grads):
        torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-6)
