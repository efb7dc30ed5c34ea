"""The three CUDA kernels against their plain versions, on the card.

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
    assert tk.launches == {"qsc_expvals": 0, "circuit_expvals": 1, "circuit_adjoint": 1}
    a2, w2 = a.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    (tk.circuit_expvals_plain(a2, w2, 8, 3)[0] * g).sum().backward()
    torch.testing.assert_close(a.grad, a2.grad, rtol=0, atol=2e-5 * a2.grad.abs().max().item())
    torch.testing.assert_close(w.grad, w2.grad, rtol=0, atol=2e-5 * w2.grad.abs().max().item())
