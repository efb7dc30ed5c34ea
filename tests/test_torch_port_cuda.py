"""The two CUDA kernels against their plain versions, on the card.

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


def test_circuit_kernel_refuses_grad(dev):
    a = torch.zeros(2, 8, device=dev, requires_grad=True)
    w = torch.zeros(1, 8, 2, device=dev)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.fused_circuit_expvals(a, w, 8, 1)
