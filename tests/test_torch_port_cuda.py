"""The five CUDA kernels (and the circuit kernels' member axis) against their
plain versions, on the card; the K-step graphs against the per-step path
(float32, bfloat16 activations, bfloat16 Adam moments); the mps impl
against the circuit kernel and its decline of the graph; the serving tier's
batching race and a pool of 2 replicas of 2 workers on B.2.

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


# every n at the batches the kernel's launches run at; 40000 rows reach the
# large-batch tile at n <= 4 too (one block per two SMs of 64-512 rows)
@pytest.mark.parametrize(
    "n,batch",
    [(4, 37), (6, 64), (8, 300)]
    + [(n, b) for n in range(1, 9) for b in (1, 64, 200, 2304)]
    + [(n, 40000) for n in range(1, 5)],
)
def test_qsc_kernel_matches_plain(dev, n, batch):
    rng = np.random.default_rng(n)
    w = torch.tensor(rng.uniform(0, 2 * np.pi, (3, n, 2)), dtype=torch.float32, device=dev)
    u = circuits.ansatz_unitary(w, n, 3) if n >= 2 else circuits.rot_gate(w[0, 0, 0], w[0, 0, 1])
    a = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32, device=dev)
    before = tk.launches["qsc_expvals"]
    got = tk.fused_qsc_expvals(a, u.re.contiguous(), u.im.contiguous(), n)
    torch.cuda.synchronize()
    assert tk.launches["qsc_expvals"] == before + 1
    want = tk.qsc_expvals_plain(a, u.re, u.im, n)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [1, 6, 8])
def test_qsc_kernel_refuses_misaligned_u(dev, n):
    """U copied with 16-byte cp.async (8-byte at n = 1): a contiguous view one
    float into its storage is refused before launch, and the context stays
    usable for the next launch."""
    dim = 1 << n
    a = torch.zeros(3, n, device=dev)
    u = torch.eye(dim, device=dev)
    shifted = torch.empty(dim * dim + 1, device=dev)[1:].view(dim, dim)
    before = tk.launches["qsc_expvals"]
    with pytest.raises(ValueError, match="byte boundary"):
        tk.fused_qsc_expvals(a, shifted, u, n)
    assert tk.launches["qsc_expvals"] == before
    got = tk.fused_qsc_expvals(a, u, torch.zeros_like(u), n)
    torch.testing.assert_close(got, torch.ones(3, n, device=dev))


# the serving batches (1, 64) and the training launch's 2304, with and
# without the state, at n from one-warp samples (2, 5, 8) to whole blocks (9, 12)
@pytest.mark.parametrize(
    "n,layers,batch,state",
    [(3, 1, 37, True), (8, 3, 64, True), (12, 3, 5, True)]
    + [(n, 3, b, st) for n in (2, 5, 8, 9, 12) for b in (1, 64, 2304) for st in (True, False)],
)
def test_circuit_kernel_matches_plain(dev, n, layers, batch, state):
    """Tolerance: 2e-5 absolute on <Z> and the unit-norm state (fp32 rounding
    over 2nL gate updates in another wire order)."""
    rng = np.random.default_rng(n + layers + batch)
    w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32, device=dev)
    before = tk.launches["circuit_expvals"]
    out = tk.fused_circuit_expvals(a, w, n, layers, return_state=state)
    torch.cuda.synchronize()
    assert tk.launches["circuit_expvals"] == before + 1
    pev, pre, pim = tk.circuit_expvals_plain(a, w, n, layers)
    pairs = zip(out, (pev, pre, pim)) if state else [(out, pev)]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


# every n (one kernel instantiation each) at L = 1 and 3, with batches that
# span several blocks and end in a ragged one (64 samples a block at n = 2,
# 2 at n = 8, 1 from n = 10)
@pytest.mark.parametrize(
    "n,layers,batch",
    [(2, 1, 3), (8, 3, 2304), (12, 5, 7)]
    + [(n, layers, max(5, ((3 << 11) >> n) + 1)) for n in range(2, 13) for layers in (1, 3)],
)
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


# the noise-sweep ensemble's member axis: one member and the shipped four, at
# n from one-warp samples (2, 6, 8) to whole blocks (12), the serving batches
# and the training launch's 2304 rows
@pytest.mark.parametrize("members,n,batch", [(e, n, b) for e in (1, 4) for n in (2, 6, 8, 12) for b in (1, 64, 2304)])
def test_member_axis_circuit_kernels_match_plain_and_single_launches(dev, members, n, batch):
    """One member-axis launch each of the forward and the adjoint: against
    their plain versions at the one-member tolerances above (2e-5 absolute;
    2e-5 of the largest cotangent plus 1e-6), and member m bit for bit equal
    to a one-member launch on its slices."""
    layers = 3
    rng = np.random.default_rng(100 * members + 10 * n + batch)
    w = torch.tensor(rng.uniform(-3, 3, (members, layers, n, 2)), dtype=torch.float32, device=dev)
    a = torch.tensor(rng.uniform(-1, 1, (members, batch, n)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.standard_normal((members, batch, n)), dtype=torch.float32, device=dev)
    before = dict(tk.launches)
    ev, fre, fim = tk.fused_circuit_expvals_ensemble(a, w, n, layers, return_state=True)
    da, dw = tk.circuit_adjoint_ensemble(fre, fim, g, a, w, n, layers)
    torch.cuda.synchronize()
    assert tk.launches["circuit_expvals_ensemble"] == before["circuit_expvals_ensemble"] + 1
    assert tk.launches["circuit_adjoint_ensemble"] == before["circuit_adjoint_ensemble"] + 1
    assert tk.launches["circuit_expvals"] == before["circuit_expvals"]
    for got, want in zip((ev, fre, fim), tk.circuit_expvals_ensemble_plain(a, w, n, layers)):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    for got, want in zip((da, dw), tk.circuit_adjoint_ensemble_plain(fre, fim, g, a, w, n, layers)):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5 * want.abs().max().item() + 1e-6)
    for m in range(members):
        sev, sre, sim = tk.fused_circuit_expvals(a[m], w[m], n, layers, return_state=True)
        sda, sdw = tk.circuit_adjoint(sre, sim, g[m].contiguous(), a[m], w[m], n, layers)
        for got, want in ((ev[m], sev), (fre[m], sre), (fim[m], sim), (da[m], sda), (dw[m], sdw)):
            assert torch.equal(got, want), m


def test_member_axis_autograd_is_one_launch_each_way(dev):
    rng = np.random.default_rng(1)
    a = torch.tensor(rng.uniform(-1, 1, (4, 2304, 6)), dtype=torch.float32, device=dev, requires_grad=True)
    w = torch.tensor(rng.uniform(-3, 3, (4, 3, 6, 2)), dtype=torch.float32, device=dev, requires_grad=True)
    g = torch.tensor(rng.standard_normal((4, 2304, 6)), dtype=torch.float32, device=dev)
    tk.reset_launch_counts()
    (circuits.run_circuit_ensemble(a, w, 6, 3, impl="pallas_circuit") * g).sum().backward()
    torch.cuda.synchronize()
    assert tk.launches == {name: int(name in tk.ENSEMBLE_COUNTERS) for name in tk.COUNTERS}
    a2, w2 = a.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    (tk.circuit_expvals_ensemble_plain(a2, w2, 6, 3)[0] * g).sum().backward()
    torch.testing.assert_close(a.grad, a2.grad, rtol=0, atol=2e-5 * a2.grad.abs().max().item())
    torch.testing.assert_close(w.grad, w2.grad, rtol=0, atol=2e-5 * w2.grad.abs().max().item())
    with pytest.raises(ValueError, match="members"):
        tk.fused_circuit_expvals_ensemble(a.detach(), w.detach()[:3], 6, 3)


def test_circuit_autograd_launches_forward_and_adjoint(dev):
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.uniform(-1, 1, (64, 8)), dtype=torch.float32, device=dev, requires_grad=True)
    w = torch.tensor(rng.uniform(-3, 3, (3, 8, 2)), dtype=torch.float32, device=dev, requires_grad=True)
    g = torch.tensor(rng.standard_normal((64, 8)), dtype=torch.float32, device=dev)
    tk.reset_launch_counts()
    (tk.fused_circuit_expvals(a, w, 8, 3) * g).sum().backward()
    torch.cuda.synchronize()
    assert tk.launches == {name: int(name in ("circuit_expvals", "circuit_adjoint")) for name in tk.COUNTERS}
    a2, w2 = a.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    (tk.circuit_expvals_plain(a2, w2, 8, 3)[0] * g).sum().backward()
    torch.testing.assert_close(a.grad, a2.grad, rtol=0, atol=2e-5 * a2.grad.abs().max().item())
    torch.testing.assert_close(w.grad, w2.grad, rtol=0, atol=2e-5 * w2.grad.abs().max().item())


def _states(rng, batch, n, dev):
    re = rng.standard_normal((batch, 1 << n))
    im = rng.standard_normal((batch, 1 << n))
    norm = np.sqrt((re**2 + im**2).sum(-1, keepdims=True))
    return CArr(*(torch.tensor(x / norm, dtype=torch.float32, device=dev) for x in (re, im)))


def _rotation_tol(n, amax):
    """1e-6 on unit-norm states through n = 14 (one layer of fp32 gate
    updates, fused multiply-adds in the kernel); from n = 15, 8 n unit
    roundoffs (2^-24) of the largest amplitude: 2n rotations, each rounding a
    two-term sum twice, in two implementations."""
    return 1e-6 if n <= 14 else 8 * n * 2.0**-24 * amax


# every plan: tiles of 2^10, 2^12 and 2^14 (a cluster of four blocks), two
# or four register bits, one to three passes
@pytest.mark.parametrize(
    "n,batch",
    [(1, 3), (7, 11), (8, 1), (8, 2304), (12, 7), (12, 600), (13, 3), (13, 300), (14, 5), (14, 64), (14, 2304),
     (15, 2), (16, 2), (16, 64), (17, 1), (20, 1), (21, 1)],
)
def test_rotation_layer_kernel_matches_plain(dev, n, batch):
    rng = np.random.default_rng(20 + n)
    psi = _states(rng, batch, n, dev)
    w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
    before = tk.launches["rotation_layer"]
    got = tk.apply_rotation_layer(psi, w, n)
    torch.cuda.synchronize()
    assert tk.launches["rotation_layer"] == before + 1
    want = tk.rotation_layer_plain(psi.re, psi.im, w, n)
    tol = _rotation_tol(n, max(want.re.abs().max().item(), want.im.abs().max().item()))
    torch.testing.assert_close(got.re, want.re, rtol=0, atol=tol)
    torch.testing.assert_close(got.im, want.im, rtol=0, atol=tol)
    # n = 0 raises before any launch; n = 15 is inside the window
    with pytest.raises(ValueError, match="1 <= n <= 32"):
        tk.apply_rotation_layer(CArr(torch.zeros(1, 1, device=dev), torch.zeros(1, 1, device=dev)), torch.zeros(0, 2, device=dev), 0)
    assert tk.launches["rotation_layer"] == before + 1


@pytest.mark.parametrize(
    "n,batch,plan",
    [(8, 1, (10, 2, 1)), (8, 2304, (10, 4, 1)), (12, 64, (12, 2, 1)), (13, 264, (14, 4, 1)),
     (14, 2304, (14, 4, 1)), (14, 1, (10, 2, 2)), (14, 64, (10, 4, 2)), (16, 1, (10, 2, 2)),
     (16, 64, (10, 4, 2)), (20, 1, (12, 4, 2)), (21, 1, (10, 4, 3))],
)
def test_rotation_layer_plan(dev, n, batch, plan):
    """The launcher's (tile bits, register bits, passes): the plan the design
    test emulates."""
    assert tk.rotation_layer_plan(batch, n) == plan


def test_rotation_layer_takes_misaligned_views_through_a_copy(dev):
    rng = np.random.default_rng(6)
    psi = _states(rng, 9, 6, dev)
    w = torch.tensor(rng.uniform(-3, 3, (6, 2)), dtype=torch.float32, device=dev)
    shifted = torch.empty(9 * 64 + 1, device=dev)[1:].view(9, 64)
    shifted.copy_(psi.re)
    before = tk.launches["rotation_layer"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        tk._rotation_launch(shifted, psi.im, w, 6)
    got = tk.apply_rotation_layer(CArr(shifted, psi.im), w, 6)
    assert tk.launches["rotation_layer"] == before + 1
    want = tk.rotation_layer_plain(psi.re, psi.im, w, 6)
    torch.testing.assert_close(got.re, want.re, rtol=0, atol=1e-6)


# every tile plan of the launcher: B <= 4, moderate B, n <= 7 at B >= 512,
# n >= 8 at B >= 1024
@pytest.mark.parametrize(
    "n,batch",
    [(1, 3), (6, 2304), (9, 40), (12, 33)] + [(n, b) for n in (1, 6, 7, 10, 12) for b in (1, 33, 2304)]
    + [(13, 1), (13, 33), (13, 1024), (14, 1), (14, 9)],
)
def test_unitary_kernel_matches_plain(dev, n, batch):
    """Tolerance: 5e-6 on unit-norm states (sums over 2^n terms, each a
    2^n-term product, in another order than the plain matmuls')."""
    rng = np.random.default_rng(30 + n)
    psi = _states(rng, batch, n, dev)
    w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
    # one layer past n = 12: the three-layer product alone would be 17 TFLOP at n = 14
    layers = 3 if n <= 12 else 1
    u = circuits.ansatz_unitary(w, n, layers) if n >= 2 else circuits.rot_gate(w[0, 0, 0], w[0, 0, 1])
    before = tk.launches["unitary_expvals"]
    got = tk.fused_unitary_expvals(psi, u, n)
    torch.cuda.synchronize()
    assert tk.launches["unitary_expvals"] == before + 1
    want = tk.unitary_expvals_plain(psi.re, psi.im, u.re, u.im, n)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-6)
    again = tk.fused_unitary_expvals(psi, u, n)
    assert torch.equal(again, got)  # no atomics: the same sums every run


@pytest.mark.parametrize("n,batch", [(6, 1), (6, 2304), (10, 1), (10, 64), (10, 2304)])
def test_unitary_kernel_is_bitwise_repeatable(dev, n, batch):
    """The column tiles' sums are added in a fixed order, never by atomics:
    two launches give the same bits."""
    rng = np.random.default_rng(40 + n)
    psi = _states(rng, batch, n, dev)
    u = circuits.ansatz_unitary(torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev), n, 3)
    first = tk.fused_unitary_expvals(psi, u, n)
    second = tk.fused_unitary_expvals(psi, u, n)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_unitary_kernel_takes_misaligned_views_through_a_copy(dev):
    """A contiguous view one float into its storage is refused by the launch
    path before any launch, and the public function copies it to aligned
    storage and launches the kernel."""
    rng = np.random.default_rng(5)
    psi = _states(rng, 9, 6, dev)
    u = circuits.ansatz_unitary(torch.tensor(rng.uniform(-3, 3, (3, 6, 2)), dtype=torch.float32, device=dev), 6, 3)
    shifted = torch.empty(9 * 64 + 1, device=dev)[1:].view(9, 64)
    shifted.copy_(psi.re)
    before = tk.launches["unitary_expvals"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        tk._unitary_launch(shifted, psi.im, u.re.contiguous(), u.im.contiguous(), 6)
    assert tk.launches["unitary_expvals"] == before
    got = tk.fused_unitary_expvals(CArr(shifted, psi.im), u, 6)
    assert tk.launches["unitary_expvals"] == before + 1
    torch.testing.assert_close(got, tk.unitary_expvals_plain(psi.re, psi.im, u.re, u.im, 6), rtol=0, atol=5e-6)


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


def test_circuit_adjoint_occupancy(dev):
    """At n = 8, L = 3 (the trained 8-qubit circuit) at least 32 warps of the
    adjoint (four blocks' worth of 256 threads) stay resident per SM; every n
    fits one block."""
    blocks, threads = tk.circuit_adjoint_occupancy(8, 3)
    assert blocks * threads >= 4 * 256
    for n in range(2, 13):
        assert tk.circuit_adjoint_occupancy(n, 3)[0] >= 1


@pytest.mark.parametrize("n", [6, 8])
def test_impl_race_on_the_card_has_no_candidate_error(dev, tmp_path, n):
    """The impl race at the serving shape: every eligible candidate times on
    the card without an error, and the race runs the QSC kernel, the circuit
    forward and its adjoint."""
    from qdml_tpu_torch.quantum import autotune

    before = dict(tk.launches)
    entry = autotune.ensure(n, 3, 64, path=str(tmp_path / "t.json"), budget_s=0.02, device=dev, force=True)
    assert entry["platform"] == "cuda" and set(entry["candidates"]) == set(autotune.eligible_impls(n))
    for impl, rec in entry["candidates"].items():
        assert "error" not in rec and rec["fwd_ms"] > 0 and rec["train_ms"] > 0, (impl, rec)
    for k in ("qsc_expvals", "circuit_expvals", "circuit_adjoint"):
        assert tk.launches[k] > before[k], k


def test_sparse_dispatch_on_the_card_matches_the_cpu(dev):
    from qdml_tpu_torch.ops.routing import select_expert, sparse_dispatch

    rng = np.random.default_rng(3)
    w = torch.tensor(rng.standard_normal((6, 5, 4)), dtype=torch.float32)
    x = torch.tensor(rng.standard_normal((64, 5)), dtype=torch.float32)
    for pred in (torch.arange(64) % 6, torch.full((64,), 2)):
        outs = []
        for d in ("cpu", dev):
            wd = w.to(d)
            outs.append(sparse_dispatch(
                lambda b: torch.einsum("scd,sde->sce", b, wd),
                lambda xx, pp: select_expert(torch.einsum("bd,sde->sbe", xx, wd), pp),
                x.to(d), pred.to(d), 6, 1.25,
            ))
        assert outs[0][1] == outs[1][1]
        torch.testing.assert_close(outs[1][0].cpu(), outs[0][0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K steps as one CUDA graph (train/scan.py)
# ---------------------------------------------------------------------------


def _scan_cfg(k, dtype="float32", moments="float32", **quantum):
    """The tests' small config at ``scan_steps`` k. ``probe_every=1``: the
    K-step path fetches and logs a chunk's losses only on the probe cadence,
    so the tests that read every step's loss from the log set it to every
    step."""
    from qdml_tpu_torch import config as tconfig

    return tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16, data_len=40),
        model=tconfig.ModelConfig(features=8, dtype=dtype),
        quantum=tconfig.QuantumConfig(n_qubits=4, n_layers=2, **quantum),
        train=tconfig.TrainConfig(batch_size=8, n_epochs=2, print_freq=1, scan_steps=k, moments_dtype=moments,
                                  probe_every=1),
    )


# the trunks' BatchNorm sites a training step (S trunks of 3, or the DCE's
# one trunk), each one bn_relu_fwd and one bn_relu_bwd launch
BN_SITES = {"hdce": 9, "dce": 3, "qsc": 0}


class _Recorder:
    def __init__(self):
        self.records = []

    def log(self, **values):
        self.records.append(values)


def _scan_run(trainer, cfg, data):
    from qdml_tpu_torch.train import dce, hdce, qsc

    rec = _Recorder()
    tk.reset_launch_counts()
    if trainer == "hdce":
        model, hist = hdce.train_hdce(cfg, data=data, logger=rec)
    elif trainer == "dce":
        model, hist = dce.train_dce(cfg, data=data, logger=rec)
    else:
        model, hist = qsc.train_classifier(cfg, True, data=data, logger=rec)
    torch.cuda.synchronize()
    losses = [r["loss"] for r in rec.records if "loss" in r and "losses" not in r]
    losses += [x for r in rec.records if "losses" in r for x in r["losses"]]
    return losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}, dict(tk.launches)


@pytest.mark.parametrize("trainer,quantum", [
    ("hdce", {}),
    ("qsc", {"impl": "pallas_circuit", "use_quantumnat": True, "noise_level": 0.05}),
    ("qsc", {"impl": "pallas"}),
])
def test_scan_graph_matches_the_per_step_path(dev, trainer, quantum):
    """Two epochs of 4 steps at K = 3 (a graph of 3 and a tail graph of 1)
    against scan_steps = 0 from the same init: step losses within rtol 1e-5,
    parameters within the Adam bound (every entry within 1.1 lr a step, at
    most 1% of all entries past 1e-5 + 1e-4|p|: the last layer's RZ weights
    have rounding-only gradients), the same kernel launches counted on both
    paths (for HDCE 9 BatchNorm + ReLU launches each way a step), and the
    QuantumNAT stream drawn step for step as the per-step path draws it."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import scan

    data = GridData.synthesize(_scan_cfg(0).data, dev)
    l0, p0, n0 = _scan_run(trainer, _scan_cfg(0, **quantum), data)
    before = dict(scan.activity)
    l3, p3, n3 = _scan_run(trainer, _scan_cfg(3, **quantum), data)
    assert scan.activity["captures"] - before["captures"] == 2
    assert scan.activity["replays"] - before["replays"] == 3  # epoch 0's first chunk is the eager warm-up
    assert len(l0) == len(l3) == 8
    np.testing.assert_allclose(l3, l0, rtol=1e-5, atol=0)
    outside = total = 0
    for k, want in p0.items():
        if want.is_floating_point():
            diff = (p3[k] - want).abs()
            assert diff.max().item() <= 1.1 * 8 * 1e-3 + 1e-5, k
            outside += int((diff > 1e-5 + 1e-4 * want.abs()).sum())
            total += want.numel()
        else:
            assert torch.equal(p3[k], want), k
    assert outside <= 0.01 * total
    assert n3 == n0
    assert n0["bn_relu_fwd"] == n0["bn_relu_bwd"] == BN_SITES[trainer] * len(l0)


@pytest.mark.parametrize("trainer,moments", [("hdce", "float32"), ("dce", "float32"), ("hdce", "bfloat16")])
def test_bf16_scan_graph_matches_the_per_step_path(dev, trainer, moments):
    """``model.dtype=bfloat16`` (and bfloat16 Adam moments) inside the K = 3
    graph against the per-step path from the same init: step losses within
    rtol 1e-5, parameters within the Adam bound, as in float32, and the same
    BatchNorm + ReLU launches (which run in float32 on the convs' output)."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import scan

    data = GridData.synthesize(_scan_cfg(0).data, dev)
    l0, p0, n0 = _scan_run(trainer, _scan_cfg(0, "bfloat16", moments), data)
    before = dict(scan.activity)
    l3, p3, n3 = _scan_run(trainer, _scan_cfg(3, "bfloat16", moments), data)
    assert scan.activity["captures"] - before["captures"] == 2
    assert len(l0) == len(l3) == 8
    np.testing.assert_allclose(l3, l0, rtol=1e-5, atol=0)
    for k, want in p0.items():
        if want.is_floating_point():
            assert want.dtype == torch.float32, k
            assert (p3[k] - want).abs().max().item() <= 1.1 * 8 * 1e-3 + 1e-5, k
        else:
            assert torch.equal(p3[k], want), k
    assert n3 == n0
    assert n0["bn_relu_fwd"] == n0["bn_relu_bwd"] == BN_SITES[trainer] * len(l0)


def test_bf16_moments_adam_is_captured_with_its_storage_dtypes(dev):
    """The bfloat16-moments Adam under a K-step graph: mu stays bfloat16 and
    nu float32 on the card, the count lives on the card and advances at
    every replay, and the parameters follow the per-step path's."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import hdce, optim

    cfg = _scan_cfg(2, "bfloat16", "bfloat16")
    data = GridData.synthesize(cfg.data, dev)
    idx = np.stack([np.random.default_rng(i).integers(0, 20, (3, 3, 8)) for i in range(2)]).astype(np.int64)
    snrs = np.full(2, 10.0, np.float32)
    params = {}
    for k in (0, 2):
        model, opt = hdce.make_trainer(cfg, dev, 100)
        assert isinstance(opt.opt, optim.AdamLowp) and opt.tensor_lr
        if k:
            run = hdce.make_hdce_scan_steps(model, opt, data, 2)
            for _ in range(3):
                run(idx, snrs)
            assert run.graphs
        else:
            for _ in range(3):
                for j in range(2):
                    batch = data.batch(torch.as_tensor(idx[j], device=dev), torch.tensor(snrs[j], device=dev))
                    hdce.hdce_train_step(model, opt, batch)
        torch.cuda.synchronize()
        for p in opt.params:
            st = opt.opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
            assert st["step"].is_cuda and float(st["step"]) == 6
        params[k] = {n: v.detach().cpu() for n, v in model.state_dict().items()}
    for n, want in params[0].items():
        if want.is_floating_point():
            assert (params[2][n] - want).abs().max().item() <= 1.1 * 6 * 1e-3 + 1e-5, n


def test_mps_cannot_be_captured_and_the_k_step_path_declines_it(dev):
    """Every SVD of the mps impl checks cuSOLVER's status on the host: a
    capture of its forward raises, and a QSC trainer whose circuit resolves
    to mps declines the graph with a recorded reason and trains per step."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.quantum.mps import mps_circuit
    from qdml_tpu_torch.train import qsc, scan

    a = torch.rand(8, 6, device=dev)
    w = torch.rand(2, 6, 2, device=dev)
    mps_circuit(a, w, 6, 2, chi=4)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(graph):
            mps_circuit(a, w, 6, 2, chi=4)
    torch.cuda.synchronize()
    cfg = _scan_cfg(2, impl="mps", mps_chi=4)
    data = GridData.synthesize(cfg.data, dev)
    rec = _Recorder()
    before = dict(scan.activity)
    qsc.train_classifier(cfg, True, data=data, logger=rec)
    decision = [r for r in rec.records if r.get("kind") == "scan_dispatch"]
    assert decision and decision[0]["eligible"] is False and "mps" in decision[0]["reason"]
    assert any("mps" in str(r.get("warning", "")) for r in rec.records)
    assert scan.activity == before


@pytest.mark.parametrize("n", [6, 8])
def test_mps_at_full_chi_matches_the_circuit_kernel(dev, n):
    """mps at full chi against B.2 (``pallas_circuit``) on the card, L = 3,
    B = 64: values within 1e-5, weight and angle gradients within 1e-4."""
    rng = np.random.default_rng(n)
    a0, w0 = rng.uniform(-1, 1, (64, n)), rng.uniform(0, 2 * np.pi, (3, n, 2))
    out = {}
    for impl in ("pallas_circuit", "mps"):
        a = torch.tensor(a0, dtype=torch.float32, device=dev, requires_grad=True)
        w = torch.tensor(w0, dtype=torch.float32, device=dev, requires_grad=True)
        ev = circuits.run_circuit(a, w, n, 3, impl=impl, mps_chi=1 << (n // 2))
        (ev**2).sum().backward()
        out[impl] = (ev.detach(), w.grad, a.grad)
    assert all(torch.isfinite(t).all() for t in out["mps"])
    torch.testing.assert_close(out["mps"][0], out["pallas_circuit"][0], rtol=0, atol=1e-5)
    torch.testing.assert_close(out["mps"][1], out["pallas_circuit"][1], rtol=0, atol=1e-4)
    torch.testing.assert_close(out["mps"][2], out["pallas_circuit"][2], rtol=0, atol=1e-4)


def test_registered_generator_replays_the_eager_stream(dev):
    shape = (2, 4, 2)
    eager = torch.Generator(device=dev).manual_seed(11)
    want = [torch.randn(shape, generator=eager, device=dev) for _ in range(6)]
    gen = torch.Generator(device=dev).manual_seed(11)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    out = torch.empty((3, *shape), device=dev)
    with torch.cuda.graph(graph):
        for j in range(3):
            out[j].copy_(torch.randn(shape, generator=gen, device=dev))
    for rep in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for j in range(3):
            assert torch.equal(out[j], want[3 * rep + j]), (rep, j)


def test_replays_count_their_kernel_launches(dev):
    """A captured circuit launch counts at each replay, not at capture."""
    a = torch.rand(2, 64, 4, device=dev)
    w = torch.rand(2, 2, 4, 2, device=dev)
    tk.fused_circuit_expvals_ensemble(a, w, 4, 2)  # built and loaded outside the capture
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with tk.counting_capture() as tally, torch.cuda.graph(graph):
        tk.fused_circuit_expvals_ensemble(a, w, 4, 2)
    assert tally["circuit_expvals_ensemble"] == 1 and tk.launches["circuit_expvals_ensemble"] == 0
    for _ in range(3):
        graph.replay()
        tk.count_replay(tally)
    assert tk.launches["circuit_expvals_ensemble"] == 3


def test_an_uncounted_or_uncapturable_capture_raises(dev):
    """A kernel launch captured outside ``counting_capture`` raises, and so
    does a K-step capture that meets a host sync: the runner never falls
    back to eager steps."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import hdce, scan

    a = torch.rand(1, 64, 4, device=dev)
    w = torch.rand(1, 2, 4, 2, device=dev)
    tk.fused_circuit_expvals_ensemble(a, w, 4, 2)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(graph):
            tk.fused_circuit_expvals_ensemble(a, w, 4, 2)

    cfg = _scan_cfg(2)
    data = GridData.synthesize(cfg.data, dev)
    model, opt = hdce.make_trainer(cfg, dev, 4)

    def synced_step(batch, _noise):
        out = hdce.hdce_train_step(model, opt, batch)
        float(out["loss"])  # a host read: cannot be captured
        return out

    run = scan.make_scan_steps(synced_step, data, opt, 2)
    idx = np.zeros((2, 3, 3, 8), np.int64)
    snrs = np.full(2, 10.0, np.float32)
    run(idx, snrs)  # the eager warm-up reads the loss fine
    count = opt.count
    with pytest.raises(RuntimeError):
        run(idx, snrs)
    assert opt.count == count and not run.graphs


def test_k_step_calls_write_the_card_path_spans(dev):
    """One warm-up, one capture and two replays: each ``scan_call`` (tagged
    with k) holds its host work, timed in its ``phases`` tag and, for the
    warm-up and the capture, in a span each; no span lies deeper (the
    captured steps open none)."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.telemetry import set_sink
    from qdml_tpu_torch.train import hdce

    class Spans:
        active = True

        def __init__(self):
            self.records = []

        def write_raw(self, rec):
            self.records.append(rec)

    cfg = _scan_cfg(2)
    data = GridData.synthesize(cfg.data, dev)
    model, opt = hdce.make_trainer(cfg, dev, 100)
    run = hdce.make_hdce_scan_steps(model, opt, data, 2)
    idx = np.zeros((2, 3, 3, 8), np.int64)
    snrs = np.full(2, 10.0, np.float32)
    sink = Spans()
    set_sink(sink)
    try:
        for _ in range(3):
            run(idx, snrs)
        torch.cuda.synchronize()
    finally:
        set_sink(None)
    recs = sink.records
    calls = [r for r in recs if r["name"] == "scan_call"]
    assert [(r["k"], r["depth"]) for r in calls] == [(2, 0)] * 3 and len(run.graphs) == 1
    # the one-off calls open a span each; a replayed call writes its one record
    assert [r["name"] for r in recs] == ["scan_warmup", "scan_call", "scan_capture", "scan_call", "scan_call"]
    for r in recs:
        if r["name"] != "scan_call":
            assert (r["path"], r["depth"]) == ("scan_call/" + r["name"], 1)
    capture = recs[2]
    assert capture["k"] == 2 and calls[1]["t0_ns"] <= capture["t0_ns"] <= capture["t1_ns"] <= calls[1]["t1_ns"]
    assert "phases" not in calls[0]
    assert [list(c["phases"]) for c in calls[1:]] == [["scan_stage", "scan_replay"],
                                                     ["scan_stage_wait", "scan_stage", "scan_replay"]]
    for c in calls[1:]:
        bounds = [t for pair in c["phases"].values() for t in pair]
        assert c["t0_ns"] <= bounds[0] and bounds == sorted(bounds) and bounds[-1] <= c["t1_ns"]
    stage, replay = calls[1]["phases"]["scan_stage"], calls[1]["phases"]["scan_replay"]
    assert stage[1] <= capture["t0_ns"] and capture["t1_ns"] <= replay[0]  # the capture between the two


_DETERMINISTIC_CHILD = """
import json
import torch
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cudnn.benchmark = False
from qdml_tpu_torch import config as c
from qdml_tpu_torch.data.datasets import GridData
from qdml_tpu_torch.train import hdce, qsc

def cfg(k, **q):
    return c.ExperimentConfig(
        data=c.DataConfig(n_ant=16, data_len=40), model=c.ModelConfig(features=8),
        quantum=c.QuantumConfig(n_qubits=4, n_layers=2, **q),
        train=c.TrainConfig(batch_size=8, n_epochs=2, scan_steps=k))

data = GridData.synthesize(cfg(0).data, "cuda")
out = {}
for name, q, train in (
    ("hdce", {}, lambda k, q: hdce.train_hdce(cfg(k, **q), data=data)[0]),
    ("qsc", {"impl": "pallas_circuit", "use_quantumnat": True, "noise_level": 0.05},
     lambda k, q: qsc.train_classifier(cfg(k, **q), True, data=data)[0]),
):
    runs = [{n: v.detach().cpu() for n, v in train(k, q).state_dict().items()} for k in (0, 0, 3)]
    out[name] = [all(torch.equal(r[n], runs[0][n]) for n in runs[0]) for r in runs[1:]]
print(json.dumps(out))
"""


def test_graph_is_the_per_step_path_bit_for_bit_with_deterministic_algorithms(dev):
    """With deterministic algorithms (``torch.use_deterministic_algorithms``
    and cuBLAS's fixed workspace, which must be set before the card is first
    used, hence a child process), two per-step runs of two epochs agree bit
    for bit, and so does the K = 3 graph: the graph adds no error of its
    own. With the default algorithms two eager runs differ (``PERF.md``)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, "-c", _DETERMINISTIC_CHILD], env=env, capture_output=True, text=True,
                         timeout=600, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"hdce": [True, True], "qsc": [True, True]}


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------


def _tier_engine_parts(**serve):
    """A small engine's config and seeded weights (features 8, n_ant 16,
    buckets 1, 4, 8), its classifier a QSC at n=6, L=3 on B.2."""
    import dataclasses

    from qdml_tpu_torch import config as tconfig
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.hdce import build_hdce

    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=6, n_layers=3, impl="pallas_circuit"),
        serve=tconfig.ServeConfig(buckets=(1, 4, 8), max_batch=8, max_queue=64),
    )
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, **serve))
    gen = torch.Generator().manual_seed(0)
    return cfg, build_hdce(cfg, "cpu", generator=gen).state_dict(), build_classifier(cfg, True, "cpu", generator=gen).state_dict()


def test_batching_race_on_the_card(dev, tmp_path, monkeypatch):
    """``serve.batching=auto`` races bucket against ragged per tier on the
    card (both candidates through B.2) into its table; a second engine's
    warmup reads it and measures nothing."""
    from qdml_tpu_torch.serve import batching_autotune
    from qdml_tpu_torch.serve.engine import ServeEngine

    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    cfg, hdce, clf = _tier_engine_parts()
    tk.reset_launch_counts()
    warm = ServeEngine(cfg, hdce, clf, quantum=True, device=dev).warmup()
    for b in (1, 4, 8):
        entry = warm["batching"]["race"][str(b)]
        assert entry["key"] == f"cuda/cap{b}/dense/float32"
        assert all(c["infer_ms"] > 0 for c in entry["candidates"].values())
    assert tk.launches["circuit_expvals"] > 0
    again = ServeEngine(cfg, hdce, clf, quantum=True, device=dev).warmup()
    assert again["work"] == {"measure": 0, "table_write": 0, "kernel_build": 0}
    batching_autotune.invalidate_cache()


def test_two_worker_pool_on_the_card(dev, tmp_path, monkeypatch):
    """Two replicas of two workers launching B.2 from four threads: every
    answer within ``1e-4 * max|h| + 1e-5`` of the CPU engine on the rows
    routed alike, one B.2 launch at least per served batch, counted exactly."""
    from qdml_tpu_torch.serve import batching_autotune
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.server import ReplicaPool

    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    cfg, hdce, clf = _tier_engine_parts(workers=2, replicas=2)
    eng = ServeEngine(cfg, hdce, clf, quantum=True, device=dev)
    eng.warmup()
    cpu = ServeEngine(cfg, hdce, clf, quantum=True, device="cpu")
    x = np.random.default_rng(1).standard_normal((64, 16, 8, 2)).astype(np.float32)
    pool = ReplicaPool(eng).start()
    tk.reset_launch_counts()
    try:
        results = [f.result(timeout=60.0) for f in [pool.submit(x[i], rid=i) for i in range(len(x))]]
    finally:
        pool.stop()
    merged = pool.merged_metrics()
    assert merged.completed == len(x) and tk.launches["circuit_expvals"] >= merged.batches
    h = np.stack([r.h for r in results])
    h_ref, pred_ref, _ = cpu.offline_forward(x)
    same = np.array([r.scenario for r in results]) == pred_ref
    assert same.sum() >= len(x) - 1
    np.testing.assert_allclose(h[same], h_ref[same], rtol=0, atol=1e-4 * np.abs(h_ref).max() + 1e-5)
    assert eng.request_path_work() == {"measure": 0, "table_write": 0, "kernel_build": 0}
    batching_autotune.invalidate_cache()
