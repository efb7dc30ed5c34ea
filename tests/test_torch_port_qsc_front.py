"""The quantum classifier's CNN front end: the hand-written kernel pair
(``csrc/qsc_front.cu`` behind ``quantum/kernels.py:qsc_front_end``), the
plain path it replaces on the card (``models/cnn.py:QSCPreprocess``), and
the switch between them (``models/qsc.py:front_end_on_kernel``).

On the CPU (tier 1): the plain version is ``QSCPreprocess`` bit for bit;
the switch sends the CPU, an input that needs its own gradient, other
widths, H or W not a multiple of 4 and more than 32 qubits to the
``nn.Sequential``; the noise-sweep ensemble's vmapped front end keeps the
``nn.Sequential`` even where the switch would take the kernel; the cost
formula; the wrapper's refusals; and the kernel's plan (pool codes, dz at
conv2 from them, conv2's input gradient by flipped taps, conv1's weight
gradient from one input patch a pooled value) emulated in float64 against
autograd through the plain path.

On the card (marked ``cuda``; skipped without one, decided in the fixture):
the kernel against float64 autograd through the plain path, forward and
all six gradients; two calls and a graph replay bit for bit; a K = 16
replay's launch count; the trainer's first 17 steps against the plain path
under the ``qsc_train.dp_8q`` cell's limits. Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_qsc_front.py -q
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch import nn  # noqa: E402

from qdml_tpu_torch.models import cnn  # noqa: E402
from qdml_tpu_torch.models import qsc as qsc_model  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.telemetry import cost  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PARAMS = ("0.weight", "0.bias", "3.weight", "3.bias", "7.weight", "7.bias")


def _front(n, seed, quantized=False):
    """A ``QSCPreprocess`` of n outputs with seeded weights. ``quantized``:
    conv weights and biases multiples of 1/16 (conv1) and 1/64 (conv2) of
    magnitude at most a quarter and a sixteenth, so that on inputs in
    quarters every convolution is exact in float32 and the pools pick the
    same entries on every path; the Linear scaled so the angles stay off
    tanh's flat ends."""
    rng = np.random.default_rng(seed)
    pre = cnn.QSCPreprocess(n)
    with torch.no_grad():
        for i, scale, step in ((0, 0.25, 16), (3, 1 / 16, 64)):
            for t in (pre[i].weight, pre[i].bias):
                v = rng.uniform(-scale, scale, t.shape)
                t.copy_(torch.tensor(np.round(v * step) / step if quantized else v, dtype=torch.float32))
        pre[7].weight.copy_(torch.tensor(rng.normal(0, 0.4, pre[7].weight.shape), dtype=torch.float32))
        pre[7].bias.copy_(torch.tensor(rng.normal(0, 0.1, pre[7].bias.shape), dtype=torch.float32))
    return pre


def _images(b, seed, h=16, w=8, quantized=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (b, 2, h, w)) / 4 if quantized else rng.standard_normal((b, 2, h, w))
    return torch.tensor(x, dtype=torch.float32)


def _params(pre):
    return [dict(pre.named_parameters())[k] for k in PARAMS]


def _tame(pre, x):
    """Scales the Linear so that every angle's pre-tanh value on ``x`` lies
    within +-2: where tanh saturates, 1 - t^2 keeps only the few bits that
    t has below 1, and the angles' gradient then carries float32's own
    relative error of 1e-4 and more on any path, the plain one too."""
    with torch.no_grad():
        u = nn.Sequential(*list(pre)[:8])(x).abs().max().item()
        if u > 2.0:
            pre[7].weight.mul_(2.0 / u)
            pre[7].bias.mul_(2.0 / u)
    return pre


# ---------------------------------------------------------------------------
# CPU: the plain version and the switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,b", [(4, 3), (6, 17), (8, 64), (16, 5)])
def test_plain_version_is_qsc_preprocess_bit_for_bit(n, b):
    """:func:`qsc_front_end_plain` is ``QSCPreprocess``'s arithmetic op for
    op: the angles and all six parameter gradients equal bit for bit."""
    pre = _front(n, n)
    x = _images(b, b)
    g = torch.randn(b, n, generator=torch.Generator().manual_seed(b))
    want = pre(x)
    want_grads = torch.autograd.grad(want, _params(pre), g)
    got = tk.qsc_front_end_plain(x, *_params(pre))
    got_grads = torch.autograd.grad(got, _params(pre), g)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b_) for a, b_ in zip(got_grads, want_grads))


def _cuda_like(shape=(4, 2, 16, 8), dtype=torch.float32, requires_grad=False):
    """What the switch reads of an input on the card: device, dtype, flag, shape."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype, requires_grad=requires_grad,
                           shape=torch.Size(shape), dim=lambda: len(shape))


def _other_widths():
    pre = cnn.QSCPreprocess(8)
    pre[0] = nn.Conv2d(2, 8, 3, padding=1)
    pre[3] = nn.Conv2d(8, 32, 3, padding=1)
    return pre


def _no_conv_bias():
    pre = cnn.QSCPreprocess(8)
    pre[3] = nn.Conv2d(16, 32, 3, padding=1, bias=False)
    return pre


def _avg_pool():
    pre = cnn.QSCPreprocess(8)
    pre[2] = nn.AvgPool2d(2, 2)
    return pre


ROUTES = [
    ("published, on the card", cnn.QSCPreprocess(8), _cuda_like(), True),
    ("n = 32", cnn.QSCPreprocess(32), _cuda_like(), True),
    ("n = 33", cnn.QSCPreprocess(33), _cuda_like(), False),
    ("the CPU", cnn.QSCPreprocess(8), torch.zeros(4, 2, 16, 8), False),
    ("x requires grad", cnn.QSCPreprocess(8), _cuda_like(requires_grad=True), False),
    ("float64", cnn.QSCPreprocess(8), _cuda_like(dtype=torch.float64), False),
    ("other widths", _other_widths(), _cuda_like(), False),
    ("conv2 without a bias", _no_conv_bias(), _cuda_like(), False),
    ("an average pool", _avg_pool(), _cuda_like(), False),
    ("H not a multiple of 4", cnn.QSCPreprocess(8), _cuda_like((4, 2, 18, 8)), False),
    ("W not a multiple of 4", cnn.QSCPreprocess(8), _cuda_like((4, 2, 16, 6)), False),
    ("the Linear not of H x W", cnn.QSCPreprocess(8), _cuda_like((4, 2, 16, 16)), False),
    ("3-D", cnn.QSCPreprocess(8), _cuda_like((2, 16, 8)), False),
]


@pytest.mark.parametrize("what,pre,x,want", ROUTES, ids=[r[0] for r in ROUTES])
def test_switch_takes_the_kernel_only_where_it_computes_the_front_end(what, pre, x, want):
    """``front_end_on_kernel`` reads the input's device, dtype, gradient
    flag and shape and the module's layers: only a float32 card input that
    needs no gradient of its own, H and W multiples of 4 matching the
    Linear, and the published widths with at most 32 outputs take the
    kernel."""
    assert qsc_model.front_end_on_kernel(pre, x) is want


@pytest.mark.parametrize("requires_grad", [False, True])
def test_cpu_forward_runs_the_sequential(monkeypatch, requires_grad):
    """On the CPU ``QSCP128.forward`` never reaches the kernel's wrapper:
    its log-probabilities are those of the ``nn.Sequential``'s angles
    through the circuit and head, bit for bit, and nothing is launched."""
    monkeypatch.setattr(tk, "qsc_front_end", lambda *a: pytest.fail("reached the kernel's wrapper"))
    model = qsc_model.QSCP128(4, 2)
    x = _images(6, 3).requires_grad_(requires_grad)
    tk.reset_launch_counts()
    got = model(x)
    from qdml_tpu_torch.quantum.circuits import run_circuit

    ev = run_circuit(model.preprocess(x), model.qlayer.weights, 4, 2, model.backend, impl=model.impl,
                     mode="train", mps_chi=model.mps_chi)
    assert torch.equal(got, torch.log_softmax(model.classifier(ev), dim=-1))
    assert tk.launches == {name: 0 for name in tk.COUNTERS}


def test_noise_sweep_keeps_the_sequential_under_vmap(monkeypatch):
    """The noise-sweep ensemble vmaps ``functional_call(model.preprocess,
    ...)`` over its members, below the switch: with the switch forced to
    the kernel for every input, its log-probabilities still come from the
    ``nn.Sequential`` and match each member's own model."""
    from qdml_tpu_torch.config import DataConfig, ExperimentConfig, QuantumConfig
    from qdml_tpu_torch.train import nat_sweep

    cfg = ExperimentConfig(data=DataConfig(data_len=40), quantum=QuantumConfig(n_qubits=4, n_layers=2))
    states = nat_sweep.member_states(cfg, 3)
    model = nat_sweep.build_sweep_model(cfg).eval()
    params = nat_sweep.stack_states(states, "cpu")
    x = _images(5, 9)
    wants = []
    for state in states:
        q = cfg.quantum
        single = qsc_model.QSCP128(q.n_qubits, q.n_layers, q.n_classes, q.backend, q.impl, mps_chi=q.mps_chi).eval()
        single.load_state_dict(state)
        with torch.no_grad():
            wants.append(single(x))
    monkeypatch.setattr(qsc_model, "front_end_on_kernel", lambda pre, x: True)
    monkeypatch.setattr(tk, "qsc_front_end", lambda *a: pytest.fail("reached the kernel's wrapper"))
    with torch.no_grad():
        got = nat_sweep.ensemble_log_probs(model, params, x, train=False)
    for m, want in enumerate(wants):
        torch.testing.assert_close(got[m], want, rtol=1e-5, atol=1e-6)


def test_qsc_front_work_counts_the_issue_s_flops():
    """At the cell's shape (B = 2304, n = 8, 16 x 8): 372,736 forward flops
    a sample (conv1 73,728, conv2 294,912, the Linear 4,096), 0.859 GFLOP a
    step, 12.8 us at 67 TFLOP/s; the backward 1,044,480 a sample, 2.41 GFLOP,
    35.9 us; bytes the input, parameters and angles (and gradients) once."""
    fwd = cost.qsc_front_work(2304, 8, 16, 8, False)
    bwd = cost.qsc_front_work(2304, 8, 16, 8, True)
    assert fwd[1] == 2304 * (73_728 + 294_912 + 4_096) == 858_783_744
    assert bwd[1] == 2304 * 1_044_480
    assert round(fwd[1] / 67e12 * 1e6, 1) == 12.8 and round(bwd[1] / 67e12 * 1e6, 1) == 35.9
    params = 288 + 16 + 4608 + 32 + 256 * 8 + 8
    assert fwd[0] == 4.0 * (2304 * 256 + params + 2304 * 8)
    assert bwd[0] == 4.0 * (2304 * 256 + 2 * params + 2304 * 8)
    counter = cost.cost_counter()
    counter.kernel("qsc_front_fwd", [], fwd)
    assert counter.kernels == {"qsc_front_fwd": 1} and (counter.bytes, counter.flops) == fwd


def test_wrapper_refuses_before_reaching_the_library(monkeypatch):
    """What the kernel cannot take raises before any build or load: a CPU
    tensor, an input that requires grad, float64, a non-contiguous view, a
    wrong rank or channel count, H not a multiple of 4, more than 32 angles,
    parameters of other shapes."""
    monkeypatch.setattr(tk, "_load", lambda name: pytest.fail("reached the loader"))
    pre = cnn.QSCPreprocess(8)
    p = [t.detach() for t in _params(pre)]
    x = _images(4, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.qsc_front_end(x, *p)
    with pytest.raises(ValueError, match="requires grad"):
        tk.qsc_front_end(x.requires_grad_(True), *p)
    x = x.detach()
    with pytest.raises(TypeError, match="float32"):
        tk.qsc_front_end(x.double(), *p)
    with pytest.raises(ValueError, match="contiguous"):
        tk.qsc_front_end(x.transpose(2, 3).contiguous().transpose(2, 3), *p)
    with pytest.raises(ValueError, match=r"\(B, 2, H, W\)"):
        tk.qsc_front_end(x[0], *p)
    with pytest.raises(ValueError, match="multiples of 4"):
        tk.qsc_front_end(_images(4, 1, h=18), *p)
    big = cnn.QSCPreprocess(33)
    with pytest.raises(ValueError, match="1 to 32 angles"):
        tk.qsc_front_end(x, *p[:4], big[7].weight.detach(), big[7].bias.detach())
    with pytest.raises(ValueError, match="conv2_w must have shape"):
        tk.qsc_front_end(x, p[0], p[1], p[2][:, :8].contiguous(), *p[3:])
    with pytest.raises(ValueError, match="CUDA device"):
        tk._qsc_front_bwd_launch(x, *p, torch.zeros(4, 8))


def test_qsc_front_source_declares_its_c_interface_and_why_it_exists():
    """The source is built with the others, says what it replaces (no TPU
    kernel), what bounds it and what its design does; its C entry points
    check the launches' errors, and it sums with no atomics."""
    assert "qsc_front" in tk.NATIVE_KERNELS and "qsc_front" in tk.SOURCES and "qsc_front" not in tk.KERNELS
    assert tk.COUNTERS[-2:] == ("qsc_front_fwd", "qsc_front_bwd")
    text = (tk.CSRC / "qsc_front.cu").read_text()
    for entry in ("qsc_front_fwd_launch(", "qsc_front_bwd_launch(", "qsc_front_bwd_blocks(", "qsc_front_entries("):
        assert f'extern "C" int {entry}' in text
    assert text.count("cudaGetLastError()") >= 3
    assert "Replaces no TPU kernel" in text and "What bounds it on an H100: FFMA operations" in text
    assert "12.8 us forward and 36 us backward" in text
    assert "atomic" not in text.replace("no\n//     atomics", "").replace("no atomics", "")


# The kernel's plan in float64, step for step as csrc/qsc_front.cu takes it.


def _pool(r):
    """2x2 max-pool with torch's rule (the first maximum in scan order):
    the pooled values and each window's code 0..3."""
    b, c, h, w = r.shape
    win = r.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(b, c, h // 2, w // 2, 4)
    m, code = win.max(-1)
    first = (win == m[..., None]).int().argmax(-1)  # torch's max may return any tied index: the first
    return m, torch.where(torch.isnan(m), code, first)


def _unpool(g, code):
    b, c, h, w = g.shape
    win = F.one_hot(code, 4).to(g.dtype) * g[..., None]
    return win.reshape(b, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(b, c, 2 * h, 2 * w)


def _taps(xp, weight, h, w):
    """A 3x3 convolution over the zero-padded xp, tap by tap."""
    return sum(torch.einsum("oc,bchw->bohw", weight[:, :, ky, kx], xp[:, :, ky : ky + h, kx : kx + w])
               for ky in range(3) for kx in range(3))


def _kernel_plan(x, w1, b1, w2, b2, fw, fb, dang):
    b, _, h, w = x.shape
    h2, w2_ = h // 2, w // 2
    xp = F.pad(x, (1, 1, 1, 1))
    z1 = _taps(xp, w1, h, w) + b1.view(1, -1, 1, 1)
    a1, c1 = _pool(torch.where(z1 <= 0, 0.0, z1))
    a1p = F.pad(a1, (1, 1, 1, 1))
    z2 = _taps(a1p, w2, h2, w2_) + b2.view(1, -1, 1, 1)
    a2, c2 = _pool(torch.where(z2 <= 0, 0.0, z2))
    feat = a2.flatten(1)
    t = torch.tanh(feat @ fw.T + fb)
    du = dang * (1 - t * t)
    gfc, gfcb = du.T @ feat, du.sum(0)
    g2 = torch.where(a2 <= 0, 0.0, (du @ fw).view(a2.shape))
    dz2 = _unpool(g2, c2)
    gw2 = torch.stack([torch.stack([torch.einsum("bohw,bchw->oc", dz2, a1p[:, :, ky : ky + h2, kx : kx + w2_])
                                    for kx in range(3)], -1) for ky in range(3)], -2)
    dz2p = F.pad(dz2, (1, 1, 1, 1))
    # the input gradient by flipped taps: da1[y, x] = sum dz2p[y + 2 - ky, x + 2 - kx] w2[ky, kx]
    da1 = sum(torch.einsum("oc,bohw->bchw", w2[:, :, ky, kx], dz2p[:, :, 2 - ky : 2 - ky + h2, 2 - kx : 2 - kx + w2_])
              for ky in range(3) for kx in range(3))
    g1 = torch.where(a1 <= 0, 0.0, da1)
    # conv1's weight gradient from one input patch a pooled value: the
    # window's argmax (2 qy + code // 2, 2 qx + code % 2)
    ys = 2 * torch.arange(h2).view(1, 1, -1, 1) + torch.div(c1, 2, rounding_mode="floor")
    xs = 2 * torch.arange(w2_).view(1, 1, 1, -1) + c1 % 2
    flat = xp.reshape(b, 2, -1)
    gw1 = torch.zeros(16, 2, 3, 3, dtype=x.dtype)
    for ci in range(2):
        for ky in range(3):
            for kx in range(3):
                idx = ((ys + ky) * (w + 2) + xs + kx).reshape(b, -1)
                patch = flat[:, ci].gather(1, idx).view(g1.shape)
                gw1[:, ci, ky, kx] = (g1 * patch).sum((0, 2, 3))
    return t, [gw1, g1.sum((0, 2, 3)), gw2, dz2.sum((0, 2, 3)), gfc, gfcb]


@pytest.mark.parametrize("quantized,h,w,n", [(True, 16, 8, 8), (False, 16, 8, 6), (True, 8, 16, 4), (False, 12, 8, 16)])
def test_kernel_plan_matches_autograd_through_the_plain_path(quantized, h, w, n):
    """The kernel's plan in float64 against autograd through the plain
    version: the angles and all six gradients within 1e-12 relative. On
    inputs in quarters the pool windows hold exact ties, which both take at
    their first maximum."""
    pre = _front(n, 7, quantized)
    if 2 * h * w != 256:
        pre[7] = nn.Linear(2 * h * w, n).double()
    pre = pre.double()
    x = _images(9, 11, h, w, quantized).double()
    dang = torch.randn(9, n, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    params = _params(pre)
    want = tk.qsc_front_end_plain(x, *params)
    want_grads = torch.autograd.grad(want, params, dang)
    with torch.no_grad():
        got, got_grads = _kernel_plan(x, *[p.detach() for p in params], dang)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    for name, g, wg in zip(PARAMS, got_grads, want_grads):
        torch.testing.assert_close(g, wg, rtol=1e-12, atol=1e-12 * wg.abs().max().item(), msg=name)


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel is CUDA C++ with no CPU mode)")
    return torch.device("cuda")


def _reference(x, params, dang):
    """Float64 on the CPU through the plain path: the angles, the six
    gradients, and for each gradient entry the sum of its terms' magnitudes:
    the same backward, through the same ReLU masks and pool indices, with
    every factor's absolute value (so a term that cancels another still
    counts)."""
    x64 = x.double().cpu()
    p64 = [p.detach().double().cpu().requires_grad_(True) for p in params]
    g64 = dang.double().cpu()
    z1 = F.conv2d(x64, p64[0], p64[1], padding=1)
    a1, i1 = F.max_pool2d(F.relu(z1), 2, 2, return_indices=True)
    z2 = F.conv2d(a1, p64[2], p64[3], padding=1)
    a2, i2 = F.max_pool2d(F.relu(z2), 2, 2, return_indices=True)
    feat = a2.flatten(1)
    u = F.linear(feat, p64[4], p64[5])
    u.retain_grad()
    t = torch.tanh(u)
    t.backward(g64)
    with torch.no_grad():
        du = u.grad.abs()
        dz2 = F.max_unpool2d((du @ p64[4].abs()).view(a2.shape), i2, 2, 2, output_size=z2.shape[-2:]) * (z2 > 0)
        da1 = torch.nn.grad.conv2d_input(a1.shape, p64[2].abs(), dz2, padding=1)
        dz1 = F.max_unpool2d(da1, i1, 2, 2, output_size=z1.shape[-2:]) * (z1 > 0)
        mags = [
            torch.nn.grad.conv2d_weight(x64.abs(), p64[0].shape, dz1, padding=1), dz1.sum((0, 2, 3)),
            torch.nn.grad.conv2d_weight(a1.abs(), p64[2].shape, dz2, padding=1), dz2.sum((0, 2, 3)),
            du.T @ feat.abs(), du.sum(0),
        ]
    return t.detach(), [p.grad for p in p64], mags


CASES = [(b, n) for b in (1, 7, 256, 2304) for n in (6, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", CASES, ids=[f"B{b}-n{n}" for b, n in CASES])
def test_kernel_matches_float64_through_the_plain_path(dev, b, n):
    """Forward on random images: the angles within 1e-5 of float64 (each
    angle is tanh of a 256-term sum whose terms' magnitudes add to a few
    units: float32 rounding of the convolutions and that sum stays under
    1e-6). Forward and backward on images in quarters with quantized conv
    weights, where both convolutions are exact in float32 and the pools pick
    the same entries as float64, and the Linear scaled so tanh does not
    saturate (:func:`_tame`): the angles within 1e-5, each gradient entry
    within 1e-5 of the sum of its terms' magnitudes (the angles' gradient
    through tanh carries a relative error near 1e-6, and a float32 sum of up
    to 2304 x 128 terms in blocks of a few hundred loses far less than 1e-5
    of their magnitude)."""
    pre = _front(n, b + n).to(dev)
    x = _images(b, b, quantized=False).to(dev)
    want, _, _ = _reference(x, _params(pre), torch.zeros(b, n))
    got = tk.qsc_front_end(x, *[p.detach() for p in _params(pre)])
    torch.cuda.synchronize()
    assert (got.double().cpu() - want).abs().max().item() <= 1e-5

    pre = _front(n, b * n + 1, quantized=True).to(dev)
    x = _images(b, b + 1, quantized=True).to(dev)
    _tame(pre, x)
    dang = torch.tensor(np.random.default_rng(b).standard_normal((b, n)), dtype=torch.float32, device=dev)
    tk.reset_launch_counts()
    got = tk.qsc_front_end(x, *_params(pre))
    grads = torch.autograd.grad(got, _params(pre), dang)
    torch.cuda.synchronize()
    assert tk.launches["qsc_front_fwd"] == tk.launches["qsc_front_bwd"] == 1
    want, want_grads, mags = _reference(x, _params(pre), dang)
    assert (got.double().cpu() - want).abs().max().item() <= 1e-5
    for name, g, wg, mag in zip(PARAMS, grads, want_grads, mags):
        err = (g.double().cpu() - wg).abs()
        bound = 1e-5 * mag + 1e-9
        assert bool((err <= bound).all()), f"{name}: max error {err.max().item():.3e}, worst excess {(err - bound).max().item():.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(7, 16, 8), (2304, 16, 8), (33, 8, 16), (20, 12, 8), (5, 4, 4)])
def test_kernel_is_bitwise_repeatable_and_replays_as_it_runs(dev, b, h, w):
    """Two eager calls, forward and backward, agree bit for bit (no atomics,
    fixed-order folds), and so does a CUDA-graph replay of the same calls;
    other image sizes than the published 16 x 8 run the same plan against
    float64 (angles within 1e-5)."""
    pre = _front(8, 5)
    if 2 * h * w != 256:
        pre[7] = nn.Linear(2 * h * w, 8)
    pre = pre.to(dev)
    p = [t.detach() for t in _params(pre)]
    x = _images(b, 4, h, w).to(dev)
    dang = torch.randn(b, 8, device=dev)

    def both():
        return (tk.qsc_front_end(x, *p), *tk._qsc_front_bwd_launch(x, *p, dang))

    first, second = both(), both()
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    want, _, _ = _reference(x, p, dang)
    assert (first[0].double().cpu() - want).abs().max().item() <= 1e-5
    graph = torch.cuda.CUDAGraph()
    with tk.counting_capture() as tally, torch.cuda.graph(graph):
        static = both()
    assert tally["qsc_front_fwd"] == tally["qsc_front_bwd"] == 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(first, static))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    """On the card: parameters on another device or of other shapes, and a
    gradient of another shape, raise before any launch."""
    pre = _front(8, 2).to(dev)
    p = [t.detach() for t in _params(pre)]
    x = _images(4, 2).to(dev)
    tk.qsc_front_end(x, *p)  # built and loaded
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="conv1_w is on cpu"):
        tk.qsc_front_end(x, p[0].cpu(), *p[1:])
    with pytest.raises(ValueError, match="fc_b must have shape"):
        tk.qsc_front_end(x, *p[:5], p[5][:4].contiguous())
    with pytest.raises(ValueError, match="dangles must have shape"):
        tk._qsc_front_bwd_launch(x, *p, torch.zeros(4, 6, device=dev))
    assert tk.launches == {name: 0 for name in tk.COUNTERS}


def _qsc_cfg(k, batch_size=8, data_len=40):
    from qdml_tpu_torch import config as tconfig

    return tconfig.ExperimentConfig(
        data=tconfig.DataConfig(data_len=data_len),
        quantum=tconfig.QuantumConfig(n_qubits=8, n_layers=3, impl="pallas_circuit"),
        train=tconfig.TrainConfig(batch_size=batch_size, scan_steps=k, probe_every=1),
    )


def _chunks(cfg, calls, seed):
    d = cfg.data
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, d.data_len, (k, d.n_scenarios, d.n_users, cfg.train.batch_size)),
             np.full(k, 10.0, np.float32)) for k in calls]


@pytest.mark.cuda
def test_k16_replay_counts_sixteen_of_each_launch(dev):
    """A QSC trainer's K = 16 call: the eager warm-up launches the front end
    once a step each way; the captured graph's replay counts 16 of each
    through its tally, as many as the circuit kernels'; eval mode launches
    the forward alone."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import qsc

    cfg = _qsc_cfg(16)
    data = GridData.synthesize(cfg.data, dev)
    model, opt = qsc.make_trainer(cfg, True, dev, 10**6)
    model.train()
    run = qsc.make_sc_scan_steps(model, opt, data, 16, probes=True)
    (i0, s0), (i1, s1), (i2, s2) = _chunks(cfg, (16, 16, 16), 1)
    tk.reset_launch_counts()
    run(i0, s0)
    torch.cuda.synchronize()
    assert tk.launches["qsc_front_fwd"] == tk.launches["qsc_front_bwd"] == 16
    run(i1, s1)  # capture, then its first replay
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    run(i2, s2)
    torch.cuda.synchronize()
    counts = {k: v for k, v in tk.launches.items() if v}
    assert counts == {"circuit_expvals": 16, "circuit_adjoint": 16, "qsc_front_fwd": 16, "qsc_front_bwd": 16}
    tk.reset_launch_counts()
    with torch.no_grad():
        model.eval()(torch.randn(64, 2, 16, 8, device=dev))
    assert {k: v for k, v in tk.launches.items() if v} == {"circuit_expvals": 1, "qsc_front_fwd": 1}


@pytest.mark.cuda
def test_first_17_steps_stay_inside_the_cell_s_limits(dev, monkeypatch):
    """The QSC trainer's first 17 steps at the ``qsc_train.dp_8q`` cell's
    shape (n = 8, L = 3, 2304 rows a step; one eager step, then a K = 16
    graph), the kernel pair against the same trainer on the plain path
    (cuDNN in float32, the switch forced off), from the same weights on the
    same rows: ``loss_gap``, ``grad_gap`` and ``change_gap`` under the
    cell's limits (``port_bench/limits/qsc_train.dp_8q.json``)."""
    from port_bench.drivers.qsc_scan import training_numbers

    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import qsc

    cfg = _qsc_cfg(16, batch_size=256, data_len=512)
    data = GridData.synthesize(cfg.data, dev)
    chunks = _chunks(cfg, (1, 16), 2)

    def follow():
        model, opt = qsc.make_trainer(cfg, True, dev, 10**6)
        model.train()
        start = {k: v.detach().clone() for k, v in model.named_parameters()}
        run = qsc.make_sc_scan_steps(model, opt, data, 16, probes=True)
        params = dict(model.named_parameters())
        beta1 = opt.opt.param_groups[0]["betas"][0]
        losses = []
        for i, (idx, snrs) in enumerate(chunks):
            losses += [float(v) for v in run(idx, snrs)["loss"].reshape(-1)]
            if i == 0:
                grad1 = {k: opt.opt.state[params[k]]["exp_avg"].float() / (1.0 - beta1) for k in params}
        return {"losses": losses, "grad1": grad1, "after": {k: v.detach().clone() for k, v in params.items()}}, start

    tk.reset_launch_counts()
    prog, start = follow()
    assert tk.launches["qsc_front_fwd"] == tk.launches["qsc_front_bwd"] == 17
    monkeypatch.setattr(qsc_model, "front_end_on_kernel", lambda pre, x: False)
    tk.reset_launch_counts()
    ref, start_ref = follow()
    assert tk.launches["qsc_front_fwd"] == tk.launches["qsc_front_bwd"] == 0
    assert all(torch.equal(start[k], start_ref[k]) for k in start)
    assert len(prog["losses"]) == 17
    numbers, _ = training_numbers(prog, ref, start)
    limits = json.loads((ROOT / "port_bench/limits/qsc_train.dp_8q.json").read_text())["limits"]
    assert all(numbers[k] <= limit for k, limit in limits.items()), (numbers, limits)
