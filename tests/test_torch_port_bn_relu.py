"""The trunks' train-mode BatchNorm + ReLU: the hand-written kernel pair
(``csrc/bn_relu.cu`` behind ``quantum/kernels.py:batch_norm_relu``) and the
plain path it replaces on the card (``models/cnn.py:BatchNorm2d``).

On the CPU (tier 1): a CPU tensor takes the plain route, counts no launch
and computes what ``F.batch_norm`` + ``var_mean`` + ``lerp_`` + ``relu``
computed before the kernel existed, bit for bit; eval mode is torch's; the
wrapper refuses what the kernel cannot take before it reaches the library;
the cost formulas; and the kernel's statistics plan (chunks, a two-pass
mean and M2 a chunk, Chan's merge in the kernel's fixed order) emulated in
float32 numpy against float64.

On the card (marked ``cuda``; skipped without one, decided in the fixture):
the kernel against float64 autograd through the plain path over ragged
shapes, bitwise repeatability eager and under CUDA-graph replay, the
wrapper's refusals and the launch counters. Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_bn_relu.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from qdml_tpu_torch.models import cnn  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.telemetry import cost  # noqa: E402

TRUNK = (768, 32, 16, 8)  # one trunk's site in the HDCE step: 2304 rows over 3 trunks


def _inputs(shape, seed, dtype=torch.float32, device="cpu"):
    """x with per-channel offsets (up to +-3) and spreads (0.5-2), so the
    statistics are not those of a standard normal; a scale and shift that
    let the ReLU cut a share of every channel; dy standard normal."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    off = rng.uniform(-3, 3, (1, c, 1, 1))
    spread = rng.uniform(0.5, 2.0, (1, c, 1, 1))
    x = off + spread * rng.standard_normal(shape)
    weight = rng.uniform(0.5, 1.5, c)
    bias = rng.uniform(-0.3, 0.3, c)
    dy = rng.standard_normal(shape)
    return [torch.tensor(a, dtype=dtype, device=device) for a in (x, weight, bias, dy)]


def _module(c, decay, weight, bias, device="cpu", dtype=torch.float32):
    bn = cnn.BatchNorm2d(c, decay=decay).to(device=device, dtype=dtype).train()
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.uniform_(-0.1, 0.1)
        bn.running_var.uniform_(0.5, 1.5)
    return bn


# ---------------------------------------------------------------------------
# CPU: the plain route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,decay", [((3, 8, 16, 8), 0.729), ((37, 16, 8, 4), 0.9), ((5, 32, 1, 1), 0.3)])
def test_cpu_tensors_take_the_plain_route_bit_for_bit(shape, decay):
    """``forward_relu`` on a CPU tensor in train mode is the formula the port
    ran before the kernel, written out here: ``F.batch_norm`` on the batch's
    statistics, ``var_mean`` (biased) folded into the running statistics by
    ``lerp_`` with torch momentum ``1 - decay``, the counter, then ``relu``:
    outputs, running statistics and gradients equal bit for bit, and no
    kernel launch counted."""
    x, weight, bias, dy = _inputs(shape, 0)
    bn = _module(shape[1], decay, weight, bias)
    ref = cnn.BatchNorm2d(shape[1], decay=decay).train()
    ref.load_state_dict(bn.state_dict())
    tk.reset_launch_counts()
    for step in range(3):
        xs = (x + step).requires_grad_(True)
        y = bn.forward_relu(xs)
        y.backward(dy)

        xr = (x + step).requires_grad_(True)
        yr = F.relu(F.batch_norm(xr, None, None, ref.weight, ref.bias, True, 0.0, ref.eps))
        with torch.no_grad():
            var, mean = torch.var_mean(xr, dim=(0, 2, 3), unbiased=False)
            ref.running_mean.lerp_(mean, 1.0 - decay)
            ref.running_var.lerp_(var, 1.0 - decay)
            ref.num_batches_tracked += 1
        yr.backward(dy)
        assert torch.equal(y, yr) and torch.equal(xs.grad, xr.grad)
    for name, want in ref.state_dict().items():
        assert torch.equal(bn.state_dict()[name], want), name
    assert torch.equal(bn.weight.grad, ref.weight.grad) and torch.equal(bn.bias.grad, ref.bias.grad)
    assert int(bn.num_batches_tracked) == 3
    assert tk.launches == {name: 0 for name in tk.COUNTERS}


def test_eval_mode_and_the_trunk_on_the_cpu_keep_the_plain_path():
    """Eval mode is torch's running-statistics BatchNorm and a ReLU, and
    leaves the statistics alone; the trunk's forward runs every site
    through ``forward_relu`` on the CPU without a launch."""
    x, weight, bias, _ = _inputs((6, 8, 4, 2), 1)
    bn = _module(8, 0.9, weight, bias).eval()
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    y = bn.forward_relu(x)
    want = F.relu(F.batch_norm(x, before["running_mean"], before["running_var"], weight, bias, False, 0.0, bn.eps))
    assert torch.equal(y, want)
    assert all(torch.equal(bn.state_dict()[k], v) for k, v in before.items())

    trunk = cnn.ConvP128(features=8).train()
    tk.reset_launch_counts()
    out = trunk(torch.randn(4, 2, 16, 8))
    assert out.shape == (4, 8 * 16 * 8) and (out >= 0).all()
    assert [int(trunk.cnn[i].num_batches_tracked) for i in (1, 4, 7)] == [1, 1, 1]
    assert tk.launches == {name: 0 for name in tk.COUNTERS}


def test_wrapper_refuses_before_reaching_the_library(monkeypatch):
    """What the kernel cannot take raises before any build or load: a CPU
    tensor, float64, a non-contiguous view, a wrong rank, one value a
    channel (torch's own train-mode refusal), a per-channel tensor of
    another length."""
    monkeypatch.setattr(tk, "_load", lambda name: pytest.fail("reached the loader"))
    x, weight, bias, _ = _inputs((4, 8, 4, 2), 2)
    rm, rv = torch.zeros(8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.batch_norm_relu(x, weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(TypeError, match="float32"):
        tk.batch_norm_relu(x.double(), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        tk.batch_norm_relu(x.transpose(2, 3), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="4-D"):
        tk.batch_norm_relu(x[0], weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        tk.batch_norm_relu(x[:1, :, :1, :1].contiguous(), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        F.batch_norm(x[:1, :, :1, :1], None, None, weight, bias, True, 0.0, 1e-5)  # the plain path agrees
    with pytest.raises(ValueError, match="CUDA device"):
        tk._bn_relu_bwd_launch(x, x, weight, bias, rm, rv)


def test_bn_relu_source_declares_its_c_interface_and_why_it_exists():
    """The source is built with the others and says what it replaces (no
    TPU kernel), what bounds it and what its design does about that; its C
    entry points check the launch's error."""
    assert "bn_relu" in tk.NATIVE_KERNELS and "bn_relu" in tk.SOURCES and "bn_relu" not in tk.KERNELS
    text = (tk.CSRC / "bn_relu.cu").read_text()
    for entry in ("bn_relu_fwd_launch(", "bn_relu_bwd_launch(", "bn_relu_tile("):
        assert f'extern "C" int {entry}' in text
    assert text.count("cudaGetLastError()") >= 4
    assert "Replaces no TPU kernel" in text and "What bounds it on an H100: bytes" in text
    assert "atomic" not in text.replace("no atomics", "")


def test_wrapper_sizes_the_scratch_by_the_source_s_tile():
    """The wrapper's tile is the source's ``kTile`` (the library checks it
    again when it loads), and the scratch has ceil(N*H*W / tile) chunks a
    channel: 12 at the trunk's site, 1 for the smallest input."""
    text = (tk.CSRC / "bn_relu.cu").read_text()
    assert f"constexpr int kTile = {tk.BN_RELU_TILE};" in text
    assert tk._bn_relu_partials(768, 32, 16 * 8, torch.device("cpu")).shape == (32, 12, 2)
    assert tk._bn_relu_partials(768, 32, 16 * 8 + 1, torch.device("cpu")).shape == (32, 13, 2)
    assert tk._bn_relu_partials(2, 8, 1, torch.device("cpu")).shape == (8, 1, 2)


def test_bn_relu_work_counts_bytes_and_flops():
    """The cost formulas at the trunk's site: forward x in and y out, backward
    x and dy in and dx out (12.58 MB a tensor), plus the per-channel
    vectors; 8 and 12 flops a value."""
    values = 768 * 32 * 16 * 8
    fwd, bwd = (cost.bn_relu_work(768, 32, 16 * 8, backward) for backward in (False, True))
    assert fwd == (4.0 * (2 * values + 8 * 32), 8.0 * values)
    assert bwd == (4.0 * (3 * values + 6 * 32), 12.0 * values)
    assert round(fwd[0] / 3.35e12 * 1e6, 2) == 7.51 and round(bwd[0] / 3.35e12 * 1e6, 2) == 11.27
    counter = cost.cost_counter()
    counter.kernel("bn_relu_fwd", [], fwd)
    assert counter.kernels == {"bn_relu_fwd": 1} and (counter.bytes, counter.flops) == fwd


# The kernel's statistics plan, mirrored from csrc/bn_relu.cu in float32
# numpy: kTile values a chunk, each chunk's mean and M2 by two passes, the
# channel's chunks merged by Chan's formula, lane l taking chunks l, l + 32,
# ... in turn, then the lanes folded down to lane 0 (16, 8, 4, 2, 1).
TILE = tk.BN_RELU_TILE


def _chan(a, b):
    if b[0] == 0:
        return a
    if a[0] == 0:
        return b
    f32 = np.float32
    n = f32(a[0] + b[0])
    d = f32(b[1] - a[1])
    f = f32(b[0] / n)
    return (n, f32(a[1] + d * f), f32(a[2] + b[2] + d * d * a[0] * f))


def _kernel_moments(values: np.ndarray):
    """(mean, M2) of one channel's float32 values as the kernel takes them."""
    m = values.size
    parts = []
    for start in range(0, m, TILE):
        chunk = values[start : start + TILE]
        mean = np.float32(chunk.sum(dtype=np.float32) / np.float32(chunk.size))
        d = chunk - mean
        parts.append((np.float32(chunk.size), mean, (d * d).sum(dtype=np.float32)))
    lanes = []
    for lane in range(32):
        acc = (np.float32(0), np.float32(0), np.float32(0))
        for p in range(lane, len(parts), 32):
            acc = _chan(acc, parts[p])
        lanes.append(acc)
    for o in (16, 8, 4, 2, 1):
        lanes = [_chan(lanes[i], lanes[i + o]) if i + o < 32 else lanes[i] for i in range(32)]
    return lanes[0][1], lanes[0][2]


@pytest.mark.parametrize("m", [2, 3, 8191, 8192, 98304, 37 * 8192 + 5, 300 * 8192])
def test_kernel_statistics_plan_is_float32_accurate(m):
    """The plan's mean and biased variance against float64, on values far
    from zero (offset 300, spread 0.01), where E[x^2] - E[x]^2 in float32
    loses every digit (at least half the variance wrong here): the mean
    within 1e-2 of the spread (the inputs' own float32 spacing at 300 is
    3e-3 of it), the variance within 1e-4 relative, from one chunk (m <
    8192) to more chunks than a warp has lanes (300)."""
    rng = np.random.default_rng(m)
    x = (300.0 + 0.01 * rng.standard_normal(m)).astype(np.float32)
    mean, m2 = _kernel_moments(x)
    x64 = x.astype(np.float64)
    var64 = x64.var()
    assert abs(float(mean) - x64.mean()) <= 1e-2 * np.sqrt(var64)
    assert abs(float(m2) / m - var64) <= 1e-4 * var64
    naive = float(np.float32((x * x).mean(dtype=np.float32) - np.float32(x.mean(dtype=np.float32)) ** 2))
    assert abs(naive - var64) >= 0.5 * var64  # what the plan avoids


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel is CUDA C++ with no CPU mode)")
    return torch.device("cuda")


def _reference(x, weight, bias, rm, rv, momentum, dy, mask):
    """Float64 on the CPU through the plain path (``BatchNorm2d``'s train
    forward): the output (with the ReLU), the batch mean and inverse std,
    the running statistics after the update, and with ``dy`` the gradients
    of x, weight and bias by autograd through the same path with the ReLU's
    mask given (the kernel's own: an entry whose pre-ReLU value is within
    rounding of 0 may fall either side, and its gradient is the derivative
    on that side)."""
    c = x.shape[1]
    bn = cnn.BatchNorm2d(c, decay=1.0 - momentum).double().train()
    with torch.no_grad():
        bn.weight.copy_(weight.double().cpu())
        bn.bias.copy_(bias.double().cpu())
        bn.running_mean.copy_(rm.double().cpu())
        bn.running_var.copy_(rv.double().cpu())
    x64 = x.double().cpu().requires_grad_(True)
    z = bn(x64)
    var, mean = torch.var_mean(x64.detach(), dim=(0, 2, 3), unbiased=False)
    out = {"y": F.relu(z).detach(), "z": z.detach(), "mean": mean, "invstd": 1.0 / torch.sqrt(var + bn.eps),
           "running_mean": bn.running_mean, "running_var": bn.running_var}
    if dy is not None:
        dx, dw, db = torch.autograd.grad(z * mask.double().cpu(), (x64, bn.weight, bn.bias), dy.double().cpu())
        out.update(dx=dx, dweight=dw, dbias=db, dz_abs=(dy.double().cpu() * mask.double().cpu()).abs())
    return out


def _close(got, want, atol, rtol, what):
    got = got.double().cpu()
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    assert bool((err <= bound).all()), f"{what}: max error {err.max().item():.3e}, worst excess {(err - bound).max().item():.3e}"


SHAPES = [TRUNK] + [(n, c, h, w) for n in (1, 3, 37, 2304) for c in (8, 16, 32) for h, w in ((16, 8), (8, 4), (1, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_kernel_matches_float64_through_the_plain_path(dev, shape):
    """Three forward steps and a backward against float64 through the plain
    path. Tolerances, from float32 rounding: y within 2e-5 of its largest
    magnitude (the statistics of up to 295k values carry a relative error
    near 1e-6, the normalisation a few ulps); the mean within 1e-5 of the
    mean magnitude and the inverse std within 2e-5 relative (two passes a
    chunk, Chan's merge); the running statistics within 2e-5 (a lerp of
    those); dx within 1e-4 relative and 1e-5 of its largest magnitude;
    dweight and dbias within 1e-5 of the sum of their terms' magnitudes
    (float32 tree sums of up to 295k terms lose at most ~20 ulps of that
    sum). One value a channel (N = 1 at 1 x 1) is refused, as the plain path
    refuses it."""
    n, c, h, w = shape
    momentum, eps = 0.271, 1e-5
    x, weight, bias, dy = _inputs(shape, sum(shape), device=dev)
    rm = torch.empty(c, device=dev).uniform_(-0.1, 0.1)
    rv = torch.empty(c, device=dev).uniform_(0.5, 1.5)
    if n * h * w < 2:
        with pytest.raises(ValueError, match="more than 1 value per channel"):
            tk._bn_relu_fwd_launch(x, weight, bias, rm, rv, momentum, eps)
        with pytest.raises(ValueError, match="more than 1 value per channel"):
            _reference(x, weight, bias, rm, rv, momentum, None, None)
        return
    ref_rm, ref_rv = rm.clone(), rv.clone()
    for step in range(3):
        xs = x * (1.0 + 0.25 * step) + 0.5 * step
        y, mean, invstd = tk._bn_relu_fwd_launch(xs, weight, bias, rm, rv, momentum, eps)
        last = step == 2
        want = _reference(xs, weight, bias, ref_rm, ref_rv, momentum, dy if last else None, y > 0)
        ref_rm, ref_rv = want["running_mean"].float(), want["running_var"].float()
        _close(y, want["y"], 2e-5 * want["y"].abs().max().item(), 0.0, f"y step {step}")
        _close(mean, want["mean"], 1e-5 * xs.abs().mean().item(), 0.0, f"mean step {step}")
        _close(invstd, want["invstd"], 0.0, 2e-5, f"invstd step {step}")
        _close(rm, want["running_mean"], 2e-5, 2e-5, f"running_mean step {step}")
        _close(rv, want["running_var"], 2e-5, 2e-5, f"running_var step {step}")
        flips = (y > 0).cpu() != (want["z"] > 0)
        assert bool((want["z"][flips].abs() < 1e-4).all()), "a ReLU mask entry differs away from 0"
    dx, dweight, dbias = tk._bn_relu_bwd_launch(xs, dy, weight, bias, mean, invstd)
    torch.cuda.synchronize()
    _close(dx, want["dx"], 1e-5 * want["dx"].abs().max().item(), 1e-4, "dx")
    xhat = (xs.double().cpu() - want["mean"].view(1, c, 1, 1)) * want["invstd"].view(1, c, 1, 1)
    dims = (0, 2, 3)
    _close(dbias, want["dbias"], 1e-5 * want["dz_abs"].sum(dims).max().item(), 0.0, "dbias")
    _close(dweight, want["dweight"], 1e-5 * (want["dz_abs"] * xhat.abs()).sum(dims).max().item(), 0.0, "dweight")


def _copies(*ts):
    return [t.clone() for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [TRUNK, (37, 16, 8, 4), (3, 8, 1, 1)])
def test_kernel_is_bitwise_repeatable_and_replays_as_it_runs(dev, shape):
    """Two eager calls, forward and backward, agree bit for bit (no atomics,
    fixed-order merges), and so does a CUDA-graph replay of the same calls
    with the running statistics reset before each."""
    x, weight, bias, dy = _inputs(shape, 5, device=dev)
    c = shape[1]
    rm0 = torch.linspace(-0.1, 0.1, c, device=dev)
    rv0 = torch.linspace(0.5, 1.5, c, device=dev)

    def both(rm, rv):
        y, mean, invstd = tk._bn_relu_fwd_launch(x, weight, bias, rm, rv, 0.271, 1e-5)
        return (y, mean, invstd, *tk._bn_relu_bwd_launch(x, dy, weight, bias, mean, invstd), rm, rv)

    first = both(*_copies(rm0, rv0))
    second = both(*_copies(rm0, rv0))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))

    rm, rv = _copies(rm0, rv0)
    graph = torch.cuda.CUDAGraph()
    with tk.counting_capture() as tally, torch.cuda.graph(graph):
        static = both(rm, rv)
    assert tally["bn_relu_fwd"] == tally["bn_relu_bwd"] == 1
    for _ in range(2):
        rm.copy_(rm0)
        rv.copy_(rv0)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, static))


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(dev):
    """A non-contiguous, non-float32 or CPU input, and per-channel tensors
    on another device or of another length, raise before any launch."""
    x, weight, bias, dy = _inputs((8, 16, 8, 4), 6, device=dev)
    rm, rv = torch.zeros(16, device=dev), torch.ones(16, device=dev)
    tk.batch_norm_relu(x, weight, bias, rm, rv, 0.1, 1e-5)  # built and loaded
    torch.cuda.synchronize()
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        tk.batch_norm_relu(x.transpose(2, 3), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        tk.batch_norm_relu(x.to(memory_format=torch.channels_last), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(TypeError, match="float32"):
        tk.batch_norm_relu(x.double(), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(TypeError, match="float32"):
        tk.batch_norm_relu(x.bfloat16(), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="CUDA device"):
        tk.batch_norm_relu(x.cpu(), weight, bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="weight is on cpu"):
        tk.batch_norm_relu(x, weight.cpu(), bias, rm, rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="shape"):
        tk.batch_norm_relu(x, weight, bias, rm[:8], rv, 0.1, 1e-5)
    with pytest.raises(ValueError, match="dy must have shape"):
        tk._bn_relu_bwd_launch(x, dy[:4], weight, bias, rm, rv)
    assert tk.launches == {name: 0 for name in tk.COUNTERS}


@pytest.mark.cuda
def test_launches_count_eagerly_at_capture_and_at_replays(dev):
    """A trunk's train step launches the pair once a site each way (3 and 3
    for ``ConvP128``) and counts them; eval mode launches none. Captured
    into a graph inside ``counting_capture`` the launches count into the
    tally, not now, and every replay adds them."""
    trunk = cnn.ConvP128(features=16).to(dev).train()
    x = torch.randn(12, 2, 16, 8, device=dev)
    tk.reset_launch_counts()
    trunk(x).square().sum().backward()
    torch.cuda.synchronize()
    assert {k: v for k, v in tk.launches.items() if v} == {"bn_relu_fwd": 3, "bn_relu_bwd": 3}
    assert [int(trunk.cnn[i].num_batches_tracked) for i in (1, 4, 7)] == [1, 1, 1]
    with torch.no_grad():
        trunk.eval()(x)
    assert {k: v for k, v in tk.launches.items() if v} == {"bn_relu_fwd": 3, "bn_relu_bwd": 3}

    xb, weight, bias, _ = _inputs((64, 8, 4, 4), 7, device=dev)
    rm, rv = torch.zeros(8, device=dev), torch.ones(8, device=dev)
    tk.reset_launch_counts()
    graph = torch.cuda.CUDAGraph()
    with tk.counting_capture() as tally, torch.cuda.graph(graph):
        tk._bn_relu_fwd_launch(xb, weight, bias, rm, rv, 0.1, 1e-5)
    assert tally["bn_relu_fwd"] == 1 and tk.launches["bn_relu_fwd"] == 0
    for _ in range(3):
        graph.replay()
        tk.count_replay(tally)
    torch.cuda.synchronize()
    assert tk.launches["bn_relu_fwd"] == 3 and tk.launches["bn_relu_bwd"] == 0
