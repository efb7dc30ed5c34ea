#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``qdml_tpu_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py        # from the repo root; needs one CUDA GPU and nvcc

Phases, each of which exits non-zero on failure:

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the five circuit kernels from ``qdml_tpu_torch/csrc/`` with
   nvcc for sm_90a, in parallel, and print the build seconds and ptxas reports;
3. kernels: hold each kernel against its plain PyTorch version on the card,
   over qubit counts, layer counts and batch sizes, plus the autograd
   gradients of the QSC, rotation-layer and unitary kernels against autograd
   through the plain versions, the adjoint kernel against autograd through
   the plain forward, and the out-of-window qubit counts that must raise.
   No entry point reaches the rotation-layer kernel (the JAX package reaches
   its own only from ``tests/test_pallas.py``), so this phase is its path;
4. serving: three full-width engines (S=3 trunks of 32 features on the
   16x8x2 image, the 4096->2048 head, seeded random weights) — quantum n=6
   L=3 through impl ``pallas``, quantum n=8 L=3 through impl
   ``pallas_circuit``, and the classical SCP128 — answer batches of 1, 5, 64
   and 100 requests over buckets (1, 8, 64); the kernels' launch counters are
   zeroed just before and read just after, and every answer is held against
   the same engine built on the CPU from the same weights;
5. microbench: the port's circuit micro-benchmark
   (``qdml_tpu_torch.scripts.quantum_microbench``) at its full shape (n=6,
   L=3, B=2304), counters zeroed before and read after; every row's <Z> is
   held against the ``dense`` row's within 1e-5. Its ``pallas_old`` row is
   the unitary kernel's path;
6. training: at full width on data synthesized on the card (data_len 2048 per
   cell, cut from the reference's 20000 for time), four trainers each run one
   epoch (7 steps of 256 rows per cell, 2304 a step) and validate: HDCE
   (Adam), SC (Adam), QSC n=6 L=3 under impl ``pallas`` (AdamW, QuantumNAT
   sigma 0.01) and QSC n=8 L=3 under impl ``pallas_circuit`` (AdamW, quantile
   gradient pruning 0.5), with the counters zeroed just before and read just
   after each; their first 2 steps are run again on a CPU twin from the same
   weights and batches (the same QuantumNAT noise) and held against it. The
   HDCE, SC and n=6 QSC write their checkpoints under ``build/chip_smoke/``;
7. eval: ``python -m qdml_tpu_torch.cli eval`` over those checkpoints (the
   SNR sweep 5..15 dB, batch 200, test_len 2000 per point, cut from the
   reference's 10000 for time), results under ``build/chip_smoke/``, counters
   zeroed before and read after; one SNR point's per-batch sums are held
   against the same per-batch function on the CPU with the same weights and
   the same test batches;
8. times: each kernel and its plain version at its path's shapes (CUDA
   events), each kernel's device time per launch (torch profiler) over batch
   sizes, each bucket's ``infer`` latency and each trainer's step time with
   its forward/backward/update split (host clock).

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX, and
writes only under ``build/``.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 2026
BUCKETS = (1, 8, 64)
REQUEST_SIZES = (1, 5, 64, 100)
SERVE_BATCH = 64
# training: samples per (scenario, user) cell, cut from the reference's
# 20000 for time only; 256 rows per cell and step, as the reference
TRAIN_DATA_LEN = 2048
TRAIN_BATCH = 256
TWIN_STEPS = 2
DEVICE = "cuda"
# eval: the trainers' checkpoints and the sweep's results, under build/
EVAL_WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
# test samples per SNR point, cut from the reference's 10000 for time only
EVAL_TEST_LEN = 2000
# the trainers whose checkpoints the eval phase restores
EVAL_TRAINERS = ("hdce", "sc", "qsc_n6_pallas")
# the rotation-layer kernel's timed shape, and the unitary kernel's (the microbench's)
ROT_N, UNI_N, WIDE_BATCH = 8, 6, 2304
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and fp32 non-tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def qsc_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (angles in, U re/im in, <Z> out, each once) and flops of one QSC call."""
    dim = 1 << n
    bytes_moved = 4 * (batch * n + 2 * dim * dim + batch * n)
    flops = batch * dim * n + 4 * batch * dim * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def adjoint_work(batch: int, n: int, layers: int) -> tuple[float, float]:
    """Bytes (final state, cotangent, angles and gate table in; dangles and
    dweights out, each once) and flops of one adjoint call: the cotangent's
    start (n + 3 per amplitude), 64 flops per amplitude pair per wire per
    layer (two gradient terms and two rotations undone on psi and lambda),
    and the embedding cotangent as the function needs it, the backward pass
    of the product-state build (``qdml_tpu/quantum/statevector.py:161``):
    about 2 per amplitude to rebuild it and 8 for its backward. The kernel
    itself spends n + 2 per amplitude per wire there, which is not counted."""
    dim = 1 << n
    bytes_moved = 4 * (2 * batch * dim + 2 * batch * n + layers * n * 4 + batch * n + layers * n * 2)
    flops = batch * (dim * (n + 3) + 32 * layers * n * dim + 10 * dim)
    return bytes_moved, flops


def circuit_work(batch: int, n: int, layers: int) -> tuple[float, float]:
    """Bytes (angles and gate table in, <Z> out) and flops of one circuit call
    without the final state: embedding, 24 flops per amplitude pair per wire
    per layer (RY then RZ), and the <Z> contraction."""
    dim = 1 << n
    bytes_moved = 4 * (batch * n + layers * n * 4 + batch * n)
    flops = batch * dim * n + 12 * batch * layers * n * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def rotation_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (the state's re and im in and out, the gate table in, each once)
    and flops of one rotation layer: about 12 per amplitude per wire (RY's
    two real 2x2 products, 6 flops a component pair, and RZ's complex phase,
    6 more)."""
    dim = 1 << n
    bytes_moved = 4 * (4 * batch * dim + 4 * n)
    flops = 12 * batch * dim * n
    return bytes_moved, flops


def unitary_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (psi re and im and U re and im in, <Z> out, each once) and flops
    of one unitary call, counted as the least the function needs: three real
    B x 2^n x 2^n products (Gauss's trick, as the TPU kernel does it), |c|^2
    (3 per amplitude) and the sign contraction (2n per amplitude)."""
    dim = 1 << n
    bytes_moved = 4 * (2 * batch * dim + 2 * dim * dim + batch * n)
    flops = 3 * 2 * batch * dim * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def event_ms(torch, fn, reps: int = 25, inner: int = 20) -> float:
    """Median over ``reps`` of the per-call device time of ``inner`` back-to-back
    calls, bracketed by CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 20) -> tuple[float, float]:
    """Median and minimum host-clock milliseconds of ``fn`` over ``reps``
    calls, each ended by a device synchronisation, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return statistics.median(lat), min(lat)


def profiled_device_us(torch, fn, kernel: str, calls: int = 20) -> float | None:
    """Mean device time of ``kernel`` per launch over ``calls`` calls of ``fn``,
    read from the torch profiler's CUDA trace; None when the trace holds no
    device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total += getattr(evt, "device_time_total", 0.0) or getattr(evt, "cuda_time_total", 0.0)
            count += evt.count
    return total / count if count and total > 0 else None


def device_sweep(torch, K, circuits, card: str) -> None:
    """Each kernel's device time per launch (profiler) over batch sizes, at
    the serving qubit counts and the circuit kernel's largest: shows whether
    a kernel's time follows its work or is fixed per block."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    for n in (6, 8):
        w = torch.tensor(rng.uniform(0, 2 * np.pi, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3)
        ur, ui = u.re.contiguous(), u.im.contiguous()
        for b in (1, 64, 4096):
            a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
            us = profiled_device_us(torch, lambda: K.fused_qsc_expvals(a, ur, ui, n), "qsc_expvals_kernel")
            log(f"device sweep qsc_expvals n={n} B={b}: {us} us per launch [{card}]")
    for n in (8, 12):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        for b in (1, 64, 4096):
            a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
            us = profiled_device_us(torch, lambda: K.fused_circuit_expvals(a, w, n, 3), "circuit_expvals_kernel")
            log(f"device sweep circuit_expvals n={n} L=3 B={b}: {us} us per launch [{card}]")
    from qdml_tpu_torch.utils.complexops import CArr

    for n in (8, 14):
        w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
        for b in (1, 64, 2304):
            psi = CArr(torch.randn(b, 1 << n, device=dev), torch.randn(b, 1 << n, device=dev))
            us = profiled_device_us(torch, lambda: K.apply_rotation_layer(psi, w, n), "rotation_layer_kernel")
            log(f"device sweep rotation_layer n={n} B={b}: {us} us per launch [{card}]")
    for n in (6, 10):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3)
        for b in (1, 64, 2304):
            psi = CArr(torch.randn(b, 1 << n, device=dev), torch.randn(b, 1 << n, device=dev))
            us = profiled_device_us(torch, lambda: K.fused_unitary_expvals(psi, u, n), "unitary_expvals_kernel")
            log(f"device sweep unitary_expvals n={n} B={b}: {us} us per launch [{card}]")


def check_kernels(torch, K, circuits) -> dict[str, float]:
    """Each kernel against its plain version on the card; returns the largest
    absolute error seen per kernel. Raises on any mismatch."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in K.KERNELS}

    def close(name, got, want, rtol, atol, what):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        worst[name] = max(worst[name], err)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{name} {what}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
        return err

    # QSC: rtol 1e-4 / atol 1e-5, as tests/test_pallas.py:33 holds the TPU kernel
    for n in (4, 6, 8):
        w = torch.tensor(rng.uniform(0, 2 * np.pi, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3)
        ur, ui = u.re.contiguous(), u.im.contiguous()
        for b in (1, 37, 64, 4096):
            a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
            got = K.fused_qsc_expvals(a, ur, ui, n)
            want = K.qsc_expvals_plain(a, ur, ui, n)
            close("qsc_expvals", got, want, 1e-4, 1e-5, f"n={n} B={b}")
        # gradients through the kernel's autograd.Function vs the plain version
        a = torch.tensor(rng.uniform(-1, 1, (37, n)), dtype=torch.float32, device=dev)
        g = torch.tensor(rng.standard_normal((37, n)), dtype=torch.float32, device=dev)
        grads = []
        for fn in (K.fused_qsc_expvals, K.qsc_expvals_plain):
            xs = [t.clone().requires_grad_(True) for t in (a, ur, ui)]
            (fn(*xs, n) * g).sum().backward()
            grads.append([t.grad for t in xs])
        for k, (gk, gp) in enumerate(zip(*grads)):
            close("qsc_expvals", gk, gp, 1e-4, 1e-5, f"n={n} grad of input {k}")
        log(f"check qsc_expvals n={n}: ok")

    # circuit: atol 2e-5 — fp32 rounding over 2nL gate updates taken in
    # another order (and with fused multiply-adds) than the plain version's
    for n in (3, 7, 8, 10, 12):
        for layers in (1, 3):
            w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32, device=dev)
            for b in (1, 37, 64, 4096):
                b = min(b, max(1, (1 << 20) >> n))  # cap B * 2^n at 2^20 amplitudes
                a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
                ev, fre, fim = K.fused_circuit_expvals(a, w, n, layers, return_state=True)
                pev, pre, pim = K.circuit_expvals_plain(a, w, n, layers)
                for got, want, what in ((ev, pev, "<Z>"), (fre, pre, "re"), (fim, pim, "im")):
                    close("circuit_expvals", got, want, 0.0, 2e-5, f"n={n} L={layers} B={b} {what}")
                ev_only = K.fused_circuit_expvals(a, w, n, layers)
                close("circuit_expvals", ev_only, pev, 0.0, 2e-5, f"n={n} L={layers} B={b} no-state")
        log(f"check circuit_expvals n={n}: ok")

    # adjoint: atol 2e-5 of the largest cotangent plus 1e-6 — fp32 rounding
    # over 2nL rotations undone and a batch sum taken in another order
    for n in (2, 4, 6, 8, 10, 12):
        ratio = 0.0
        for layers in (1, 3, 5):
            w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32, device=dev)
            for b in (1, 64, 2304):
                a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
                g = torch.tensor(rng.standard_normal((b, n)), dtype=torch.float32, device=dev)
                _, fre, fim = K.fused_circuit_expvals(a, w, n, layers, return_state=True)
                got = K.circuit_adjoint(fre, fim, g, a, w, n, layers)
                want = K.circuit_adjoint_plain(fre, fim, g, a, w, n, layers)
                refs = [want]
                if b <= 64:  # autograd keeps every gate's state: small batches only
                    xs = [t.clone().requires_grad_(True) for t in (a, w)]
                    (K.circuit_expvals_plain(*xs, n, layers)[0] * g).sum().backward()
                    refs.append([t.grad for t in xs])
                for ref in refs:
                    for x, y, what in zip(got, ref, ("dangles", "dweights")):
                        tol = 2e-5 * y.abs().max().item() + 1e-6
                        err = close("circuit_adjoint", x, y, 0.0, tol, f"n={n} L={layers} B={b} {what}")
                        ratio = max(ratio, err / tol)
        log(f"check circuit_adjoint n={n}: ok, largest error {100 * ratio:.1f}% of its tolerance "
            f"(2e-5 * max|ref| + 1e-6; against the plain adjoint and autograd of the plain forward)")

    from qdml_tpu_torch.quantum import statevector as sv
    from qdml_tpu_torch.utils.complexops import CArr

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def embedded(b, n):
        a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
        return circuits.angle_embed(sv.zero_state(n, (b,), device=dev), a, n)

    # rotation layer: atol 2e-6 of the largest amplitude, fp32 rounding of 2n
    # gate updates (fused multiply-adds in the kernel, rounded products in
    # the plain version), on unnormalised random states and embedded ones
    for n in (1, 3, 6, 7, 8, 12, 14):
        w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
        for b in (1, 11, 64, 2304):
            for kind, psi in (("random", CArr(randn(b, 1 << n), randn(b, 1 << n))), ("embedded", embedded(b, n))):
                got = K.apply_rotation_layer(psi, w, n)
                want = K.rotation_layer_plain(psi.re, psi.im, w, n)
                tol = 2e-6 * max(want.re.abs().max().item(), want.im.abs().max().item())
                for x, y, what in ((got.re, want.re, "re"), (got.im, want.im, "im")):
                    close("rotation_layer", x, y, 0.0, tol, f"n={n} B={b} {kind} {what}")
        log(f"check rotation_layer n={n}: ok")

    # unitary: atol 5e-6 on unit-norm states, fp32 sums over 2^n terms (each
    # a 2^n-term product) taken in another order than the plain matmuls'
    for n in (1, 2, 4, 6, 8, 10, 12):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3) if n >= 2 else circuits.rot_gate(w[0, 0, 0], w[0, 0, 1])
        for b in (1, 9, 64, 2304):
            re, im = randn(b, 1 << n), randn(b, 1 << n)
            norm = torch.sqrt((re * re + im * im).sum(-1, keepdim=True))
            for kind, psi in (("random", CArr(re / norm, im / norm)), ("embedded", embedded(b, n))):
                got = K.fused_unitary_expvals(psi, u, n)
                want = K.unitary_expvals_plain(psi.re, psi.im, u.re, u.im, n)
                close("unitary_expvals", got, want, 0.0, 5e-6, f"n={n} B={b} {kind}")
        log(f"check unitary_expvals n={n}: ok")

    # both backwards are autograd through the plain versions: the same values
    for n in (3, 8):
        psi = CArr(randn(37, 1 << n), randn(37, 1 << n))
        w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
        g_re, g_im = randn(37, 1 << n), randn(37, 1 << n)
        grads = []
        for fn in (lambda p, w_: K.apply_rotation_layer(p, w_, n),
                   lambda p, w_: K.rotation_layer_plain(p.re, p.im, w_, n)):
            xs = [t.clone().requires_grad_(True) for t in (psi.re, psi.im, w)]
            out = fn(CArr(xs[0], xs[1]), xs[2])
            (out.re * g_re + out.im * g_im).sum().backward()
            grads.append([t.grad for t in xs])
        for k, (gk, gp) in enumerate(zip(*grads)):
            close("rotation_layer", gk, gp, 1e-5, 1e-6, f"n={n} grad of input {k}")
    for n in (2, 6):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3)
        ins = (randn(37, 1 << n), randn(37, 1 << n), u.re.contiguous(), u.im.contiguous())
        g = randn(37, n)
        grads = []
        for fn in (lambda a, b, c, d: K.fused_unitary_expvals(CArr(a, b), CArr(c, d), n),
                   lambda a, b, c, d: K.unitary_expvals_plain(a, b, c, d, n)):
            xs = [t.clone().requires_grad_(True) for t in ins]
            (fn(*xs) * g).sum().backward()
            grads.append([t.grad for t in xs])
        for k, (gk, gp) in enumerate(zip(*grads)):
            close("unitary_expvals", gk, gp, 1e-5, 1e-6, f"n={n} grad of input {k}")
    log("check rotation_layer and unitary_expvals gradients: ok")

    # outside their windows both wrappers raise before any launch
    for n in (0, 15):
        z = CArr(torch.zeros(1, 1 << n, device=dev), torch.zeros(1, 1 << n, device=dev))
        try:
            K.apply_rotation_layer(z, torch.zeros(max(n, 1), 2, device=dev), n)
        except ValueError:
            pass
        else:
            raise AssertionError(f"rotation_layer accepted n={n}")
    for n in (0, 13):
        z = CArr(torch.zeros(1, 1 << n, device=dev), torch.zeros(1, 1 << n, device=dev))
        u = CArr(torch.empty(1 << n, 1 << n, device=dev), torch.empty(1 << n, 1 << n, device=dev))
        try:
            K.fused_unitary_expvals(z, u, n)
        except ValueError:
            pass
        else:
            raise AssertionError(f"unitary_expvals accepted n={n}")
    log("check out-of-window n raises (rotation_layer n=0, 15; unitary_expvals n=0, 13): ok")
    return worst


def serve(torch, K, cfg_mod, engine_mod, hdce_mod, qsc_mod):
    """Build the three engines on the card and on the CPU, drive the card's
    through the request sizes with the launch counters zeroed, and hold every
    answer against the CPU twin. Returns per-kernel launches, the engines and
    the requests."""
    from dataclasses import replace

    base = cfg_mod.ExperimentConfig()
    variants = {
        "qsc_n6_pallas": (replace(base, quantum=replace(base.quantum, n_qubits=6, n_layers=3, impl="pallas")), True),
        "qsc_n8_pallas_circuit": (replace(base, quantum=replace(base.quantum, n_qubits=8, n_layers=3, impl="pallas_circuit")), True),
        "sc_classical": (base, False),
    }
    gen = torch.Generator().manual_seed(SEED)
    hdce_sd = hdce_mod.build_hdce(base, device="cpu", generator=gen).state_dict()
    engines = {}
    for name, (cfg, quantum) in variants.items():
        clf_sd = qsc_mod.build_classifier(cfg, quantum, device="cpu", generator=gen).state_dict()
        gpu = engine_mod.ServeEngine(cfg, hdce_sd, clf_sd, quantum=quantum, buckets=BUCKETS)
        cpu = engine_mod.ServeEngine(cfg, hdce_sd, clf_sd, quantum=quantum, buckets=BUCKETS, device="cpu")
        warm = gpu.warmup()
        cpu.warmup()
        log(f"engine {name}: warm {json.dumps(warm)}")
        engines[name] = (gpu, cpu)

    rng = np.random.default_rng(SEED + 1)
    hw = base.image_hw
    requests = {n: rng.standard_normal((n, *hw, 2)).astype(np.float32) for n in REQUEST_SIZES}

    # the main path: counters zeroed just before, read just after
    K.reset_launch_counts()
    answers = {}
    per_engine = {}
    for name, (gpu, _) in engines.items():
        before = dict(K.launches)
        answers[name] = {n: gpu.infer(x) for n, x in requests.items()}
        torch.cuda.synchronize()
        per_engine[name] = {k: K.launches[k] - before[k] for k in K.launches}
    launches = dict(K.launches)
    log(f"main-path launches per engine: {json.dumps(per_engine)}")
    if per_engine["qsc_n6_pallas"]["qsc_expvals"] == 0:
        raise AssertionError("the n=6 pallas engine never launched the QSC kernel")
    if per_engine["qsc_n8_pallas_circuit"]["circuit_expvals"] == 0:
        raise AssertionError("the n=8 pallas_circuit engine never launched the circuit kernel")
    for k in ("qsc_expvals", "circuit_expvals"):  # the serving path's kernels
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the serving path")

    for name, (gpu, cpu) in engines.items():
        for n, x in requests.items():
            h, pred, conf, info = answers[name][n]
            h_ref, pred_ref, conf_ref, _ = cpu.infer(x)
            if h.shape != (n, base.h_out_dim) or pred.shape != (n,) or conf.shape != (n,):
                raise AssertionError(f"{name} n={n}: shapes {h.shape} {pred.shape} {conf.shape}")
            if not (np.isfinite(h).all() and np.isfinite(conf).all()):
                raise AssertionError(f"{name} n={n}: non-finite output")
            with torch.inference_mode():
                logp = cpu.clf(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
            top2 = np.sort(logp, axis=-1)[:, -2:]
            sure = (top2[:, 1] - top2[:, 0]) > 1e-4
            if not np.array_equal(pred[sure], pred_ref[sure]):
                raise AssertionError(f"{name} n={n}: routed scenario differs from the CPU engine")
            same = pred == pred_ref
            tol = 1e-4 * np.abs(h_ref).max() + 1e-5
            err = np.abs(h[same] - h_ref[same]).max() if same.any() else 0.0
            if err > tol:
                raise AssertionError(f"{name} n={n}: |h - h_cpu| {err:.3e} > {tol:.3e}")
            cerr = np.abs(conf - conf_ref).max()
            if cerr > 1e-4:
                raise AssertionError(f"{name} n={n}: |conf - conf_cpu| {cerr:.3e}")
            log(
                f"serve {name} n={n}: bucket {info.bucket} chunks {info.chunks} "
                f"rows {info.rows}, max|h-h_cpu| {err:.3e} (tol {tol:.3e}), "
                f"routed rows agreeing {int(same.sum())}/{n}, sure {int(sure.sum())}"
            )
    return launches, engines, requests


def microbench(torch, K, card: str) -> dict[str, int]:
    """The port's circuit micro-benchmark at its full shape on the card, the
    counters zeroed just before and read just after; every row's <Z> within
    1e-5 of the ``dense`` row's. Returns the launches."""
    from qdml_tpu_torch.scripts import quantum_microbench as mb

    K.reset_launch_counts()
    res, outs = mb.run(mb.BATCH, DEVICE)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    ref = outs["dense"]
    for name, out in outs.items():
        err = (out - ref).abs().max().item()
        log(f"microbench fwd_{name}: {res[f'fwd_{name}_us']} us a call, {res[f'fwd_{name}_sps']} "
            f"samples/s (B={mb.BATCH}, n={mb.N}, L={mb.L}, mean of {mb.REPS}); max |<Z> - dense| "
            f"{err:.3e} (tol 1e-5) [{card}]")
        if out.shape != (mb.BATCH, mb.N) or not torch.isfinite(out).all() or err > 1e-5:
            raise AssertionError(f"microbench row {name}: shape {tuple(out.shape)}, max err {err:.3e}")
    log(f"microbench json: {json.dumps(res)}; launches {json.dumps(counts)}")
    if counts["unitary_expvals"] == 0 or counts["qsc_expvals"] == 0:
        raise AssertionError("the microbench never launched the unitary or the QSC kernel")
    return counts


def _cpu_batch(batch: dict) -> dict:
    from qdml_tpu_torch.utils.complexops import CArr

    return {k: CArr(v.re.cpu(), v.im.cpu()) if isinstance(v, CArr) else v.cpu() for k, v in batch.items()}


def evaluate(torch, K, mods, card: str) -> dict[str, int]:
    """``cli eval`` over the training phase's checkpoints, counters zeroed
    just before and read just after; then one SNR point's per-batch sums
    against the same per-batch function on the CPU (same weights, the same
    test batches drawn on the card and copied over): rtol 1e-4 (float32 sums
    in another order, cuDNN vs CPU convs), and the routed predictions equal
    wherever the top-two log-prob margin exceeds 1e-4. Returns the launches."""
    cli, cfg_mod = mods["cli"], mods["config"]
    from qdml_tpu_torch.data.baselines import beam_delay_profile
    from qdml_tpu_torch.data.channels import ChannelGeometry
    from qdml_tpu_torch.data.datasets import sweep_batch
    from qdml_tpu_torch.eval.sweep import batch_metrics, load_sweep_models

    overrides = [
        f"--train.workdir={EVAL_WORK / 'ws'}",
        f"--eval.results_dir={EVAL_WORK / 'results'}",
        f"--eval.test_len={EVAL_TEST_LEN}",
        "--quantum.n_qubits=6", "--quantum.n_layers=3", "--quantum.impl=pallas",
    ]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    if cli.main(["eval", *overrides]) != 0:
        raise AssertionError("cli eval failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    cfg = cfg_mod.from_args(overrides)
    workdir = cli.workdir_of(cfg)
    with open(EVAL_WORK / "results" / "quantum_classical_comparison.json") as fh:
        results = json.load(fh)
    curves, grid = results["nmse_db"], list(cfg.eval.snr_grid)
    if results["snr"] != grid or set(curves) != {"ls", "mmse", "mmse_oracle", "hdce_classical", "hdce_quantum"}:
        raise AssertionError(f"eval results: snr {results['snr']}, curves {sorted(curves)}")
    if not all(len(v) == len(grid) and np.isfinite(v).all() for v in curves.values()):
        raise AssertionError(f"eval results: non-finite or short curves {curves}")
    if not all(m < ls for m, ls in zip(curves["mmse"], curves["ls"])):
        raise AssertionError(f"eval: MMSE {curves['mmse']} not below LS {curves['ls']}")
    if set(results["acc"]) != {"classical", "quantum"}:
        raise AssertionError(f"eval accuracies: {results['acc']}")
    points = []
    with open(Path(workdir) / "eval.metrics.jsonl") as fh:
        points = [json.loads(line) for line in fh if '"snr_db"' in line][-len(grid):]
    log(f"eval: sweep over {len(grid)} SNR points of {EVAL_TEST_LEN} samples (cut from 10000 for time "
        f"only), batch {cfg.eval.batch_size}, wall {wall:.3f} s for the whole command; per point "
        f"{[round(r['seconds'], 4) for r in points]} s; launches {json.dumps(counts)} [{card}]")
    if counts["qsc_expvals"] == 0:
        raise AssertionError("eval never launched the QSC kernel (impl pallas)")

    # the CPU twin of one SNR point, over the models eval itself restores
    models = {}
    for dev in (DEVICE, "cpu"):
        cfg, models[dev] = load_sweep_models(cfg, workdir, dev)
    geom = ChannelGeometry.from_config(cfg.data)
    profile = beam_delay_profile(geom, device=DEVICE)
    snr, bs = float(grid[-1]), cfg.eval.batch_size
    worst, skipped = 0.0, 0
    with torch.inference_mode():
        for b in range(EVAL_TEST_LEN // bs):
            batch = sweep_batch(cfg.data, cfg.data.data_len * 3, b * bs, bs, snr, DEVICE, geom)
            got = batch_metrics(models[DEVICE], batch, snr, profile, geom)
            cb = _cpu_batch(batch)
            want = batch_metrics(models["cpu"], cb, snr, profile.cpu(), geom)
            x = batch["yp_img"].permute(0, 3, 1, 2).contiguous()
            routed_alike = {}
            for name, key in (("sc", "classical"), ("qsc", "quantum")):
                pred = getattr(models[DEVICE], name)(x).argmax(-1).cpu().numpy()
                logp = getattr(models["cpu"], name)(x.cpu()).numpy()
                top2 = np.sort(logp, axis=-1)[:, -2:]
                sure = (top2[:, 1] - top2[:, 0]) > 1e-4
                if not np.array_equal(pred[sure], logp.argmax(-1)[sure]):
                    raise AssertionError(f"eval twin batch {b}: {name} predictions differ on sure rows")
                routed_alike[key] = bool(np.array_equal(pred, logp.argmax(-1)))
            for key, value in want.items():
                if key.endswith(("_classical", "_quantum")) and not routed_alike[key.rsplit("_", 1)[1]]:
                    skipped += 1  # a near-tie row routed the other way: a different sum, not an error
                    continue
                g, w_ = float(got[key]), float(value)
                rel = abs(g - w_) / max(abs(w_), 1e-30)
                worst = max(worst, rel)
                if rel > 1e-4:
                    raise AssertionError(f"eval twin batch {b} {key}: card {g} vs CPU {w_} (rel {rel:.2e})")
    log(f"eval twin at {snr:g} dB over {EVAL_TEST_LEN // bs} batches: per-batch sums within rel "
        f"{worst:.3e} of the CPU's (rtol 1e-4); {skipped} sums skipped for near-tie routing")
    return counts


class Recorder:
    """Keeps what a trainer logs (each step's loss at print_freq 1)."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, step=None, **values) -> None:
        self.records.append({"step": step, **values})


def trainer_configs(cfg_mod):
    """The four trainers at full width: (config, quantum) with quantum None
    for the HDCE."""
    from dataclasses import replace

    base = cfg_mod.ExperimentConfig()
    base = replace(
        base,
        data=replace(base.data, data_len=TRAIN_DATA_LEN),
        train=replace(base.train, batch_size=TRAIN_BATCH, n_epochs=1, print_freq=1),
    )
    q = base.quantum
    return {
        "hdce": (base, None),
        "sc": (base, False),
        "qsc_n6_pallas": (replace(base, quantum=replace(
            q, n_qubits=6, n_layers=3, impl="pallas", use_quantumnat=True, noise_level=0.01)), True),
        "qsc_n8_pallas_circuit": (replace(base, quantum=replace(
            q, n_qubits=8, n_layers=3, impl="pallas_circuit", use_gradient_pruning=True,
            gradient_prune_mode="quantile", gradient_threshold=0.5)), True),
    }


def trainee(mods, cfg, quantum, device, steps_per_epoch):
    """The trainer's own model and optimizer (``make_trainer``), and its step
    ``step(batch, noise) -> {"loss": ...}``."""
    if quantum is None:
        model, opt = mods["hdce"].make_trainer(cfg, device, steps_per_epoch)
        return model, opt, lambda b, eps: mods["hdce"].hdce_train_step(model, opt, b)
    model, opt = mods["qsc"].make_trainer(cfg, quantum, device, steps_per_epoch)
    return model, opt, lambda b, eps: mods["qsc"].classifier_train_step(model, opt, b, noise=eps)


def cpu_twin(torch, mods, name, cfg, quantum, batches, steps_per_epoch) -> None:
    """The first steps on the card and on the CPU from the same weights,
    batches and QuantumNAT noise. Losses: rtol 1e-4 (fp32 sums over 2304 rows
    in another order). The circuit weights' gradient of the first backward
    (before pruning), where the circuit kernels' autograd lands: within
    1e-4 max|g| + 1e-7 of the twin's, since Adam's first update is
    lr * sign(g) and hides a wrong magnitude from the parameters.
    Parameters: within 1e-5 + 1e-4 |p| except where a gradient is
    rounding-dominated, which Adam turns into up to lr per step either way
    (the last layer's RZ weights, whose gradient is zero, and entries at the
    pruning cutoff); every entry within that bound, and at most 1% of entries
    outside the tight one."""
    qcfg = cfg.quantum
    gen = torch.Generator().manual_seed(SEED + 5)
    noises = [
        qcfg.noise_level * torch.randn((qcfg.n_layers, qcfg.n_qubits, 2), generator=gen)
        if quantum and qcfg.use_quantumnat else None
        for _ in batches
    ]
    runs = []
    for dev in (DEVICE, "cpu"):
        model, opt, step = trainee(mods, cfg, quantum, dev, steps_per_epoch)
        grads = []
        if quantum:  # the leaf's gradient as autograd delivers it, copied before pruning edits .grad in place
            hook = model.qlayer.weights.register_hook(lambda g: grads.append(g.detach().to("cpu", copy=True)))
        losses = []
        for b, eps in zip(batches, noises):
            b = {k: v.to(dev) for k, v in b.items()}
            losses.append(float(step(b, None if eps is None else eps.to(dev))["loss"]))
        if quantum:
            hook.remove()
        runs.append((losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}, grads))
    (gl, gp, gg), (cl, cp, cg) = runs
    if not np.allclose(gl, cl, rtol=1e-4, atol=0.0):
        raise AssertionError(f"train {name}: losses {gl} on the card, {cl} on the CPU twin")
    if quantum:
        gtol = 1e-4 * cg[0].abs().max().item() + 1e-7
        gerr = (gg[0] - cg[0]).abs().max().item()
        log(f"train {name}: circuit weights' first gradient, card vs CPU twin: max |diff| {gerr:.3e} "
            f"(tol 1e-4 max|g| + 1e-7 = {gtol:.3e}; max|g| {cg[0].abs().max().item():.3e})")
        if gerr > gtol:
            raise AssertionError(f"train {name}: circuit weights' gradient differs from the CPU twin")
    lr = cfg.train.lr
    bound = 1.1 * TWIN_STEPS * lr + 1e-5
    worst, outside, total = 0.0, 0, 0
    for k, want in cp.items():
        if not want.is_floating_point():
            continue
        diff = (gp[k] - want).abs()
        worst = max(worst, diff.max().item())
        outside += int((diff > 1e-5 + 1e-4 * want.abs()).sum())
        total += want.numel()
    log(f"train {name}: CPU twin over {TWIN_STEPS} steps: losses card {gl}, cpu {cl} (rtol 1e-4); "
        f"params max |diff| {worst:.3e} (bound {bound:.1e}), {outside}/{total} entries outside "
        f"1e-5 + 1e-4|p| (at most 1%)")
    if worst > bound or outside > 0.01 * total:
        raise AssertionError(f"train {name}: parameters differ from the CPU twin")


def train(torch, K, mods, card: str):
    """The training phase: per trainer, the CPU twin, then the main path with
    the launch counters zeroed just before and read just after, then its
    step times. Returns the launches summed over the trainers and the
    circuit_adjoint launches per training step."""
    data_cfg = trainer_configs(mods["config"])["hdce"][0].data
    t0 = time.perf_counter()
    data = mods["datasets"].GridData.synthesize(data_cfg, DEVICE)
    torch.cuda.synchronize()
    log(f"train data: {data_cfg.data_len} samples per cell (cut from 20000 for time only), "
        f"synthesized on the card in {time.perf_counter() - t0:.2f} s")
    loader = mods["datasets"].DMLGridLoader(data, TRAIN_BATCH, "train")
    spe = loader.steps_per_epoch
    batches = [
        {k: b[k] for k in ("yp_img", "h_label", "h_perf", "indicator")}
        for _, b in zip(range(TWIN_STEPS), loader.epoch(0))
    ]
    launches = {k: 0 for k in K.launches}
    per_step_adjoint = None
    shutil.rmtree(EVAL_WORK, ignore_errors=True)
    for name, (cfg, quantum) in trainer_configs(mods["config"]).items():
        cpu_twin(torch, mods, name, cfg, quantum, batches, spe)

        # the eval phase's checkpoints (cli eval's workdir scheme)
        workdir = mods["cli"].workdir_of(mods["config"].from_args([f"--train.workdir={EVAL_WORK / 'ws'}"]))
        workdir = workdir if name in EVAL_TRAINERS else None
        rec = Recorder()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        if quantum is None:
            _, hist = mods["hdce"].train_hdce(cfg, data=data, logger=rec, workdir=workdir)
        else:
            _, hist = mods["qsc"].train_classifier(cfg, quantum, data=data, logger=rec, workdir=workdir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launches)
        for k in launches:
            launches[k] += counts[k]
        steps = [r["loss"] for r in rec.records if "loss" in r]
        log(f"train {name}: one epoch ({len(steps)} steps of {cfg.data.n_scenarios * cfg.data.n_users * TRAIN_BATCH} "
            f"rows) + validation in {wall:.2f} s; step losses {[round(x, 5) for x in steps]}; "
            f"history {json.dumps(hist)}; launches {json.dumps(counts)}")
        if len(steps) != spe or not all(np.isfinite(steps)):
            raise AssertionError(f"train {name}: step losses {steps}")
        if not all(np.isfinite(v).all() for v in hist.values()):
            raise AssertionError(f"train {name}: non-finite history {hist}")
        if quantum is None and not steps[-1] < steps[0]:
            raise AssertionError(f"train hdce: last step loss {steps[-1]} not below the first {steps[0]}")
        if name == "qsc_n6_pallas" and counts["qsc_expvals"] == 0:
            raise AssertionError("the pallas trainer never launched the QSC kernel")
        if name == "qsc_n8_pallas_circuit":
            if counts["circuit_expvals"] == 0 or counts["circuit_adjoint"] == 0:
                raise AssertionError("the pallas_circuit trainer never launched the circuit kernels")
            per_step_adjoint = counts["circuit_adjoint"] / spe

        # step time and its split, on a fresh model: forward (loss), backward, update
        saved = dict(K.launches)
        model, opt, _ = trainee(mods, cfg, quantum, DEVICE, spe)
        b = {k: v for k, v in batches[0].items()}
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        parts = {"forward": [], "backward": [], "update": []}
        for i in range(13):
            marks = [time.perf_counter()]
            if quantum is None:
                loss, _ = mods["hdce"].hdce_loss(model.train(), b)
            else:
                loss = mods["qsc"].classifier_loss(model, b, generator=gen)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            opt.zero_grad()
            loss.backward()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            opt.step()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if i >= 3:  # after warm-up
                for part, t_a, t_b in zip(parts, marks, marks[1:]):
                    parts[part].append((t_b - t_a) * 1e3)
        K.launches.update(saved)  # timing launches are not main-path launches
        med = {k: statistics.median(v) for k, v in parts.items()}
        log(f"time train step {name}: median {sum(med.values()):.4f} ms = forward {med['forward']:.4f} "
            f"+ backward {med['backward']:.4f} + update {med['update']:.4f} ms (host clock, synchronized "
            f"after each part, 10 steps of {cfg.data.n_scenarios * cfg.data.n_users * TRAIN_BATCH} rows) [{card}]")
    log(f"main-path training launches: {json.dumps(launches)}; circuit_adjoint per training step "
        f"{per_step_adjoint}")
    return launches, per_step_adjoint


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2

    from qdml_tpu_torch import cli
    from qdml_tpu_torch import config as cfg_mod
    from qdml_tpu_torch.data import datasets
    from qdml_tpu_torch.models import qsc as qsc_mod
    from qdml_tpu_torch.quantum import circuits
    from qdml_tpu_torch.quantum import kernels as K
    from qdml_tpu_torch.serve import engine as engine_mod
    from qdml_tpu_torch.train import hdce as hdce_mod
    from qdml_tpu_torch.train import qsc as train_qsc
    from qdml_tpu_torch.utils.device import resolve_device

    resolve_device()  # float32 matmuls and convs (no TF32)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    secs = K.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} wall {time.perf_counter() - t0:.2f} s")
    for name, text in K.build_log.items():
        for line in text.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line or "smem" in line):
                log(f"ptxas {name}: {line.strip()}")

    K.reset_launch_counts()
    worst = check_kernels(torch, K, circuits)
    kernel_phase = dict(K.launches)
    launches, engines, requests = serve(torch, K, cfg_mod, engine_mod, hdce_mod, qsc_mod)
    micro_launches = microbench(torch, K, card)
    mods = {"config": cfg_mod, "datasets": datasets, "hdce": hdce_mod, "qsc": train_qsc, "cli": cli}
    train_launches, adjoint_per_step = train(torch, K, mods, card)
    eval_launches = evaluate(torch, K, mods, card)
    launches = {
        k: launches[k] + micro_launches[k] + train_launches[k] + eval_launches[k] for k in launches
    }
    # No entry point reaches B.3 (the JAX package runs its kernel only from
    # tests/test_pallas.py:65-83), so its path is the kernel phase.
    launches["rotation_layer"] = kernel_phase["rotation_layer"]
    log(f"launches on each kernel's path: {json.dumps(launches)}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched on its path")

    # times at the serving shapes, plain version beside each kernel
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    a6 = torch.tensor(rng.uniform(-1, 1, (SERVE_BATCH, 6)), dtype=torch.float32, device=dev)
    w6 = torch.tensor(rng.uniform(0, 2 * np.pi, (3, 6, 2)), dtype=torch.float32, device=dev)
    u6 = circuits.ansatz_unitary(w6, 6, 3)
    ur, ui = u6.re.contiguous(), u6.im.contiguous()
    a8 = torch.tensor(rng.uniform(-1, 1, (SERVE_BATCH, 8)), dtype=torch.float32, device=dev)
    w8 = torch.tensor(rng.uniform(0, 2 * np.pi, (3, 8, 2)), dtype=torch.float32, device=dev)
    saved = dict(K.launches)
    with torch.inference_mode():
        qsc_ms = event_ms(torch, lambda: K.fused_qsc_expvals(a6, ur, ui, 6))
        qsc_plain_ms = event_ms(torch, lambda: K.qsc_expvals_plain(a6, ur, ui, 6))
        circ_ms = event_ms(torch, lambda: K.fused_circuit_expvals(a8, w8, 8, 3))
        circ_plain_ms = event_ms(torch, lambda: K.circuit_expvals_plain(a8, w8, 8, 3))
        # the adjoint at the training shape (n=8, L=3, 2304 rows a step) and at
        # B=64; every event timing runs before the first profiler session
        adj = {}
        for b in (TRAIN_BATCH * 9, SERVE_BATCH):
            a = torch.tensor(rng.uniform(-1, 1, (b, 8)), dtype=torch.float32, device=dev)
            g = torch.tensor(rng.standard_normal((b, 8)), dtype=torch.float32, device=dev)
            _, fre, fim = K.fused_circuit_expvals(a, w8, 8, 3, return_state=True)
            args = (fre, fim, g, a, w8, 8, 3)
            adj[b] = {
                "args": args,
                "ms": event_ms(torch, lambda: K.circuit_adjoint(*args)),
                "plain_ms": event_ms(torch, lambda: K.circuit_adjoint_plain(*args), reps=5, inner=2),
                "bound": bound(*adjoint_work(b, 8, 3)),
            }

        # the rotation layer at n=8, B=2304 and the unitary kernel at the
        # microbench's n=6, B=2304, with the complex product alone beside it
        from qdml_tpu_torch.utils.complexops import CArr

        r_re = torch.tensor(rng.standard_normal((WIDE_BATCH, 1 << ROT_N)), dtype=torch.float32, device=dev)
        r_im = torch.tensor(rng.standard_normal((WIDE_BATCH, 1 << ROT_N)), dtype=torch.float32, device=dev)
        w_l = torch.tensor(rng.uniform(-3, 3, (ROT_N, 2)), dtype=torch.float32, device=dev)
        rot_args = (CArr(r_re, r_im), w_l, ROT_N)
        rot = {
            "ms": event_ms(torch, lambda: K.apply_rotation_layer(*rot_args)),
            "plain_ms": event_ms(torch, lambda: K.rotation_layer_plain(r_re, r_im, w_l, ROT_N), reps=10, inner=5),
            "bound": bound(*rotation_work(WIDE_BATCH, ROT_N)),
        }
        p_re = torch.tensor(rng.standard_normal((WIDE_BATCH, 1 << UNI_N)), dtype=torch.float32, device=dev)
        p_im = torch.tensor(rng.standard_normal((WIDE_BATCH, 1 << UNI_N)), dtype=torch.float32, device=dev)
        uni_psi, uni_u = CArr(p_re, p_im), CArr(u6.re.contiguous(), u6.im.contiguous())
        psi_c, ut_c = torch.complex(p_re, p_im), torch.complex(u6.re, u6.im).T.contiguous()
        uni = {
            "ms": event_ms(torch, lambda: K.fused_unitary_expvals(uni_psi, uni_u, UNI_N)),
            "plain_ms": event_ms(torch, lambda: K.unitary_expvals_plain(p_re, p_im, uni_u.re, uni_u.im, UNI_N)),
            "matmul_ms": event_ms(torch, lambda: torch.matmul(psi_c, ut_c)),
            "bound": bound(*unitary_work(WIDE_BATCH, UNI_N)),
        }

    for name, (gpu, _) in engines.items():
        for b in BUCKETS:
            x = requests[64][:b]
            med, low = host_ms(torch, lambda: gpu.infer(x))
            log(f"time infer {name} bucket {b}: median {med:.4f} ms, min {low:.4f} ms over 20 [{card}]")
        # where one bucket-64 forward goes: the classifier (with its circuit),
        # then all trunks and the head
        xt = torch.from_numpy(requests[64]).to(dev).permute(0, 3, 1, 2).contiguous()
        xs = xt.expand(gpu.cfg.data.n_scenarios, *xt.shape)
        with torch.inference_mode():
            clf_ms, _ = host_ms(torch, lambda: gpu.clf(xt))
            hdce_ms, _ = host_ms(torch, lambda: gpu.hdce(xs))
        log(f"time forward parts {name} bucket 64: classifier {clf_ms:.4f} ms, trunks+head {hdce_ms:.4f} ms (medians) [{card}]")
    with torch.inference_mode():
        u_ms, _ = host_ms(torch, lambda: circuits.ansatz_unitary(w6, 6, 3))
    log(f"time ansatz_unitary n=6 L=3 (rebuilt by impl pallas on every call): median {u_ms:.4f} ms [{card}]")

    # device times last: a profiler session can slow the host's launches after it
    with torch.inference_mode():
        qsc_dev_us = profiled_device_us(torch, lambda: K.fused_qsc_expvals(a6, ur, ui, 6), "qsc_expvals_kernel")
        circ_dev_us = profiled_device_us(torch, lambda: K.fused_circuit_expvals(a8, w8, 8, 3), "circuit_expvals_kernel")
        for t in adj.values():
            t["device_us"] = profiled_device_us(
                torch, lambda: K.circuit_adjoint(*t["args"]), "circuit_adjoint_kernel"
            )
        rot["device_us"] = profiled_device_us(torch, lambda: K.apply_rotation_layer(*rot_args), "rotation_layer_kernel")
        uni["device_us"] = profiled_device_us(
            torch, lambda: K.fused_unitary_expvals(uni_psi, uni_u, UNI_N), "unitary_expvals_kernel"
        )
        device_sweep(torch, K, circuits, card)
        after = event_ms(torch, lambda: K.circuit_adjoint(*adj[SERVE_BATCH]["args"]))
    K.launches.update(saved)  # timing launches are not main-path launches
    for name, us in (("qsc_expvals_kernel", qsc_dev_us), ("circuit_expvals_kernel", circ_dev_us)):
        shown = f"{us:.3f} us per launch" if us is not None else "not measured (no device time in the trace)"
        log(f"profiler device time {name}: {shown} [{card}]")
    log(f"time qsc_expvals n=6 B={SERVE_BATCH}: kernel {qsc_ms:.5f} ms, plain {qsc_plain_ms:.5f} ms [{card}]")
    log(f"time circuit_expvals n=8 L=3 B={SERVE_BATCH}: kernel {circ_ms:.5f} ms, plain {circ_plain_ms:.5f} ms [{card}]")
    for b, t in adj.items():
        us = t["device_us"]
        shown = f"{us:.3f} us" if us is not None else "not measured (no device time in the trace)"
        log(f"time circuit_adjoint n=8 L=3 B={b}: wrapper {t['ms']:.5f} ms, device {shown} per launch, "
            f"plain {t['plain_ms']:.5f} ms, bound {t['bound'][0]:.3e} ms ({t['bound'][1]}); "
            f"{adjoint_per_step} launches per training step [{card}]")
    log(f"time circuit_adjoint n=8 L=3 B={SERVE_BATCH} wrapper again after the profiler sessions: "
        f"{after:.5f} ms (before them: {adj[SERVE_BATCH]['ms']:.5f} ms) [{card}]")

    def shown_us(us):
        return f"{us:.3f} us" if us is not None else "not measured (no device time in the trace)"

    log(f"time rotation_layer n={ROT_N} B={WIDE_BATCH}: wrapper {rot['ms']:.5f} ms, device "
        f"{shown_us(rot['device_us'])} per launch, plain {rot['plain_ms']:.5f} ms, bound "
        f"{rot['bound'][0]:.3e} ms ({rot['bound'][1]}) [{card}]")
    log(f"time unitary_expvals n={UNI_N} B={WIDE_BATCH}: wrapper {uni['ms']:.5f} ms, device "
        f"{shown_us(uni['device_us'])} per launch, plain {uni['plain_ms']:.5f} ms, the complex product "
        f"alone (torch.matmul, complex64) {uni['matmul_ms']:.5f} ms, bound {uni['bound'][0]:.3e} ms "
        f"({uni['bound'][1]}) [{card}]")

    train_adj = adj[TRAIN_BATCH * 9]  # the adjoint's main-path shape is the training step's
    qsc_bound, qsc_by = bound(*qsc_work(SERVE_BATCH, 6))
    circ_bound, circ_by = bound(*circuit_work(SERVE_BATCH, 8, 3))
    kernels = [
        {
            "name": "qsc_expvals",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/qsc_expvals.cu",
            "replaces": "qdml_tpu/quantum/pallas_kernels.py:205",
            "launches": launches["qsc_expvals"],
            "max_abs_err": worst["qsc_expvals"],
            "ms": qsc_ms,
            "device_ms": None if qsc_dev_us is None else qsc_dev_us / 1e3,
            "plain_ms": qsc_plain_ms,
            "bound_ms": qsc_bound,
            "bound_by": qsc_by,
            "library_ms": None,
        },
        {
            "name": "circuit_expvals",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/circuit_expvals.cu",
            "replaces": "qdml_tpu/quantum/pallas_kernels.py:354",
            "launches": launches["circuit_expvals"],
            "max_abs_err": worst["circuit_expvals"],
            "ms": circ_ms,
            "device_ms": None if circ_dev_us is None else circ_dev_us / 1e3,
            "plain_ms": circ_plain_ms,
            "bound_ms": circ_bound,
            "bound_by": circ_by,
            "library_ms": None,
        },
        {
            "name": "circuit_adjoint",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/circuit_adjoint.cu",
            "replaces": "qdml_tpu/quantum/pallas_kernels.py:521",
            "launches": launches["circuit_adjoint"],
            "max_abs_err": worst["circuit_adjoint"],
            "ms": train_adj["ms"],
            "device_ms": None if train_adj["device_us"] is None else train_adj["device_us"] / 1e3,
            "plain_ms": train_adj["plain_ms"],
            "bound_ms": train_adj["bound"][0],
            "bound_by": train_adj["bound"][1],
            "library_ms": None,
        },
    ]
    for name, t, replaces in (
        ("rotation_layer", rot, "qdml_tpu/quantum/pallas_kernels.py:587"),
        ("unitary_expvals", uni, "qdml_tpu/quantum/pallas_kernels.py:75"),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"qdml_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": t["ms"],
            "device_ms": None if t["device_us"] is None else t["device_us"] / 1e3,
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": None,  # no one PyTorch call computes either function
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
