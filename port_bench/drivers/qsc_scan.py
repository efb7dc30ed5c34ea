"""Closed-loop training of the quantum scenario classifier through the
trainer's K-step call (``qsc.make_trainer`` with ``quantum=True`` and
``qsc.make_sc_scan_steps`` over ``train/scan.py``).

Traffic parameters (``port_bench/traffic/<mix>.json``), as for
``train_scan``:

- ``grid_rows``: rows a (scenario, user) cell of the grid on the card;
- ``feed_chunks``: distinct K-step index chunks the window cycles through;
- ``trace_seconds``: how much of the window a traced run profiles.

A step trains on the whole S x U x ``train.batch_size`` grid flattened into
one batch (the circuit's batch), K = ``train.scan_steps`` steps a call.
Set-up resolves the device through the program's own
``utils/device.resolve_device`` before anything else touches the card,
builds the trainer, races the circuit impls at the step's batch
(``quantum/autotune.prewarm``, impl ``auto``; the table under
``port_bench/cache/``) and then drives that same trainer through a first
call of one step (eager) and a second of K, which captures and replays the
window's graph, on rows that all differ. Set-up ends with the window's own
calls replayed for as long as the window (at most :data:`SETTLE_S`): on
the H100 a process's first seconds of replays (up to ~20) run ~6% slower,
for a cause not found in the program (PERF.md, section 6), and a training
run's rate is the one that follows; that time counts in ``setup_s``, and
its rate by second is logged. The set-up's program spans are logged on one line
(:func:`port_bench.program_spans.setup_line`). The program's first gradient is
read from AdamW's first moment after step 1 (m_1 = (1 - b1) g_1), each
leaf's change after step 1 + K; the reference
(:mod:`port_bench.reference.qsc`) follows the same steps from the same
weights and rows. The classifier has no running statistics, so the
numbers are ``loss_gap``, ``grad_gap`` and ``change_gap``, as
:mod:`port_bench.checks` defines them.

The window counts the hand circuit kernels' launches
(``kernels.launches["circuit_expvals"]`` and ``["circuit_adjoint"]``) over
the calls made while a traced run profiles, for the rooflines' readers.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from port_bench import checks, inputs, program_spans
from port_bench.harness import driver_module
from port_bench.reference import qsc as ref_qsc

# the circuit kernels' launch counters the window reads
CIRCUIT_COUNTERS = ("circuit_expvals", "circuit_adjoint")
# the longest a run's set-up replays the window's calls before the window:
# on the H100 no window after 20 s of them ran slow past its second 2 (PERF.md)
SETTLE_S = 20.0

Base = driver_module("train_scan").Driver


class Driver(Base):
    def specs(self) -> list[tuple]:
        cfg = self.cfg
        q = cfg.quantum
        return ref_qsc.qsc_specs(q.n_qubits, q.n_layers, q.n_classes, cfg.image_hw)

    def make_inputs(self) -> None:
        """The grid, the feed and the weights as the HDCE driver draws them,
        with the circuit weights uniform in [0, 2 pi), drawn from a stream
        of their own."""
        super().make_inputs()
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(inputs.stream_seed(self.ctx.seed, "weights") ^ 1)
        w = self.weights["qlayer.weights"]
        self.weights["qlayer.weights"] = 2.0 * math.pi * torch.rand(w.shape, generator=gen, device=self.dev)

    # -- the program ---------------------------------------------------------------

    def setup(self) -> None:
        with program_spans.Collector() as spans:
            self._setup()
        self.ctx.log(program_spans.setup_line(spans.records))
        self.settle(min(SETTLE_S, self.ctx.seconds))

    def _setup(self) -> None:
        from qdml_tpu_torch.data.datasets import GridData
        from qdml_tpu_torch.quantum import autotune
        from qdml_tpu_torch.train import qsc
        from qdml_tpu_torch.utils.device import resolve_device

        t0 = time.perf_counter()
        self.dev = resolve_device(self.dev)
        cfg = self.cfg
        self.make_inputs()
        self._sync()
        t_inputs = time.perf_counter()
        data = GridData(cfg.data, self.rows, cached=False)
        model, opt = qsc.make_trainer(cfg, True, self.dev, steps_per_epoch=10**9)
        model.load_state_dict(self.weights)
        self._sync()
        t_built = time.perf_counter()
        autotune.prewarm(cfg, batch=qsc.circuit_batch(cfg), device=self.dev)
        impl = qsc.step_circuit_impl(cfg, self.dev)
        t_raced = time.perf_counter()
        run = qsc.make_sc_scan_steps(model, opt, data, self.k, probes=cfg.train.probe_every > 0)
        self.model, self.opt, self.run = model, opt, run
        params = dict(model.named_parameters())
        beta1 = opt.opt.param_groups[0]["betas"][0]
        losses = []
        done = 0
        for i, steps in enumerate(self.check_calls):
            out = run(self.check_idx[done : done + steps], np.full(steps, self.snr, np.float32))
            losses.append(out["loss"].detach().clone())
            done += steps
            if i == 0:
                # a step that took no update has no first moment: its gradient reads as nought
                grad1 = {k: opt.opt.state.get(params[k], {}).get("exp_avg", torch.zeros_like(params[k])).float()
                         / (1.0 - beta1) for k in self.names}
        self.prog = {"losses": [float(v) for v in torch.cat(losses)], "grad1": grad1,
                     "after": {k: params[k].detach().clone() for k in self.names}}
        self._sync()
        t_checked = time.perf_counter()
        self.ctx.log(f"setup phases: inputs {t_inputs - t0:.3f} s, trainer {t_built - t_inputs:.3f} s, "
                     f"circuit impl race {t_raced - t_built:.3f} s (the step's impl: {impl}), "
                     f"checked steps with the graph's capture {t_checked - t_raced:.3f} s")

    def settle(self, seconds: float) -> None:
        """The window's calls, on its feed, for ``seconds``; their samples
        by whole second are logged."""
        ends: list[float] = []
        self._sync()
        t0 = time.perf_counter()
        while not ends or ends[-1] < seconds:
            self.run(self.feed[len(ends) % len(self.feed)], self.snr_k)
            ends.append(time.perf_counter() - t0)
        self._sync()
        per_second = self._per_second(ends, time.perf_counter() - t0)
        self.ctx.log(f"set-up's settling calls, samples trained in each whole second: {per_second}")

    def _per_second(self, ends: list[float], wall: float) -> list[int]:
        """Samples done in each whole second, read off the calls' ends: a
        call is 2.6% of a second on the H100, too coarse for whole calls a
        second."""
        done = np.interp(np.arange(1, int(wall) + 1), [0.0, *ends],
                         np.arange(len(ends) + 1) * self.k * self.rows_per_step)
        return np.diff(done, prepend=0.0).round().astype(np.int64).tolist()

    def window(self, seconds: float, tracer) -> dict:
        from qdml_tpu_torch.quantum import kernels

        run, feed, snr_k = self.run, self.feed, self.snr_k
        ends: list[float] = []
        calls = 0
        tracer.start()
        self._sync()
        start = {c: kernels.launches[c] for c in CIRCUIT_COUNTERS}
        traced = None
        t0 = time.perf_counter()
        traced_calls = None
        while True:
            tc = time.perf_counter()
            run(feed[calls % len(feed)], snr_k)
            te = time.perf_counter()
            ends.append(te - t0)
            calls += 1
            if tracer.recording:
                tracer.host_span("k_step_call", tc, te)
                tracer.poll()
                if tracer.done:
                    traced_calls = calls
                    traced = {c: kernels.launches[c] - start[c] for c in CIRCUIT_COUNTERS}
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        if tracer.recording:
            tracer.stop()
            traced_calls = calls
            traced = {c: kernels.launches[c] - start[c] for c in CIRCUIT_COUNTERS}
        steps = calls * self.k
        rate = steps * self.rows_per_step / wall
        per_second = self._per_second(ends, wall)
        self.ctx.log(f"samples trained in each whole second of the window: {per_second}")
        layer_rate = traced_calls * self.k * self.rows_per_step / tracer.window_s if traced_calls else rate
        out = {"end_to_end": {"train_samples_per_s": rate}, "attempted": steps, "failed": 0,
               "samples_per_s": layer_rate, "circuit_batch": self.rows_per_step}
        if traced is not None:
            out["launches"] = traced
            self.ctx.log(f"circuit kernel launches over the {traced_calls} traced calls: {traced}")
        return out

    # -- the check ---------------------------------------------------------------

    def reference(self, tf32: bool = False, half_batch: bool = False, frozen: bool = False) -> dict:
        """The reference's 1 + K checked steps (``tf32``: the control, in
        TF32; ``half_batch``: a fault, each cell's first half of the batch
        only; ``frozen``: a fault, steps that leave the parameters as they
        were and take no first moment)."""
        idxs = [torch.as_tensor(self.check_idx[i], device=self.dev) for i in range(sum(self.check_calls))]
        if half_batch:
            idxs = [i[..., : i.shape[-1] // 2] for i in idxs]
        q, t = self.cfg.quantum, self.cfg.train
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            out = ref_qsc.follow(self.weights, self.rows, idxs, self.snr, self.ctx.geom, q.n_qubits, q.n_layers,
                                 0.0 if frozen else t.lr, t.weight_decay)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        if frozen:
            out["grad1"] = {k: torch.zeros_like(v) for k, v in out["grad1"].items()}
        return out

    def check(self) -> dict[str, float]:
        self.free_program()
        numbers, notes = training_numbers(self.prog, self.reference(), self.weights)
        for note in notes:
            self.ctx.log(note)
        return numbers

    def control(self, kind: str) -> dict[str, float]:
        """A control or fault's numbers, the reference put in the program's
        place: ``tf32``, ``half_batch`` or ``step_unchanged``. Needs
        :meth:`make_inputs` only."""
        ref = self.reference()
        got = self.reference(tf32=kind == "tf32", half_batch=kind == "half_batch", frozen=kind == "step_unchanged")
        return training_numbers(got, ref, self.weights)[0]


def training_numbers(prog: dict, ref: dict, start: dict) -> tuple[dict[str, float], list[str]]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` as
    :func:`port_bench.checks.training_numbers` computes them, for a model
    with no running statistics: ``prog`` and ``ref`` hold ``losses``,
    ``grad1`` and ``after``, ``start`` the parameters both began from.
    Returns the numbers and the lines that say which leaf set each."""

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_at = checks.norm_gap({k: norm(v) for k, v in prog["grad1"].items()},
                                        {k: norm(v) for k, v in ref["grad1"].items()})
    rms = statistics.median(norm(g) / g.numel() ** 0.5 for g in ref["grad1"].values())
    p_change, r_change, notes = {}, {}, []
    for k, g in ref["grad1"].items():
        moving = g.abs() >= checks.STILL_LEAF * rms
        still = int((~moving).sum())
        if still:
            notes.append(f"change_gap leaves out {still} of {g.numel()} entries of {k} (still)")
        if still < g.numel():
            p_change[k] = norm(torch.where(moving, prog["after"][k] - start[k], 0.0))
            r_change[k] = norm(torch.where(moving, ref["after"][k] - start[k], 0.0))
    change_gap, change_at = checks.norm_gap(p_change, r_change)
    by_step = [f"{abs(p - r) / max(abs(r), 1e-30):.3g}" for p, r in zip(prog["losses"], ref["losses"])]
    notes.append(f"loss gap by step: {' '.join(by_step)}")
    notes.append(f"worst leaves: grad_gap {grad_at}, change_gap {change_at}")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}, notes
