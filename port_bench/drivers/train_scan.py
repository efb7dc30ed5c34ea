"""Closed-loop training of the HDCE through the trainer's K-step call
(``hdce.make_hdce_scan_steps`` over ``train/scan.py``).

Traffic parameters (``port_bench/traffic/<mix>.json``):

- ``grid_rows``: rows a (scenario, user) cell of the grid on the card;
- ``feed_chunks``: distinct K-step index chunks the window cycles through;
- ``trace_seconds``: how much of the window a traced run profiles.

The batch is ``train.batch_size`` rows a cell of the S x U grid, K =
``train.scan_steps`` steps a call, all from the configuration.

Set-up builds the trainer once and drives that same object, through the
call and feed the window uses, for its first 1 + K steps: a first call of
one step (run eagerly, as the runner's first call always is) and a second
of K, which captures and replays the very K-step graph that the window
then replays, on rows that all differ. The program's first gradient is
read from the optimizer's first moment after step 1 (m_1 = (1 - b1) g_1),
each leaf's change and the BatchNorm running statistics after step 1 + K;
the reference follows the same steps from the same weights and rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import checks, inputs
from port_bench.harness import CellError
from port_bench.reference import models as ref_models
from port_bench.reference import train as ref_train


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.dev = ctx.device
        d = self.cfg.data
        self.grid_shape = (d.n_scenarios, d.n_users, self.cfg.train.batch_size)
        self.rows_per_step = int(np.prod(self.grid_shape))
        self.k = self.cfg.train.scan_steps
        # steps in each of set-up's two calls: the second is the window's graph
        self.check_calls = (1, self.k)
        self.snr = float(d.snr_db)

    # -- inputs ------------------------------------------------------------------

    def specs(self) -> list[tuple]:
        cfg = self.cfg
        return ref_models.hdce_specs(cfg.data.n_scenarios, cfg.model.features, cfg.image_hw, cfg.h_out_dim)

    def make_inputs(self) -> None:
        ctx = self.ctx
        s, u, b = self.grid_shape
        self.grid_rows = int(ctx.traffic["grid_rows"])
        n_check = sum(self.check_calls)
        if self.grid_rows < n_check * b:
            raise CellError(f"grid_rows {self.grid_rows} < {n_check} checked steps x {b} rows: "
                            "the checked steps' rows would repeat")
        self.rows = inputs.make_grid(ctx.geom, s, u, self.grid_rows, ctx.seed, self.dev)
        self.weights = inputs.make_weights(self.specs(), ctx.seed, "weights", self.dev)
        self.names = ref_models.trainable(self.specs())
        self.stat_names = ref_models.running(self.specs())
        chunks = int(ctx.traffic["feed_chunks"])
        idx = inputs.step_indices(n_check + chunks * self.k, s, u, b, self.grid_rows, ctx.seed)
        self.check_idx = idx[:n_check]
        self.feed = [idx[n_check + i * self.k : n_check + (i + 1) * self.k] for i in range(chunks)]
        self.snr_k = np.full(self.k, self.snr, np.float32)

    # -- the program ---------------------------------------------------------------

    def setup(self) -> None:
        from qdml_tpu_torch.data.datasets import GridData
        from qdml_tpu_torch.train import hdce

        t0 = time.perf_counter()
        self.make_inputs()
        self._sync()
        t_inputs = time.perf_counter()
        data = GridData(self.cfg.data, self.rows, cached=False)
        model, opt = hdce.make_trainer(self.cfg, self.dev, steps_per_epoch=10**9)
        model.load_state_dict(self.weights)
        run = hdce.make_hdce_scan_steps(model, opt, data, self.k, probes=self.cfg.train.probe_every > 0)
        self.model, self.opt, self.run = model, opt, run
        self._sync()
        t_built = time.perf_counter()
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
        buffers = dict(model.named_buffers())
        self.prog = {"losses": [float(v) for v in torch.cat(losses)], "grad1": grad1,
                     "after": {k: params[k].detach().clone() for k in self.names},
                     "stats": {k: buffers[k].detach().clone() for k in self.stat_names}}
        self._sync()
        t_checked = time.perf_counter()
        self.ctx.log(f"setup phases: inputs {t_inputs - t0:.3f} s, trainer {t_built - t_inputs:.3f} s, "
                     f"checked steps with the graph's capture {t_checked - t_built:.3f} s")

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def window(self, seconds: float, tracer) -> dict:
        run, feed, snr_k = self.run, self.feed, self.snr_k
        ends: list[float] = []
        calls = 0
        tracer.start()
        self._sync()
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
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        wall = time.perf_counter() - t0
        if tracer.recording:
            tracer.stop()
            traced_calls = calls
        steps = calls * self.k
        rate = steps * self.rows_per_step / wall
        per_second = np.bincount(np.asarray(ends, dtype=np.int64)) * self.k * self.rows_per_step
        self.ctx.log(f"calls returned in each second of the window, as samples: {per_second.tolist()}")
        # a traced run's layer metrics read its traced part: stopping the
        # session takes seconds inside the window
        layer_rate = traced_calls * self.k * self.rows_per_step / tracer.window_s if traced_calls else rate
        return {
            "end_to_end": {"train_samples_per_s": rate},
            "attempted": steps,
            "failed": 0,
            "samples_per_s": layer_rate,
        }

    def memory_peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.dev))

    # -- the check ---------------------------------------------------------------

    def reference(self, tf32: bool = False, half_batch: bool = False) -> dict:
        """The reference's 1 + K checked steps (``tf32``: the control, in
        TF32; ``half_batch``: a fault, each cell's first half of the batch
        only)."""
        idxs = [torch.as_tensor(self.check_idx[i], device=self.dev) for i in range(sum(self.check_calls))]
        if half_batch:
            idxs = [i[..., : i.shape[-1] // 2] for i in idxs]
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            return ref_train.follow(self.weights, self.names, self.rows, idxs, self.snr, self.ctx.geom,
                                    self.cfg.train.lr)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def free_program(self) -> None:
        for name in ("run", "model", "opt"):
            if hasattr(self, name):
                delattr(self, name)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict[str, float]:
        self.free_program()
        ref = self.reference()
        numbers, notes = checks.training_numbers(self.prog, ref, self.weights)
        for note in notes:
            self.ctx.log(note)
        return numbers

    def control(self, kind: str) -> dict[str, float]:
        """A control or fault's numbers, the reference put in the program's
        place: ``tf32``, ``half_batch``, or ``stats_unchanged`` (the steps
        right, BatchNorm's running statistics left as they began). Needs
        :meth:`make_inputs` only."""
        ref = self.reference()
        got = self.reference(tf32=kind == "tf32", half_batch=kind == "half_batch")
        if kind == "stats_unchanged":
            got["stats"] = {k: self.weights[k] for k in got["stats"]}
        return checks.training_numbers(got, ref, self.weights)[0]
