"""K training steps a dispatch (``qdml_tpu/train/scan.py``).

The JAX trainers run K steps as one ``lax.scan`` program with a donated
carry, so the host enters the loop once per K steps, K = 1 included. The
port's counterpart on the card is a CUDA graph: :class:`ScanSteps` captures
K whole steps (the batch gathered by index from the
:class:`~qdml_tpu_torch.data.datasets.GridData` grid and scaled by the
step's SNR, forward, backward, pruning when configured, the update) as one
``torch.cuda.CUDAGraph`` and replays it once per chunk. On the CPU the same
chunks run step by step, eagerly: the plain version.

What a graph would otherwise freeze, and how each is kept live:

- the chunk's indices, SNRs and noise sit in static device buffers, which
  the host fills before each replay with one copy each (indices and SNRs
  asynchronously from pinned staging memory; before refilling it the host
  waits only for the previous chunk's copies);
- the learning rate is :attr:`Optimizer.lr <qdml_tpu_torch.train.optim.
  Optimizer.lr>`, a device tensor the host writes once per chunk
  (:meth:`~qdml_tpu_torch.train.optim.Optimizer.pin_rate`, which raises if
  the chunk's updates would take two rates); Adam and AdamW are capturable
  on the card, so their step counts live there too;
- the QuantumNAT generator of the QSC trainer is registered with each graph
  (``CUDAGraph.register_generator_state``), so every replay draws the next
  stretch of its Philox stream, what the per-step path draws step for step
  (the contract JAX keeps with ``presplit_keys``);
- the Python side of a step (``Optimizer.count``) is advanced by the
  runner, K per replay;
- the kernels' launch counters: a capture counts its launches into a tally
  (:func:`~qdml_tpu_torch.quantum.kernels.counting_capture`) that each
  replay adds (:func:`~qdml_tpu_torch.quantum.kernels.count_replay`), so
  ``launches`` keeps counting kernel launches.

Warm-up: the first chunk of a run on the card runs eagerly (a real chunk
of training, on the capture's side stream), which builds the kernels, fills
the per-device caches, makes Adam's state and lets cuDNN and cuBLAS set up;
the next chunk is captured and replayed. A run holds at most two graphs,
one for K and one for the epoch's tail, as JAX bounds its recompiles.

No fallback: on the card a capture or replay that fails raises, and the
run stops; nothing continues eagerly.

Spans (:mod:`~qdml_tpu_torch.telemetry.spans`), all on the host, none in
the code a graph captures: one ``scan_call`` (tag ``k``) a call. On the
card its ``phases`` tag times, as ``[t0_ns, t1_ns]``, ``scan_stage_wait``
(the host waiting for the previous chunk's copies, so for the card),
``scan_stage`` (the rest of the staging) and ``scan_replay`` (the graph's
launch), so a replayed call writes one record. The one-off calls open
spans of their own: ``scan_warmup`` (the eager first chunk) and
``scan_capture`` (tag ``k``). A call's host work is its ``scan_call``
less its ``scan_stage_wait``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Sequence

import numpy as np
import torch

from qdml_tpu_torch.data.datasets import GridData
from qdml_tpu_torch.quantum import kernels
from qdml_tpu_torch.telemetry.spans import span
from qdml_tpu_torch.train.optim import Optimizer

# A step: (batch, that step's noise or None) -> its outputs, device tensors
StepFn = Callable[[dict, "torch.Tensor | None"], dict]

MAX_GRAPHS = 2

# CUDA graphs captured and replayed by every runner since the process started
activity = {"captures": 0, "replays": 0}


def scan_eligible(
    cfg, logger, device: torch.device | None = None, circuit_impl: str | None = None, mesh=None
) -> bool:
    """Whether the K-step path runs this training (``qdml_tpu/train/scan.py:
    109-161``): yes for ``train.scan_steps >= 1``, K = 1 included; 0 selects
    the per-step path. Under a ``mesh`` it declines with JAX's reason for a
    multi-process run: in the port every mesh is several processes, each
    with its own rows, and no collective is captured into a graph. On the
    card an optimizer that reads its rate as a host float (SGD) declines
    too: a graph would replay the capture step's rate. So does a step whose
    circuit resolves to ``mps`` (``circuit_impl``, the resolved impl of a
    quantum trainer's step): each of its SVDs checks cuSOLVER's status on
    the host, which no CUDA graph can capture. Every decision is logged as
    ``kind="scan_dispatch"`` with ``eligible``, ``scan_steps`` and
    ``reason``; a decline of a K >= 1 also logs a warning. Under
    ``train.checkify`` it declines with JAX's reason: the sanitizer's
    contract is an error fetch a step, and no dispatch mode runs inside a
    graph replay."""
    k = cfg.train.scan_steps

    def decide(eligible: bool, reason: str, warn: str | None = None) -> bool:
        logger.log(kind="scan_dispatch", eligible=eligible, scan_steps=k, reason=reason)
        if warn is not None:
            logger.log(warning=warn)
        return eligible

    if k < 1:
        return decide(False, "disabled: scan_steps=0 selects the per-step path")
    if cfg.train.checkify:
        return decide(
            False,
            "checkify: per-step error fetch is the sanitizer's contract",
            warn=f"scan_steps={k} ignored: train.checkify forces per-step dispatch",
        )
    if mesh is not None:
        return decide(
            False,
            "loader shape: multi-process per-host slice generation owns the data",
            warn=f"scan_steps={k} ignored: multi-process "
            "or non-dividing batch uses the per-step placer data path",
        )
    if device is not None and device.type == "cuda" and cfg.train.optimizer == "sgd":
        return decide(
            False,
            "optimizer: sgd reads its learning rate as a host float, which a CUDA graph would freeze",
            warn=f"scan_steps={k} ignored: train.optimizer=sgd forces per-step dispatch on the card",
        )
    if device is not None and device.type == "cuda" and circuit_impl == "mps":
        return decide(
            False,
            "circuit impl mps: every torch.linalg.svd on the card checks cuSOLVER's status on the host, "
            "which a CUDA graph cannot capture",
            warn=f"scan_steps={k} ignored: the mps circuit impl forces per-step dispatch on the card",
        )
    return decide(
        True,
        "fused: single-device, K steps a dispatch (one CUDA-graph replay on the card, "
        "the eager chunk on the CPU), the batch gathered from the grid inside",
    )


def _stack(outs: Sequence[dict]) -> dict:
    """The steps' outputs stacked on a leading (k,) axis, nested dicts (the
    numerics probe's ``branch_grad_norm``) key by key."""
    return {
        key: _stack([o[key] for o in outs]) if isinstance(outs[0][key], dict) else torch.stack([o[key] for o in outs])
        for key in outs[0]
    }


def _tensors(out: dict) -> list[torch.Tensor]:
    return [t for v in out.values() for t in (_tensors(v) if isinstance(v, dict) else [v])]


def _clone(out: dict) -> dict:
    """A replay's outputs copied out of the graph's static buffers (the next
    replay overwrites them), nested dicts key by key."""
    return {key: _clone(v) if isinstance(v, dict) else v.clone() for key, v in out.items()}


class ScanSteps:
    """The K-step runner of one trainer (``make_scan_steps``).

    ``step_fn(batch, noise)`` is the trainer's whole step (its update through
    ``opt``); ``data`` the grid the batches are gathered from; ``k`` the chunk
    length; ``noise_shape`` the per-step shape of noise handed in with each
    chunk (the ensemble's), if any; ``generators`` the device generators the
    step draws from (registered with each graph).

    ``run(idx (k', S, U, B), snrs (k',), noise=None)`` takes host arrays
    from :meth:`~qdml_tpu_torch.data.datasets.DMLGridLoader.epoch_chunks`
    (and the chunk's noise on the device) and returns the step outputs
    stacked on a leading ``(k',)`` axis, on the device, without a host sync.
    ``graphs`` holds the captured graphs by chunk length.
    """

    def __init__(
        self,
        step_fn: StepFn,
        data: GridData,
        opt: Optimizer,
        k: int,
        noise_shape: tuple[int, ...] | None = None,
        generators: Sequence[torch.Generator] = (),
    ):
        if k < 1:
            raise ValueError(f"ScanSteps needs k >= 1, got {k}")
        self.step_fn = step_fn
        self.data = data
        self.opt = opt
        self.k = k
        self.noise_shape = noise_shape
        self.device = data.device
        self.generators = tuple(generators)
        self.graphs: dict[int, tuple[torch.cuda.CUDAGraph, dict[str, int], dict]] = {}
        self._warm = False
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            # static inputs of every graph; a tail graph reads their first k'
            self._idx_buf = None  # (k, S, U, B) int64, sized at the first chunk
            self._snr_buf = torch.zeros((k,), dtype=torch.float32, device=self.device)
            self._snr_host = torch.zeros((k,), dtype=torch.float32).pin_memory()
            self._idx_host = None
            self._noise_buf = (
                None if noise_shape is None
                else torch.zeros((k, *noise_shape), dtype=torch.float32, device=self.device)
            )
            self._staged: torch.cuda.Event | None = None

    # -- the steps themselves ---------------------------------------------------

    def _steps(self, idx: torch.Tensor, snrs: torch.Tensor, noise: torch.Tensor | None) -> dict:
        """The chunk's steps in order, on device tensors: what a graph
        captures and what the eager path runs."""
        outs = [
            self.step_fn(self.data.batch(idx[j], snrs[j]), None if noise is None else noise[j])
            for j in range(idx.shape[0])
        ]
        return _stack(outs)

    def _eager(self, idx: np.ndarray, snrs: np.ndarray, noise: torch.Tensor | None) -> dict:
        idx_t = torch.tensor(idx, dtype=torch.long, device=self.device)
        snr_t = torch.tensor(snrs, dtype=torch.float32, device=self.device)
        return self._steps(idx_t, snr_t, noise)

    # -- the card ---------------------------------------------------------------

    def _warmup(self, idx: np.ndarray, snrs: np.ndarray, noise: torch.Tensor | None) -> dict:
        """The first chunk, eagerly on the capture's side stream."""
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = self._eager(idx, snrs, noise)
        main.wait_stream(self.stream)
        for v in _tensors(out):
            v.record_stream(main)
        self._warm = True
        return out

    def _stage(self, idx: np.ndarray, snrs: np.ndarray, noise: torch.Tensor | None, phases: dict) -> None:
        """Fill the static inputs for a chunk of ``len(snrs)`` steps: one
        asynchronous copy each from pinned staging memory, which the host
        reuses only after the last chunk's copies have run. Times the wait
        and the rest into ``phases``."""
        k = len(snrs)
        if self._idx_buf is None:
            self._idx_buf = torch.zeros((self.k, *idx.shape[1:]), dtype=torch.long, device=self.device)
            self._idx_host = torch.zeros((self.k, *idx.shape[1:]), dtype=torch.long).pin_memory()
        t0 = time.perf_counter_ns()
        if self._staged is not None:
            self._staged.synchronize()
            t1 = time.perf_counter_ns()
            phases["scan_stage_wait"] = (t0, t1)
            t0 = t1
        self._idx_host.numpy()[:k] = idx
        self._snr_host.numpy()[:k] = snrs
        self._idx_buf[:k].copy_(self._idx_host[:k], non_blocking=True)
        self._snr_buf[:k].copy_(self._snr_host[:k], non_blocking=True)
        if noise is not None:
            self._noise_buf[:k].copy_(noise)
        self._staged = torch.cuda.Event()
        self._staged.record(torch.cuda.current_stream(self.device))
        phases["scan_stage"] = (t0, time.perf_counter_ns())

    def _capture(self, k: int) -> None:
        """Capture a graph of ``k`` steps over the static inputs. The update
        count the captured steps advanced in Python is taken back: the
        replays advance it."""
        if len(self.graphs) >= MAX_GRAPHS:
            raise RuntimeError(
                f"a chunk of {k} steps would be graph {len(self.graphs) + 1}; a run holds at most "
                f"{MAX_GRAPHS} (K = {self.k} and the epoch's tail), have {sorted(self.graphs)}"
            )
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        count = self.opt.count
        noise = None if self._noise_buf is None else self._noise_buf[:k]
        try:
            with kernels.counting_capture() as tally, torch.cuda.graph(graph, stream=self.stream):
                out = self._steps(self._idx_buf[:k], self._snr_buf[:k], noise)
        finally:
            self.opt.count = count
        self.graphs[k] = (graph, tally, out)
        activity["captures"] += 1

    def __call__(
        self, idx: np.ndarray, snrs: np.ndarray, noise: torch.Tensor | None = None
    ) -> dict[str, torch.Tensor]:
        k = len(snrs)
        if not 1 <= k <= self.k or idx.shape[0] != k:
            raise ValueError(f"a chunk of {idx.shape[0]} windows and {k} SNRs, want 1..{self.k} of each")
        if (noise is None) != (self.noise_shape is None):
            raise ValueError("noise must be given exactly when the runner was built with noise_shape")
        with span("scan_call", k=k) as tags:
            self.opt.pin_rate(k)
            try:
                if self.device.type != "cuda":
                    return self._eager(idx, snrs, noise)
                if not self._warm:
                    with span("scan_warmup"):
                        return self._warmup(idx, snrs, noise)
                phases = tags["phases"] = {}
                self._stage(idx, snrs, noise, phases)
                if k not in self.graphs:
                    with span("scan_capture", k=k):
                        self._capture(k)
                graph, tally, out = self.graphs[k]
                t0 = time.perf_counter_ns()
                graph.replay()
                kernels.count_replay(tally)
                phases["scan_replay"] = (t0, time.perf_counter_ns())
                activity["replays"] += 1
                self.opt.count += k
                return _clone(out)
            finally:
                self.opt.unpin_rate()


def make_scan_steps(
    step_fn: StepFn,
    data: GridData,
    opt: Optimizer,
    k: int,
    noise_shape: tuple[int, ...] | None = None,
    generators: Sequence[torch.Generator] = (),
) -> ScanSteps:
    """The K-step runner of one trainer (``qdml_tpu/train/scan.py:
    make_scan_steps``); see :class:`ScanSteps`."""
    return ScanSteps(step_fn, data, opt, k, noise_shape, generators)


class LoopTelemetry:
    """A train loop's instrumentation (``qdml_tpu/train/hdce.py:284-345``):
    its :class:`~qdml_tpu_torch.telemetry.counters.StepClock`, its
    :class:`~qdml_tpu_torch.telemetry.numerics.FlightRecorder` (``note_good``
    on ``params()`` at construction), and one ``cost`` record a run, counted
    over its first dispatch (:meth:`first_dispatch`). ``params`` returns the
    parameters to keep as last-good (called on the recorder's cadence only),
    ``rng`` is the step's noise generator for the dump, ``gather`` the
    mesh's one-rank gather of a snapshot, ``dtype`` the program's activation
    dtype (the cost record's ceiling)."""

    def __init__(self, name: str, cfg, device, params: Callable[[], dict], workdir: str | None = None,
                 rng=None, dtype: str = "float32", gather: Callable | None = None):
        from qdml_tpu_torch.telemetry.counters import StepClock
        from qdml_tpu_torch.telemetry.numerics import FlightRecorder

        self.name = name
        self.clock = StepClock(name)
        self.rec = FlightRecorder(name, cfg, workdir=workdir, gather=gather)
        self.rec.note_good(params)
        self.params = params
        self.rng = rng
        self.device = torch.device(device)
        self.dtype = dtype
        self._cost_done = False

    def first_dispatch(self, name: str, **tags):
        """Around a dispatch: the run's one cost record on its first, nothing after."""
        if self._cost_done:
            return contextlib.nullcontext()
        self._cost_done = True
        from qdml_tpu_torch.telemetry.cost import maybe_emit_cost

        return maybe_emit_cost(name, self.device, self.dtype, **tags)

    def epoch_end(self, epoch: int, tot):
        """The epoch's loss sum fetched once (None without steps), the
        watchdog's epoch-aggregate check on it, the epoch's counters record."""
        host = None if tot is None else tot.detach().cpu().numpy().astype(np.float64)
        self.rec.on_epoch_loss(epoch, host)
        self.clock.epoch_end(epoch=epoch)
        return host


def _losses(t: torch.Tensor):
    """A fetched loss: a float for a scalar, else a list."""
    return t.item() if t.dim() == 0 else t.cpu().tolist()


def run_epoch(
    run: ScanSteps,
    loader,
    epoch: int,
    logger,
    print_freq: int,
    noise: torch.Tensor | None = None,
    tele: LoopTelemetry | None = None,
) -> tuple:
    """One training epoch through ``run`` (``qdml_tpu/train/hdce.py:
    286-330``): the epoch's chunks from ``loader.epoch_chunks``, and with
    ``noise`` (steps, ...) on the device each chunk's slice of it. The loss
    sum stays on the device until the epoch's one fetch. With ``tele`` a
    chunk's losses (and probes) are fetched only when its flight recorder's
    cadence says so (``FlightRecorder.should_fetch``): at
    ``train.probe_every=0`` no chunk is, and the epoch makes no host
    transfer before its sum. A fetched chunk is logged every
    ``max(print_freq // K, 1)`` chunks: ``loss`` the chunk's last,
    ``losses`` all of them. Without ``tele`` every such chunk is fetched.
    Returns the loss sum (host, float64) and the step count."""
    k = run.k
    tot, n = None, 0
    with span("train_epoch", epoch=epoch):
        for idx, snrs in loader.epoch_chunks(epoch, k):
            steps = len(snrs)
            cadence = ((n + steps) // k) % max(print_freq // k, 1) == 0
            fetch = tele.rec.should_fetch() if tele is not None else cadence
            losses = None
            with contextlib.ExitStack() as stack:
                st = stack.enter_context(tele.clock.step()) if tele is not None else None
                if tele is not None:
                    stack.enter_context(tele.first_dispatch(f"{tele.name}_scan", scan_steps=k))
                ms = run(idx, snrs, None if noise is None else noise[n : n + steps])
                if fetch:
                    if st is not None:
                        st.transfer()
                    losses = ms["loss"].cpu().numpy()
            chunk = ms["loss"].sum(dim=0)
            tot = chunk if tot is None else tot + chunk
            n += steps
            if tele is not None:
                tele.rec.on_step(epoch, ms, loss=losses, params=tele.params, rng=tele.rng,
                                 batch_info={"dispatch": "scan", "idx": idx, "snrs": snrs})
            if losses is not None and cadence:
                rows = losses.tolist()
                logger.log(step=run.opt.count, epoch=epoch, loss=rows[-1], losses=rows)
    if tele is not None:
        return tele.epoch_end(epoch, tot), n
    return (None if tot is None else tot.cpu().numpy().astype(np.float64)), n


def run_steps(
    step_fn: StepFn,
    opt: Optimizer,
    loader,
    epoch: int,
    logger,
    print_freq: int,
    noise: torch.Tensor | None = None,
    tele: LoopTelemetry | None = None,
) -> tuple:
    """One training epoch on the per-step path (``train.scan_steps=0``): a
    dispatch a step from ``loader.epoch``, with ``noise[n]`` for step n.
    With ``tele`` each step's loss is fetched for the watchdog, as JAX's
    per-step loop fetches it (``qdml_tpu/train/hdce.py:333-345``), and
    ``step_fn`` is called with ``probes`` set to the flight recorder's
    cadence (``FlightRecorder.should_fetch``): the host knows it before each
    step here, so an off-cadence step computes no probe (the K-step graph
    captures one a step, as JAX's scan does). The loss sum stays on the
    device. Every ``print_freq`` steps that step's loss is logged. Returns
    the loss sum (host, float64) and the step count, as :func:`run_epoch`
    does."""
    tot, n = None, 0
    with span("train_epoch", epoch=epoch):
        for batch in loader.epoch(epoch):
            loss = None
            with contextlib.ExitStack() as stack:
                st = stack.enter_context(tele.clock.step()) if tele is not None else None
                if tele is not None:
                    stack.enter_context(tele.first_dispatch(f"{tele.name}_step"))
                if tele is None:
                    m = step_fn(batch, None if noise is None else noise[n])
                else:
                    m = step_fn(batch, None if noise is None else noise[n], probes=tele.rec.should_fetch())
                if st is not None:
                    st.transfer()
                    loss = _losses(m["loss"])
            tot = m["loss"] if tot is None else tot + m["loss"]
            n += 1
            if tele is not None:
                tele.rec.on_step(epoch, m, loss=loss, params=tele.params, rng=tele.rng,
                                 batch_info={"dispatch": "step", "step_in_epoch": n - 1})
            if n % print_freq == 0:
                logger.log(step=opt.count, epoch=epoch, loss=_losses(m["loss"]) if loss is None else loss)
    if tele is not None:
        return tele.epoch_end(epoch, tot), n
    return (None if tot is None else tot.cpu().numpy().astype(np.float64)), n
