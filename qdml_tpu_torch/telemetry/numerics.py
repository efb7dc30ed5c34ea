"""Numerics flight recorder: on-device training probes and the divergence
watchdog (``qdml_tpu/telemetry/numerics.py``).

- :func:`probe_tree`: gradient/update statistics computed on the device
  inside the train step (global and per-branch gradient norms, the
  parameter and update norms and their ratio, a fused NaN/Inf count),
  accumulated in float32 (on the card one multi-tensor ``_foreach_norm``
  launch a branch). The step returns them in
  its metrics dict, so on the K-step path they are captured into the CUDA
  graph as static outputs beside the losses; nothing is fetched until the
  recorder's cadence asks, and then in one device-to-host copy.
- :class:`Watchdog`: the trip policy: a nonfinite loss, gradient or update,
  or a gradient norm past ``train.watchdog_grad_norm_max``.
- :class:`FlightRecorder`: what every trainer drives: ``numerics`` records
  on the ``train.probe_every`` cadence into the run's JSONL, a last-good
  copy of the parameters, and on a trip a post-mortem bundle under
  ``<eval.results_dir>/<name>/flightrec/`` (``bundle.json``: reason, step,
  epoch, batch info, the noise generator's seed and offset, the probe
  history tail; ``last_good`` through :mod:`qdml_tpu_torch.train.checkpoint`)
  before a typed :class:`DivergenceError` naming the dump.

Under a world of ranks the probe is the global one: each branch's sums are
added over the ranks that hold distinct shards of it (``groups``), so every
rank reaches the same trip decision, and the dump's ``last_good`` is
gathered into the one-rank layout with every rank joining (``gather``).
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np

from qdml_tpu_torch.telemetry import spans as _spans
from qdml_tpu_torch.telemetry.core import is_primary

HISTORY_TAIL = 32  # probe records kept for the post-mortem bundle
# last-good refresh cadence when no probes run (probe_every=0, watchdog on):
# without one every dump would restore to the step-0 parameters
LAST_GOOD_FALLBACK_EVERY = 100


class DivergenceError(RuntimeError):
    """Training diverged (NaN/Inf or a gradient-norm explosion) and the
    watchdog made the run a typed failure. ``dump_dir`` is the flight-recorder
    bundle (``None`` when this process writes none); ``reason`` the trip."""

    def __init__(self, message: str, dump_dir: str | None, reason: str):
        super().__init__(message)
        self.dump_dir = dump_dir
        self.reason = reason


# ---------------------------------------------------------------------------
# On-device probes (inside the train step, capturable)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    import torch

    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [leaf for v in tree for leaf in _leaves(v)]


def _stats(grads, params, updates, members: bool, device):
    """One branch's sums as a (5,) or, with ``members``, (5, E) float32
    tensor: grad sum of squares, grad nonfinite count, param and update sum
    of squares, update nonfinite count."""
    import torch

    def sumsq(leaves):
        if not leaves:
            return None
        if members:
            return torch.stack([t.reshape(t.shape[0], -1).float().square().sum(1) for t in leaves]).sum(0)
        if leaves[0].device.type == "cuda":  # one multi-tensor launch (a tree reduction per tensor)
            return torch.stack(torch._foreach_norm([t.float() for t in leaves])).square().sum()
        # the CPU's norm kernels lose up to ~1e-4 on a tensor of near-equal
        # magnitudes (Adam's first updates); its sum is a cascade
        return torch.stack([t.float().square().sum() for t in leaves]).sum()

    def nonfinite(leaves):
        if not leaves:
            return None
        if members:
            return torch.stack([(~torch.isfinite(t)).reshape(t.shape[0], -1).sum(1) for t in leaves]).sum(0)
        # one flat copy and one count: three launches, whatever the leaf count
        return (~torch.isfinite(torch.cat([t.reshape(-1) for t in leaves]))).sum()

    g, p, u = _leaves(grads), _leaves(params), _leaves(updates)
    parts = [sumsq(g), nonfinite(g), sumsq(p), sumsq(u), nonfinite(u)]
    like = next(x for x in parts if x is not None)
    zero = torch.zeros_like(like, dtype=torch.float32, device=device)
    return torch.stack([zero if x is None else x.float() for x in parts])


def probe_tree(grads, params=None, updates=None, members: bool = False) -> dict:
    """Numerics probe over one step's gradients (and parameters and updates).

    Trees are a tensor, a sequence of tensors or a mapping of branch name to
    a subtree; a mapping's keys become ``branch_grad_norm``'s (the trainers
    name branches as the JAX package's parameter tree does), and ``params``
    and ``updates`` then take the same keys. ``members=True`` reads a leading
    member axis on every leaf and returns (E,) values.

    Returns device tensors: ``grad_norm``, ``branch_grad_norm`` (mapping
    trees only), ``param_norm``, ``update_norm`` and ``update_ratio``
    (``update_norm / (param_norm + 1e-12)``) when given, and ``nonfinite``,
    the int32 NaN/Inf count over gradients and updates."""
    branches = grads if isinstance(grads, Mapping) else {None: grads}
    device = _leaves(grads)[0].device

    def sub(tree, k):
        return tree if k is None or tree is None else tree[k]

    stats = {k: _stats(g, sub(params, k), sub(updates, k), members, device) for k, g in branches.items()}
    return probe_from_stats(stats, isinstance(grads, Mapping), params is not None, updates is not None)


def branch_stats(grads=None, params=None, updates=None, members: bool = False):
    """One branch's sums (see :func:`probe_from_stats`), for a probe taken
    in two parts around an update: gradients and parameters before it, the
    updates after (:meth:`~qdml_tpu_torch.train.optim.Optimizer.step`)."""
    leaves = _leaves(grads) or _leaves(params) or _leaves(updates)
    return _stats(grads, params, updates, members, leaves[0].device)


def probe_from_stats(stats: Mapping, branched: bool, with_params: bool, with_updates: bool,
                     groups: Mapping | None = None) -> dict:
    """The probe dict of :func:`probe_tree` from per-branch sums (a (5,) or
    (5, E) tensor a branch: gradient sum of squares and nonfinite count,
    parameter and update sums of squares, update nonfinite count), each
    branch first added over its ``groups`` entry: the process group whose
    ranks hold distinct shards of it (an all-reduce, outside any graph)."""
    import torch

    for k, group in (groups or {}).items():
        if group is not None and k in stats:
            from qdml_tpu_torch.parallel.collectives import all_reduce_

            all_reduce_(stats[k], group)
    total = torch.stack(list(stats.values())).sum(0)
    out: dict[str, Any] = {"grad_norm": torch.sqrt(total[0])}
    if branched:
        out["branch_grad_norm"] = {str(k): torch.sqrt(s[0]) for k, s in stats.items()}
    nonfinite = total[1]
    if with_params:
        out["param_norm"] = torch.sqrt(total[2])
    if with_updates:
        out["update_norm"] = torch.sqrt(total[3])
        nonfinite = nonfinite + total[4]
        if with_params:
            out["update_ratio"] = out["update_norm"] / (out["param_norm"] + 1e-12)
    out["nonfinite"] = nonfinite.to(torch.int32)
    return out


def branch_params(named, prefixes) -> dict:
    """Parameters grouped into the JAX package's top-level branches:
    ``named`` is ``(name, tensor)`` pairs (``model.named_parameters()``),
    ``prefixes`` ``(prefix, branch)`` pairs in order; a tensor goes to the
    first branch whose prefix starts its name. A name no prefix takes
    raises: a probe must not drop parameters."""
    out: dict[str, list] = {branch: [] for _, branch in prefixes}
    for name, t in named:
        branch = next((b for p, b in prefixes if name.startswith(p)), None)
        if branch is None:
            raise KeyError(f"parameter {name!r} is in no probe branch of {prefixes}")
        out[branch].append(t)
    return out


def fetch(tree):
    """A probe (or any nest of device tensors) on the host, as numpy, in one
    device-to-host copy: the leaves are packed into one float64 buffer
    (exact for float32 values and int32 counts) and unpacked by shape."""
    import torch

    leaves = _leaves(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).double() for t in leaves]).cpu().numpy()
    it = iter(leaves)
    pos = [0]

    def unpack(node):
        if isinstance(node, torch.Tensor):
            t = next(it)
            n = t.numel()
            arr = flat[pos[0] : pos[0] + n].reshape(tuple(t.shape))
            pos[0] += n
            if not t.dtype.is_floating_point:
                arr = arr.astype(np.int64)
            return arr
        if isinstance(node, Mapping):
            return {k: unpack(v) for k, v in node.items()}
        return [unpack(v) for v in node]

    return unpack(tree)


# ---------------------------------------------------------------------------
# Host side: JSON views, watchdog policy, flight recorder
# ---------------------------------------------------------------------------


def _j(x):
    """JSON-safe view of a fetched probe leaf: finite floats stay numbers,
    nonfinite become strings; small arrays become lists, large ones a
    summary."""
    if isinstance(x, Mapping):
        return {k: _j(v) for k, v in x.items()}
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.ndim == 0:
        v = arr.item()
        if isinstance(v, float) and not math.isfinite(v):
            return str(v)
        return v
    if arr.size <= 16:
        return [_j(v) for v in arr.reshape(-1)]
    finite = arr[np.isfinite(arr)] if np.issubdtype(arr.dtype, np.floating) else arr
    return {
        "shape": list(arr.shape),
        "min": _j(finite.min()) if finite.size else None,
        "max": _j(finite.max()) if finite.size else None,
        "last": _j(arr.reshape(-1)[-1]),
    }


def rng_info(gen) -> dict | None:
    """What replays a step's noise draw from a ``torch.Generator``: its seed
    and, where the generator keeps one (Philox on the card), its offset
    after the step."""
    if gen is None:
        return None
    if isinstance(gen, Mapping):
        return dict(gen)
    out: dict[str, Any] = {"seed": int(gen.initial_seed()), "device": str(gen.device)}
    if gen.device.type == "cuda":
        out["philox_offset"] = int(gen.get_offset())
    return out


class Watchdog:
    """Divergence trip policy over fetched losses and probes.

    Trips (returns the reason) on a nonfinite loss (whenever the loop hands
    one over: every step on the per-step path, on the probe cadence on the
    K-step path, and on the epoch's loss sum through
    :meth:`FlightRecorder.on_epoch_loss`), a nonzero ``nonfinite`` count, a
    nonfinite ``grad_norm``, or ``grad_norm`` above ``grad_norm_max`` (0
    disables the ceiling). Arrays (a chunk's (K,), an ensemble's (E,)) are
    checked elementwise: any bad step or member trips."""

    def __init__(self, grad_norm_max: float = 0.0):
        self.grad_norm_max = float(grad_norm_max)

    def check(self, loss=None, probe: dict | None = None) -> str | None:
        if loss is not None:
            larr = np.asarray(loss, dtype=np.float64)
            if not np.isfinite(larr).all():
                return f"nonfinite loss ({_j(larr)})"
        if probe is not None:
            nf = int(np.sum(np.asarray(probe.get("nonfinite", 0))))
            if nf > 0:
                return f"{nf} nonfinite gradient/update element(s)"
            gn = np.asarray(probe.get("grad_norm", 0.0), dtype=np.float64)
            if not np.isfinite(gn).all():
                return f"nonfinite grad norm ({_j(gn)})"
            if self.grad_norm_max > 0 and float(np.max(gn)) > self.grad_norm_max:
                return f"grad norm {float(np.max(gn)):g} exceeds ceiling {self.grad_norm_max:g}"
        return None


def _snapshot(params) -> dict:
    """A copy of the parameters on their device: a callable is called first
    (the trainers pass ``model.state_dict``), every tensor cloned (the
    K-step graphs update parameters in place)."""
    if callable(params):
        params = params()
    return {k: v.detach().clone() for k, v in params.items()}


class FlightRecorder:
    """Per-trainer numerics recorder and watchdog harness.

    One instance a train loop (``FlightRecorder("qsc_train", cfg,
    workdir=...)``): :meth:`note_good` once on the initial parameters,
    :meth:`on_step` once a host-visible step (a dispatch: a step, or a chunk
    of K on the K-step path) with that step's metrics (device tensors; the
    probe is fetched only on the cadence), :meth:`on_epoch_loss` on the
    epoch's fetched loss sum. ``numerics`` records go to the explicit sink or
    the process-global one, like :class:`~.counters.StepClock`'s.

    ``gather``, under a world of ranks, turns this rank's parameter
    snapshot into the one-rank layout (a collective: every rank calls it in
    :meth:`dump`; rank 0 writes). Off cleanly: ``train.probe_every=0`` stops
    the records, ``train.watchdog=false`` the trips."""

    def __init__(self, name: str, cfg, workdir: str | None = None, sink=None, gather: Callable | None = None):
        self.name = name
        self.cfg = cfg
        self.workdir = workdir
        self._sink = sink
        self._gather = gather
        self.probe_every = int(cfg.train.probe_every)
        self.watchdog = Watchdog(cfg.train.watchdog_grad_norm_max) if cfg.train.watchdog else None
        self.dump_root = os.path.join(cfg.eval.results_dir, cfg.name, "flightrec")
        self._n = 0
        self._history: deque[dict] = deque(maxlen=HISTORY_TAIL)
        self._last_good: tuple[int, dict] | None = None

    @property
    def enabled(self) -> bool:
        return self.probe_every > 0 or self.watchdog is not None

    def _target(self):
        return self._sink if self._sink is not None else _spans.get_sink()

    def should_fetch(self) -> bool:
        """Whether the next :meth:`on_step` lands on the logging cadence (the
        run's first step or a ``probe_every`` multiple). The K-step loop
        fetches a chunk's losses only then: off-cadence chunks make no host
        transfer, and ``probe_every=0`` none until the epoch's sum."""
        if self.probe_every <= 0:
            return False
        nxt = self._n + 1
        return nxt == 1 or nxt % self.probe_every == 0

    def note_good(self, params) -> None:
        """Keep a copy of known-good parameters (the init or the restored
        state), so even a first-step divergence has a restore point."""
        if self.watchdog is None:
            return
        self._last_good = (self._n, _snapshot(params))

    def on_step(self, epoch: int, metrics: Mapping | None, loss=None, params=None,
                batch_info: dict | None = None, rng=None) -> None:
        """One host-visible step: log on cadence, feed the watchdog, and on a
        trip dump and raise :class:`DivergenceError`. ``metrics`` is the
        step's dict of device tensors (``probe`` fetched on cadence only,
        ``checkify_err`` under the sanitizer, fetched every step); ``loss``
        the already-fetched host loss or losses, if any; ``params`` (a
        mapping or a callable returning one), ``batch_info`` and ``rng`` (a
        generator) feed the last-good copy and the bundle."""
        has_checkify = isinstance(metrics, Mapping) and "checkify_err" in metrics
        if not self.enabled and not has_checkify:
            return
        self._n += 1
        if has_checkify:
            from qdml_tpu_torch.telemetry.sanitizer import error_message

            # every rank of a world gets the same answer (a collective)
            msg = error_message(metrics["checkify_err"], world=True)
            if msg is not None:
                reason = f"checkify: {msg.splitlines()[0]}"
                dump_dir = self.dump(reason, epoch, batch_info=batch_info, rng=rng, loss=loss, metrics=metrics)
                raise DivergenceError(
                    f"{self.name} tripped a checkify check at step {self._n} (epoch {epoch}): {reason}"
                    + (f" — flight-recorder dump: {dump_dir}" if dump_dir else ""),
                    dump_dir,
                    reason,
                )
        probe_host = None
        probe = metrics.get("probe") if isinstance(metrics, Mapping) else None
        if probe is not None and self.probe_every > 0 and (self._n == 1 or self._n % self.probe_every == 0):
            probe_host = fetch(probe)  # the one extra transfer
            rec = {
                "step": self._n,
                "epoch": int(epoch),
                "loss": _j(loss) if loss is not None else None,
                **{k: _j(v) for k, v in probe_host.items()},
            }
            self._history.append(rec)
            target = self._target()
            if target is not None and getattr(target, "active", False):
                target.emit("numerics", name=self.name, **rec)
        if self.watchdog is None:
            return
        reason = self.watchdog.check(loss=loss, probe=probe_host)
        if reason is None:
            # refresh last-good on a cadence, never every step: the probe
            # cadence when probes log, a fixed one when they do not
            snap = probe_host is not None or (self.probe_every <= 0 and self._n % LAST_GOOD_FALLBACK_EVERY == 0)
            if snap and params is not None:
                self._last_good = (self._n, _snapshot(params))
            return
        dump_dir = self.dump(reason, epoch, batch_info=batch_info, rng=rng, loss=loss,
                             probe_host=probe_host, metrics=metrics)
        raise DivergenceError(
            f"{self.name} diverged at step {self._n} (epoch {epoch}): {reason}"
            + (f" — flight-recorder dump: {dump_dir}" if dump_dir else ""),
            dump_dir,
            reason,
        )

    def on_epoch_loss(self, epoch: int, loss) -> None:
        """Watchdog check of an epoch's already-fetched loss sum: NaN/Inf
        carries through the sum, so this catches any divergence the cadence
        skipped, the ``probe_every=0`` mode's only loss check. Trips as
        :meth:`on_step` does."""
        if self.watchdog is None or loss is None:
            return
        reason = self.watchdog.check(loss=loss)
        if reason is None:
            return
        reason = f"epoch-aggregate {reason}"
        dump_dir = self.dump(reason, epoch, loss=loss)
        raise DivergenceError(
            f"{self.name} diverged during epoch {epoch} (aggregate over the epoch's dispatches): {reason}"
            + (f" — flight-recorder dump: {dump_dir}" if dump_dir else ""),
            dump_dir,
            reason,
        )

    # -- post-mortem --------------------------------------------------------

    def dump(self, reason: str, epoch: int, batch_info: dict | None = None, rng=None, loss=None,
             probe_host: dict | None = None, metrics: Mapping | None = None) -> str | None:
        """Write the post-mortem bundle; returns its directory. Every rank
        joins the ``last_good`` gather (a collective); the bundle, the
        checkpoint and the telemetry record are the primary's. A failing dump
        never masks the :class:`DivergenceError` that follows it."""
        dump_dir = os.path.join(self.dump_root, f"{self.name}-step{self._n:06d}")
        try:
            if probe_host is None and isinstance(metrics, Mapping) and "probe" in metrics:
                probe_host = fetch(metrics["probe"])
            last_good_meta = None
            if self._last_good is not None:
                good_step, good_params = self._last_good
                if self._gather is not None:
                    good_params = self._gather(good_params)
                if is_primary():
                    from qdml_tpu_torch.train.checkpoint import save_checkpoint

                    save_checkpoint(
                        dump_dir, "last_good", {"params": good_params},
                        {"step": good_step, "name": self.cfg.name, "loop": self.name},
                    )
                last_good_meta = {"step": good_step, "checkpoint": "last_good"}
            if not is_primary():
                return dump_dir
            os.makedirs(dump_dir, exist_ok=True)
            from qdml_tpu_torch.telemetry.manifest import config_hash

            bundle = {
                "kind": "flightrec_bundle",
                "ts": round(time.time(), 3),
                "name": self.name,
                "run": self.cfg.name,
                "config_hash": config_hash(self.cfg),
                "reason": reason,
                "step": self._n,
                "epoch": int(epoch),
                "loss": _j(loss) if loss is not None else None,
                "batch_info": _j(batch_info) if batch_info else None,
                "rng_key": rng_info(rng),
                "probe": _j(probe_host) if probe_host else None,
                "probe_history": list(self._history),
                "last_good": last_good_meta,
                "workdir": self.workdir,
            }
            with open(os.path.join(dump_dir, "bundle.json"), "w") as fh:
                json.dump(bundle, fh, indent=2)
            target = self._target()
            if target is not None and getattr(target, "active", False):
                target.emit("flightrec_dump", name=self.name, reason=reason, step=self._n,
                            epoch=int(epoch), dump_dir=dump_dir)
            return dump_dir
        except Exception as e:  # lint: disable=broad-except(a failing dump must not mask the DivergenceError about to be raised)
            print(f"[flightrec] dump failed: {type(e).__name__}: {e}", flush=True)
            return None
