"""Serving engine (``qdml_tpu/serve/engine.py``): classify -> route -> estimate, per bucket.

The online pipeline of the JAX engine: the scenario classifier gives
log-probabilities, ``argmax`` picks each row's scenario, and the per-scenario
HDCE trunks with the shared head give the routed estimate. Each bucket's
forward is fixed at :meth:`ServeEngine.warmup` and pinned for the engine's
life:

- the **circuit impl** of the quantum classifier: at ``quantum.impl=auto``
  measured on the card (:func:`~qdml_tpu_torch.quantum.autotune.prewarm` at
  the bucket's batch, then the forward winner), so impls ``pallas`` and
  ``pallas_circuit`` launch the port's CUDA kernels where they win; a table
  that changes after warmup does not change a warmed engine;
- the **routing** (``serve.dispatch``): dense, every trunk on the batch and
  :func:`~qdml_tpu_torch.ops.routing.select_expert`, or capacity-bucketed
  ``sparse``, :func:`~qdml_tpu_torch.ops.routing.sparse_dispatch`, whose
  overflow rows take the dense value (one host sync a batch to read the
  overflow count). ``auto``, the default, is the measured race
  (:func:`~qdml_tpu_torch.ops.dispatch_autotune.ensure_route`, per bucket,
  table-cached): sparse enters it from S = 6, so at the reference's S = 3
  dense is chosen and nothing is timed;
- the **batching** (``serve.batching``, default ``bucket``): bucket, where
  pad rows are inert because every op is row-independent in eval mode, or
  ``ragged``, where the forward first zeroes the rows at and past the valid
  count so that garbage in them cannot reach a valid row. At ``auto`` the
  JAX package races the two per bucket; the port has no such race yet
  (ragged mode has no caller until continuous admission, ROADMAP A.11), so
  ``auto`` takes what JAX's lookup falls back to without a table entry,
  bucket.

A batch pads with zeros to the smallest bucket that fits it, oversize
batches are served in largest-bucket chunks, and requests arrive in the JAX
layout, NHWC ``(n, n_sub, n_beam, 2)``. After warmup the request path takes
no measurement, writes no table and builds no kernel
(:meth:`ServeEngine.request_path_work` counts them). :meth:`swap_params`
replaces the weights between batches without a new warmup.

Not ported yet: mesh sharding, expert sharding and checkify (ROADMAP
A.10, A.12), the micro-batcher threads with continuous admission and the TCP
server (A.11).
"""

from __future__ import annotations

import threading
from typing import Any, Mapping

import numpy as np
import torch

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.models.qsc import build_classifier
from qdml_tpu_torch.ops import dispatch_autotune
from qdml_tpu_torch.ops.routing import select_expert, sparse_dispatch
from qdml_tpu_torch.quantum import autotune
from qdml_tpu_torch.quantum import kernels
from qdml_tpu_torch.quantum.circuits import resolve_impl
from qdml_tpu_torch.serve.batcher import pick_bucket, power_of_two_buckets
from qdml_tpu_torch.serve.types import DispatchInfo
from qdml_tpu_torch.train.hdce import build_hdce
from qdml_tpu_torch.utils.device import resolve_device
from qdml_tpu_torch.utils.tune_table import activity


def _restore_family(workdir: str, prefix: str, tags: dict | None):
    """One family's weights for eval: the tag ``tags`` pins (which must
    exist), else the newest of best > last > resume. Returns ``(state_dict,
    meta, tag)``."""
    from qdml_tpu_torch.train.checkpoint import (
        CheckpointNotFoundError,
        has_checkpoint,
        latest_tag,
        restore_params,
    )

    tag = (tags or {}).get(prefix)
    if tag is None:
        tag = latest_tag(workdir, prefix)
        if tag is None:
            raise CheckpointNotFoundError(f"no {prefix} checkpoint (best/last/resume) under {workdir!r}")
    elif not has_checkpoint(workdir, tag):
        raise FileNotFoundError(f"pinned tag {tag!r} does not exist under {workdir!r}")
    vars_, meta = restore_params(workdir, tag)
    return vars_["params"], meta, tag


# What JAX's batching race falls back to without a table entry
# (qdml_tpu/serve/batching_autotune.py:lookup); that race is not ported.
_AUTO_BATCHING = "bucket"


def _signature(sd: Mapping[str, torch.Tensor]) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}


class ServeEngine:
    """HDCE plus scenario classifier behind per-bucket padded batches.

    ``hdce_sd`` holds the :class:`~qdml_tpu_torch.train.hdce.HDCE` state dict
    (``trunks.{s}.cnn.*``, ``head.FC.*``); ``clf_sd`` the classifier's in
    reference naming (``QSCP128`` when ``quantum``, else ``SCP128``), as
    :mod:`qdml_tpu_torch.interop` writes them. Runs on ``cuda`` unless
    ``device="cpu"``.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        hdce_sd: Mapping[str, torch.Tensor],
        clf_sd: Mapping[str, torch.Tensor],
        quantum: bool = False,
        buckets: tuple[int, ...] | None = None,
        device: str | torch.device | None = None,
    ):
        for field, modes in (("dispatch", ("dense", "sparse")), ("batching", ("bucket", "ragged"))):
            mode = getattr(cfg.serve, field)
            if mode != "auto" and mode not in modes:
                raise ValueError(f"serve.{field} must be auto|{'|'.join(modes)}, got {mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quantum = quantum
        self.buckets = tuple(
            sorted(buckets or cfg.serve.buckets or power_of_two_buckets(cfg.serve.max_batch))
        )
        # the live (hdce, clf) modules: read once per batch under _swap_lock,
        # replaced whole by swap_params, so a batch never sees a torn pair
        self._swap_lock = threading.Lock()
        # serializes whole swaps (validate -> build -> flip); never taken on
        # the request path
        self._swap_gate = threading.RLock()
        self._swap_epoch = 0
        self._live = self._build(hdce_sd, clf_sd)
        # per bucket: the circuit impl (quantum classifier only, with the
        # race entry behind it), the routing and the batching mode
        self.quantum_impl: dict[str, dict] = {}
        self.dispatch_mode: dict[str, str] = {}
        # per bucket: the routing race's entry, or {"forced": mode}
        self.dispatch_race: dict[str, dict] = {}
        self.batching_mode: dict[str, str] = {}
        # sparse overflow accounting (overflow rows are served dense, never dropped)
        self._dispatch_lock = threading.Lock()
        self._overflow_rows = 0
        self._routed_rows = 0
        self._work0: dict[str, int] = {}
        self._warm = False

    def _build(self, hdce_sd, clf_sd) -> tuple[torch.nn.Module, torch.nn.Module]:
        hdce = build_hdce(self.cfg, self.device)
        hdce.load_state_dict(hdce_sd)
        clf = build_classifier(self.cfg, self.quantum, self.device)
        clf.load_state_dict(clf_sd)
        return hdce, clf

    # -- live weights (hot-swap) ---------------------------------------------

    def live_vars(self) -> tuple[torch.nn.Module, torch.nn.Module]:
        """One atomic read of the live ``(hdce, clf)`` modules."""
        with self._swap_lock:
            return self._live

    @property
    def hdce(self) -> torch.nn.Module:
        return self.live_vars()[0]

    @property
    def clf(self) -> torch.nn.Module:
        return self.live_vars()[1]

    @property
    def swap_epoch(self) -> int:
        """Successful hot-swaps since construction."""
        with self._swap_lock:
            return self._swap_epoch

    def swap_params(self, hdce_sd: Mapping[str, torch.Tensor], clf_sd: Mapping[str, torch.Tensor]) -> dict:
        """Hot-swap to new weights between batches.

        The state dicts must match the serving ones key for key in shape and
        dtype (a mismatch raises ``ValueError`` and the old weights keep
        serving). New modules are built and their copies to the device
        finished off the request path, then the live pair flips under the
        lock: a batch already running keeps the modules it read, every later
        batch sees the new ones. Returns ``{"epoch", "work"}``, ``work``
        being the measurements, table writes and kernel builds over the swap
        (all zero)."""
        if not self._warm:
            raise RuntimeError("swap_params before warmup(): nothing is serving yet")
        with self._swap_gate:
            live_h, live_c = self.live_vars()
            for name, new, old in (("hdce", hdce_sd, live_h), ("clf", clf_sd, live_c)):
                if _signature(new) != _signature(old.state_dict()):
                    raise ValueError(
                        f"hot-swap {name} state dict does not match the serving one "
                        "(keys/shapes/dtypes): a shape-changing checkpoint needs a "
                        "fresh engine and warmup, not a swap"
                    )
            pre = self._work()
            new_live = self._build(hdce_sd, clf_sd)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            post = self._work()
            with self._swap_lock:
                self._swap_epoch += 1
                self._live = new_live
                epoch = self._swap_epoch
        return {"epoch": epoch, "work": {k: post[k] - pre[k] for k in post}}

    def swap_from_workdir(self, workdir: str, tags: dict | None = None) -> dict:
        """Hot-swap to the newest checkpoints under ``workdir`` (best > last >
        resume per family), or to the tags ``tags`` pins per family prefix.
        A quantum checkpoint trained for another circuit config than the
        engine serves raises ``ValueError``."""
        from qdml_tpu_torch.train.checkpoint import reconcile_quantum_cfg

        with self._swap_gate:
            hdce_sd, _, hdce_tag = _restore_family(workdir, "hdce", tags)
            prefix = "qsc" if self.quantum else "sc"
            clf_sd, clf_meta, clf_tag = _restore_family(workdir, prefix, tags)
            if self.quantum and reconcile_quantum_cfg(self.cfg, clf_meta).quantum != self.cfg.quantum:
                raise ValueError(
                    f"hot-swap checkpoint {clf_tag!r} was trained for another quantum "
                    "config than this engine serves: deploy it with a fresh engine"
                )
            rec = self.swap_params(hdce_sd, clf_sd)
        rec["tags"] = {"hdce": hdce_tag, prefix: clf_tag}
        return rec

    # -- forwards ---------------------------------------------------------------

    def _classify(self, clf, x: torch.Tensor, impl: str | None):
        logp = clf(x, impl=impl) if self.quantum else clf(x)
        top, pred = logp.max(dim=-1)
        return pred, torch.exp(top)

    def _forward(self, hdce, clf, x: torch.Tensor, impl: str | None = None):
        """``x`` (B, 2, n_sub, n_beam) -> ``(h (B, 2*h_dim), pred (B,), conf
        (B,))``: classify, every trunk on the batch, top-1 gather. ``conf`` is
        the routed class's probability, ``exp(max log-prob)``."""
        pred, conf = self._classify(clf, x, impl)
        est_all = hdce(x.expand(self.cfg.data.n_scenarios, *x.shape))  # (S, B, D)
        return select_expert(est_all, pred), pred, conf

    def _forward_sparse(self, hdce, clf, x: torch.Tensor, n_valid: int, impl: str | None = None):
        """Sparse twin of :meth:`_forward`: only each row's chosen trunk runs,
        on capacity buckets; rows at and past ``n_valid`` take no capacity.
        Returns ``(h, pred, conf, overflow)``."""
        s = self.cfg.data.n_scenarios
        pred, conf = self._classify(clf, x, impl)
        valid = torch.arange(x.shape[0], device=x.device) < n_valid

        def dense_fb(xb, pb):
            return select_expert(hdce(xb.expand(s, *xb.shape)), pb)

        h, overflow = sparse_dispatch(
            hdce, dense_fb, x, pred, s, self.cfg.serve.capacity_factor, valid=valid
        )
        return h, pred, conf, overflow

    @staticmethod
    def _mask_padding(x: torch.Tensor, n_valid: int) -> torch.Tensor:
        """Rows at and past ``n_valid`` become exact zeros before any compute,
        so NaN or Inf there cannot reach a valid output."""
        valid = torch.arange(x.shape[0], device=x.device) < n_valid
        return torch.where(valid.view(-1, *(1,) * (x.dim() - 1)), x, x.new_zeros(()))

    def _forward_ragged(self, hdce, clf, x: torch.Tensor, n_valid: int, impl: str | None = None):
        return self._forward(hdce, clf, self._mask_padding(x, n_valid), impl)

    def _forward_sparse_ragged(self, hdce, clf, x: torch.Tensor, n_valid: int, impl: str | None = None):
        return self._forward_sparse(hdce, clf, self._mask_padding(x, n_valid), n_valid, impl)

    def _impl(self, b: int) -> str | None:
        rec = self.quantum_impl.get(str(b))
        return rec["impl"] if rec else None

    def forward_tier(self, xp, n: int):
        """Bucket ``len(xp)``'s pinned forward on a padded batch ``xp`` (b,
        n_sub, n_beam, 2) whose first ``n`` rows are valid. Returns device
        tensors ``(h, pred, conf)`` over all b rows and the sparse overflow
        count (``None`` on a dense tier)."""
        b = int(xp.shape[0])
        key = str(b)
        if key not in self.dispatch_mode:
            raise ValueError(f"bucket {b} was not warmed (buckets {self.buckets})")
        xt = torch.as_tensor(xp, dtype=torch.float32).to(self.device).permute(0, 3, 1, 2).contiguous()
        hdce, clf = self.live_vars()
        impl = self._impl(b)
        ragged = self.batching_mode[key] == "ragged"
        with torch.inference_mode():
            if self.dispatch_mode[key] == "sparse":
                fwd = self._forward_sparse_ragged if ragged else self._forward_sparse
                return fwd(hdce, clf, xt, n, impl)
            if ragged:
                return (*self._forward_ragged(hdce, clf, xt, n, impl), None)
            return (*self._forward(hdce, clf, xt, impl), None)

    def offline_forward(self, x) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The parity reference: the dense forward at the natural (unpadded)
        batch, its circuit impl resolved for that batch. Returns ``(h, pred,
        conf)``."""
        hdce, clf = self.live_vars()
        xt = torch.as_tensor(np.asarray(x, np.float32)).to(self.device).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            out = self._forward(hdce, clf, xt)
        return tuple(t.cpu().numpy() for t in out)

    # -- warmup -------------------------------------------------------------------

    def _batching(self) -> str:
        """``serve.batching``, with ``auto`` taking JAX's no-table fallback."""
        mode = self.cfg.serve.batching
        return _AUTO_BATCHING if mode == "auto" else mode

    def _bucket_dispatch(self, b: int) -> str:
        """Bucket ``b``'s routing, decided at warmup
        (``qdml_tpu/serve/engine.py:585-603``): a forced ``serve.dispatch``
        wins outright; ``auto`` is the race on the live trunks at this
        bucket, which times nothing below S = 6."""
        mode = self.cfg.serve.dispatch
        if mode != "auto":
            self.dispatch_race[str(b)] = {"forced": mode}
            return mode
        hdce, _ = self.live_vars()
        entry = dispatch_autotune.ensure_route(
            hdce,
            torch.zeros((b, 2, *self.cfg.image_hw), device=self.device),
            self.cfg.data.n_scenarios,
            capacity_factor=self.cfg.serve.capacity_factor,
        )
        self.dispatch_race[str(b)] = entry
        return entry.get("best_infer") or "dense"

    @staticmethod
    def _work() -> dict[str, int]:
        return {
            "measure": activity["measure"],
            "table_write": activity["save"],
            "kernel_build": sum(kernels.builds.values()),
        }

    def warmup(self) -> dict:
        """Decide and pin each bucket's circuit impl (the race runs here, off
        the request path), routing and batching, then run each bucket's
        forward once: the kernels build or load and cuDNN picks its
        algorithms. After this, :meth:`request_path_work` counts from zero."""
        pre = self._work()
        q = self.cfg.quantum
        for b in self.buckets:
            key = str(b)
            if self.quantum:
                entry = autotune.prewarm(self.cfg, batch=b, device=self.device)
                rec: dict[str, Any] = {
                    "impl": resolve_impl(
                        q.impl, q.backend, q.n_qubits, q.n_layers, b, mode="infer",
                        platform=self.device.type,
                    )
                }
                if entry is not None:
                    rec["autotuned"] = True
                    rec["candidates"] = entry["candidates"]
                self.quantum_impl[key] = rec
            self.dispatch_mode[key] = self._bucket_dispatch(b)
            self.batching_mode[key] = self._batching()
            self.forward_tier(np.zeros((b, *self.cfg.image_hw, 2), np.float32), b)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._work0 = self._work()
        self._warm = True
        out: dict[str, Any] = {
            "buckets": self.buckets,
            "work": {k: self._work0[k] - pre[k] for k in pre},
            "dispatch": {
                "mode": dict(self.dispatch_mode),
                "capacity_factor": float(self.cfg.serve.capacity_factor),
                "race": dict(self.dispatch_race),
            },
            "batching": {"mode": dict(self.batching_mode)},
        }
        if self.quantum_impl:
            out["quantum_impl"] = dict(self.quantum_impl)
        return out

    def request_path_work(self) -> dict[str, int]:
        """Measurements, table writes and kernel builds since warmup ended,
        counted process-wide (another engine's warmup in between counts too):
        unchanged across ``infer`` calls, which do none of them."""
        now = self._work()
        return {k: now[k] - self._work0.get(k, 0) for k in now}

    def batching_summary(self) -> dict:
        """The batching mode and its per-tier record."""
        return {"mode": self._batching(), "per_tier": dict(self.batching_mode)}

    def dispatch_summary(self) -> dict:
        """Per-bucket routing modes (``mode`` one word when they agree, else
        ``mixed``), the capacity factor, and the sparse overflow rate over
        everything served (``None`` before a sparse batch)."""
        modes = set(self.dispatch_mode.values())
        mode = modes.pop() if len(modes) == 1 else ("mixed" if modes else "dense")
        with self._dispatch_lock:
            routed, overflow = self._routed_rows, self._overflow_rows
        return {
            "mode": mode,
            "per_bucket": dict(self.dispatch_mode),
            "capacity_factor": float(self.cfg.serve.capacity_factor),
            "overflow_rows": overflow,
            "routed_rows": routed,
            "overflow_rate": round(overflow / routed, 6) if routed else None,
        }

    # -- request path -------------------------------------------------------------

    def infer(self, x) -> tuple[np.ndarray, np.ndarray, np.ndarray, DispatchInfo]:
        """Serve one batch ``x`` (n, n_sub, n_beam, 2): pad to its bucket, run
        the bucket's pinned forward, slice back. Returns ``(h (n, 2*h_dim),
        pred (n,), conf (n,), info)``."""
        if not self._warm:
            raise RuntimeError("ServeEngine.infer before warmup()")
        x = np.asarray(x, dtype=np.float32)
        n = int(x.shape[0])
        if n == 0:
            raise ValueError("empty batch")
        largest = self.buckets[-1]
        if n > largest:
            parts = [self.infer(x[lo : lo + largest]) for lo in range(0, n, largest)]
            infos = [p[3] for p in parts]
            return (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                DispatchInfo(
                    bucket=max(i.bucket for i in infos),
                    n=n,
                    rows=sum(i.rows for i in infos),
                    chunks=sum(i.chunks for i in infos),
                    mode=infos[0].mode,
                ),
            )
        b = pick_bucket(n, self.buckets)
        xp = np.zeros((b, *x.shape[1:]), np.float32)
        xp[:n] = x
        h, pred, conf, overflow = self.forward_tier(xp, n)
        if overflow is not None:
            with self._dispatch_lock:
                self._overflow_rows += overflow
                self._routed_rows += n
        return (
            h[:n].cpu().numpy(),
            pred[:n].cpu().numpy(),
            conf[:n].cpu().numpy(),
            DispatchInfo(bucket=b, n=n, rows=b, mode=self.batching_mode[str(b)]),
        )
