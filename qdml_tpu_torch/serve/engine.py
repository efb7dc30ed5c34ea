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
- the **batching** (``serve.batching``): bucket, where pad rows are inert
  because every op is row-independent in eval mode, or ``ragged``, where
  the forward first zeroes the rows at and past the valid count so that
  garbage in them cannot reach a valid row. ``auto``, the default, races
  the two per tier on the same varied rows
  (:func:`~qdml_tpu_torch.serve.batching_autotune.ensure_batching`,
  table-cached). When the largest tier serves ragged, the micro-batcher in
  front admits continuously (:attr:`ServeEngine.continuous_admission`).

A batch pads with zeros to the smallest bucket that fits it, oversize
batches are served in largest-bucket chunks, and requests arrive in the JAX
layout, NHWC ``(n, n_sub, n_beam, 2)``. After warmup the request path takes
no measurement, writes no table and builds no kernel
(:meth:`ServeEngine.request_path_work` counts them). :meth:`swap_params`
replaces the weights between batches without a new warmup. ``infer(x,
traced=True)`` times the compute and fetch phases of a batch with one
stream synchronisation; untraced it reads no clock.

The micro-batcher, replica pool and socket server in front of the engine
are :mod:`~qdml_tpu_torch.serve.batcher` and
:mod:`~qdml_tpu_torch.serve.server`. Not ported yet: mesh and expert
sharding of the request path (ROADMAP A.14;
:func:`~qdml_tpu_torch.parallel.mesh.serve_mesh`, re-exported here,
validates the knobs, serves one rank on one device and refuses a world of
several ranks) and checkify (A.12).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.models.qsc import build_classifier
from qdml_tpu_torch.ops import dispatch_autotune
from qdml_tpu_torch.ops.routing import select_expert, sparse_dispatch
from qdml_tpu_torch.parallel.mesh import serve_mesh  # noqa: F401  (the engine's knob check)
from qdml_tpu_torch.quantum import autotune
from qdml_tpu_torch.quantum import kernels
from qdml_tpu_torch.quantum.circuits import resolve_impl
from qdml_tpu_torch.serve import batching_autotune
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
        # per tier: the batching race's entry, or {"forced": mode}
        self.batching_race: dict[str, dict] = {}
        # per bucket: what the warmup forward cost (the JAX package's
        # compiled-program cost analysis has no torch counterpart; see warmup)
        self.bucket_cost: dict[str, dict] = {}
        # mesh sharding per bucket: none on one device (serve_mesh)
        self.bucket_sharding: dict[str, str] = {}
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

    @classmethod
    def from_workdir(
        cls,
        cfg: ExperimentConfig,
        workdir: str,
        device: str | torch.device | None = None,
        buckets: tuple[int, ...] | None = None,
        tags: dict | None = None,
    ) -> "ServeEngine":
        """The newest trained HDCE and classifier under ``workdir``
        (``qdml_tpu/serve/engine.py:272-320``): best > last > resume per
        family, or the tags ``tags`` pins. The quantum classifier is served
        when one was trained, its circuit config taken from its checkpoint
        (``reconcile_quantum_cfg``); only a family never trained falls through
        to the classical ``SCP128``. A ``qsc`` tag that exists but fails to
        restore raises, never downgrading a quantum deployment."""
        from qdml_tpu_torch.train.checkpoint import CheckpointNotFoundError, reconcile_quantum_cfg

        hdce_sd, _, _ = _restore_family(workdir, "hdce", tags)
        try:
            clf_sd, clf_meta, _ = _restore_family(workdir, "qsc", tags)
        except CheckpointNotFoundError:
            pass
        else:
            cfg = reconcile_quantum_cfg(cfg, clf_meta)
            return cls(cfg, hdce_sd, clf_sd, quantum=True, buckets=buckets, device=device)
        try:
            clf_sd, _, _ = _restore_family(workdir, "sc", tags)
        except CheckpointNotFoundError:
            raise FileNotFoundError(
                f"no scenario-classifier checkpoint (qsc/sc) under {workdir!r} "
                "— run `train-sc` (or train-qsc) first"
            ) from None
        return cls(cfg, hdce_sd, clf_sd, quantum=False, buckets=buckets, device=device)

    def mesh_topology(self) -> None:
        """The serving mesh's axes: ``None``, one device (``serve_mesh``)."""
        return None

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

    def _tier_batching(self, b: int, route: str) -> str:
        """Tier ``b``'s batching, decided at warmup
        (``qdml_tpu/serve/engine.py:531-584``): a forced ``serve.batching``
        wins outright; ``auto`` races the tier's bucket forward against its
        ragged twin (table-cached, so a second warmup reads and times
        nothing). Both candidates take the same varied rows from
        ``default_rng(0)``: identical rows would send every prediction to
        one expert, and on a sparse tier time the overflow branch."""
        mode = self.cfg.serve.batching
        if mode != "auto":
            self.batching_race[str(b)] = {"forced": mode}
            return mode
        hdce, clf = self.live_vars()
        impl = self._impl(b)
        x = np.random.default_rng(0).standard_normal((b, *self.cfg.image_hw, 2)).astype(np.float32)
        xt = torch.from_numpy(x).to(self.device).permute(0, 3, 1, 2).contiguous()

        def bucket(xx):
            with torch.inference_mode():
                if route == "sparse":
                    return self._forward_sparse(hdce, clf, xx, b, impl)
                return self._forward(hdce, clf, xx, impl)

        def ragged(xx):
            with torch.inference_mode():
                if route == "sparse":
                    return self._forward_sparse_ragged(hdce, clf, xx, b, impl)
                return self._forward_ragged(hdce, clf, xx, b, impl)

        entry = batching_autotune.ensure_batching(
            {"bucket": (bucket, (xt,)), "ragged": (ragged, (xt,))},
            capacity=b,
            platform=self.device.type,
            route=route,
            dtype=self.cfg.model.dtype,
        )
        self.batching_race[str(b)] = entry
        return entry.get("best_infer") or "bucket"

    @staticmethod
    def _work() -> dict[str, int]:
        return {
            "measure": activity["measure"],
            "table_write": activity["save"],
            "kernel_build": sum(kernels.builds.values()),
        }

    def _sync(self) -> None:
        """Wait for this thread's stream on the engine's card (never the whole
        device: other workers' batches keep running)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def warmup(self) -> dict:
        """Decide and pin each bucket's circuit impl (the race runs here, off
        the request path), routing and batching, then run each bucket's
        forward once: the kernels build or load and cuDNN picks its
        algorithms. After this, :meth:`request_path_work` counts from zero.
        ``bucket_cost`` records, per bucket, the wall seconds of that first
        forward (torch compiles no program to analyse, so the JAX package's
        flops and bytes are not available)."""
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
            self.batching_mode[key] = self._tier_batching(b, self.dispatch_mode[key])
            t0 = time.perf_counter()
            self.forward_tier(np.zeros((b, *self.cfg.image_hw, 2), np.float32), b)
            self._sync()
            self.bucket_cost[key] = {
                "available": False,
                "reason": "torch compiles no program: no flops/bytes analysis",
                "platform": self.device.type,
                "first_forward_s": round(time.perf_counter() - t0, 6),
            }
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._work0 = self._work()
        self._warm = True
        out: dict[str, Any] = {
            "buckets": self.buckets,
            "work": {k: self._work0[k] - pre[k] for k in pre},
            "cost": dict(self.bucket_cost),
            "dispatch": {
                "mode": dict(self.dispatch_mode),
                "capacity_factor": float(self.cfg.serve.capacity_factor),
                "race": dict(self.dispatch_race),
            },
            "batching": {
                "mode": dict(self.batching_mode),
                "continuous_admission": self.continuous_admission,
                "race": dict(self.batching_race),
            },
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

    @property
    def continuous_admission(self) -> bool:
        """True when the largest tier resolved to ragged at warmup: the
        batcher in front then admits continuously."""
        return self.batching_mode.get(str(self.buckets[-1])) == "ragged"

    def batching_summary(self) -> dict:
        """Per-tier batching modes (``mode`` one word when they agree, else
        ``mixed``) and whether the batcher admits continuously."""
        modes = set(self.batching_mode.values())
        mode = modes.pop() if len(modes) == 1 else ("mixed" if modes else "bucket")
        return {
            "mode": mode,
            "per_tier": dict(self.batching_mode),
            "continuous_admission": self.continuous_admission,
        }

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

    def infer(self, x, traced: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray, DispatchInfo]:
        """Serve one batch ``x`` (n, n_sub, n_beam, 2): pad to its bucket, run
        the bucket's pinned forward, slice back. Returns ``(h (n, 2*h_dim),
        pred (n,), conf (n,), info)``.

        ``traced`` sets ``info.compute_s`` (dispatch until this thread's
        stream has finished the batch: one stream synchronisation, never a
        device-wide one) and ``info.fetch_s`` (the device-to-host copy of
        the reply). Untraced, it reads no clock and adds no synchronisation:
        the reply's ``.cpu()`` is the one wait."""
        if not self._warm:
            raise RuntimeError("ServeEngine.infer before warmup()")
        x = np.asarray(x, dtype=np.float32)
        n = int(x.shape[0])
        if n == 0:
            raise ValueError("empty batch")
        largest = self.buckets[-1]
        if n > largest:
            parts = [self.infer(x[lo : lo + largest], traced=traced) for lo in range(0, n, largest)]
            infos = [p[3] for p in parts]
            modes = {i.mode for i in infos}
            return (
                np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                DispatchInfo(
                    bucket=max(i.bucket for i in infos),
                    n=n,
                    rows=sum(i.rows for i in infos),
                    chunks=sum(i.chunks for i in infos),
                    mode=modes.pop() if len(modes) == 1 else "mixed",
                    compute_s=sum(i.compute_s or 0.0 for i in infos) if traced else None,
                    fetch_s=sum(i.fetch_s or 0.0 for i in infos) if traced else None,
                ),
            )
        b = pick_bucket(n, self.buckets)
        xp = np.zeros((b, *x.shape[1:]), np.float32)
        xp[:n] = x
        t_dispatch = time.perf_counter() if traced else None
        h, pred, conf, overflow = self.forward_tier(xp, n)
        t_fetch = None
        if traced:
            self._sync()
            t_fetch = time.perf_counter()
        if overflow is not None:
            with self._dispatch_lock:
                self._overflow_rows += overflow
                self._routed_rows += n
        out_h, out_pred, out_conf = h[:n].cpu().numpy(), pred[:n].cpu().numpy(), conf[:n].cpu().numpy()
        info = DispatchInfo(bucket=b, n=n, rows=b, mode=self.batching_mode[str(b)])
        if traced:
            info.compute_s = t_fetch - t_dispatch
            info.fetch_s = time.perf_counter() - t_fetch
        return out_h, out_pred, out_conf, info
