"""Serving engine (``qdml_tpu/serve/engine.py``): classify -> all trunks -> top-1 route.

The online pipeline of the JAX engine's ``_forward``
(``qdml_tpu/serve/engine.py:442-456``): the scenario classifier gives
log-probabilities, ``argmax`` picks the scenario, every per-scenario trunk and
the shared head run on the batch, and :func:`select_expert` keeps each row's
routed trunk. With the quantum classifier the circuit runs through the impl
the config names, so impls ``pallas`` and ``pallas_circuit`` launch the
port's CUDA kernels.

Batching is by bucket: a batch pads with zeros to the smallest bucket that
fits it (pad rows are inert, every op of the forward being row-independent
in eval mode) and oversize batches are served in largest-bucket chunks, as
in the JAX engine (``:853-885``). Requests arrive in the JAX layout, NHWC
``(n, n_sub, n_beam, 2)``, and are permuted to NCHW here. Dispatch is dense;
sparse and ragged dispatch, hot-swap, the micro-batcher threads and the TCP
server come with later slices (ROADMAP A.8, A.11).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.models.qsc import build_classifier
from qdml_tpu_torch.ops.routing import select_expert
from qdml_tpu_torch.quantum.circuits import resolve_impl
from qdml_tpu_torch.serve.batcher import pick_bucket, power_of_two_buckets
from qdml_tpu_torch.serve.types import DispatchInfo
from qdml_tpu_torch.train.hdce import build_hdce
from qdml_tpu_torch.utils.device import resolve_device


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
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quantum = quantum
        self.buckets = tuple(
            sorted(buckets or cfg.serve.buckets or power_of_two_buckets(cfg.serve.max_batch))
        )
        self.hdce = build_hdce(cfg, self.device)
        self.hdce.load_state_dict(hdce_sd)
        self.clf = build_classifier(cfg, quantum, self.device)
        self.clf.load_state_dict(clf_sd)
        # quantum classifier only: the circuit impl each bucket dispatches
        # (the static resolution; measured dispatch is a later slice)
        self.quantum_impl: dict[str, dict] = {}
        self._warm = False

    def _forward(self, x: torch.Tensor):
        """``x`` (B, 2, n_sub, n_beam) on the engine's device ->
        ``(h (B, 2*h_dim), pred (B,), conf (B,))``; ``conf`` is the routed
        class's probability, ``exp(max log-prob)``."""
        logp = self.clf(x)
        top, pred = logp.max(dim=-1)
        xs = x.expand(self.cfg.data.n_scenarios, *x.shape)
        est_all = self.hdce(xs)  # (S, B, D)
        return select_expert(est_all, pred), pred, torch.exp(top)

    def warmup(self) -> dict:
        """One forward per bucket, off the request path: cuDNN picks its
        algorithms, the kernels build or load, and each bucket's resolved
        circuit impl is recorded in ``quantum_impl``."""
        hw = self.cfg.image_hw
        for b in self.buckets:
            if self.quantum:
                q = self.cfg.quantum
                self.quantum_impl[str(b)] = {"impl": resolve_impl(q.impl, q.backend, q.n_qubits)}
            x = torch.zeros((b, 2, *hw), dtype=torch.float32, device=self.device)
            with torch.inference_mode():
                self._forward(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._warm = True
        out: dict[str, Any] = {"buckets": self.buckets}
        if self.quantum_impl:
            out["quantum_impl"] = dict(self.quantum_impl)
        return out

    def infer(self, x) -> tuple[np.ndarray, np.ndarray, np.ndarray, DispatchInfo]:
        """Serve one batch ``x`` (n, n_sub, n_beam, 2): pad to its bucket, run
        the forward, slice back. Returns ``(h (n, 2*h_dim), pred (n,),
        conf (n,), info)``."""
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
                ),
            )
        b = pick_bucket(n, self.buckets)
        xp = np.zeros((b, *x.shape[1:]), np.float32)
        xp[:n] = x
        xt = torch.from_numpy(xp).to(self.device).permute(0, 3, 1, 2).contiguous()
        with torch.inference_mode():
            h, pred, conf = self._forward(xt)
        return (
            h[:n].cpu().numpy(),
            pred[:n].cpu().numpy(),
            conf[:n].cpu().numpy(),
            DispatchInfo(bucket=b, n=n, rows=b),
        )
