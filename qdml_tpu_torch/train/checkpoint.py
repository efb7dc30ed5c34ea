"""Checkpoints (``qdml_tpu/train/checkpoint.py``) in the port's own format.

A tag ``<workdir>/<tag>.pt`` is one ``torch.save`` file with a JSON sidecar
``<tag>.meta.json`` (epoch, metric, config name). The trainers write
``*_best`` (the model's state dict at the best validation metric), ``*_last``
(at the end) and ``*_resume`` (model, optimizer, update count, epoch and the
running best, every epoch), and resume from ``*_resume``. Eval restores
model weights only (:func:`restore_params`) and rebuilds the quantum
classifier a checkpoint was trained as (:func:`reconcile_quantum_cfg`).
Reading the JAX package's orbax checkpoints is not part of the port: weights
cross through :mod:`qdml_tpu_torch.interop`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any

import torch
from torch import nn

from qdml_tpu_torch.train.optim import Optimizer


class CheckpointRestoreError(RuntimeError):
    """An EXISTING checkpoint tag failed to restore (corrupt, truncated,
    partially written) — distinct from :class:`CheckpointNotFoundError`, so a
    caller with a never-trained fallback never takes it for a missing one."""


class CheckpointNotFoundError(FileNotFoundError):
    """A model family was never trained in this workdir (no best/last/resume tag)."""


def _path(workdir: str, tag: str) -> str:
    return os.path.join(os.path.abspath(workdir), f"{tag}.pt")


def save_checkpoint(workdir: str, tag: str, payload: Any, meta: dict | None = None) -> str:
    """Save ``payload`` under ``workdir/tag`` (write, then rename: a reader
    never sees half a file). Returns the file's path."""
    path = _path(workdir, tag)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path[: -len(".pt")] + ".meta.json", "w") as fh:
            json.dump(meta, fh)
    return path


def has_checkpoint(workdir: str, tag: str) -> bool:
    return os.path.isfile(_path(workdir, tag))


def restore_checkpoint(
    workdir: str, tag: str, map_location: str | torch.device = "cpu"
) -> tuple[Any, dict]:
    """Restore ``workdir/tag``; returns (payload, meta). A missing tag raises
    :class:`CheckpointNotFoundError`; one that exists but fails to load
    raises :class:`CheckpointRestoreError`."""
    path = _path(workdir, tag)
    if not os.path.isfile(path):
        raise CheckpointNotFoundError(f"no checkpoint {tag!r} under {workdir!r}")
    try:
        payload = torch.load(path, map_location=map_location, weights_only=True)
    except (OSError, RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
        raise CheckpointRestoreError(
            f"checkpoint {tag!r} under {workdir!r} exists but failed to restore "
            f"(corrupt/truncated/partially written?): {type(e).__name__}: {e}"
        ) from e
    meta: dict = {}
    meta_path = path[: -len(".pt")] + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
    return payload, meta


def latest_tag(workdir: str, prefix: str) -> str | None:
    """The best restorable tag of a model family: ``{prefix}_best``, else
    ``_last``, else ``_resume``; ``None`` when it was never trained here."""
    for cand in (f"{prefix}_best", f"{prefix}_last", f"{prefix}_resume"):
        if has_checkpoint(workdir, cand):
            return cand
    return None


def restore_params(
    workdir: str, tag: str, map_location: str | torch.device = "cpu"
) -> tuple[dict, dict]:
    """Eval-only restore (``qdml_tpu/train/checkpoint.py:204-217``): the model's
    state dict without optimizer state, from ``*_best``/``*_last`` and
    ``*_resume`` tags alike. Returns ``({"params": state_dict}, meta)``."""
    payload, meta = restore_checkpoint(workdir, tag, map_location)
    return {"params": payload["params"]}, meta


def reconcile_quantum_cfg(cfg, meta: dict):
    """The config a QSC checkpoint was trained for
    (``qdml_tpu/train/checkpoint.py:27-120``): the architecture facts in
    ``meta["quantum"]`` (n_qubits, n_layers, n_classes, input_norm) replace
    the config's, while ``backend`` and ``impl`` are execution strategies, so
    the eval config's win. An explicit eval pin (``quantum.impl``, else the
    legacy ``quantum.backend``) that cannot run at the checkpoint's qubit count
    raises: ``NotImplementedError`` for an impl the port lacks, as
    ``run_circuit`` raises it, and past a capacity cap
    :class:`~qdml_tpu_torch.quantum.autotune.ImplIneligibleError` (a
    ``ValueError``), as JAX raises it. A no-op for meta without ``quantum``."""
    from qdml_tpu_torch.quantum.autotune import (
        UNPORTED_IMPLS,
        ImplIneligibleError,
        impl_eligible,
    )
    from qdml_tpu_torch.quantum.circuits import canonical_impl, resolve_backend

    stored = dict((meta or {}).get("quantum") or {})
    if not stored:
        return cfg
    trained_backend = stored.pop("backend", None)
    trained_impl = stored.pop("impl", None)
    if trained_impl not in (None, "", "auto"):
        trained_impl = canonical_impl(trained_impl)
    stored.pop("mps_chi", None)
    n_q = stored.get("n_qubits", cfg.quantum.n_qubits)
    q = cfg.quantum
    pinned = q.impl if q.impl not in ("", "auto") else (q.backend if q.backend != "auto" else None)
    if pinned is not None:
        pinned = canonical_impl(pinned)
        ok, why = impl_eligible(pinned, n_q)
        if not ok:
            err = NotImplementedError if pinned in UNPORTED_IMPLS else ImplIneligibleError
            raise err(f"checkpoint (n_qubits={n_q}) pins circuit impl {pinned!r}, which cannot run here: {why}")
    elif trained_impl not in (None, "", "auto"):
        ok, why = impl_eligible(trained_impl, n_q)
        if not ok:
            print(f"note: checkpoint was trained with circuit impl {trained_impl!r}, "
                  f"ineligible here ({why}); the dispatcher re-resolves")
    if trained_backend is not None:
        trained_res = resolve_backend(trained_backend, n_q)
        eval_res = resolve_backend(q.backend, n_q)
        if trained_res != eval_res:
            print(f"note: checkpoint was trained on the {trained_res!r} circuit path "
                  f"(backend={trained_backend!r}); evaluating on {eval_res!r} "
                  "(numerically equivalent execution strategies)")
    mismatch = {k: v for k, v in stored.items() if getattr(q, k) != v}
    if mismatch:
        print(f"using checkpoint quantum config {mismatch}")
        cfg = dataclasses.replace(cfg, quantum=dataclasses.replace(q, **mismatch))
    return cfg


def save_train_state(
    workdir: str, tag: str, model: nn.Module, opt: Optimizer, meta: dict | None = None
) -> str:
    """Everything a resume needs: the model's state dict (BatchNorm statistics
    included), the optimizer's state and its update count."""
    return save_checkpoint(
        workdir, tag, {"params": model.state_dict(), "opt": opt.state_dict()}, meta
    )


def try_resume(
    workdir: str | None, tag: str, model: nn.Module, opt: Optimizer
) -> tuple[int, dict]:
    """Restore ``model`` and ``opt`` from ``workdir/tag`` in place when the tag
    exists. Returns ``(start_epoch, meta)``: the epoch after the checkpointed
    one (0 with nothing to resume) and the trainer's saved meta (the running
    best, so a resumed run does not clobber a better ``*_best``)."""
    if workdir is None or not has_checkpoint(workdir, tag):
        return 0, {}
    dev = next(model.parameters()).device
    payload, meta = restore_checkpoint(workdir, tag, map_location=dev)
    model.load_state_dict(payload["params"])
    opt.load_state_dict(payload["opt"])
    return int(meta.get("epoch", -1)) + 1, meta
