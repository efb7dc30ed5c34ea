"""Run manifests: the provenance header every telemetry artifact starts with
(``qdml_tpu/telemetry/manifest.py:30-136``).

Config and its content hash, git SHA, the torch/device topology, the
effective performance knobs and the seeds, captured once at startup and
written as the first line of the run's JSONL. The JAX package's ``jax``
block is ``null`` here (as its own ``include_jax=False`` leaves it); the
``torch`` block takes its place: version, CUDA version, backend, device
count and names, and the process index and count of the world.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Sequence

SCHEMA_VERSION = 1


def config_hash(cfg: Any) -> str:
    """Stable 16-hex content hash of a (nested) config dataclass or dict:
    equal to the JAX package's for configs whose ``dataclasses.asdict``
    dumps are equal."""
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else cfg
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def effective_knobs(cfg: Any) -> dict:
    """The performance-relevant knobs whose omission has bitten before."""
    return {
        "rng_impl": cfg.data.rng_impl,
        "trig_impl": cfg.data.trig_impl,
        "moments_dtype": cfg.train.moments_dtype,
        "scan_steps": cfg.train.scan_steps,
        "optimizer": cfg.train.optimizer,
        "model_dtype": cfg.model.dtype,
        "conv_impl": cfg.model.conv_impl,
        "quantum_backend": cfg.quantum.backend,
        "quantum_impl": cfg.quantum.impl,
        "quantum_autotune": cfg.quantum.autotune,
        "mesh": {
            "data_axis": cfg.mesh.data_axis,
            "model_axis": cfg.mesh.model_axis,
            "fed_axis": cfg.mesh.fed_axis,
        },
    }


def _git_info() -> dict | None:
    """Repo SHA and dirty flag; None outside a usable git checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=5, cwd=root)
        if sha.returncode != 0:
            return None
        status = subprocess.run(["git", "status", "--porcelain"], capture_output=True, text=True, timeout=5, cwd=root)
        return {
            "sha": sha.stdout.strip(),
            "dirty": bool(status.stdout.strip()) if status.returncode == 0 else None,
        }
    except (OSError, subprocess.SubprocessError):  # git absent: no provenance rather than no run
        return None


def _torch_info() -> dict:
    """torch and device topology; a failure is recorded, never raised."""
    try:
        import torch
        import torch.distributed as dist

        cuda = torch.cuda.is_available()
        world = dist.is_available() and dist.is_initialized()
        n = torch.cuda.device_count() if cuda else 0
        return {
            "version": torch.__version__,
            "cuda": torch.version.cuda,
            "backend": "cuda" if cuda else "cpu",
            "device_count": n,
            "device_names": sorted({torch.cuda.get_device_name(i) for i in range(n)}),
            "process_index": dist.get_rank() if world else 0,
            "process_count": dist.get_world_size() if world else 1,
        }
    except Exception as e:  # lint: disable=broad-except(a manifest must never kill a run; the failure is recorded in the manifest itself)
        return {"error": f"{type(e).__name__}: {e}"}


def run_manifest(
    cfg: Any = None,
    argv: Sequence[str] | None = None,
    include_torch: bool = True,
    extra: dict | None = None,
) -> dict:
    """The run-manifest record (``kind: "manifest"``). ``cfg`` (an
    :class:`~qdml_tpu_torch.config.ExperimentConfig`) adds the config hash,
    knobs, seeds and the full config dump; ``include_torch=False`` keeps it
    free of torch for host-side tools."""
    man: dict = {
        "kind": "manifest",
        "schema": SCHEMA_VERSION,
        "ts": round(time.time(), 3),
        "argv": list(argv) if argv is not None else None,
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "python": sys.version.split()[0],
        "git": _git_info(),
        "jax": None,
        "torch": _torch_info() if include_torch else None,
    }
    if cfg is not None:
        man["name"] = getattr(cfg, "name", None)
        man["config_hash"] = config_hash(cfg)
        man["knobs"] = effective_knobs(cfg)
        man["seeds"] = {"data": cfg.data.seed, "train": cfg.train.seed}
        man["config"] = dataclasses.asdict(cfg)
    if extra:
        man.update(extra)
    return man
