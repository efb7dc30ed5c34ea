"""Measured bucket-vs-ragged batching per capacity tier (``qdml_tpu/serve/batching_autotune.py``).

The third race of the port's measured dispatch (circuit impls in
:mod:`qdml_tpu_torch.quantum.autotune`, dense-vs-sparse routing in
:mod:`qdml_tpu_torch.ops.dispatch_autotune`). A tier can serve as
**bucket**, pad to the bucket and slice back (pad rows are inert because
every op is row-independent in eval mode), or as **ragged**, the same shape
with the pad rows zeroed inside the forward from the valid count, which
brings continuous admission with it. The two do the same work at the same
shape; the only cost ragged adds is the mask, and whether that is free on a
card at a shape is measured, per ``(platform, capacity, route, dtype)``,
and kept in a table.

- :func:`ensure_batching` is host-side and eager: ``ServeEngine.warmup``
  calls it per tier when ``serve.batching=auto``, never the request path.
- :func:`lookup` is read-only and cheap; any table pathology degrades to
  ``None`` (the caller's bucket fallback), never raises.
- A forced ``serve.batching=bucket|ragged`` never races.

Where the port differs from the JAX package:

- **Its own table**: ``results_torch/autotune/serve_batching.json`` by
  default (``QDML_TORCH_SERVE_BATCHING_TABLE`` overrides it), never
  ``results/``. The platform in a key is the device type (``cuda``, ``cpu``).
- **Timing** is the routing race's (:func:`~qdml_tpu_torch.ops.
  dispatch_autotune.measure`): the median wall ms of eager calls, each
  ended by a synchronisation of the device, after a warm-up call, so the
  three races' numbers compare.
- ``checkify`` stays in the key for the JAX package's format; the port's
  sanitizer is not ported (ROADMAP A.12), so it is always False here.
"""

from __future__ import annotations

import os
import time
from typing import Callable

from qdml_tpu_torch.utils.tune_table import TableStore

SCHEMA = 1
DEFAULT_TABLE = os.path.join("results_torch", "autotune", "serve_batching.json")
ENV_TABLE = "QDML_TORCH_SERVE_BATCHING_TABLE"

_MODES = ("bucket", "ragged")

_STORE = TableStore(DEFAULT_TABLE, ENV_TABLE, "serve_batching_table", "serve.batching_autotune")


def set_table_path(path: str | None) -> None:
    """Install (or clear, with None/"") the process-wide table location."""
    _STORE.set_path(path)


def table_path(path: str | None = None) -> str:
    """Explicit argument > installed path > ``QDML_TORCH_SERVE_BATCHING_TABLE`` > default."""
    return _STORE.path(path)


def table_key(
    platform: str,
    capacity: int,
    route: str = "dense",
    dtype: str = "float32",
    checkify: bool = False,
) -> str:
    """Entry key (``qdml_tpu/serve/batching_autotune.py:70-88``): the route and
    dtype are part of the raced shape (the sparse ragged forward threads the
    valid count through capacity accounting too)."""
    return f"{platform}/cap{capacity}/{route}/{dtype}" + ("/ck" if checkify else "")


def load_table(path: str | None = None) -> dict:
    """Entries of the table; ``{}`` on a missing/corrupt/alien file."""
    return _STORE.load(path)


def table_status(path: str | None = None) -> str:
    return _STORE.status(path)


def save_table(entries: dict, path: str | None = None) -> str:
    """Atomically persist the manifest-headed table; best-effort."""
    return _STORE.save(entries, path, schema=SCHEMA)


def invalidate_cache() -> None:
    _STORE.invalidate()


def lookup(
    capacity: int,
    route: str = "dense",
    dtype: str = "float32",
    path: str | None = None,
    checkify: bool = False,
    platform: str | None = None,
) -> str | None:
    """The tuned mode for this tier on ``platform`` (default: ``cuda`` when a
    card is visible, else ``cpu``), or ``None``. Never raises, never measures."""
    try:
        from qdml_tpu_torch.quantum.autotune import default_platform

        entry = load_table(path).get(
            table_key(platform or default_platform(), int(capacity), route, dtype, checkify)
        )
        if not isinstance(entry, dict):
            return None
        sel = entry.get("best_infer")
        return sel if sel in _MODES else None
    except Exception:  # any table pathology degrades to the bucket fallback
        return None


def ensure_batching(
    candidates: dict[str, tuple[Callable, tuple]],
    capacity: int,
    platform: str,
    route: str = "dense",
    dtype: str = "float32",
    path: str | None = None,
    force: bool = False,
    budget_s: float = 0.2,
    checkify: bool = False,
) -> dict:
    """This tier's table entry, raced and persisted first when absent (or
    ``force``). ``candidates`` maps ``"bucket"`` / ``"ragged"`` to ``(fn,
    args)`` at the full tier shape on the device named by ``platform``; a
    table hit calls neither."""
    from qdml_tpu_torch.ops.dispatch_autotune import measure

    key = table_key(platform, int(capacity), route, dtype, checkify)
    entries = dict(load_table(path))
    entry = entries.get(key)
    if not force and isinstance(entry, dict) and entry.get("best_infer") in _MODES:
        return entry
    cands = measure(candidates, budget_s=budget_s)
    timed = {m: v["infer_ms"] for m, v in cands.items() if isinstance(v.get("infer_ms"), (int, float))}
    best = min(timed, key=timed.get) if timed else "bucket"
    entry = {
        "key": key,
        "platform": platform,
        "capacity": int(capacity),
        "route": route,
        "dtype": dtype,
        "checkify": bool(checkify),
        "candidates": cands,
        "best_infer": best,
        "ts": round(time.time(), 3),
    }
    entries[key] = entry
    save_table(entries, path)
    return entry
