"""Measured dense-vs-sparse routing dispatch (``qdml_tpu/ops/dispatch_autotune.py``).

At the reference's S = 3 running every trunk and gathering
(:func:`~qdml_tpu_torch.ops.routing.select_expert`) is nearly free, but the
estimation work grows with S, so somewhere past that grid the
capacity-bucketed sparse path (:func:`~qdml_tpu_torch.ops.routing.
sparse_dispatch`) must take over. Where is a property of the card, the
scenario count and the batch bucket, so ``serve.dispatch=auto`` measures it
per ``(platform, S, bucket, capacity factor, dtype)`` key and keeps the
winner in a table, as the circuit-impl race does
(:mod:`qdml_tpu_torch.quantum.autotune`).

- :func:`ensure_route` (the tuner) is host-side and eager: the serving
  engine calls it per bucket at warmup, the scenario-scaling bench per S
  point; never the request path.
- :func:`lookup` is read-only and cheap; any table pathology degrades to the
  ``dense`` fallback, never raises.
- ``sparse`` enters the race only from :data:`SPARSE_MIN_SCENARIOS`: below
  it nothing is timed, the entry records the exclusion and is not saved
  (a window-only decision carries no timing worth caching).
- The race times the routing stage under a balanced top-1 load
  (``pred = i % S``): the classifier forward is the same in both
  candidates, and a random-init classifier's degenerate argmax would send
  every sparse row through the overflow fallback.

Where the port differs from the JAX package:

- **Its own table**: ``results_torch/autotune/routing_dispatch.json`` by
  default (``QDML_TORCH_ROUTING_AUTOTUNE_TABLE`` overrides it), in a
  :class:`~qdml_tpu_torch.utils.tune_table.TableStore` beside
  ``qsc_impl.json``; never ``results/``, the JAX package's. The platform in
  a key is the device type (``cuda``, ``cpu``).
- **Timing** is the impl race's: the median wall ms of eager calls, each
  ended by a device synchronisation, after a warm-up call. The sparse
  candidate reads its overflow count on the host, as the port's sparse
  route always does (one sync a call).
- **A candidate that breaks raises.** Only the errors that say a candidate
  cannot run here (``ImplIneligibleError``, ``NotImplementedError``) are
  recorded in the entry; any other error stops the race, as in the impl
  race, instead of handing ``auto`` to the other mode under a saved table.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable

import torch

from qdml_tpu_torch.ops.routing import select_expert, sparse_dispatch
from qdml_tpu_torch.quantum.autotune import (
    ImplIneligibleError,
    _time_callable,
    batch_bucket,
    default_platform,
)
from qdml_tpu_torch.utils.tune_table import TableStore, activity

SCHEMA = 1
DEFAULT_TABLE = os.path.join("results_torch", "autotune", "routing_dispatch.json")
ENV_TABLE = "QDML_TORCH_ROUTING_AUTOTUNE_TABLE"

# Below this scenario count the sparse path is not worth timing: S*C rows of
# sparse trunk work ~= capacity_factor * B barely undercuts S * B while
# paying the rank/scatter/gather bookkeeping (qdml_tpu/ops/dispatch_autotune.py:49-54).
SPARSE_MIN_SCENARIOS = 6

_MODES = ("dense", "sparse")

_STORE = TableStore(DEFAULT_TABLE, ENV_TABLE, "routing_dispatch_table", "ops.dispatch_autotune")

# a function of stacked per-scenario inputs (S, B', 2, H, W) -> (S, B', D)
ApplyTrunks = Callable[[torch.Tensor], torch.Tensor]


def set_table_path(path: str | None) -> None:
    """Install (or clear, with None/"") the process-wide table location."""
    _STORE.set_path(path)


def table_path(path: str | None = None) -> str:
    """Explicit argument > installed path > ``QDML_TORCH_ROUTING_AUTOTUNE_TABLE`` > default."""
    return _STORE.path(path)


def table_key(
    platform: str,
    n_scenarios: int,
    bucket: int,
    dtype: str = "float32",
    capacity_factor: float = 1.25,
) -> str:
    """Entry key (``qdml_tpu/ops/dispatch_autotune.py:68-79``): the capacity
    factor is part of the raced shape, since the sparse candidate does about
    ``f * B`` rows of trunk work."""
    return f"{platform}/S{n_scenarios}/b{bucket}/f{capacity_factor:g}/{dtype}"


def eligible_modes(n_scenarios: int) -> list[str]:
    """Modes worth racing at this scenario count: ``dense`` always (it is
    also the overflow fallback), ``sparse`` from :data:`SPARSE_MIN_SCENARIOS`."""
    modes = ["dense"]
    if n_scenarios >= SPARSE_MIN_SCENARIOS:
        modes.append("sparse")
    return modes


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
    n_scenarios: int,
    batch: int,
    dtype: str = "float32",
    path: str | None = None,
    capacity_factor: float = 1.25,
    platform: str | None = None,
) -> str | None:
    """The tuned mode for this shape on ``platform`` (default: ``cuda``
    when a card is visible, else ``cpu``), or ``None`` (the caller falls
    back to dense). Never raises, never measures."""
    try:
        entry = load_table(path).get(
            table_key(platform or default_platform(), n_scenarios, batch_bucket(batch), dtype, capacity_factor)
        )
        if not isinstance(entry, dict):
            return None
        sel = entry.get("best_infer")
        if sel not in _MODES:
            return None
        if sel == "sparse" and n_scenarios < SPARSE_MIN_SCENARIOS:
            # an alien or hand-edited entry cannot force sparse below its window
            return None
        return sel
    except Exception:  # lint: disable=broad-except(dispatch lookup must degrade to the dense fallback on ANY table pathology: tuning can speed routing up, never crash it)
        return None


def route_candidates(
    apply_trunks: ApplyTrunks,
    x: torch.Tensor,
    n_scenarios: int,
    capacity_factor: float,
) -> dict[str, tuple[Callable, tuple]]:
    """The two routing-stage candidates at this exact shape: ``x`` (B, 2, H,
    W) on the device, both fed the balanced top-1 load ``pred = i % S``.
    Each is ``(fn, args)``; ``fn(*args)`` returns (B, D) without autograd."""
    s = int(n_scenarios)
    pred = torch.arange(x.shape[0], device=x.device) % s

    def _dense(xx, pp):
        with torch.inference_mode():
            return select_expert(apply_trunks(xx.expand(s, *xx.shape)), pp)

    def _sparse(xx, pp):
        with torch.inference_mode():
            out, _ = sparse_dispatch(apply_trunks, _dense, xx, pp, s, capacity_factor)
            return out

    return {"dense": (_dense, (x, pred)), "sparse": (_sparse, (x, pred))}


def measure(
    candidates: dict[str, tuple[Callable, tuple]],
    budget_s: float = 0.2,
    max_reps: int = 30,
) -> dict[str, dict[str, Any]]:
    """Median wall ms (``infer_ms``) per candidate, the impl race's timer. A
    candidate that cannot run here is recorded with its error; any other
    error raises."""
    activity["measure"] += 1
    out: dict[str, dict[str, Any]] = {}
    for mode, (fn, args) in candidates.items():
        rec: dict[str, Any] = {}
        try:
            rec["infer_ms"] = round(_time_callable(fn, args, budget_s, max_reps), 4)
        except (ImplIneligibleError, NotImplementedError) as e:  # recorded in the table
            rec["error"] = f"{type(e).__name__}: {e}"
        out[mode] = rec
    return out


def ensure_route(
    apply_trunks: ApplyTrunks,
    x: torch.Tensor,
    n_scenarios: int,
    capacity_factor: float = 1.25,
    dtype: str = "float32",
    path: str | None = None,
    force: bool = False,
    budget_s: float = 0.2,
) -> dict:
    """This shape's table entry on ``x``'s device, raced and persisted first
    when absent (or ``force``). With one eligible mode nothing is timed:
    the entry names it, records the exclusion, and is not saved."""
    platform = x.device.type
    bucket = batch_bucket(x.shape[0])
    key = table_key(platform, n_scenarios, bucket, dtype, capacity_factor)
    entries = dict(load_table(path))
    entry = entries.get(key)
    if not force and isinstance(entry, dict) and entry.get("best_infer"):
        return entry
    modes = eligible_modes(n_scenarios)
    excluded = []
    if "sparse" not in modes:
        excluded.append({
            "mode": "sparse",
            "reason": (
                f"S={n_scenarios} < {SPARSE_MIN_SCENARIOS}: bucketing bookkeeping cannot "
                "beat a fused all-trunks pass this small (eligibility window)"
            ),
        })
    raced = len(modes) > 1
    if not raced:
        cands: dict[str, dict[str, Any]] = {modes[0]: {"only_candidate": True}}
        best = modes[0]
    else:
        every = route_candidates(apply_trunks, x, n_scenarios, capacity_factor)
        cands = measure({m: every[m] for m in modes}, budget_s=budget_s)
        timed = {m: v["infer_ms"] for m, v in cands.items() if isinstance(v.get("infer_ms"), (int, float))}
        best = min(timed, key=timed.get) if timed else "dense"
    entry = {
        "key": key,
        "platform": platform,
        "n_scenarios": int(n_scenarios),
        "batch_bucket": bucket,
        "dtype": dtype,
        "capacity_factor": float(capacity_factor),
        "candidates": cands,
        "best_infer": best,
        "ts": round(time.time(), 3),
    }
    if excluded:
        entry["excluded"] = excluded
    if raced:
        entries[key] = entry
        save_table(entries, path)
    return entry
