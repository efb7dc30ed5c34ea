"""Measured implementation dispatch for the circuit (``qdml_tpu/quantum/autotune.py``).

The circuit has six interchangeable implementations in the port (``dense``,
``dense_fused``, ``tensor``, the CUDA kernels behind ``pallas`` and
``pallas_circuit``, and the bond-chi ``mps``), and which is fastest depends on the card, the qubit
count and the batch. So ``impl=auto`` does not guess: :func:`ensure` times
every eligible implementation once per ``(platform, n_qubits, n_layers,
batch bucket, dtype)`` key, the winners persist in a manifest-headed JSON
table, and every later call of that shape reads the table.

- :func:`ensure` (the tuner) is host-side and eager. The QSC trainer calls it
  (through :func:`prewarm`) before its first step and the serving engine per
  bucket at warmup; nothing calls it on the request path.
- :func:`lookup_reason` is read-only and cheap. The port runs it on every
  eager forward (JAX runs it once per trace), so after the table's first
  read it costs one dict lookup: no file I/O, no device sync, no tensor.
  Any table pathology degrades to the static heuristic
  (``circuits.resolve_backend``), never to an exception.

Where the port differs from the JAX package:

- **Its own table**: ``results_torch/autotune/qsc_impl.json`` by default
  (``QDML_TORCH_QSC_AUTOTUNE_TABLE`` overrides it, ``quantum.autotune_table``
  installs another). ``results/autotune/qsc_impl.json`` is the JAX
  package's, never read or written here. The platform in a key is the
  device type, ``cuda`` on the card and ``cpu`` in tests.
- **The ``pallas_circuit`` window is the port kernel's, 2 <= n <= 12.** JAX
  times it only at 128 <= 2^n <= 4096: below one 128-lane tile its kernel
  gives way to its XLA twin, so timing it there would re-measure dense math.
  The port's CUDA kernel runs for real from n = 2 (the ring needs two wires;
  ``kernels._check_circuit_window``), so the shipped n = 6 classifier gets a
  candidate that builds no unitary. The other windows are JAX's: ``dense``
  and ``dense_fused`` n <= 12, ``pallas`` n <= 8, ``tensor`` 9 <= n <= 14,
  ``mps`` from n = 13 (timed at ``quantum.mps_chi``, which the entry
  records). ``sharded_statevector`` from n = 10 on a model line of two or
  more ranks (:func:`model_axis_devices`), as JAX's rule on its devices.
- **Timing is eager on the device**: per candidate the median of reps of a
  forward (``fwd_ms``) and of one forward plus ``backward()`` of
  ``sum(out**2)`` with respect to the weights (``train_ms``, JAX's single
  ``value_and_grad``), each rep ended by a device synchronisation, after an
  untimed warm-up call that also builds the kernels.
- **A candidate that breaks raises.** JAX records any candidate's error and
  races on; the port records only the errors that say a candidate cannot
  run here (ineligible, not ported). A kernel that fails to build or launch
  stops :func:`ensure`, and with it trainer start and serve warmup, rather
  than leave the card on a plain version under a saved table.
- **Fallbacks print** JAX's no-sink line once per (table, key, reason): the
  port has no telemetry sink yet (ROADMAP A.12).
"""

from __future__ import annotations

import os
import statistics
import time
from functools import lru_cache
from typing import Any, Sequence

import numpy as np
import torch

from qdml_tpu_torch.quantum.kernels import CIRCUIT_MIN_QUBITS, QSC_MAX_QUBITS
from qdml_tpu_torch.quantum.mps import DEFAULT_CHI
from qdml_tpu_torch.utils.device import resolve_device
from qdml_tpu_torch.utils.tune_table import TableStore, activity

SCHEMA = 1
DEFAULT_TABLE = os.path.join("results_torch", "autotune", "qsc_impl.json")
ENV_TABLE = "QDML_TORCH_QSC_AUTOTUNE_TABLE"

_STORE = TableStore(DEFAULT_TABLE, ENV_TABLE, "qsc_autotune_table", "quantum.autotune")
# (table, key, reason) triples already reported: the lookup runs on every
# forward, and one line per distinct pathology is signal where one per call
# would be noise.
_FALLBACK_EMITTED: set[tuple] = set()

# Winners a table entry may name: concrete impls only ("auto" would recurse
# through the resolver). The JAX package's set, so one table means the same
# in both; impl_eligible then refuses what this package cannot run.
_DISPATCHABLE = frozenset(
    {
        "dense",
        "dense_fused",
        "pallas",
        "pallas_circuit",
        "pallas_tensor",
        "tensor",
        "mps",
        "sharded",
        "sharded_statevector",
    }
)

# Capacity caps (qdml_tpu/quantum/autotune.py:92-93): the dense 2^n x 2^n
# unitary build and the per-sample 2^n statevector. The timing windows of
# the kernel impls are the kernels' own (QSC_MAX_QUBITS, CIRCUIT_MIN_QUBITS).
DENSE_MAX_QUBITS = 12
TENSOR_MAX_QUBITS = 14
TENSOR_MIN_QUBITS = 9
# mps races tensor over the 13-14 crossover and is the only candidate past 14
MPS_MIN_QUBITS = 13
# the sharded statevector is timed from here, on a model line of >= 2 ranks
SHARDED_MIN_QUBITS = 10
# Impls the port has no counterpart for: none since the sharded statevector
# landed (quantum/sharded.py).
UNPORTED_IMPLS: tuple[str, ...] = ()


class ImplIneligibleError(ValueError):
    """A pinned circuit impl cannot run at this qubit count or topology.

    Raised where a configuration or checkpoint forces an impl that
    :func:`impl_eligible` rejects (``dense`` pinned at n > 12, or
    ``sharded_statevector`` restored on one rank), so a restore fails with
    the eligibility reason instead of deep in the first forward."""


def model_axis_devices() -> int:
    """The ranks on the current mesh's model line
    (:func:`~qdml_tpu_torch.parallel.mesh.current_mesh`), or 1 without a
    mesh: the topology the ``sharded_statevector`` rules read."""
    from qdml_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    return 1 if mesh is None else mesh.shape["model"]


def impl_eligible(
    impl: str, n_qubits: int, devices_on_model: int | None = None
) -> tuple[bool, str | None]:
    """Whether ``impl`` can run at ``n_qubits`` on a model line of
    ``devices_on_model`` ranks (default :func:`model_axis_devices`) in the
    port: ``(ok, reason)``. The capacity caps and the topology rule of
    ``qdml_tpu/quantum/autotune.py:122-156``. Unknown names raise
    ``ValueError``."""
    from qdml_tpu_torch.quantum.circuits import canonical_impl

    impl = canonical_impl(impl)
    if impl in ("dense", "dense_fused", "pallas", "pallas_circuit") and n_qubits > DENSE_MAX_QUBITS:
        return False, f"impl {impl!r} is capped at n <= {DENSE_MAX_QUBITS}; n={n_qubits}"
    if impl == "tensor" and n_qubits > TENSOR_MAX_QUBITS:
        return False, (
            f"the 2^n statevector per sample is capped at n <= {TENSOR_MAX_QUBITS}; "
            f"n={n_qubits} needs mps or sharded_statevector"
        )
    if impl == "sharded_statevector":
        devs = model_axis_devices() if devices_on_model is None else devices_on_model
        if devs < 2:
            return False, (
                "sharded_statevector partitions the amplitudes over the mesh's "
                f"model axis and needs >= 2 devices; this topology has {devs}"
            )
    return True, None


def eligible_impls(n_qubits: int, devices_on_model: int | None = None) -> list[str]:
    """Implementations worth timing at ``n_qubits``, in JAX's order (see the
    module docstring for the windows and the ``pallas_circuit`` difference);
    ``sharded_statevector`` only when ``devices_on_model`` >= 2 is given, as
    JAX's topology-blind default leaves it out."""
    impls = []
    if n_qubits <= DENSE_MAX_QUBITS:
        impls += ["dense", "dense_fused"]
    if n_qubits <= QSC_MAX_QUBITS:
        impls.append("pallas")
    if CIRCUIT_MIN_QUBITS <= n_qubits <= DENSE_MAX_QUBITS:
        impls.append("pallas_circuit")
    if TENSOR_MIN_QUBITS <= n_qubits <= TENSOR_MAX_QUBITS:
        impls.append("tensor")
    if n_qubits >= MPS_MIN_QUBITS:
        impls.append("mps")
    if devices_on_model is not None and devices_on_model >= 2 and n_qubits >= SHARDED_MIN_QUBITS:
        impls.append("sharded_statevector")
    return impls


@lru_cache(maxsize=1)
def default_platform() -> str:
    """The platform word of a call that names no device: ``cuda`` when a card
    is visible (entry points run there by default), else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def autotune_enabled(setting: str, platform: str | None = None) -> bool:
    """``quantum.autotune``: "on" / "off" / "auto" (tune on the card only;
    the CPU keeps the heuristic and pays no tuning)."""
    s = (setting or "auto").lower()
    if s in ("on", "1", "true", "yes"):
        return True
    if s in ("off", "0", "false", "no"):
        return False
    return (platform or default_platform()) != "cpu"


def batch_bucket(batch: int) -> int:
    """Power-of-two batch bucket: one entry covers every batch up to it."""
    b = 1
    while b < max(1, int(batch)):
        b *= 2
    return b


def table_key(
    platform: str, n_qubits: int, n_layers: int, bucket: int, dtype: str = "float32"
) -> str:
    return f"{platform}/n{n_qubits}/L{n_layers}/b{bucket}/{dtype}"


# ---------------------------------------------------------------------------
# Persistence (utils/tune_table.TableStore)
# ---------------------------------------------------------------------------


def set_table_path(path: str | None) -> None:
    """Install (or clear, with None/"") the process-wide table location."""
    _STORE.set_path(path)


def table_path(path: str | None = None) -> str:
    """Explicit argument > installed path > ``QDML_TORCH_QSC_AUTOTUNE_TABLE`` > default."""
    return _STORE.path(path)


def load_table(path: str | None = None) -> dict:
    """Entries of the table at ``path``; ``{}`` on a missing/corrupt/alien file."""
    return _STORE.load(path)


def table_status(path: str | None = None) -> str:
    """"ok" / "missing" / "corrupt" / "alien" / "unreadable"."""
    return _STORE.status(path)


def save_table(entries: dict, path: str | None = None) -> str:
    """Atomically persist the manifest-headed table; best-effort."""
    return _STORE.save(entries, path, schema=SCHEMA)


def invalidate_cache() -> None:
    """Drop the table cache, the installed path and the reported fallbacks."""
    _STORE.invalidate()
    _FALLBACK_EMITTED.clear()


# ---------------------------------------------------------------------------
# Micro-benchmark
# ---------------------------------------------------------------------------


def _sync(args) -> None:
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.is_cuda:
                torch.cuda.synchronize(a.device)
            return


def _time_callable(fn, args, budget_s: float, max_reps: int) -> float:
    """Median wall ms of ``fn(*args)`` over reps, each ended by a sync of the
    device of the first tensor in ``args``, after one untimed warm-up call
    (which builds the kernels and lets cuDNN pick its algorithms)."""
    fn(*args)
    _sync(args)
    t0 = time.perf_counter()
    fn(*args)
    _sync(args)
    est = max(time.perf_counter() - t0, 1e-5)
    reps = max(3, min(max_reps, int(budget_s / est)))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(args)
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def measure(
    n_qubits: int,
    n_layers: int,
    bucket: int,
    impls: Sequence[str] | None = None,
    budget_s: float = 0.25,
    max_reps: int = 30,
    device: str | torch.device | None = None,
    mps_chi: int | None = None,
) -> dict[str, dict[str, Any]]:
    """``fwd_ms`` and ``train_ms`` of each candidate at this exact shape on
    ``device``, the ``mps`` candidate at bond dimension ``mps_chi``. A
    candidate that cannot run here (:func:`impl_eligible` refuses it at this
    n on this topology, or it raises ``ImplIneligibleError`` or
    ``NotImplementedError``) is recorded with its error and left out of the
    selection, as in JAX. Any other error, a kernel that fails to build or to
    launch among them, raises: the race must not hand ``impl=auto`` to the
    plain versions in its place, nor save a table that would keep it there."""
    from qdml_tpu_torch.quantum.circuits import run_circuit

    dev = resolve_device(device)
    activity["measure"] += 1
    impls = list(impls) if impls is not None else eligible_impls(n_qubits)
    rng = np.random.default_rng(0)
    angles = torch.tensor(rng.uniform(-1, 1, (bucket, n_qubits)).astype(np.float32), device=dev)
    weights = torch.tensor(
        rng.uniform(0, 2 * np.pi, (n_layers, n_qubits, 2)).astype(np.float32), device=dev
    )
    out: dict[str, dict[str, Any]] = {}
    for impl in impls:
        rec: dict[str, Any] = {}
        try:
            ok, why = impl_eligible(impl, n_qubits)
            if not ok:  # a pinned candidate this topology cannot run
                raise ImplIneligibleError(why)

            def fwd(a, w, impl=impl):
                with torch.no_grad():
                    return run_circuit(a, w, n_qubits, n_layers, impl=impl, mps_chi=mps_chi)

            rec["fwd_ms"] = round(_time_callable(fwd, (angles, weights), budget_s, max_reps), 4)
            # train metric = ONE forward + backward (JAX's value_and_grad);
            # fwd_ms + a separate grad time would count the forward twice
            w_train = weights.clone().requires_grad_(True)

            def step(a, w, impl=impl):
                w.grad = None
                loss = (run_circuit(a, w, n_qubits, n_layers, impl=impl, mps_chi=mps_chi) ** 2).sum()
                loss.backward()
                return loss

            rec["train_ms"] = round(_time_callable(step, (angles, w_train), budget_s, max_reps), 4)
        except (ImplIneligibleError, NotImplementedError) as e:  # recorded in the table
            rec["error"] = f"{type(e).__name__}: {e}"
        out[impl] = rec
    return out


def _pick(cands: dict[str, dict], field: str) -> str | None:
    timed = {k: v[field] for k, v in cands.items() if isinstance(v.get(field), (int, float))}
    return min(timed, key=timed.get) if timed else None


def ensure(
    n_qubits: int,
    n_layers: int,
    batch: int,
    dtype: str = "float32",
    path: str | None = None,
    force: bool = False,
    budget_s: float = 0.25,
    impls: Sequence[str] | None = None,
    device: str | torch.device | None = None,
    mps_chi: int | None = None,
) -> dict:
    """This shape's table entry on ``device``, measured and persisted first
    when absent (or ``force``). Host-side and eager: call it where a warm-up
    is expected (trainer start, serve warmup), never on the request path.
    The ``mps`` candidate is timed at ``mps_chi``, which an entry that raced
    it records (``qdml_tpu/quantum/autotune.py:468-471``)."""
    dev = resolve_device(device)
    platform = dev.type
    bucket = batch_bucket(batch)
    key = table_key(platform, n_qubits, n_layers, bucket, dtype)
    entries = dict(load_table(path))
    entry = entries.get(key)
    if not force and isinstance(entry, dict) and entry.get("best_train"):
        return entry
    if impls is None:
        impls = eligible_impls(n_qubits)
    cands = measure(n_qubits, n_layers, bucket, impls=impls, budget_s=budget_s, device=dev, mps_chi=mps_chi)
    entry = {
        "key": key,
        "platform": platform,
        "n_qubits": n_qubits,
        "n_layers": n_layers,
        "batch_bucket": bucket,
        "dtype": dtype,
        "candidates": cands,
        "best_fwd": _pick(cands, "fwd_ms"),
        "best_train": _pick(cands, "train_ms"),
        "ts": round(time.time(), 3),
    }
    if "mps" in cands:
        entry["mps_chi"] = int(mps_chi or DEFAULT_CHI)
    entries[key] = entry
    save_table(entries, path)
    return entry


def lookup_reason(
    n_qubits: int,
    n_layers: int,
    batch: int,
    dtype: str = "float32",
    mode: str = "train",
    path: str | None = None,
    platform: str | None = None,
) -> tuple[str | None, str | None]:
    """``(selection, fallback_reason)`` for this shape on ``platform``.

    ``selection`` is the tuned impl, or ``None`` (the caller takes the static
    heuristic). ``fallback_reason`` is ``None`` for the normal misses (no
    table yet, shape not tuned) and a slug for the pathologies:
    ``table-corrupt`` / ``table-alien`` / ``table-unreadable``,
    ``entry-alien`` (the winner names no dispatchable impl) and
    ``entry-ineligible`` (the winner cannot run here). Never raises, never
    measures, never reads the file past its first load."""
    try:
        from qdml_tpu_torch.quantum.circuits import canonical_impl

        entries = load_table(path)
        status = table_status(path)
        reason = f"table-{status}" if status in ("corrupt", "alien", "unreadable") else None
        entry = entries.get(
            table_key(platform or default_platform(), n_qubits, n_layers, batch_bucket(batch), dtype)
        )
        if not isinstance(entry, dict):
            return None, reason
        sel = entry.get("best_fwd" if mode == "infer" else "best_train")
        if not isinstance(sel, str) or sel not in _DISPATCHABLE:
            return None, "entry-alien" if sel is not None else reason
        sel = canonical_impl(sel)
        ok, _why = impl_eligible(sel, n_qubits)
        if not ok:
            return None, "entry-ineligible"
        return sel, None
    except Exception:  # any table pathology degrades to the heuristic
        return None, None


def lookup(
    n_qubits: int,
    n_layers: int,
    batch: int,
    dtype: str = "float32",
    mode: str = "train",
    path: str | None = None,
    platform: str | None = None,
) -> str | None:
    """The tuned impl for this shape, or ``None``."""
    return lookup_reason(n_qubits, n_layers, batch, dtype, mode, path, platform)[0]


def emit_fallback(
    reason: str,
    n_qubits: int,
    n_layers: int,
    batch: int,
    mode: str,
    fallback: str,
    platform: str | None = None,
) -> dict | None:
    """Report a pathological fallback once per (table, key, reason) with
    JAX's no-sink line. Returns the record, or ``None`` when this pathology
    was already reported."""
    p = table_path()
    key = table_key(platform or default_platform(), n_qubits, n_layers, batch_bucket(batch))
    tok = (p, key, reason)
    if tok in _FALLBACK_EMITTED:
        return None
    _FALLBACK_EMITTED.add(tok)
    print(f"autotune_fallback: {reason} table={p} key={key} -> {fallback}", flush=True)
    return {"reason": reason, "table": p, "key": key, "mode": mode, "fallback": fallback}


def prewarm(
    cfg, batch: int, force: bool = False, device: str | torch.device | None = None, mesh=None
) -> dict | None:
    """Tune ``cfg.quantum``'s circuit at ``batch`` on ``device`` when the
    dispatcher is in play: ``quantum.impl`` and ``quantum.backend`` both
    ``auto`` and ``quantum.autotune`` on for this platform. A configured
    ``quantum.autotune_table`` is installed process-wide first, so the
    per-call lookup reads the table the tuner writes. Under a ``mesh`` rank
    0 alone races and writes the table, and every rank adopts its entry
    (:func:`adopt_entry`), so the ranks dispatch one impl. Returns the
    entry, or ``None`` when tuning was skipped."""
    q = cfg.quantum
    if q.autotune_table:
        set_table_path(q.autotune_table)
    if q.impl not in ("", "auto") or q.backend != "auto":
        return None
    dev = resolve_device(device)
    if not autotune_enabled(q.autotune, dev.type):
        return None
    entry = None
    if mesh is None or mesh.rank == 0:
        entry = ensure(
            q.n_qubits, q.n_layers, batch, path=q.autotune_table or None, force=force, device=dev,
            mps_chi=q.mps_chi,
        )
    if mesh is not None:
        from qdml_tpu_torch.parallel.collectives import broadcast_object

        entry = broadcast_object(entry)
        adopt_entry(entry, q.autotune_table or None)
    return entry


def adopt_entry(entry: dict, path: str | None = None) -> None:
    """Put ``entry``, measured by another rank, into this process's view of
    the table at ``path``, without measuring or writing."""
    load_table(path)[entry["key"]] = entry
