"""Shared persistence for the measured-dispatch tables (``qdml_tpu/utils/tune_table.py``).

The circuit-impl race (:mod:`qdml_tpu_torch.quantum.autotune`), the
routing race (:mod:`qdml_tpu_torch.ops.dispatch_autotune`) and the batching
race (:mod:`qdml_tpu_torch.serve.batching_autotune`) keep their tables in a
:class:`TableStore` each, as the JAX package's three races do:

- loads never raise: any pathology degrades to ``{}`` entries with a status
  in ``ok|missing|corrupt|alien|unreadable``, so tuning can speed a hot path
  up and never crash it;
- saves are atomic (tmp + ``os.replace``) and best-effort: serving survives
  a read-only results directory;
- an in-process cache keyed on the absolute path makes repeat lookups free
  of file I/O; ``invalidate()`` clears it.

The table files are the JAX package's format (``{"schema", "kind",
"manifest", "entries"}``), so either package reads the other's entries. The
manifest is the run manifest of :mod:`qdml_tpu_torch.telemetry.manifest`:
its ``torch`` block records this package's runtime and devices, and its
``jax`` is null.

``activity`` counts the measurements the race takes and the tables it
writes, process-wide: the serving engine reads it to show that its request
path does neither after warmup.
"""

from __future__ import annotations

import json
import os

# Races measured (``autotune.measure`` adds one per call) and tables
# written (``TableStore.save``), since the process started.
activity = {"measure": 0, "save": 0}


class TableStore:
    """One autotune table's path resolution, cache, load and atomic save."""

    def __init__(self, default_path: str, env_var: str, kind: str, argv_tag: str):
        self.default_path = default_path
        self.env_var = env_var
        self.kind = kind          # payload "kind" stamped into saved tables
        self.argv_tag = argv_tag  # manifest argv label for provenance
        self._cache: dict[str, dict] = {}
        self._status: dict[str, str] = {}
        self._active: str | None = None

    def set_path(self, path: str | None) -> None:
        """Install (or clear, with None/"") the process-wide table location."""
        self._active = os.path.abspath(path) if path else None

    def path(self, path: str | None = None) -> str:
        """Explicit argument > installed path > environment > default."""
        return os.path.abspath(
            path or self._active or os.environ.get(self.env_var) or self.default_path
        )

    def load(self, path: str | None = None) -> dict:
        """The entries dict; ``{}`` on a missing/corrupt/alien file, never raises."""
        p = self.path(path)
        if p in self._cache:
            return self._cache[p]
        entries: dict = {}
        status = "ok"
        try:
            with open(p) as fh:
                data = json.load(fh)
            if isinstance(data, dict) and isinstance(data.get("entries"), dict):
                entries = data["entries"]
            else:
                status = "alien"
        except FileNotFoundError:
            status = "missing"
        except json.JSONDecodeError:
            status = "corrupt"
        except OSError:
            status = "unreadable"
        except (ValueError, TypeError):
            status = "corrupt"
        self._cache[p] = entries
        self._status[p] = status
        return entries

    def status(self, path: str | None = None) -> str:
        """How the table at ``path`` loaded (loads and caches on first ask)."""
        self.load(path)
        return self._status.get(self.path(path), "ok")

    def save(self, entries: dict, path: str | None = None, schema: int = 1) -> str:
        """Atomically persist the manifest-headed table; best-effort. Returns
        the path."""
        p = self.path(path)
        activity["save"] += 1
        from qdml_tpu_torch.telemetry.manifest import run_manifest

        payload = {
            "schema": schema,
            "kind": self.kind,
            "manifest": run_manifest(argv=[self.argv_tag]),
            "entries": entries,
        }
        try:
            os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
            tmp = f"{p}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, indent=2)
                fh.write("\n")
            os.replace(tmp, p)
        except OSError:
            pass
        self._cache[p] = entries
        self._status[p] = "ok"
        return p

    def invalidate(self) -> None:
        """Drop the cache and the installed path (tests, or after an external edit)."""
        self._cache.clear()
        self._status.clear()
        self.set_path(None)
