"""Joining a world, and each rank's rectangle of the grid batch (``qdml_tpu/parallel/multihost.py``).

The JAX package runs one program per host under ``jax.distributed``, each
host synthesizing only its slice of every global batch, which
``jax.make_array_from_process_local_data`` assembles into global arrays. The
port runs one process per rank under ``torch.distributed``:

- :func:`init_distributed_from_env` joins the world the launcher's
  environment describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``); it is strict, as JAX's is: a failed
  rendezvous raises (:func:`ensure_initialized`) instead of leaving R
  independent one-rank trainings on the same data;
- :func:`process_batch_slice` and :func:`process_grid_slice` keep JAX's
  rectangle rules and messages, computed from the rank's mesh coordinates
  (a rank owns one ``(fed, data)`` cell, and its model line shares it);
- :func:`make_grid_placer` switches a loader to its rank's rectangle
  (:meth:`~qdml_tpu_torch.data.datasets.DMLGridLoader.set_process_slice`).
  Every rank holds the whole grid, synthesized from the same seed, and
  gathers only its rectangle: at these sizes that is cheap, and the rows
  are exactly those the one-rank run puts in that slice.

JAX's ``local_grid_batch_to_global`` has no counterpart: no global array is
ever assembled, because each rank computes on its own rows and the
collectives (:mod:`~qdml_tpu_torch.parallel.collectives`) combine what the
step needs.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from qdml_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, Mesh, init_distributed, world_rank, world_size


def ensure_initialized(backend: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Idempotent ``init_process_group`` from the launcher's environment
    (``env://``), with a timeout: a no-op when the world is already live, and
    any rendezvous failure propagates."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend, init_method="env://", timeout=datetime.timedelta(seconds=timeout_s)
    )


def init_distributed_from_env(device: str | torch.device | None = None) -> bool:
    """Join the launcher's world on this rank's device when the environment
    names one of several ranks (``WORLD_SIZE > 1``); returns whether a world
    of several ranks is live. Without such an environment: ``False``, a
    no-op."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    init_distributed(device)
    return world_size() > 1


def process_batch_slice(global_bs: int, mesh: Mesh, axis: str = "data") -> tuple[int, int]:
    """``(start, length)`` of this rank's slice of the global batch: the
    ``axis`` coordinate's equal share (``qdml_tpu/parallel/multihost.py:
    157-192``). A batch the axis does not divide raises."""
    n = mesh.shape[axis]
    if global_bs % n:
        raise ValueError(f"global batch {global_bs} not divisible by {n} processes")
    local = global_bs // n
    return mesh.coord(axis) * local, local


def process_grid_slice(
    global_bs: int, n_scenarios: int, mesh: Mesh, fed: bool
) -> tuple[int, int, int, int]:
    """The contiguous ``(scen_start, scen_count, b_start, b_count)``
    rectangle of the grid batch this rank computes on
    (``qdml_tpu/parallel/multihost.py:195-256``): the batch over ``data``
    and, with ``fed``, the scenarios over ``fed``; the ranks of one model
    line share their cell's rectangle."""
    if mesh.size == 1:
        return 0, n_scenarios, 0, global_bs
    if not fed or mesh.shape["fed"] == 1:
        b0, blen = process_batch_slice(global_bs, mesh)
        return 0, n_scenarios, b0, blen
    n_fed, n_data = mesh.shape["fed"], mesh.shape["data"]
    if n_scenarios % n_fed:
        raise ValueError(f"{n_scenarios} scenarios do not shard evenly over the fed axis ({n_fed})")
    if global_bs % n_data:
        raise ValueError(f"global batch {global_bs} not divisible by the mesh data axis ({n_data})")
    spf, bpd = n_scenarios // n_fed, global_bs // n_data
    return mesh.coord("fed") * spf, spf, mesh.coord("data") * bpd, bpd


def make_grid_placer(loader, mesh: Mesh | None, fed: bool = False) -> None:
    """The trainers' batch placement for one loader
    (``qdml_tpu/parallel/multihost.py:259-297``). JAX returns a function
    that places each batch; here the loader itself yields this rank's rows,
    so nothing is returned:

    - no mesh: nothing changes;
    - a batch the ``data`` axis divides: the loader is switched to this
      rank's rectangle (:func:`process_grid_slice`);
    - a batch it does not divide (a split-clamped validation loader): every
      rank runs the whole batch, replicated, with JAX's log line. Every
      reduction over ``data`` in the trainers is a ratio of sums, or a mean
      of equal parts, so the replicated batch gives the same numbers.
    """
    if mesh is None:
        return
    bs = loader.batch_size
    data = mesh.shape["data"]
    if bs % data:
        if world_rank() == 0:
            print(
                f"note: batch {bs} not divisible by mesh data axis ({data}); "
                "running this loader replicated (no data parallelism)"
            )
        return
    s0, sc, b0, blen = process_grid_slice(bs, loader.cfg.n_scenarios, mesh, fed)
    loader.set_process_slice(b0, blen, s0, sc)

