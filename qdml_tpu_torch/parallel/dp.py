"""Data parallelism over the mesh's ``data`` axis (``qdml_tpu/parallel/dp.py``).

JAX places the batch with B split over ``data``, replicates the state, and
lets XLA insert the gradient all-reduce into the same jitted step. The port
writes each piece out:

- :func:`shard_grid_batch` / :func:`shard_flat_batch`: this rank's rows of
  a batch, B over ``data`` and, optionally, S over ``fed``, as JAX's
  ``grid_batch_spec`` splits them (the trainers' loaders yield those rows
  directly, :func:`~qdml_tpu_torch.parallel.multihost.make_grid_placer`);
- :func:`replicate`: parameters, buffers and optimizer state broadcast from
  rank 0;
- :func:`sync_grads`: the hook an
  :class:`~qdml_tpu_torch.train.optim.Optimizer` runs before its update,
  which reduces the gradients over the ranks that hold the same parameter;
- :func:`attach_batchnorm_group`: every
  :class:`~qdml_tpu_torch.models.cnn.BatchNorm2d` takes its statistics over
  the data line, as GSPMD computes them for the global batch.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist

from qdml_tpu_torch.parallel.collectives import all_reduce_many_, all_reduce_mean_, broadcast_
from qdml_tpu_torch.parallel.mesh import Mesh
from qdml_tpu_torch.utils.complexops import CArr


def _rows(n: int, mesh: Mesh, axis: str) -> slice:
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} rows do not split over the {axis} axis ({k})")
    c = mesh.coord(axis) if mesh.size > 1 else 0
    return slice(c * (n // k), (c + 1) * (n // k))


def shard_grid_batch(batch: dict, mesh: Mesh, fed: bool = False) -> dict:
    """This rank's rectangle of a grid batch ``(S, U, B, ...)``: B over
    ``data`` and, with ``fed``, S over ``fed`` (``qdml_tpu/parallel/dp.py:
    25-44``)."""

    def take(x):
        s = _rows(x.shape[0], mesh, "fed") if fed else slice(None)
        return x[s, :, _rows(x.shape[2], mesh, "data")]

    return {k: take(v) for k, v in batch.items()}


def shard_flat_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a flat batch (a tensor, a :class:`CArr`, or a
    dict of them, B leading) over ``data``."""
    if isinstance(batch, dict):
        return {k: shard_flat_batch(v, mesh) for k, v in batch.items()}
    rows = _rows(batch.shape[0], mesh, "data")
    return CArr(batch.re[rows], batch.im[rows]) if isinstance(batch, CArr) else batch[rows]


def replicate(state, mesh: Mesh | None, opt=None):
    """Make ``state`` (a module's parameters and floating-point buffers, or
    an iterable of tensors) and ``opt``'s state tensors, when given, rank
    0's on every rank of the world (``qdml_tpu/parallel/dp.py:58-66``).
    Returns ``state``."""
    if mesh is None or dist.get_world_size() == 1:
        return state
    if isinstance(state, torch.nn.Module):
        tensors = list(state.parameters()) + [b for b in state.buffers() if b.is_floating_point()]
    else:
        tensors = list(state)
    if opt is not None:
        for state in opt.opt.state.values():
            tensors += [v for v in state.values() if isinstance(v, torch.Tensor) and v.is_floating_point()]
    broadcast_(tensors)
    return state


def attach_batchnorm_group(module: torch.nn.Module, group) -> torch.nn.Module:
    """Point every mesh-aware BatchNorm of ``module`` at ``group`` (the data
    line; ``None`` detaches). Returns ``module``."""
    from qdml_tpu_torch.models.cnn import BatchNorm2d

    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.group = group
    return module


def sync_grads(reductions: Iterable[tuple[list[torch.Tensor], Any, str]]) -> Callable[[], None]:
    """The pre-update hook of an :class:`~qdml_tpu_torch.train.optim.
    Optimizer` under a mesh: for each ``(params, group, op)`` the gradients
    of ``params`` are averaged (``op="mean"``) or summed (``"sum"``) over
    ``group``; a ``None`` group is skipped. Parameters without a gradient
    take part as zeros, so every rank sends the same buffer."""
    plan = [(list(ps), g, op) for ps, g, op in reductions if g is not None and ps]

    def hook() -> None:
        for params, group, op in plan:
            grads = []
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
            (all_reduce_mean_ if op == "mean" else all_reduce_many_)(grads, group)

    return hook


def reduce_over_(tensors: list[torch.Tensor], mesh: Mesh, axes: Iterable[str]) -> None:
    """Sum ``tensors`` in place over this rank's lines along ``axes`` in
    turn (the ``(fed, data)`` plane of a loss or a metric whose parts the
    ranks computed); axes of size 1 cost nothing."""
    for axis in axes:
        all_reduce_many_(tensors, mesh.group(axis))
