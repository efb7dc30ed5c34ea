"""The collectives of the port's mesh, written out, each with its gradient rule.

JAX's collectives have no file of their own: XLA inserts them where the
shardings meet, and AD differentiates them. The port calls
``torch.distributed`` over the groups of a
:class:`~qdml_tpu_torch.parallel.mesh.Mesh` (``None`` is an axis of size 1,
where each of these is the identity), and every collective a gradient
passes through is a ``torch.autograd.Function`` whose backward gives the
one-rank gradient:

- :func:`exchange`: swap a tensor with one partner rank; the backward swaps
  the cotangent back with the same partner (XOR pairing is its own inverse);
- :func:`psum_replicated`: forward all-reduce-sum, backward identity. Its
  output is replicated, and every rank computes the same loss from it, so
  each rank's cotangent already is the whole one;
- :func:`enter_replicated`: forward identity, backward all-reduce-sum. A
  replicated input (angles, weights, the head's input) reaches each rank's
  part of the work; the parts' cotangents sum to its gradient;
- :func:`psum_parts`: forward and backward all-reduce-sum, for a sum whose
  result feeds every rank's PART of a loss that is the sum over the ranks
  (BatchNorm's statistics over the data line);
- :func:`all_gather_cols`: the head's column shards concatenated on the last
  axis; the backward keeps this rank's columns of the (replicated)
  cotangent;
- :func:`all_reduce_`, :func:`all_reduce_many_`, :func:`all_reduce_mean_`
  and :func:`broadcast_`, in place and outside autograd: gradients, losses,
  metric sums and rank 0's state, many tensors flattened into one buffer;
  :func:`broadcast_object` for a small Python value.

``torch.distributed.nn.functional.all_reduce`` all-reduces the cotangent
again in its backward: under a replicated loss that multiplies the
gradients by the group size. Hence the two rules above.

Over gloo, which takes CPU tensors only, a CUDA tensor is copied to host
memory, exchanged and copied back, explicitly (:func:`_on_wire`); NCCL takes
the device tensor as it is. :data:`stats` counts the collectives and the
host-staged bytes of the process, so a caller can tell what a run moved.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

# collectives run and bytes staged through host memory since the process started,
# and the wall seconds spent inside the collectives (host clock, device synced
# by the staging copies)
stats = {"calls": 0, "staged_bytes": 0, "seconds": 0.0}


def reset_stats() -> None:
    stats.update(calls=0, staged_bytes=0, seconds=0.0)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _on_wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend takes it: a host copy of a CUDA tensor
    over gloo, else ``t`` itself (contiguous)."""
    if _staged(t, group):
        stats["staged_bytes"] += t.numel() * t.element_size()
        return t.detach().to("cpu")
    return t.contiguous()


def _back(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return wire.to(like.device, non_blocking=False) if wire.device != like.device else wire


class _Timed:
    def __enter__(self):
        self.t0 = time.perf_counter()
        stats["calls"] += 1

    def __exit__(self, *exc):
        stats["seconds"] += time.perf_counter() - self.t0


def _swap(t: torch.Tensor, group, peer: int) -> torch.Tensor:
    """Send ``t`` to global rank ``peer`` and receive its tensor of the
    same shape, the send and the receive in one batch (two ranks that
    both sent first, unbatched, could each wait on the other under NCCL)."""
    with _Timed():
        send = _on_wire(t.detach(), group)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, peer, group), dist.P2POp(dist.irecv, recv, peer, group)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        return _back(recv, t)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place over ``group`` (a no-op for ``None``);
    outside autograd."""
    if group is None:
        return t
    with _Timed():
        wire = _on_wire(t.detach(), group)
        dist.all_reduce(wire, op=op, group=group)
        if wire is not t:
            t.detach().copy_(wire)
    return t


def all_reduce_many_(tensors: list[torch.Tensor], group, mean: bool = False) -> None:
    """Sum (or, with ``mean``, average) ``tensors`` in place over ``group``,
    in one collective over their flattened concatenation."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    if mean:
        flat /= dist.get_world_size(group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(flat[off : off + n].view_as(t))
        off += n


def all_reduce_mean_(tensors: list[torch.Tensor], group) -> None:
    """Average ``tensors`` in place over ``group`` (the data-parallel
    gradient average)."""
    all_reduce_many_(tensors, group, mean=True)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, peer):
        ctx.group, ctx.peer = group, peer
        return _swap(t, group, peer)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, ctx.group, ctx.peer), None, None


def exchange(t: torch.Tensor, group, peer: int) -> torch.Tensor:
    """The partner's ``t``: a pairwise swap with global rank ``peer`` of
    ``group``. Its backward swaps the cotangent back."""
    return _Exchange.apply(t, group, peer)


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(t.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_replicated(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, replicated; backward identity."""
    return t if group is None else _PsumReplicated.apply(t, group)


class _EnterReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def enter_replicated(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` itself; backward all-reduce-sum of the ranks' partial cotangents."""
    return t if group is None else _EnterReplicated.apply(t, group)


class _PsumParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def psum_parts(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``; backward all-reduce-sum."""
    return t if group is None else _PsumParts.apply(t, group)


class _AllGatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        ctx.index = dist.get_group_rank(group, dist.get_rank())
        ctx.width = t.shape[-1]
        with _Timed():
            wire = _on_wire(t.detach(), group)
            parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, wire, group=group)
            return _back(torch.cat(parts, dim=-1), t)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.index * w : (ctx.index + 1) * w].contiguous(), None


def all_gather_cols(t: torch.Tensor, group) -> torch.Tensor:
    """The column shards of ``group``'s ranks, in group order, concatenated
    on the last axis; backward: this rank's columns of the cotangent."""
    return t if group is None else _AllGatherCols.apply(t, group)


def broadcast_(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with global rank ``src``'s, in one broadcast of
    their flattened concatenation (per dtype)."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        with _Timed():
            wire = _on_wire(flat, None)
            dist.broadcast(wire, src=src)
            flat = wire.to(flat.device)
        off = 0
        for t in group:
            with torch.no_grad():
                t.copy_(flat[off : off + t.numel()].view_as(t))
            off += t.numel()


def broadcast_object(obj, src: int = 0):
    """``obj`` of global rank ``src`` on every rank of the world (rank 0's
    view of a checkpoint, a race's table entry); ``obj`` itself without a
    world."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
