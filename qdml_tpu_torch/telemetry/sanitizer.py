"""Runtime numerics sanitizer: the port's ``checkify`` (``qdml_tpu/telemetry/sanitizer.py``).

The flight recorder's probes see a step's aggregate damage; this catches
the op where it happens, with the JAX package's error classes and message
shapes:

- **NaN generated**: an op's output holds a NaN, whatever its inputs held:
  ``"nan generated by primitive: <op>."``. This is JAX's rule (its
  checkify tests the output of every primitive in ``nan_primitives``): a
  NaN that arrives in a request or a batch trips the first op that
  computes with it. An Inf input alone does not trip it (``log(inf)`` is
  ``inf``), an Inf that meets a zero or another Inf does (``inf - inf``);
- **division by zero**: integer ``div`` (with a rounding mode),
  ``floor_divide``, ``remainder`` and ``fmod`` by zero;
- **out-of-bounds index**: a gather, scatter, index, take, embedding or
  NLL target outside its operand, with JAX's message and the op named.

Design: :class:`Sanitizer` is a ``TorchDispatchMode``. Per aten op it folds
"this op tripped" into one int32 error tensor on the op's device, keeping
the code of the *first* op that tripped (and, for an index, the first bad
index beside it); the table of codes and op names stays on the host. An
out-of-bounds index is clamped after it is recorded, so the op runs (an
unclamped out-of-range gather on the card is a device-side assert that
kills the CUDA context; JAX's gathers clamp). The mode reaches the autograd
engine's device threads with the rest of the thread-local dispatch state,
so backward ops are checked too. The hand-written CUDA kernels are called
through ``ctypes`` and no dispatch mode sees them: their wrappers hand
their outputs to :meth:`Sanitizer.kernel` (the gate-table prep included),
which checks them under the kernel's name
(``"nan generated by primitive: circuit_expvals."``), forward and backward.
On the CPU those wrappers run their plain versions, checked op by op.

Ops that cannot make a NaN the inputs lack (views, copies, concatenation,
selection, creation of constants) skip the NaN test, so a NaN moves through
them (and through a ``where`` that masks it out, as the ragged batches'
pad rows are masked) untested; ops that allocate
uninitialised memory (``empty``) are not read. An op whose outputs cannot
be read for NaN (integer, boolean or sparse outputs) and that no index or
division rule covers is listed by name in :attr:`Sanitizer.unchecked`,
which the trainers write into the run's ``checkify`` record.

Cost: two or three small launches per aten op and one device-to-host fetch
a host-visible step (train) or a batch (serve), in :func:`error_message`;
under a world of ranks the trainers add one small all-reduce a step, so
that every rank reaches the same trip decision.
A debugging mode: the K-step path declines under it
(:func:`~qdml_tpu_torch.train.scan.scan_eligible`). Off (the default)
nothing is wrapped, so a step runs the same ops and the K-step path
captures the same graphs.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

# ops whose outputs are uninitialised memory: never read
_UNREAD = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten.resize_, aten.set_,
}
# ops that cannot produce a NaN their inputs lack: data movement, selection,
# constants (their values come from the inputs or from finite scalars)
_NO_NAN = {
    aten.copy_, aten._to_copy, aten.clone, aten.cat, aten.stack, aten.where, aten.detach, aten.alias,
    aten.lift_fresh, aten.lift_fresh_copy, aten._unsafe_view, aten.index_select, aten.gather, aten.index,
    aten.take, aten.zeros, aten.zeros_like, aten.ones, aten.ones_like, aten.full, aten.full_like,
    aten.new_zeros, aten.new_ones, aten.new_full, aten.fill_, aten.zero_, aten.arange, aten.scalar_tensor,
    aten._local_scalar_dense, aten.embedding, aten.slice_scatter, aten.select_scatter, aten.constant_pad_nd,
    aten.masked_fill, aten.masked_fill_, aten.index_put, aten.index_put_, aten.scatter, aten.scatter_,
    aten.index_copy, aten.index_copy_, aten.repeat, aten.flip, aten.roll, aten.tril, aten.triu,
    aten.max_pool2d_with_indices, aten.relu, aten.relu_, aten.sort, aten.topk, aten.max, aten.min,
    aten.amax, aten.amin, aten.argmax, aten.argmin, aten.eq, aten.ne, aten.lt, aten.le, aten.gt, aten.ge,
    aten.isnan, aten.isinf, aten.isfinite, aten.logical_not, aten.logical_and, aten.logical_or,
    aten.bitwise_not, aten.bitwise_and, aten.bitwise_or, aten.any, aten.all,
}
# integer division ops: the divisor is argument 1
_DIVISION = {aten.div, aten.div_, aten.floor_divide, aten.floor_divide_, aten.remainder, aten.remainder_,
             aten.fmod, aten.fmod_}

_NAN, _DIV, _OOB = "nan", "div", "oob"


def _float(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())


class _DeviceState:
    """One device's error code (int32, 0 when clean) and the first bad
    index (int64) of an out-of-bounds trip."""

    __slots__ = ("err", "payload")

    def __init__(self, device: torch.device):
        self.err = torch.zeros((), dtype=torch.int32, device=device)
        self.payload = torch.zeros((), dtype=torch.int64, device=device)


class Sanitizer(TorchDispatchMode):
    """The checks over every aten op run while the mode is entered (and over
    the hand kernels' boundaries); see the module docstring. One instance a
    step or a batch: :func:`error_message` reads it."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # never under torch.compile: an unwrapped dispatch spares a process's
        # first check the import of torch._dynamo (seconds at a warmup)
        return False

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._table: list[tuple[str, str, tuple]] = []  # code - 1 -> (kind, op, detail)
        self._codes: dict[tuple, int] = {}
        self._state: dict[torch.device, _DeviceState] = {}
        self.unchecked: dict[str, str] = {}

    # -- bookkeeping --------------------------------------------------------------

    def _code(self, kind: str, op: str, detail: tuple = ()) -> int:
        key = (kind, op, detail)
        with self._lock:
            code = self._codes.get(key)
            if code is None:
                self._table.append(key)
                code = self._codes[key] = len(self._table)
        return code

    def _dev(self, device: torch.device) -> _DeviceState:
        st = self._state.get(device)
        if st is None:
            with self._lock:
                st = self._state.setdefault(device, _DeviceState(device))
        return st

    def _fold(self, tripped: torch.Tensor, code: int, payload: torch.Tensor | None = None) -> None:
        """Record ``code`` where ``tripped`` (a bool scalar on the device) and
        no earlier op tripped; no host sync."""
        st = self._dev(tripped.device)
        first = tripped & (st.err == 0)
        if payload is not None:
            st.payload = torch.where(first, payload.to(torch.int64), st.payload)
        st.err = torch.where(first, torch.full_like(st.err, code), st.err)

    # -- the checks ---------------------------------------------------------------

    def _any_nan(self, tensors, device) -> torch.Tensor | None:
        flags = [t.isnan().any() for t in tensors if _float(t) and t.device == device and t.numel()]
        if not flags:
            return None
        return flags[0] if len(flags) == 1 else torch.stack(flags).any()

    def _oob(self, op: str, idx: torch.Tensor, low: int, size: int, axis: int, shape, allowed=None):
        """Record an out-of-bounds index (outside [low, size)) and return the
        index clamped into range (``allowed`` values, such as an NLL
        ``ignore_index``, pass)."""
        if idx.dtype == torch.bool or not idx.numel():
            return idx
        bad = (idx < low) | (idx >= size)
        if allowed is not None:
            bad = bad & (idx != allowed)
        flat = bad.reshape(-1)
        first = torch.argmax(flat.to(torch.uint8)).reshape(1)
        code = self._code(_OOB, op, (tuple(shape), axis, size))
        self._fold(flat.any(), code, idx.reshape(-1).index_select(0, first)[0])
        if allowed is not None:  # an NLL target: a bad class reads class 0
            return torch.where(bad, idx.new_zeros(()), idx)
        return torch.where(bad, idx.clamp(min(low, 0), max(size - 1, 0)), idx)

    def _index_rules(self, func, args: list, kwargs: dict, op: str) -> None:
        """Check (and clamp, in ``args``) the index arguments of an index op."""
        pk = func.overloadpacket
        if pk in (aten.gather, aten.scatter, aten.scatter_, aten.scatter_add, aten.scatter_add_,
                  aten.scatter_reduce, aten.scatter_reduce_, aten.index_select, aten.index_add,
                  aten.index_add_, aten.index_copy, aten.index_copy_, aten.index_fill, aten.index_fill_):
            self_, dim = args[0], args[1]
            if isinstance(args[2], torch.Tensor) and self_.dim():
                d = dim % self_.dim()
                args[2] = self._oob(op, args[2], 0, self_.shape[d], d, self_.shape)
        elif pk in (aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_):
            self_, indices = args[0], list(args[1])
            d = 0
            for i, idx in enumerate(indices):
                if idx is None:
                    d += 1
                elif idx.dtype == torch.bool:
                    d += idx.dim()
                else:
                    indices[i] = self._oob(op, idx, -self_.shape[d], self_.shape[d], d, self_.shape)
                    d += 1
            args[1] = indices
        elif pk is aten.take:
            n = args[0].numel()
            args[1] = self._oob(op, args[1], -n, n, 0, (n,))
        elif pk is aten.embedding:
            w = args[0]
            args[1] = self._oob(op, args[1], 0, w.shape[0], 0, w.shape)
        elif pk is aten.embedding_dense_backward:
            args[1] = self._oob(op, args[1], 0, int(args[2]), 0, (int(args[2]),))
        elif pk in (aten.nll_loss_forward, aten.nll_loss_backward):
            pos = 1 if pk is aten.nll_loss_forward else 2
            inp = args[pos - 1]
            c = inp.shape[-1] if inp.dim() else 1
            ignore = args[pos + 3] if len(args) > pos + 3 else kwargs.get("ignore_index", -100)
            args[pos] = self._oob(op, args[pos], 0, c, inp.dim() - 1, inp.shape, allowed=int(ignore))

    def _division(self, func, args: list, kwargs: dict, op: str) -> None:
        """Integer division by zero: record, then divide by 1 instead."""
        if func.overloadpacket in (aten.div, aten.div_) and kwargs.get("rounding_mode") is None:
            return  # true division: integers divide as floats (0/0 is a NaN, checked as one)
        num, den = args[0], args[1]
        if not isinstance(num, torch.Tensor) or num.is_floating_point() or num.is_complex():
            return
        code = self._code(_DIV, op)
        if isinstance(den, torch.Tensor):
            if den.is_floating_point() or den.is_complex():
                return
            zero = den == 0
            self._fold(zero.any().to(num.device), code)
            args[1] = torch.where(zero, torch.ones_like(den), den)
        elif den == 0:
            self._fold(torch.ones((), dtype=torch.bool, device=num.device), code)
            args[1] = 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        pk = func.overloadpacket
        if pk in _UNREAD:
            return func(*args, **kwargs)
        op = str(pk)
        args = list(args)
        self._index_rules(func, args, kwargs, op)
        if pk in _DIVISION:
            self._division(func, args, kwargs, op)
        nan_check = pk not in _NO_NAN and not func.is_view
        out = func(*args, **kwargs)
        if not nan_check:
            return out
        flat_out, _ = tree_flatten(out)
        outs = [t for t in flat_out if isinstance(t, torch.Tensor)]
        if any(t.is_sparse for t in outs):
            self.unchecked.setdefault(op, "sparse output")
            return out
        floats = [t for t in outs if _float(t)]
        if not floats:
            if outs and pk not in _DIVISION and op not in self.unchecked:
                self.unchecked[op] = "non-float output"
            return out
        dev = floats[0].device
        out_nan = self._any_nan(floats, dev)
        if out_nan is not None:
            self._fold(out_nan, self._code(_NAN, op))
        return out

    # -- the hand kernels -------------------------------------------------------------

    def kernel(self, name: str, outputs, work=None) -> None:
        """Check a hand kernel's call as one op named ``name``: a NaN in its
        outputs trips, whatever its inputs held (called by the wrappers in
        :mod:`qdml_tpu_torch.quantum.kernels`, with the modes off)."""
        outs = [t for t in outputs if _float(t)]
        if not outs:
            return
        out_nan = self._any_nan(outs, outs[0].device)
        if out_nan is not None:
            self._fold(out_nan, self._code(_NAN, name))

    # -- the host side ------------------------------------------------------------------

    def message(self) -> str | None:
        """The first tripped check's message, or None when clean. One
        device-to-host copy per device touched (one on a single card)."""
        with _disable_current_modes():
            states = list(self._state.values())
            if not states:
                return None
            for st in states:
                code, payload = (int(v) for v in torch.stack([st.err.to(torch.int64), st.payload]).cpu())
                if code:
                    with self._lock:
                        kind, op, detail = self._table[code - 1]
                    if kind == _NAN:
                        return f"nan generated by primitive: {op}."
                    if kind == _DIV:
                        return f"division by zero (primitive: {op})"
                    shape, axis, size = detail
                    return (f"out-of-bounds indexing for array of shape {shape}: index {payload} is out of "
                            f"bounds for axis {axis} with size {size}. (primitive: {op})")
        return None


def error_message(err: Sanitizer, world: bool = False) -> str | None:
    """First tripped check's message, or None when the step was clean. A
    host sync: callers pay it once a host-visible step.

    With ``world``, under a ``torch.distributed`` world of two or more ranks,
    a collective every rank joins: one all-reduce (MIN) of the lowest rank
    that tripped, and on a trip a broadcast of that rank's message. Every
    rank then returns the same answer and takes the same branch; a trip that
    one rank's rows alone produce would otherwise leave that rank in the
    flight recorder's dump while the others wait in the next step's
    collectives."""
    msg = err.message()
    if not world:
        return msg
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() < 2:
        return msg
    from qdml_tpu_torch.parallel.collectives import all_reduce_, broadcast_object

    n = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    first = torch.tensor(dist.get_rank() if msg else n, dtype=torch.int64, device=dev)
    with _disable_current_modes():
        all_reduce_(first, dist.group.WORLD, op=dist.ReduceOp.MIN)
    src = int(first)
    return None if src == n else broadcast_object(msg, src=src)


def checkify_step(step_fn: Callable[..., dict]) -> Callable[..., dict]:
    """Wrap a train step so it runs under a fresh :class:`Sanitizer` and its
    metrics carry it as ``checkify_err``: the same call and returns as
    ``step_fn`` (a dict of device tensors), one key more, for the flight
    recorder (``FlightRecorder.on_step``)."""

    def step(*args: Any, **kwargs: Any) -> dict:
        san = Sanitizer()
        with san:
            out = step_fn(*args, **kwargs)
        return {**out, "checkify_err": san}

    return step

