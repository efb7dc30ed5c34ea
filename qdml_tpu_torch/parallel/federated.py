"""Federated and tensor-parallel HDCE: which rank holds what (``qdml_tpu/parallel/federated.py``).

The reference's "distributed ML": one ``Conv_P128`` trunk per scenario and
one shared ``FC_P128`` head, the head's gradient accumulated over the whole
(scenario, user) grid every step. In JAX each scenario's trunk lives on its
own ``fed`` slice and GSPMD inserts one reduction over ``fed`` for the head.
The port holds the same layout on the ranks of a mesh
(:func:`hdce_state_shardings`, the rule, in JAX's three cases):

- under ``fed == n_scenarios`` rank ``(f, d, m)`` keeps trunk f of
  ``StackedConvP128``, its Adam moments and its BatchNorm state;
- under ``model > 1`` (tensor parallel) the head's weight rows (its output
  columns) and its bias are split over ``model``;
- everything else is replicated.

:func:`shard_hdce_state` turns a whole (one-rank layout) HDCE and its
optimizer state into this rank's :class:`HDCEShard` and its share of the
optimizer state; :func:`gather_hdce_state` is the inverse, which the
checkpoint save runs so that rank 0 writes the one-rank files.
:func:`shard_hdce_vars` is the eval-side twin over a plain state dict.

The split head (:class:`HDCEShard`): its input enters through
:func:`~qdml_tpu_torch.parallel.collectives.enter_replicated` and its
output columns are gathered over ``model``
(:func:`~qdml_tpu_torch.parallel.collectives.all_gather_cols`). The loss
and the gradient reductions that make the step the global one are the
trainer's (:mod:`qdml_tpu_torch.train.hdce`).
"""

from __future__ import annotations

import copy
from typing import Any

import torch
import torch.distributed as dist

from qdml_tpu_torch.parallel import collectives as coll
from qdml_tpu_torch.parallel.mesh import Mesh

HEAD_SPLIT = ("head.FC.weight", "head.FC.bias")


def hdce_state_shardings(
    names, mesh: Mesh, n_scenarios: int = 3, tensor_parallel: bool = False
) -> dict[str, str]:
    """The rule for each HDCE state-dict entry in ``names``: ``"fed"`` (the
    trunk of one scenario, on the ranks of its fed coordinate), ``"model"``
    (split on its first axis over the model line) or ``"replicated"``
    (``qdml_tpu/parallel/federated.py:38-58``)."""
    fed_ok = mesh.shape["fed"] == n_scenarios
    tp_ok = tensor_parallel and mesh.shape["model"] > 1

    def rule(name: str) -> str:
        if fed_ok and name.startswith("trunks."):
            return "fed"
        if tp_ok and name in HEAD_SPLIT:
            return "model"
        return "replicated"

    return {name: rule(name) for name in names}


def _full_name(local: str, scen0: int) -> str:
    """A shard's state-dict name in the one-rank layout."""
    if local.startswith("trunks."):
        _, i, rest = local.split(".", 2)
        return f"trunks.{scen0 + int(i)}.{rest}"
    return local


class HDCEShard(torch.nn.Module):
    """This rank's part of an HDCE over ``mesh``: the trunks of scenarios
    ``scen0 ..`` and the head's output columns ``col0 ..``, with ``rules``
    (:func:`hdce_state_shardings`) over the one-rank names and
    ``whole_names``, the one-rank model's parameter names in order.
    ``(S', B, 2, H, W) -> (S', B, out_dim)``: the whole head's output, the
    columns gathered over ``model``."""

    def __init__(self, local, mesh: Mesh, scen0: int, col0: int, rules: dict[str, str], whole_names: list[str]):
        super().__init__()
        self.trunks, self.head = local.trunks, local.head
        self.mesh, self.scen0, self.col0 = mesh, scen0, col0
        self.rules, self.whole_names = rules, whole_names  # rules: every one-rank state-dict key, in order
        self.model_group = mesh.group("model") if "model" in rules.values() else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.trunks(x)
        if self.model_group is None:
            return self.head(feats)
        feats = coll.enter_replicated(feats, self.model_group)
        return coll.all_gather_cols(self.head(feats), self.model_group)

    def full_names(self) -> list[str]:
        """The one-rank names of this shard's parameters, in order."""
        return [_full_name(n, self.scen0) for n, _ in self.named_parameters()]


def _cut(value, rule: str, col0: int, n_cols: int):
    """A one-rank entry's share on this rank: its rows ``col0 ..`` when
    split over ``model``, else itself (scalars, such as Adam's step count,
    stay whole)."""
    if rule == "model" and torch.is_tensor(value) and value.dim():
        return value[col0 : col0 + n_cols]
    return value


def shard_hdce_state(
    model, mesh: Mesh, n_scenarios: int = 3, tensor_parallel: bool = False, opt_state: dict | None = None
):
    """This rank's :class:`HDCEShard` of the whole HDCE ``model`` (every
    rank holds the same one, in the one-rank layout), on its device and in
    its mode, and this rank's share of ``opt_state`` (an
    :class:`~qdml_tpu_torch.train.optim.Optimizer` state dict over
    ``model``'s parameters) when given: ``(shard, local_opt_state or
    None)`` (``qdml_tpu/parallel/federated.py:86-90``)."""
    whole_names = [n for n, _ in model.named_parameters()]
    rules = hdce_state_shardings(model.state_dict(), mesh, n_scenarios, tensor_parallel)
    local = copy.deepcopy(model)
    scen0, col0 = 0, 0
    if "fed" in rules.values():
        n_scen = n_scenarios // mesh.shape["fed"]
        scen0 = mesh.coord("fed") * n_scen
        owned = [local.trunks[i] for i in range(scen0, scen0 + n_scen)]
        local.trunks._modules = {str(i): t for i, t in enumerate(owned)}
    fc = local.head.FC
    n_cols = fc.out_features
    if "model" in rules.values():
        n_cols //= mesh.shape["model"]
        col0 = mesh.coord("model") * n_cols
        split = torch.nn.Linear(fc.in_features, n_cols, device=fc.weight.device)
        with torch.no_grad():
            split.weight.copy_(fc.weight[col0 : col0 + n_cols])
            split.bias.copy_(fc.bias[col0 : col0 + n_cols])
        local.head.FC = split
    shard = HDCEShard(local, mesh, scen0, col0, rules, whole_names)
    if opt_state is None:
        return shard, None
    index = {name: i for i, name in enumerate(whole_names)}
    state = opt_state["opt"]
    local_state = {}
    for j, name in enumerate(shard.full_names()):
        entry = state["state"].get(index[name])
        if entry is not None:
            local_state[j] = {k: _cut(v, rules[name], col0, n_cols) for k, v in entry.items()}
    groups = [{**g, "params": list(range(len(shard.full_names())))} for g in state["param_groups"]]
    return shard, {"opt": {"state": local_state, "param_groups": groups}, "count": opt_state["count"]}


def gather_hdce_state(shard: HDCEShard, opt_state: dict | None = None) -> tuple[dict, dict | None]:
    """The inverse of :func:`shard_hdce_state`, on every rank: the whole
    HDCE's state dict (one-rank names and shapes, CPU tensors) and, when
    ``opt_state`` (this shard's optimizer state) is given, the optimizer
    state over the whole HDCE's parameters. A collective over the world;
    only the sharded entries travel, from the ranks of data coordinate 0
    (trunks from model coordinate 0, head columns from fed coordinate 0)."""
    rules = shard.rules
    names = shard.full_names()
    mine: dict[str, Any] = {
        _full_name(k, shard.scen0): v.detach().cpu() for k, v in shard.state_dict().items()
    }
    if opt_state is not None:
        for j, entry in opt_state["opt"]["state"].items():
            mine["opt:" + names[j]] = {k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in entry.items()}

    def rule(k: str) -> str:
        return rules[k.removeprefix("opt:")]

    full = {k: v for k, v in mine.items() if rule(k) == "replicated"}
    c = shard.mesh.coords()
    sends = c["data"] == 0
    sent = {
        k: v for k, v in mine.items()
        if sends and ((rule(k) == "fed" and c["model"] == 0) or (rule(k) == "model" and c["fed"] == 0))
    }
    parts: list[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (c["model"], sent))
    pieces: dict[str, list] = {}
    for m, sent_part in parts:
        for k, v in sent_part.items():
            pieces.setdefault(k, []).append((m, v))
    for k, got in pieces.items():
        got = [v for _, v in sorted(got, key=lambda p: p[0])]
        if rule(k) == "fed":
            full[k] = got[0]
        elif k.startswith("opt:"):
            full[k] = {f: torch.cat([g[f] for g in got]) if torch.is_tensor(x) and x.dim() else x
                       for f, x in got[0].items()}
        else:
            full[k] = torch.cat(got)
    full_sd = {k: full[k] for k in rules}
    if opt_state is None:
        return full_sd, None
    state = {i: full["opt:" + n] for i, n in enumerate(shard.whole_names) if "opt:" + n in full}
    groups = [{**g, "params": list(range(len(shard.whole_names)))} for g in opt_state["opt"]["param_groups"]]
    return full_sd, {"opt": {"state": state, "param_groups": groups}, "count": opt_state["count"]}


def shard_hdce_vars(params: dict, mesh: Mesh, cfg) -> HDCEShard:
    """The eval-side twin of :func:`shard_hdce_state` over a restored state
    dict (``qdml_tpu/parallel/federated.py:93-112``): the trunks over
    ``fed`` when it equals the scenario count, the head replicated."""
    from qdml_tpu_torch.train.hdce import HDCE

    full = HDCE(cfg.data.n_scenarios, cfg.model.features, cfg.h_out_dim, cfg.image_hw)
    full.load_state_dict(params)
    return shard_hdce_state(full, mesh, cfg.data.n_scenarios)[0]
