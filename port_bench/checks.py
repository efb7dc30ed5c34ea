"""The numbers that decide ``correct``, each against its limit.

Training (the program's first checked steps against the reference's):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient, against the larger of that
  leaf's reference norm and the median leaf's;
- ``change_gap``: the same for each leaf's change over the steps,
  over the entries whose reference gradient is at least a thousandth of
  the median leaf's root-mean-square entry: an entry with no gradient to
  speak of (some thousands of the head's weights) moves under Adam by the
  sign of its round-off alone;
- ``stats_gap``: the worst BatchNorm running mean's or variance's
  distance from the reference's after the last step, the norm of their
  difference against the larger of that statistic's reference norm and the
  median statistic's. The statistics are averages the steps keep, not
  parameters that round-off can steer, so their difference is compared
  whole.

The limits live in ``port_bench/limits/<cell>.json``, one file a cell.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

LIMITS_DIR = Path(__file__).resolve().parent / "limits"
# an entry whose reference gradient is under this share of the median leaf's
# root-mean-square entry has no change of its own to compare
STILL_LEAF = 1e-3


def load_limits(cell: str) -> dict[str, float]:
    return json.loads((LIMITS_DIR / f"{cell}.json").read_text())["limits"]


def norm_gap(prog: dict[str, float], ref: dict[str, float]) -> tuple[float, str]:
    """The worst leaf's |prog - ref| against max(ref, the median leaf's
    ref), and that leaf."""
    floor = statistics.median(ref.values())
    worst, at = 0.0, ""
    for k in ref:
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def training_numbers(prog: dict, ref: dict, start: dict) -> tuple[dict[str, float], list[str]]:
    """``prog`` and ``ref`` each hold ``losses`` (a list), ``grad1`` (the
    first step's gradient, leaf -> tensor), ``after`` (the parameters
    after the last step) and ``stats`` (the BatchNorm running statistics
    after it); ``start`` the parameters both began from. Returns the numbers and lines that say which leaf set each
    and which entries were left out as still."""
    import torch

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_at = norm_gap({k: norm(v) for k, v in prog["grad1"].items()},
                                 {k: norm(v) for k, v in ref["grad1"].items()})
    # an entry whose reference gradient is under a thousandth of the median
    # leaf's root-mean-square entry moves by round-off alone under Adam
    rms = statistics.median(norm(g) / g.numel() ** 0.5 for g in ref["grad1"].values())
    p_change, r_change, notes = {}, {}, []
    for k, g in ref["grad1"].items():
        moving = g.abs() >= STILL_LEAF * rms
        still = int((~moving).sum())
        if still:
            notes.append(f"change_gap leaves out {still} of {g.numel()} entries of {k} (still)")
        if still < g.numel():
            p_change[k] = norm(torch.where(moving, prog["after"][k] - start[k], 0.0))
            r_change[k] = norm(torch.where(moving, ref["after"][k] - start[k], 0.0))
    change_gap, change_at = norm_gap(p_change, r_change)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
    by_step = [f"{abs(p - r) / max(abs(r), 1e-30):.3g}" for p, r in zip(prog["losses"], ref["losses"])]
    notes.append(f"loss gap by step: {' '.join(by_step)}")
    notes.append(f"worst leaves: grad_gap {grad_at}, change_gap {change_at}")
    diff = {k: norm(prog["stats"][k] - r) for k, r in ref["stats"].items()}
    size = {k: norm(r) for k, r in ref["stats"].items()}
    floor = statistics.median(size.values())
    gaps = {k: diff[k] / max(size[k], floor, 1e-30) for k in size}
    stats_at = max(gaps, key=gaps.get)
    numbers["stats_gap"] = gaps[stats_at]
    notes.append(f"worst statistic: stats_gap {stats_at}")
    return numbers, notes


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit. A number that is
    missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
