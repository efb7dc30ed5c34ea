"""Training loss-curve figure (``qdml_tpu/eval/loss_curves.py``; reference ``Loss Curve.png``).

The reference's second published artifact plots classifier training loss vs
epoch for the classical CNN and the QML classifier at 4/6/8 qubits over 100
epochs (``Loss Curve.png`` legend; BASELINE.md rows "Final train loss").
The trainers here log one JSONL record per epoch (``train_loss`` key,
:class:`qdml_tpu_torch.utils.metrics.MetricsLogger`), so the figure is a pure
post-processing step over any set of runs. Framework-free: a copy of the JAX
package's module, which the port may not import.
"""

from __future__ import annotations

import json
import os


def read_loss_history(jsonl_path: str) -> list[float]:
    """Per-epoch train losses from a trainer metrics JSONL (epoch-summary
    records are those carrying ``train_loss``)."""
    hist: list[float] = []
    with open(jsonl_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "train_loss" in rec and "epoch" in rec:
                hist.append(float(rec["train_loss"]))
    return hist


def parse_curve_spec(spec: str) -> list[tuple[str, str]]:
    """``LABEL:PATH,LABEL:PATH`` -> [(label, path), ...]."""
    out = []
    for item in spec.split(","):
        if not item.strip():
            continue
        label, _, path = item.partition(":")
        if not path:
            raise ValueError(f"curve spec item {item!r} is not LABEL:PATH")
        out.append((label.strip(), path.strip()))
    return out


def create_loss_curve_plot(
    curves: list[tuple[str, list[float]]], results_dir: str
) -> str | None:
    """Loss-vs-epoch figure for the given (label, history) pairs; returns the
    PNG path (None if matplotlib is unavailable — the JSON twin is written
    regardless, it needs no plotting library)."""
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, "loss_curves.json"), "w") as fh:
        json.dump({label: hist for label, hist in curves}, fh, indent=2)

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(7.5, 4.8))
    for label, hist in curves:
        ax.plot(range(len(hist)), hist, label=label, linewidth=1.6)
    ax.set_xlabel("epoch")
    ax.set_ylabel("training loss")
    ax.set_title("Scenario-classifier training loss")
    ax.grid(True, alpha=0.4)
    ax.legend()
    fig.tight_layout()
    path = os.path.join(results_dir, "Loss_Curve.png")
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
