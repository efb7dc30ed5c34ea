"""Reporting: comparison plots and JSON results (``qdml_tpu/eval/report.py``;
reference ``create_comparison_plots``, ``Test.py:277-336``).

The reference's two-panel figure, NMSE (dB) vs SNR for LS / MMSE /
HDCE-classical / HDCE-quantum (and the monolithic DCE under the JAX key
``dce`` when the sweep has it) and classifier accuracy vs SNR, is saved as
``Quantum_vs_Classical_Comparison.png`` in the results directory, beside the
results JSON (``quantum_classical_comparison.json``). Without matplotlib the
figure is skipped (``None``) and the JSON still written. Framework-free: a
copy of the JAX package's module, which the port may not import.
"""

from __future__ import annotations

import json
import os
from typing import Any

_CURVE_LABELS = {
    "ls": "LS",
    "mmse": "MMSE",
    "mmse_oracle": "MMSE (oracle prior)",
    "dce": "DCE (monolithic)",
    "hdce_classical": "HDCE (classical SC)",
    "hdce_quantum": "HDCE (quantum SC)",
}


def save_results_json(results: dict[str, Any], results_dir: str) -> str:
    os.makedirs(results_dir, exist_ok=True)
    path = os.path.join(results_dir, "quantum_classical_comparison.json")
    with open(path, "w") as fh:
        json.dump(results, fh, indent=2)
    return path


# Reference-published values read off its figures (BASELINE.md) for the
# side-by-side README table; keys match the sweep's curve names.
_REFERENCE_PUBLISHED = {
    "ls": {5.0: -2.2, 15.0: -12.0},
    "mmse": {5.0: -3.5, 15.0: -13.5},
    "hdce_classical": {5.0: -9.0, 15.0: -17.5},
    "hdce_quantum": {5.0: -9.0, 15.0: -17.5},
}
_REFERENCE_ACC = {5.0: 0.79, 15.0: 0.95}


def results_markdown_table(results: dict[str, Any]) -> str:
    """Markdown table of NMSE (dB) per curve at each SNR vs the reference's
    published figure values, plus classifier accuracies."""
    snrs = results["snr"]
    lines = [
        "| Curve | " + " | ".join(f"{s:g} dB" for s in snrs) + " | reference @5/@15 |",
        "|---|" + "---|" * (len(snrs) + 1),
    ]
    for key, vals in results["nmse_db"].items():
        ref = _REFERENCE_PUBLISHED.get(key)
        ref_s = f"{ref[5.0]:g} / {ref[15.0]:g}" if ref else "—"
        row = " | ".join(f"{v:.1f}" for v in vals)
        lines.append(f"| {_CURVE_LABELS.get(key, key)} | {row} | {ref_s} |")
    for key, vals in results.get("acc", {}).items():
        row = " | ".join(f"{v:.3f}" for v in vals)
        lines.append(
            f"| accuracy ({key} SC) | {row} | "
            f"{_REFERENCE_ACC[5.0]:g} / {_REFERENCE_ACC[15.0]:g} |"
        )
    return "\n".join(lines)


def create_comparison_plots(results: dict[str, Any], results_dir: str) -> str | None:
    """Two-panel comparison figure; returns the PNG path (None if matplotlib
    is unavailable)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # headless minimal images
        return None

    os.makedirs(results_dir, exist_ok=True)
    snr = results["snr"]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))

    for key, vals in results["nmse_db"].items():
        ax1.plot(snr, vals, marker="o", label=_CURVE_LABELS.get(key, key))
    ax1.set_xlabel("SNR (dB)")
    ax1.set_ylabel("NMSE (dB)")
    ax1.set_title("Channel estimation performance")
    ax1.grid(True, alpha=0.4)
    ax1.legend()

    for key, vals in results["acc"].items():
        ax2.plot(snr, vals, marker="s", label=f"{key} SC")
    ax2.set_xlabel("SNR (dB)")
    ax2.set_ylabel("Scenario classification accuracy")
    ax2.set_ylim(0.0, 1.02)
    ax2.set_title("Classifier accuracy")
    ax2.grid(True, alpha=0.4)
    ax2.legend()

    fig.tight_layout()
    path = os.path.join(results_dir, "Quantum_vs_Classical_Comparison.png")
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
