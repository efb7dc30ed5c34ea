"""A serving engine's warmup with and without its cost count, each in a fresh process.

    python -m qdml_tpu_torch.scripts.warmup_cost [--reps=2] [--device=cpu]

The engine is the full-width QSC one a fleet backend serves (S=3 trunks of
32 features on the 16x8x2 image, the 4096->2048 head, QSC n=6 L=3 at impl
``pallas_circuit``, buckets 1/8/64, seeded random weights). With a
telemetry sink active, ``ServeEngine.warmup`` runs each bucket's first
forward under the counting dispatch mode (``telemetry/cost.py``) for its
``cost`` record; without one it counts nothing. ``cli serve`` installs a
sink, so every spawned backend pays the count, and a fresh process also
pays the mode's first imports: hence one process a run. The runs alternate
without, with, with, without (``--reps`` times each), after one untimed
process that loads the kernels. Each prints one JSON line (``warmup_s``,
each bucket's ``first_forward_s``, whether it was counted); the last line
is the medians. Runs on the card unless ``--device=cpu``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time


def _child(mode: str, device: str) -> dict:
    from dataclasses import replace

    import torch

    from qdml_tpu_torch import config as cfg_mod
    from qdml_tpu_torch.models import qsc as qsc_mod
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.telemetry import set_sink
    from qdml_tpu_torch.train import hdce as hdce_mod
    from qdml_tpu_torch.utils.device import resolve_device
    from qdml_tpu_torch.utils.metrics import MetricsLogger

    dev = resolve_device(None if device == "cuda" else device)
    base = cfg_mod.ExperimentConfig()
    cfg = replace(base, quantum=replace(base.quantum, n_qubits=6, n_layers=3, impl="pallas_circuit"),
                  serve=replace(base.serve, batching="bucket"))
    gen = torch.Generator().manual_seed(0)
    hdce_sd = hdce_mod.build_hdce(cfg, device="cpu", generator=gen).state_dict()
    clf_sd = qsc_mod.build_classifier(cfg, True, device="cpu", generator=gen).state_dict()
    eng = ServeEngine(cfg, hdce_sd, clf_sd, quantum=True, buckets=(1, 8, 64), device=dev)
    logger = None
    if mode == "count":
        logger = MetricsLogger(os.path.join(tempfile.mkdtemp(), "warmup.jsonl"), echo=False)
        set_sink(logger)
    t0 = time.perf_counter()
    try:
        eng.warmup()
    finally:
        if logger is not None:
            set_sink(None)
            logger.close()
    return {
        "mode": mode,
        "warmup_s": round(time.perf_counter() - t0, 6),
        "first_forward_s": {b: c["first_forward_s"] for b, c in eng.bucket_cost.items()},
        "counted": [b for b, c in eng.bucket_cost.items() if c.get("available")],
        "device": str(dev),
    }


def main(argv: list[str]) -> int:
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    device = opts.get("device", "cuda")
    if "child" in opts:
        print(json.dumps(_child(opts["child"], device)), flush=True)
        return 0
    reps = int(opts.get("reps", 2))
    from qdml_tpu_torch.quantum import kernels as K

    if device != "cpu":
        K.build(("circuit_expvals", "circuit_adjoint"))
    order = ["plain"] + ["plain", "count", "count", "plain"] * reps  # the first loads the kernels, untimed
    runs: dict[str, list[dict]] = {"plain": [], "count": []}
    for i, mode in enumerate(order):
        out = subprocess.run([sys.executable, "-m", "qdml_tpu_torch.scripts.warmup_cost", f"--child={mode}",
                              f"--device={device}"], check=True, capture_output=True, text=True)
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        if i:
            runs[mode].append(rec)
            print(json.dumps(rec), flush=True)
    print(json.dumps({m: {"warmup_s_median": statistics.median(r["warmup_s"] for r in rs),
                          "first_forward_1_s_median": statistics.median(r["first_forward_s"]["1"] for r in rs),
                          "n": len(rs)} for m, rs in runs.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
