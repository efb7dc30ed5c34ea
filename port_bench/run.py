"""The benchmark of ``qdml_tpu_torch`` on NVIDIA cards: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Sets up the cell named in
``BENCHMARK.json``, measures for ``--seconds``, checks what the measured
path produced against the plain reference, and prints one JSON object as
the last line of standard output (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer metrics, the device's busy seconds
and a breakdown). Each compared number and its limit are the last lines of
standard error and the result's last key. Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 3; a
cell whose files are missing exits 2; a run that loaded JAX or the JAX
package exits 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
CACHE = BENCH / "cache"
# the program's dispatch tables and any kernel cache, at fixed paths inside
# the checkout: the first run of a cell races and builds, later runs read
CACHE_ENV = {
    "QDML_TORCH_QSC_AUTOTUNE_TABLE": CACHE / "qsc_impl.json",
    "QDML_TORCH_ROUTING_AUTOTUNE_TABLE": CACHE / "routing_dispatch.json",
    "QDML_TORCH_SERVE_BATCHING_TABLE": CACHE / "serve_batching.json",
    "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
    "TRITON_CACHE_DIR": CACHE / "triton",
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    CACHE.mkdir(exist_ok=True)
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    sys.path.insert(0, str(REPO))

    from port_bench import harness

    try:
        cell = harness.find_cell(harness.manifest(), args.workload)
    except harness.CellError as e:
        log(f"error: {e}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"error: {args.workload} needs {cell['chips']} CUDA card(s); {have} visible")
        return 3
    try:
        out, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), T_START, log=log)
    except harness.CellError as e:
        log(f"error: {e}")
        return 4 if "forbidden" in str(e) else 2
    for line in lines:
        log(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
