"""The readings that set a cell's limits, at the cell's own size, on the card:

    python3 port_bench/control.py --workload <cell> --seconds <s> \\
        --program-seeds 1,2,3 --control-seeds 4,5,6 --kinds tf32,half_batch

For each program seed: the cell set up as a run sets it up and its window
(``--seconds``), then the numbers that decide ``correct``, without their
limits. For each control seed and kind: the reference put in the program's
place, computed as the kind says (``tf32``: TF32 matmuls and convolutions,
the precision below the float32 the configurations state; ``half_batch``:
each cell's first half of the batch only; ``stats_unchanged``: BatchNorm's
running statistics left as they began), judged against the float32
reference. One JSON line a reading. The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import run as run_mod  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--kinds", default="tf32")
    args = ap.parse_args(argv)
    run_mod.CACHE.mkdir(exist_ok=True)
    for key, path in run_mod.CACHE_ENV.items():
        os.environ[key] = str(path)
    import torch

    from port_bench import harness, tracing

    dev = torch.device("cuda", 0)

    def driver(seed: int):
        return harness.driver_for(args.workload, seed, args.seconds, dev, log=run_mod.log)

    card = torch.cuda.get_device_name(dev)
    for seed in _seeds(args.program_seeds):
        drv = driver(seed)
        drv.setup()
        drv.window(args.seconds, tracing.Tracer(False, 0.0, dev))
        numbers = drv.check()
        print(json.dumps({"side": "program", "seed": seed, **numbers, "card": card}), flush=True)
        del drv
        torch.cuda.empty_cache()
    for seed in _seeds(args.control_seeds):
        drv = driver(seed)
        drv.make_inputs()
        for kind in args.kinds.split(","):
            print(json.dumps({"side": kind, "seed": seed, **drv.control(kind), "card": card}), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
