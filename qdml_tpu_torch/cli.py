"""Command-line entry points of the port (``qdml_tpu/cli.py``).

    python -m qdml_tpu_torch.cli train-hdce [--device=cpu] [--train.lr=3e-4 ...]
    python -m qdml_tpu_torch.cli train-sc   [...]   # classical scenario classifier
    python -m qdml_tpu_torch.cli train-qsc  [...]   # quantum scenario classifier

Dotted flags override :mod:`qdml_tpu_torch.config` fields, as in the JAX
package. Runs on the card unless ``--device=cpu`` is given. Checkpoints and
the ``<command>.metrics.jsonl`` log go to ``<train.workdir>/Pn_<pilot_num>/
<name>/``. The JAX package's ``eval``, ``gen-data`` and the SNR sweep are the
port's next slice (ROADMAP A.7).
"""

from __future__ import annotations

import os
import sys
import time

from qdml_tpu_torch import config as cfg_mod
from qdml_tpu_torch.utils.metrics import MetricsLogger

COMMANDS = ("train-hdce", "train-sc", "train-qsc")


def workdir_of(cfg: cfg_mod.ExperimentConfig) -> str:
    """The reference's checkpoint scheme: ``./workspace/Pn_128/<name>``."""
    return os.path.join(cfg.train.workdir, f"Pn_{cfg.data.pilot_num}", cfg.name)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; want one of {COMMANDS}")
        return 2
    device = None
    overrides = []
    for arg in rest:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = cfg_mod.from_args(overrides)
    workdir = workdir_of(cfg)
    logger = MetricsLogger(os.path.join(workdir, f"{cmd}.metrics.jsonl"))
    t0 = time.time()
    try:
        if cmd == "train-hdce":
            from qdml_tpu_torch.train.hdce import train_hdce

            _, history = train_hdce(cfg, device=device, workdir=workdir, logger=logger)
        else:
            from qdml_tpu_torch.train.qsc import train_classifier

            _, history = train_classifier(
                cfg, quantum=cmd == "train-qsc", device=device, workdir=workdir, logger=logger
            )
    finally:
        logger.close()
    last = {k: v[-1] for k, v in history.items() if v}
    print(f"{cmd} done in {time.time() - t0:.1f}s: {last}; checkpoints in {workdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
