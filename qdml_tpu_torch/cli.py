"""Command-line entry points of the port (``qdml_tpu/cli.py``).

    python -m qdml_tpu_torch.cli train-hdce  [--device=cpu] [--train.lr=3e-4 ...]
    python -m qdml_tpu_torch.cli train-sc    [...]   # classical scenario classifier
    python -m qdml_tpu_torch.cli train-qsc   [...]   # quantum scenario classifier
    python -m qdml_tpu_torch.cli eval        [...]   # the SNR sweep over the trained models
    python -m qdml_tpu_torch.cli gen-data    [--out=available_data] [...]
    python -m qdml_tpu_torch.cli loss-curves --curves=LABEL:PATH[,LABEL:PATH...] [...]

Dotted flags override :mod:`qdml_tpu_torch.config` fields, as in the JAX
package, and ``--preset=NAME`` starts from one of its presets
(``single_4q``, ``nat_sweep``, ``robust_qsc``; the mesh presets raise until
ROADMAP A.10). Runs on the card unless ``--device=cpu`` is given. With
``quantum.impl=auto`` (the default) ``train-qsc`` times the circuit impls on
the card before its first step and logs the winners (``kind=
"quantum_autotune"``); the table is ``results_torch/autotune/qsc_impl.json``
unless ``--quantum.autotune_table`` names another. Checkpoints and
the ``<command>.metrics.jsonl`` log go to ``<train.workdir>/Pn_<pilot_num>/
<name>/``. ``eval`` restores ``hdce``, ``sc`` and, when trained, ``qsc`` from
there and writes ``quantum_classical_comparison.json``, ``results_table.md``
and (with matplotlib) the comparison figure to ``eval.results_dir``, by
default ``results_torch/``; ``results/`` holds the JAX package's own.
``gen-data`` writes the training grid as the reference's ``.npy`` cache,
``loss-curves`` the loss figure and its JSON from trainer metrics logs.
"""

from __future__ import annotations

import os
import sys
import time

from qdml_tpu_torch import config as cfg_mod
from qdml_tpu_torch.utils.metrics import MetricsLogger

COMMANDS = ("train-hdce", "train-sc", "train-qsc", "eval", "gen-data", "loss-curves")


def workdir_of(cfg: cfg_mod.ExperimentConfig) -> str:
    """The reference's checkpoint scheme: ``./workspace/Pn_128/<name>``."""
    return os.path.join(cfg.train.workdir, f"Pn_{cfg.data.pilot_num}", cfg.name)


def _eval(cfg: cfg_mod.ExperimentConfig, workdir: str, device, logger: MetricsLogger) -> None:
    """``qdml_tpu/cli.py:307-354``, dense dispatch on one device."""
    from qdml_tpu_torch.eval.report import (
        create_comparison_plots,
        results_markdown_table,
        save_results_json,
    )
    from qdml_tpu_torch.eval.sweep import load_sweep_models, run_snr_sweep

    cfg, models = load_sweep_models(cfg, workdir, device)
    results = run_snr_sweep(cfg, models, logger=logger, device=device)
    out_json = save_results_json(results, cfg.eval.results_dir)
    out_png = create_comparison_plots(results, cfg.eval.results_dir)
    table = results_markdown_table(results)
    with open(os.path.join(cfg.eval.results_dir, "results_table.md"), "w") as fh:
        fh.write(table + "\n")
    print(table)
    print(f"results: {out_json} plot: {out_png}")


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
    extra: dict[str, str] = {}
    overrides = []
    for arg in rest:
        key = arg.split("=", 1)[0]
        if key == "--device":
            device = arg.split("=", 1)[1]
        elif key in ("--out", "--curves"):
            extra[key] = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = cfg_mod.from_args(overrides)
    workdir = workdir_of(cfg)
    t0 = time.time()
    if cmd == "gen-data":
        from qdml_tpu_torch.data.datasets import save_npy_cache

        out = extra.get("--out", "available_data")
        save_npy_cache(out, cfg.data, device)
        print(f"wrote npy cache to {out} in {time.time() - t0:.1f}s")
        return 0
    if cmd == "loss-curves":
        from qdml_tpu_torch.eval.loss_curves import (
            create_loss_curve_plot,
            parse_curve_spec,
            read_loss_history,
        )

        spec = extra.get("--curves")
        if spec is None:
            raise SystemExit("loss-curves requires --curves=LABEL:PATH[,LABEL:PATH...]")
        curves = [(label, read_loss_history(path)) for label, path in parse_curve_spec(spec)]
        print(f"loss curves: {create_loss_curve_plot(curves, cfg.eval.results_dir)}")
        return 0
    logger = MetricsLogger(os.path.join(workdir, f"{cmd}.metrics.jsonl"))
    try:
        if cmd == "eval":
            _eval(cfg, workdir, device, logger)
            print(f"eval done in {time.time() - t0:.1f}s")
            return 0
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
