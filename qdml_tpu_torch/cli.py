"""Command-line entry points of the port (``qdml_tpu/cli.py``).

    python -m qdml_tpu_torch.cli train-hdce   [--device=cpu] [--train.lr=3e-4 ...]
    python -m qdml_tpu_torch.cli train-dce    [...]   # the monolithic DCE baseline
    python -m qdml_tpu_torch.cli train-sc     [...]   # classical scenario classifier
    python -m qdml_tpu_torch.cli train-qsc    [...]   # quantum scenario classifier
    python -m qdml_tpu_torch.cli nat-sweep    [...]   # QSC ensemble over quantum.noise_sweep
    python -m qdml_tpu_torch.cli eval         [...]   # the SNR sweep over the trained models
    python -m qdml_tpu_torch.cli profile      [--out=results_torch/trace] [...]
    python -m qdml_tpu_torch.cli gen-data     [--out=available_data] [...]
    python -m qdml_tpu_torch.cli import-torch [--out=DIR_OF_PTH_FILES] [...]
    python -m qdml_tpu_torch.cli export-torch [--out=torch_ckpts] [...]
    python -m qdml_tpu_torch.cli loss-curves  --curves=LABEL:PATH[,LABEL:PATH...] [...]
    python -m qdml_tpu_torch.cli serve        [--serve.port=8377 --serve.replicas=N ...]
    python -m qdml_tpu_torch.cli loadgen      [--rate=200] [--n=512] [--drift-at=K] [...]
    python -m qdml_tpu_torch.cli control      [--ticks=N] [--control.dry_run=true ...]
    python -m qdml_tpu_torch.cli route        [--fleet.backends=H:P,H:P --fleet.port=8378 ...]
    python -m qdml_tpu_torch.cli fleet-scale  --addr=HOST:PORT [--backends=N] [--timeout-s=S]
    python -m qdml_tpu_torch.cli report       --current=PATH[,PATH...] --baseline=PATH [--threshold=10]
    python -m qdml_tpu_torch.cli events       --addr=HOST:PORT [--follow] [--min-severity=warning ...]
    python -m qdml_tpu_torch.cli plan         --trace=W.jsonl[,W2.jsonl...] --validate
    python -m qdml_tpu_torch.cli plan         --trace=W.jsonl --target-rps=X --p99-ms=Y [--emit-target=T.json]
    python -m qdml_tpu_torch.cli monitor      --addr=HOST:PORT [--duration=30] [--attach --dry-run] [--out=M.jsonl]
    python -m qdml_tpu_torch.cli monitor      --render --current=M.jsonl [--events=A.jsonl] [--out=timeline.md]
    python -m qdml_tpu_torch.cli lint         [--baseline] [--json=F] [--paths=P,...] [--durations=F] [--list-rules]

Dotted flags override :mod:`qdml_tpu_torch.config` fields, as in the JAX
package, and ``--preset=NAME`` starts from one of its presets (``single_4q``,
``dp_8q``, ``sharded_16q``, ``federated``, ``nat_sweep``, ``robust_qsc``),
among them the low-precision levers (``--model.dtype=bfloat16``,
``--train.moments_dtype=bfloat16``, ``--data.trig_impl=split``,
``--data.rng_impl=``) and ``--quantum.mps_chi=`` for the ``mps`` circuit
impl. Runs on the card unless ``--device=cpu`` is given.

Several ranks: under ``python -m torch.distributed.run --nproc_per_node=R
-m qdml_tpu_torch.cli <command> ...`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) the
process joins the world before it builds any model or data, rank r runs on
``cuda:{LOCAL_RANK}`` unless ``--device`` names one, and ``train-hdce``,
``train-sc``, ``train-qsc``, ``nat-sweep`` and ``eval`` lay themselves on
the ``--mesh.*`` layout (:mod:`qdml_tpu_torch.parallel`). Rank 0 alone
writes logs, metrics files, checkpoints and results. The other commands run
on one rank; ``serve`` and ``loadgen`` under a world raise: one process
serves over the cards it sees (``serve.shard=auto``, the serving mesh of
:func:`~qdml_tpu_torch.parallel.mesh.serve_mesh`). With
``quantum.impl=auto`` (the default) ``train-qsc`` times the circuit impls on
the card before its first step and logs the winners (``kind=
"quantum_autotune"``); the table is ``results_torch/autotune/qsc_impl.json``
unless ``--quantum.autotune_table`` names another. Checkpoints and
the ``<command>.metrics.jsonl`` log go to ``<train.workdir>/Pn_<pilot_num>/
<name>/``. ``nat-sweep`` trains one QSC per ``quantum.noise_sweep`` sigma in
one ensemble step. ``eval`` restores ``hdce``, ``sc`` and, when trained,
``qsc`` and ``dce`` from there and writes ``quantum_classical_comparison.json``, ``results_table.md``
and (with matplotlib) the comparison figure to ``eval.results_dir``, by
default ``results_torch/``; ``results/`` holds the JAX package's own.
``gen-data`` writes the training grid as the reference's ``.npy`` cache,
``loss-curves`` the loss figure and its JSON from trainer metrics logs.
``import-torch`` reads the reference's ``.pth`` files from ``--out`` into
``{hdce,sc,qsc}_best``; ``export-torch`` writes those tags back as reference
``.pth`` files. ``profile`` traces 12 HDCE steps after a warm-up step with
``torch.profiler`` into ``--out`` and writes ``summary.json`` there
(samples/sec, step percentiles, the card's memory and the device-busy share
of the traced window, with the card's name and power limit). ``serve``
restores the newest HDCE and classifier from the workdir
(``ServeEngine.from_workdir``), warms the engine (the impl, routing and
batching races) and serves a replica pool behind the newline-JSON socket
at ``serve.host:serve.port``, printing a banner with the bound port once it
listens (``--serve.port=0`` binds a free one); ``{"op": "swap"}`` re-reads
the workdir. ``loadgen`` drives the same engine in process with open-loop
arrivals (``serve.arrival``, ``--rate=`` requests/s, ``--n=`` requests,
``serve.deadline_ms``, ``--drift-at=`` with ``serve.drift_step``) and prints
the ``serve_summary`` JSON. Both take every ``--serve.*`` field and, with
several visible cards and ``serve.shard=auto`` (the default), serve over all
of them (``--mesh.*`` lays them out; ``serve.expert_sharding``). ``control``
attaches to a running ``serve`` at ``serve.host:serve.port`` over the
``metrics``/``swap``/``scale`` verbs and supervises it (drift detection,
fine-tune of the drifted trunk, canary, hot-swap, watch, autoscaling; every
``--control.*`` field), printing its header line first; fine-tune and
canary run in its own process on the shared workdir. ``--ticks=N`` stops it
after N polls. ``route`` fronts running ``serve`` processes
(``fleet.backends``) with the fleet router on ``fleet.host:fleet.port``,
printing its banner once it listens; it needs no device and no checkpoint,
the backends own the models. ``--fleet.elastic=true`` arms the
``{"op": "fleet"}`` scaling form: backends spawned with
``fleet.spawn_overrides`` (on the card unless ``--device=cpu`` is among
them). ``fleet-scale`` is host-side, dispatched before config parsing: one
``{"op": "fleet"}`` exchange with a running ``route``, the status form
without ``--backends``; exit 0, 3 when the fleet did not converge or the
router refused (the typed reason printed), 2 on usage errors.

Telemetry: every command with a metrics log opens it with the run manifest
(:func:`~qdml_tpu_torch.telemetry.manifest.run_manifest`) and installs it
as the process-global sink, so spans, ``counters``, ``numerics``, ``cost``
and flight-recorder records land in the same file. The trainers compute the
numerics probes at ``--train.probe_every`` (default 100; 0 computes none),
arm the watchdog (``--train.watchdog``, ``--train.watchdog_grad_norm_max``)
and, with ``--train.checkify=true``, run each step under the sanitizer;
``--serve.checkify=true`` checks every served batch. A divergence prints
``DIVERGED: ...`` (the flight-recorder dump under
``<eval.results_dir>/<name>/flightrec/``) and exits 4. ``report`` is
host-side, dispatched before config parsing and before any device is
resolved: the regression gate over telemetry artifacts
(:mod:`~qdml_tpu_torch.telemetry.report`), exit 0, 3 on a regression, 2
on usage errors.

The flight deck is host-side too, dispatched the same way; none of its
commands opens a context on the card. ``events`` tails a running
``serve`` or ``route`` endpoint's event spine as JSONL (one tail, or
``--follow``; exit 0, 3 when the endpoint cannot be read, 2 on usage
errors). ``plan`` replays recorded ``serve_summary`` windows
(:mod:`~qdml_tpu_torch.telemetry.capacity`): ``--validate`` exits 0 when
every window's self-replay lands inside the band, 3 when one does not;
``--target-rps`` with ``--p99-ms`` sweeps backend counts and exits 0 with
an answer, 3 when no count meets the target, and ``--emit-target`` writes
the record :func:`~qdml_tpu_torch.control.fleet_scale.load_planner_target`
reads. ``monitor`` scrapes a running endpoint over the ``health``,
``metrics`` (and, with ``--attach``, ``events``) verbs into windows and
burn-rate alerts (:mod:`~qdml_tpu_torch.telemetry.timeseries`), writes a
manifest-headed ``monitor.jsonl`` and prints its summary; ``--attach``
ticks a fleet autoscaler each window through the ``{"op": "fleet"}`` verb
(``--dry-run`` decides without acting), exit 0, 3 on a reconnect give-up;
``--render`` turns a recorded stream into the markdown timeline.

``lint`` is host-side the same way (no device, no config, no world, no
kernel built or loaded): the static-analysis gate over the port's own tree
(:mod:`qdml_tpu_torch.analysis`), exit 0 clean, 1 on new findings, 2 on
usage errors; ``--json=F`` writes the record ``report --lint=F`` reads.
"""

from __future__ import annotations

import os
import sys
import time

from qdml_tpu_torch import config as cfg_mod
from qdml_tpu_torch.utils.device import resolve_device
from qdml_tpu_torch.utils.metrics import MetricsLogger

COMMANDS = (
    "train-hdce", "train-dce", "train-sc", "train-qsc", "nat-sweep", "eval", "profile", "gen-data",
    "import-torch", "export-torch", "loss-curves", "serve", "loadgen", "control", "route",
)  # "report", "fleet-scale", "events", "plan", "monitor", "lint" dispatch before config parsing (host-side)
# the commands that lay themselves on a mesh under a world of several ranks
MESH_COMMANDS = ("train-hdce", "train-sc", "train-qsc", "nat-sweep", "eval")


def workdir_of(cfg: cfg_mod.ExperimentConfig) -> str:
    """The reference's checkpoint scheme: ``./workspace/Pn_128/<name>``."""
    return os.path.join(cfg.train.workdir, f"Pn_{cfg.data.pilot_num}", cfg.name)


def _eval(cfg: cfg_mod.ExperimentConfig, workdir: str, device, logger: MetricsLogger) -> None:
    """``qdml_tpu/cli.py:307-354``, dense dispatch; under a world of several
    ranks on the training mesh (``:330-344``), rank 0 writing the results."""
    from qdml_tpu_torch.eval.report import (
        create_comparison_plots,
        results_markdown_table,
        save_results_json,
    )
    from qdml_tpu_torch.eval.sweep import load_sweep_models, run_snr_sweep
    from qdml_tpu_torch.parallel.mesh import training_mesh

    mesh = training_mesh(cfg, device)
    cfg, models = load_sweep_models(cfg, workdir, device, mesh)
    results = run_snr_sweep(cfg, models, logger=logger, device=device, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return
    out_json = save_results_json(results, cfg.eval.results_dir)
    out_png = create_comparison_plots(results, cfg.eval.results_dir)
    table = results_markdown_table(results)
    with open(os.path.join(cfg.eval.results_dir, "results_table.md"), "w") as fh:
        fh.write(table + "\n")
    print(table)
    print(f"results: {out_json} plot: {out_png}")


def _profile(cfg: cfg_mod.ExperimentConfig, out: str, device) -> dict:
    """``qdml_tpu/cli.py:372-424``: one HDCE step to warm up, then 12 traced
    steps. The batch comes from a grid cut to one batch a cell (the step's
    speed does not depend on the data). The device-busy share is the time
    the traced device activities cover (``profiling.device_busy_us``) over
    the window's host wall time; on the CPU it and
    the card's memory are not measured (None). The memory is
    :func:`~qdml_tpu_torch.telemetry.counters.device_memory_snapshot`'s,
    JAX's keys per card."""
    import dataclasses
    import json

    import torch

    from qdml_tpu_torch.data.datasets import DMLGridLoader, GridData
    from qdml_tpu_torch.train.hdce import hdce_train_step, make_trainer
    from qdml_tpu_torch.telemetry.counters import device_memory_snapshot
    from qdml_tpu_torch.telemetry.spans import profiler_trace
    from qdml_tpu_torch.utils.profiling import StepTimer, card, device_busy_us, force

    dev = resolve_device(device)
    bs = cfg.train.batch_size
    cut = dataclasses.replace(cfg.data, data_len=min(cfg.data.data_len, int(bs / cfg.data.train_split) + 2))
    loader = DMLGridLoader(GridData.synthesize(cut, dev), bs)
    batch = next(iter(loader.epoch(0)))
    model, opt = make_trainer(cfg, dev, loader.steps_per_epoch)
    force(hdce_train_step(model, opt, batch)["loss"])  # warm-up, outside the trace
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    timer = StepTimer(warmup=2)
    n_steps = 12
    with profiler_trace(out, dev) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            timer.tick(hdce_train_step(model, opt, batch)["loss"])
        timer.elapsed()  # the timed span ends here, before the trace is written out
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
    rows = bs * cfg.data.n_scenarios * cfg.data.n_users
    busy_us = device_busy_us(prof.events()) if cuda else None
    summary = {
        "backend": dev.type,
        "card": card() if cuda else None,
        "steps_traced": n_steps,
        "rows_per_step": rows,
        "samples_per_sec": round(timer.samples_per_sec(rows), 1),
        "step_ms": timer.histogram(),
        "window_s": window_s,
        "device_busy_us": busy_us,
        "device_busy_share": busy_us / (window_s * 1e6) if cuda else None,
        "memory": device_memory_snapshot() if cuda else None,
        "trace_dir": out,
    }
    with open(os.path.join(out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    return summary


def _loaded(cfg: cfg_mod.ExperimentConfig, name: str, state: dict, device) -> dict:
    """``state`` loaded (strictly) into the port's ``name`` module on
    ``device``, and that module's state dict: weights that do not fit the
    port's modules are refused before anything is written."""
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.checkpoint import reconcile_quantum_cfg
    from qdml_tpu_torch.train.hdce import build_hdce
    from qdml_tpu_torch.train.torch_interop import qsc_meta_from_state

    if name == "hdce":
        model = build_hdce(cfg, device)
    else:
        qcfg = reconcile_quantum_cfg(cfg, {"quantum": qsc_meta_from_state(state)}) if name == "qsc" else cfg
        model = build_classifier(qcfg, name == "qsc", device)
    model.load_state_dict(state)
    return model.state_dict()


def _import_torch(cfg: cfg_mod.ExperimentConfig, src: str, workdir: str, device) -> list[str]:
    """``qdml_tpu/cli.py:431-456``: the reference ``.pth`` files in ``src`` as
    ``{hdce,sc,qsc}_best``, each loaded into its module on ``device`` first;
    the QSC's architecture meta from its weights."""
    from qdml_tpu_torch.train.checkpoint import save_checkpoint
    from qdml_tpu_torch.train.torch_interop import import_reference_dir, qsc_meta_from_state

    states = import_reference_dir(src, batch_size=cfg.train.batch_size, snr_db=int(cfg.data.snr_db))
    checked = {name: _loaded(cfg, name, sd, device) for name, sd in states.items()}
    for name, sd in checked.items():
        meta: dict = {"source": src}
        if name == "qsc":
            meta["quantum"] = qsc_meta_from_state(sd, cfg.quantum.backend)
        save_checkpoint(workdir, f"{name}_best", {"params": sd}, meta)
    return sorted(states)


def _export_torch(cfg: cfg_mod.ExperimentConfig, out: str, workdir: str, device) -> list[str]:
    """``qdml_tpu/cli.py:457-471``: ``{hdce,sc,qsc}_best``, those trained,
    loaded into their modules on ``device``, as reference ``.pth`` files
    under ``out``."""
    from qdml_tpu_torch.train.checkpoint import has_checkpoint, restore_params
    from qdml_tpu_torch.train.torch_interop import export_reference_dir

    kwargs = {}
    for name in ("hdce", "sc", "qsc"):
        if has_checkpoint(workdir, f"{name}_best"):
            state = restore_params(workdir, f"{name}_best", device)[0]["params"]
            kwargs[f"{name}_state"] = _loaded(cfg, name, state, device)
    return export_reference_dir(out, batch_size=cfg.train.batch_size, snr_db=int(cfg.data.snr_db), **kwargs)


def _serve(cmd: str, cfg: cfg_mod.ExperimentConfig, workdir: str, device, extra: dict, logger) -> None:
    """``qdml_tpu/cli.py:474-512``: ``serve`` and ``loadgen`` over the engine
    restored from ``workdir``."""
    import json

    from qdml_tpu_torch.parallel.mesh import serve_mesh
    from qdml_tpu_torch.serve.engine import ServeEngine

    mesh = serve_mesh(cfg, device)  # the cards this process sees, or None for one device
    engine = ServeEngine.from_workdir(cfg, workdir, device=None if mesh is not None else device, mesh=mesh)
    if cmd == "serve":
        from qdml_tpu_torch.serve.server import run_server

        with logger.span("serve_warmup", buckets=list(engine.buckets)):
            engine.warmup()
        run_server(engine.cfg, engine, logger=logger, workdir=workdir)
        return
    from qdml_tpu_torch.serve.loadgen import run_loadgen

    drift_at = extra.get("--drift-at")
    summary = run_loadgen(
        engine.cfg,
        engine,
        rate=float(extra.get("--rate", 200.0)),
        n=int(extra.get("--n", 512)),
        deadline_ms=cfg.serve.deadline_ms if cfg.serve.deadline_ms > 0 else None,
        logger=logger,
        drift_at=None if drift_at is None else int(drift_at),
    )
    print(json.dumps(summary))


def fleet_scale_main(argv: list[str]) -> int:
    """``fleet-scale --addr=HOST:PORT [--backends=N] [--timeout-s=S]``
    (``qdml_tpu/cli.py:170-210``): the ``{"op": "fleet"}`` verb from the
    shell. Without ``--backends`` it prints the membership status; with it,
    it asks the router's lifecycle manager to converge the serving backend
    count (spawns and drains take minutes: ``--timeout-s`` defaults to 900).
    Exit 0 on success, 3 when the fleet did not converge or the router
    refused (reply printed), 2 on usage errors."""
    import json

    from qdml_tpu_torch.serve.client import ServeClient, ServeClientError

    def arg(name, default):
        return next((a.split("=", 1)[1] for a in argv if a.startswith(f"--{name}=")), default)

    addr = arg("addr", None)
    if not addr or ":" not in addr:
        print("fleet-scale needs --addr=HOST:PORT (a running route)")
        return 2
    host, port = addr.rsplit(":", 1)
    backends = arg("backends", None)
    client = ServeClient(host, int(port), timeout_s=float(arg("timeout-s", "900")), retries=0)
    try:
        rep = client.fleet(backends=None if backends is None else int(backends))
    except (ServeClientError, ConnectionError, OSError) as e:
        print(json.dumps({"ok": False, "reason": f"{type(e).__name__}: {e}"}))
        return 3
    finally:
        client.close_connection()
    print(json.dumps(rep, indent=2))
    return 0 if rep.get("ok") else 3


def main(argv: list[str] | None = None) -> int:
    from qdml_tpu_torch.parallel.mesh import leave_world

    try:
        rc = _main(argv)
    except BaseException:
        leave_world(sync=False)
        raise
    leave_world()  # after rank 0's writes, every rank leaves together
    return rc


def _main(argv: list[str] | None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "report":
        from qdml_tpu_torch.telemetry.report import report_main

        return report_main(rest)
    if cmd == "fleet-scale":
        return fleet_scale_main(rest)
    if cmd == "events":
        from qdml_tpu_torch.telemetry.events import events_main

        return events_main(rest)
    if cmd == "plan":
        from qdml_tpu_torch.telemetry.capacity import plan_main

        return plan_main(rest)
    if cmd == "monitor":
        from qdml_tpu_torch.telemetry.timeseries import monitor_main

        return monitor_main(rest)
    if cmd == "lint":
        from qdml_tpu_torch.analysis.cli import lint_main

        return lint_main(rest)
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
        elif key in ("--out", "--curves", "--rate", "--n", "--drift-at", "--ticks"):
            extra[key] = arg.split("=", 1)[1]
        else:
            overrides.append(arg)
    cfg = cfg_mod.from_args(overrides)
    workdir = workdir_of(cfg)
    t0 = time.time()
    # join the launcher's world before any model or data is built
    # (qdml_tpu/cli.py:265-270); a failed rendezvous raises
    from qdml_tpu_torch.parallel.mesh import rank_device, world_rank
    from qdml_tpu_torch.parallel.multihost import init_distributed_from_env

    if init_distributed_from_env(device):
        device = str(rank_device(device))
        if cmd not in MESH_COMMANDS + ("serve", "loadgen"):
            raise NotImplementedError(
                f"{cmd} has no mesh path; run it on one rank (mesh commands: {MESH_COMMANDS})"
            )
    rank0 = world_rank() == 0
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
    if cmd == "profile":
        import json

        print(json.dumps(_profile(cfg, extra.get("--out", "results_torch/trace"), device)))
        return 0
    if cmd == "import-torch":
        src = extra.get("--out", ".")
        print(f"imported {_import_torch(cfg, src, workdir, resolve_device(device))} from {src} -> {workdir}")
        return 0
    if cmd == "export-torch":
        written = _export_torch(cfg, extra.get("--out", "torch_ckpts"), workdir, resolve_device(device))
        print("wrote:\n  " + "\n  ".join(written))
        return 0
    from qdml_tpu_torch.telemetry import DivergenceError, run_manifest, set_sink

    logger = MetricsLogger(
        os.path.join(workdir, f"{cmd}.metrics.jsonl") if rank0 else None,
        echo=rank0,
        manifest=run_manifest(cfg, argv=argv) if rank0 else None,
    )
    set_sink(logger)
    try:
        if cmd in ("serve", "loadgen"):
            _serve(cmd, cfg, workdir, device, extra, logger)
            return 0
        if cmd == "route":
            from qdml_tpu_torch.fleet.frontend import run_router

            run_router(cfg, logger=logger)
            return 0
        if cmd == "control":
            from qdml_tpu_torch.control.loop import control_main

            ticks = extra.get("--ticks")
            # attaches to the RUNNING serve at serve.host:port over the
            # metrics/swap/scale verbs; fine-tune and canary run in this
            # process against the shared workdir (qdml_tpu/cli.py:512-522)
            return control_main(cfg, logger=logger, workdir=workdir, ticks=None if ticks is None else int(ticks),
                                device=device)
        if cmd == "eval":
            _eval(cfg, workdir, device, logger)
            if rank0:
                print(f"eval done in {time.time() - t0:.1f}s")
            return 0
        if cmd == "train-hdce":
            from qdml_tpu_torch.train.hdce import train_hdce

            _, history = train_hdce(cfg, device=device, workdir=workdir, logger=logger)
        elif cmd == "train-dce":
            from qdml_tpu_torch.train.dce import train_dce

            _, history = train_dce(cfg, device=device, workdir=workdir, logger=logger)
        elif cmd == "nat-sweep":
            from qdml_tpu_torch.train.nat_sweep import train_nat_sweep

            _, history = train_nat_sweep(cfg, device=device, workdir=workdir, logger=logger)
            history = {k: [[float(x) for x in v] for v in vals] for k, vals in history.items()}
        else:
            from qdml_tpu_torch.train.qsc import train_classifier

            _, history = train_classifier(
                cfg, quantum=cmd == "train-qsc", device=device, workdir=workdir, logger=logger
            )
    except DivergenceError as e:
        # the watchdog's typed failure: the dump's path, not a traceback
        # (qdml_tpu/cli.py:532-536)
        print(f"DIVERGED: {e}", flush=True)
        return 4
    finally:
        set_sink(None)
        logger.close()
    last = {k: v[-1] for k, v in history.items() if v}
    if rank0:
        print(f"{cmd} done in {time.time() - t0:.1f}s: {last}; checkpoints in {workdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
