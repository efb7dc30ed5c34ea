"""One run of one cell: find its files by name, set it up, measure the
window, judge what the window produced, and build the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

- the configuration ``port_bench/configs/<config>.json`` (the program's
  dotted overrides and the geometry the benchmark's inputs follow);
- the traffic mix ``port_bench/traffic/<traffic>.json``, whose ``driver``
  names the general driver ``port_bench/drivers/<driver>.py`` that reads
  it, and whose other keys are that driver's parameters;
- each per-layer metric's reader ``port_bench/metrics/<metric>.py``;
- the cell's limits ``port_bench/limits/<cell>.json``.

A cell, traffic mix or metric added later is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "qdml_tpu")


class CellError(RuntimeError):
    """A cell that cannot be run as the files describe it."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise CellError(f"missing file {path.relative_to(REPO)}") from e


def manifest(path: Path | None = None) -> dict:
    return load_json(path or REPO / "BENCHMARK.json")


def find_cell(man: dict, name: str) -> dict:
    for cell in man["workloads"]:
        if cell["name"] == name:
            return cell
    raise CellError(f"no workload {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file found by name (names may hold dots)."""
    if not path.is_file():
        raise CellError(f"missing file {path.relative_to(REPO)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_file(name: str) -> dict:
    return load_json(ROOT / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def driver_module(name: str) -> ModuleType:
    return load_module(ROOT / "drivers" / f"{name}.py", f"port_bench_driver_{name}")


def reader_module(metric: str) -> ModuleType:
    return load_module(ROOT / "metrics" / f"{metric}.py", "port_bench_metric_" + metric.replace(".", "_"))


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def experiment_config(conf: dict, extra: dict | None = None):
    """The program's ``ExperimentConfig`` with the configuration's dotted
    overrides (and, for tests at a small size, ``extra``)."""
    from qdml_tpu_torch import config as cfg_mod

    cfg = cfg_mod.ExperimentConfig(name=conf["name"])
    for dotted, value in {**conf["overrides"], **(extra or {})}.items():
        cfg = cfg_mod.override(cfg, dotted, value)
    return cfg


def geometry(cfg) -> dict:
    """The sizes the benchmark's inputs and the reference follow, read from
    the configuration's fields."""
    d = cfg.data
    return {"n_sub": d.n_sub, "n_beam": d.n_beam, "h_dim": d.n_ant * d.n_sub, "pilot_num": d.n_beam * d.n_sub,
            "label_noise_factor": d.label_noise_factor, "n_scenarios": d.n_scenarios, "n_users": d.n_users}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole: ``qdml_tpu_torch`` is not
    ``qdml_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def device_info(device, chips: int, peak_bytes: int) -> dict:
    import torch

    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips, "memory_peak_bytes": int(peak_bytes)}


def driver_for(name: str, seed: int, seconds: float, device, trace: bool = False, extra: dict | None = None,
               man: dict | None = None, log=print):
    """Cell ``name``'s driver, built from its files but not set up. The
    traffic file's ``overrides`` (load, such as the batch) apply after the
    configuration's, and ``extra`` (the tests' small sizes) last."""
    import torch

    cell = find_cell(man or manifest(), name)
    conf = config_file(cell["config"])
    traffic = traffic_file(cell["traffic"])
    cfg = experiment_config(conf, {**traffic.get("overrides", {}), **(extra or {})})
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    return driver_module(traffic["driver"]).Driver(
        SimpleNamespace(cell=cell, conf=conf, traffic=traffic, cfg=cfg, geom=geometry(cfg), seed=int(seed),
                        seconds=float(seconds), device=dev, chips=int(cell["chips"]), trace=bool(trace),
                        extra=extra, log=log))


def run_cell(name: str, seed: int, seconds: float, trace: bool, t_start: float, device=None,
             man: dict | None = None, extra: dict | None = None, log=print) -> tuple[dict, list[str]]:
    """Run cell ``name`` once. Returns the result line's object and the
    lines that set each compared number beside its limit. ``device``
    defaults to the first card; ``extra`` adds dotted overrides (the tests'
    small sizes). Raises :class:`CellError` where the cell's files are
    incomplete or a forbidden module was loaded."""
    import torch

    from port_bench import checks, tracing

    man = man or manifest()
    drv = driver_for(name, seed, seconds, device, trace, extra, man, log)
    cell, traffic, cfg, dev, chips = drv.ctx.cell, drv.ctx.traffic, drv.ctx.cfg, drv.ctx.device, drv.ctx.chips
    drv.setup()
    setup_s = time.perf_counter() - t_start
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tracer = tracing.Tracer(trace, float(traffic.get("trace_seconds", seconds)), dev)
    res = drv.window(float(seconds), tracer)
    tracer.stop()
    peak = drv.memory_peak_bytes() if dev.type == "cuda" else 0
    log(f"memory_peak_bytes {peak} (torch.cuda.max_memory_allocated, the fullest card)")
    traced = tracer.read() if trace else None
    numbers = drv.check()
    limits = checks.load_limits(name)
    correct, judged = checks.judge(numbers, limits)
    found = forbidden_modules()
    if found:
        raise CellError(f"forbidden modules loaded in the run: {', '.join(found)}")
    metrics: dict[str, dict] = {}
    if not trace:
        values = {"setup_s": setup_s, **res["end_to_end"]}
        for m in man["end_to_end"]:
            if applies(m, name):
                if m["name"] not in values:
                    raise CellError(f"the driver gave no {m['name']} for {name}")
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(cfg=cfg, geom=geometry(cfg), cell=cell, traffic=traffic, run=res,
                              device_events=traced["device"], host_events=traced["host"],
                              busy_s=traced["busy_s"], window_s=traced["window_s"])
        for m in man["per_layer"]:
            if applies(m, name):
                value = reader_module(m["name"]).read(ctx)
                if value is None:
                    # a kernel taken off the path leaves its metric silent,
                    # and the whole step's mfu still bounds the step
                    log(f"metric {m['name']} found nothing to read in {name} and is left out of the line")
                else:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]), "failed": int(res["failed"]),
           "metrics": metrics, "device": device_info(dev, chips, peak)}
    if trace:
        out["device"]["busy_s"] = traced["busy_s"]
        out["device"]["window_s"] = traced["window_s"]
        out["breakdown"] = traced["breakdown"]
    out["checks"] = judged
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in judged.items()]
    return out, lines
