"""Worlds of ranks for checking the mesh paths, and the rank programs they run.

:func:`spawn_world` starts R rank processes with the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT`` on a free local port), or one
``python -m torch.distributed.run --standalone`` that starts them. Each
process logs to a file, never a pipe (a rank blocked on a full pipe would
stall the whole world inside a collective), and a world that outlives its
timeout is killed and reported. The tests and ``chip_smoke.py`` run their
worlds through it.

The rank programs (``python -m qdml_tpu_torch.parallel.selfcheck STEP
[STEP ...] [--in=DIR] --out=DIR [--device=...]``) run their steps in order
in one world. A step is a job below, which reads its inputs from ``.pt``
files the caller wrote in ``--in``, or ``cli:ARGS``, one command of
:mod:`qdml_tpu_torch.cli` (its arguments split on spaces). Each rank writes
``--out/rank{r}.json``, ``{"rank", "steps": [...]}``, one record a step
with the kernel launches the step made on this rank (the counts are reset
before each step) and its wall seconds; rank 0 also writes what a job
names below:

- ``circuit``: for each case, the sharded statevector (:mod:`~qdml_tpu_
  torch.quantum.sharded`) on the model line of the world: ⟨Z⟩ and the
  gradients of ``sum(<Z>^2)`` with respect to the angles and weights, the
  B.3 launches a forward made, and with ``reps`` > 0 the rank's median
  forward and forward+backward milliseconds and the part of each spent
  inside the exchanges and the all-reduce (host clock, the device synced
  around each);
- ``hdce-step``: one global HDCE step
  (:func:`~qdml_tpu_torch.train.hdce.hdce_mesh_train_step`) on a mesh from
  a whole model and batch, the loss and the whole new state (gathered);
- ``qsc-step``: one quantum classifier step on a mesh (the batch over
  ``data``, the circuit per ``quantum.backend``), the loss, and (rank 0,
  ``state.pt``) the new state and the reduced gradients;
- ``hdce-h``: a checkpoint of the one-rank layout restored on the mesh
  (the trunks over ``fed``) and the estimate ``h`` of a fixed batch, each
  scenario's rows through its trunk, gathered (rank 0, ``h.pt``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(
    nproc: int,
    argv: list[str],
    log_dir: str | os.PathLike,
    env: dict[str, str] | None = None,
    timeout_s: float = 300.0,
    launcher: bool = False,
) -> list[int]:
    """Run ``python argv...`` as the ``nproc`` ranks of one world and return
    their exit codes (the launcher's one code with ``launcher=True``). Logs
    go to ``log_dir/rank{r}.log`` (``launcher.log``). Past ``timeout_s`` every
    process is killed and ``TimeoutError`` raised."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    base = dict(os.environ)
    base["PYTHONPATH"] = str(REPO) + os.pathsep + base.get("PYTHONPATH", "")
    base.setdefault("OMP_NUM_THREADS", "1")
    base.update(env or {})
    procs: list[subprocess.Popen] = []
    logs = []
    try:
        if launcher:
            fh = open(log_dir / "launcher.log", "w")
            logs.append(fh)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 f"--nproc_per_node={nproc}", *argv],
                env=base, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT,
            ))
        else:
            port = free_port()
            for r in range(nproc):
                rank_env = dict(base, RANK=str(r), WORLD_SIZE=str(nproc), LOCAL_RANK=str(r),
                                LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                fh = open(log_dir / f"rank{r}.log", "w")
                logs.append(fh)
                procs.append(subprocess.Popen(
                    [sys.executable, *argv], env=rank_env, cwd=REPO, stdout=fh, stderr=subprocess.STDOUT,
                ))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        return [p.returncode for p in procs]
    except subprocess.TimeoutExpired as e:
        raise TimeoutError(f"world of {nproc} ranks outlived {timeout_s} s: {argv}") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()


def read_ranks(out_dir: str | os.PathLike, nproc: int) -> list[dict]:
    """Every rank's JSON result of a job, in rank order."""
    return [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) for r in range(nproc)]


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _circuit(args, dev) -> dict:
    import torch

    from qdml_tpu_torch.config import MeshConfig
    from qdml_tpu_torch.parallel import collectives as coll
    from qdml_tpu_torch.parallel.mesh import make_mesh, world_size
    from qdml_tpu_torch.quantum import kernels
    from qdml_tpu_torch.quantum.sharded import run_circuit_sharded

    inp = torch.load(Path(args.inp) / "circuit.pt", weights_only=False)
    mesh = make_mesh(MeshConfig(model_axis=world_size(), data_axis=1), device=dev)
    reps = int(inp.get("reps", 0))
    cases = []
    for case in inp["cases"]:
        n, layers = int(case["n"]), int(case["layers"])
        angles = case["angles"].to(dev).requires_grad_(True)
        weights = case["weights"].to(dev).requires_grad_(True)

        def fwd():
            with torch.no_grad():
                return run_circuit_sharded(angles, weights, n, layers, mesh)

        def fwd_bwd():
            angles.grad = weights.grad = None
            out = run_circuit_sharded(angles, weights, n, layers, mesh)
            (out**2).sum().backward()
            return out

        before = kernels.launches["rotation_layer"]
        fwd()
        launches = kernels.launches["rotation_layer"] - before
        out = fwd_bwd()
        rec = {
            "n": n, "layers": layers,
            "ev": out.detach().cpu().tolist(),
            "g_angles": angles.grad.cpu().tolist(),
            "g_weights": weights.grad.cpu().tolist(),
            "rotation_layer_launches_per_forward": launches,
            "device": str(out.device),
            "shard_amplitudes": 2**n // world_size(),
        }
        for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            samples, exch = [], []
            for _ in range(reps):
                _sync(dev)
                coll.reset_stats()
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                samples.append(1e3 * (time.perf_counter() - t0))
                exch.append(1e3 * coll.stats["seconds"])
            if reps:
                rec[f"{name}_ms"] = sorted(samples)[reps // 2]
                rec[f"{name}_exchange_ms"] = sorted(exch)[reps // 2]
        cases.append(rec)
    return {"cases": cases}


def _hdce_step(args, dev) -> dict:
    import torch

    from qdml_tpu_torch.config import MeshConfig
    from qdml_tpu_torch.parallel.dp import shard_grid_batch
    from qdml_tpu_torch.parallel.federated import gather_hdce_state
    from qdml_tpu_torch.parallel.mesh import make_mesh, world_rank
    from qdml_tpu_torch.train.hdce import lay_out_on_mesh, hdce_mesh_train_step, make_trainer

    inp = torch.load(Path(args.inp) / "hdce.pt", weights_only=False)
    cfg = inp["cfg"]
    mesh = make_mesh(MeshConfig(**inp["mesh"]), device=dev)
    model, opt = make_trainer(cfg, dev, 1, inp["state"])
    model, opt = lay_out_on_mesh(cfg, model, opt, mesh, 1)
    fed = mesh.shape["fed"] > 1
    batch = shard_grid_batch({k: v.to(dev) for k, v in inp["batch"].items()}, mesh, fed=fed)
    out = hdce_mesh_train_step(model, opt, batch, mesh, cfg.data.n_scenarios)
    params, _ = gather_hdce_state(model, opt.state_dict())
    if world_rank() == 0:
        torch.save(params, Path(args.out) / "state.pt")
    return {"loss": float(out["loss"]), "loss_perf": float(out["loss_perf"]), "coords": mesh.coords()}


def _qsc_step(args, dev) -> dict:
    import torch

    from qdml_tpu_torch.parallel.dp import shard_grid_batch
    from qdml_tpu_torch.parallel.mesh import training_mesh, world_rank
    from qdml_tpu_torch.train.qsc import classifier_train_step, data_mean, make_trainer, replicate_for_data

    inp = torch.load(Path(args.inp) / "qsc.pt", weights_only=False)
    cfg = inp["cfg"]
    mesh = training_mesh(cfg, dev)
    model, opt = make_trainer(cfg, True, dev, 1, inp["state"])
    if mesh is not None:
        replicate_for_data(model, opt, mesh)
    batch = shard_grid_batch({k: v.to(dev) for k, v in inp["batch"].items()}, mesh)
    out = classifier_train_step(model, opt, batch, noise=inp.get("noise"))
    loss = float(data_mean(out["loss"], mesh))
    if world_rank() == 0:
        torch.save({
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
        }, Path(args.out) / "state.pt")
    return {"loss": loss}


def _hdce_h(args, dev) -> dict:
    import torch

    from qdml_tpu_torch.config import ExperimentConfig
    from qdml_tpu_torch.parallel.collectives import all_reduce_
    from qdml_tpu_torch.parallel.federated import shard_hdce_vars
    from qdml_tpu_torch.parallel.mesh import training_mesh, world_rank
    from qdml_tpu_torch.train.checkpoint import restore_params

    inp = torch.load(Path(args.inp) / "hdce_h.pt", weights_only=False)
    cfg: ExperimentConfig = inp["cfg"]
    mesh = training_mesh(cfg, dev)
    params = restore_params(inp["workdir"], inp["tag"], dev)[0]["params"]
    shard = shard_hdce_vars(params, mesh, cfg).to(dev).eval()
    x = inp["x"].to(dev)  # (S, B, 2, H, W): row block s through trunk s
    with torch.no_grad():
        own = shard(x[shard.scen0 : shard.scen0 + len(shard.trunks)])
        h = torch.zeros((x.shape[0], *own.shape[1:]), device=dev)
        h[shard.scen0 : shard.scen0 + own.shape[0]] = own
        all_reduce_(h, mesh.group("fed"))
    if world_rank() == 0:
        torch.save(h.cpu(), Path(args.out) / "h.pt")
    return {"scen0": shard.scen0, "device": str(own.device)}


def _cli(argv: list[str], dev) -> dict:
    """One ``qdml_tpu_torch.cli`` command in the live world (the world is
    left at the end of all steps, not after each)."""
    from qdml_tpu_torch import cli

    rc = cli._main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} returned {rc}")
    return {"argv": argv}


JOBS = {"circuit": _circuit, "hdce-step": _hdce_step, "qsc-step": _qsc_step, "hdce-h": _hdce_h}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qdml_tpu_torch.parallel.selfcheck")
    ap.add_argument("steps", nargs="+", help=f"jobs ({', '.join(sorted(JOBS))}) or 'cli:ARGS' commands, in order")
    ap.add_argument("--in", dest="inp", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from qdml_tpu_torch.parallel.mesh import leave_world, rank_device, world_rank, world_size
    from qdml_tpu_torch.parallel.multihost import init_distributed_from_env
    from qdml_tpu_torch.quantum import kernels

    try:
        init_distributed_from_env(args.device)
        dev = rank_device(args.device)
        Path(args.out).mkdir(parents=True, exist_ok=True)
        results = []
        for step in args.steps:
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            if step.startswith("cli:"):
                rec = _cli(step[4:].split(), dev)
            else:
                rec = JOBS[step](args, dev)
            _sync(dev)
            rec.update(step=step, seconds=time.perf_counter() - t0, launches=dict(kernels.launches))
            results.append(rec)
            if world_size() > 1:
                torch.distributed.barrier()  # rank 0's files are written before the next step reads them
        out = {"rank": world_rank(), "steps": results}
        (Path(args.out) / f"rank{world_rank()}.json").write_text(json.dumps(out))
    except BaseException:
        leave_world(sync=False)
        raise
    leave_world()
    return 0


if __name__ == "__main__":
    sys.exit(main())
