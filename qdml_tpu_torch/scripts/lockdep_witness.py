"""The serving tier's locks witnessed at run time: a replica crash and a hot
swap under ``QDML_LOCKDEP=1`` (the ``lockdep`` block of JAX's
``scripts/chaos_dryrun.py``, over the port).

    QDML_LOCKDEP=1 python -m qdml_tpu_torch.scripts.lockdep_witness [--device=cuda] [CONFIG_FLAGS...]

``CONFIG_FLAGS`` are the CLI's (``--train.workdir=...``,
``--quantum.n_qubits=6``, ...); a workdir without ``hdce_best`` gets an
HDCE and a QSC of seeded weights first. It serves from that workdir
through a supervised :class:`~qdml_tpu_torch.serve.server.ReplicaPool`
(bucket batching) with one injected ``worker_exception`` on replica 1,
sending waves of 16 requests until the fault fires and the supervisor has
restarted the replica, then one ``swap_params`` (to the live weights) while
a wave is in flight. It prints one JSON line: the witness summary
(:func:`~qdml_tpu_torch.utils.lockdep.witness_summary`), every witnessed
order edge, the restarts, the faults and the wall seconds. Exit 0 when the
fault fired, the replica restarted, the swap advanced the epoch and no
inversion was witnessed; 1 otherwise; 2 without ``QDML_LOCKDEP=1``.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import replace

SEED = 2026
WAVE = 16
MAX_REQUESTS = 8192


def _seed_workdir(cfg, wd: str) -> None:
    """An HDCE and a QSC of seeded weights as ``*_best``."""
    import torch

    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.checkpoint import save_checkpoint
    from qdml_tpu_torch.train.hdce import build_hdce
    from qdml_tpu_torch.train.torch_interop import qsc_meta_from_state

    gen = torch.Generator().manual_seed(SEED)
    hdce_sd = build_hdce(cfg, "cpu", generator=gen).state_dict()
    qsc_sd = build_classifier(cfg, True, "cpu", generator=gen).state_dict()
    save_checkpoint(wd, "hdce_best", {"params": hdce_sd}, {})
    save_checkpoint(wd, "qsc_best", {"params": qsc_sd}, {"quantum": qsc_meta_from_state(qsc_sd)})


def main(argv: list[str]) -> int:
    from qdml_tpu_torch.utils import lockdep

    if not lockdep.enabled():
        print("lockdep_witness: set QDML_LOCKDEP=1 (locks are witnessed only when built with it)",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    from pathlib import Path

    from qdml_tpu_torch import cli
    from qdml_tpu_torch import config as cfg_mod
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.faults import FaultInjected, FaultPlan, FaultSpec
    from qdml_tpu_torch.serve.loadgen import make_request_samples
    from qdml_tpu_torch.serve.server import ReplicaPool
    from qdml_tpu_torch.serve.types import Prediction

    device = next((a.split("=", 1)[1] for a in argv if a.startswith("--device=")), "cuda")
    cfg = cfg_mod.from_args([a for a in argv if not a.startswith("--device=")])
    cfg = replace(cfg, serve=replace(cfg.serve, batching="bucket", replicas=2))
    wd = cli.workdir_of(cfg)
    if not any(Path(wd).glob("hdce_best*")):
        Path(wd).mkdir(parents=True, exist_ok=True)
        _seed_workdir(cfg, wd)
    engine = ServeEngine.from_workdir(cfg, wd, device=device)
    engine.warmup()
    x = make_request_samples(cfg, WAVE * 4)["x"]
    plan = FaultPlan([FaultSpec("worker_exception", at=1, replica="serve-replica-1")], seed=SEED)
    pool = ReplicaPool(engine, faults=plan).start()
    outcome = {"served": 0, "failed": 0, "other": 0}
    sent = 0
    epoch = None

    def wave(base: int) -> None:
        for f in [pool.submit(x[(base + i) % len(x)], rid=base + i) for i in range(WAVE)]:
            try:
                r = f.result(timeout=60.0)
                outcome["served" if isinstance(r, Prediction) else "other"] += 1
            except FaultInjected:
                outcome["failed"] += 1

    try:
        while sent < MAX_REQUESTS and not plan.fired:
            wave(sent)
            sent += WAVE
        deadline = time.monotonic() + 30.0
        while pool.health()["restarts"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        # one swap with a wave in flight: the swap's locks against the workers'
        futs = [pool.submit(x[i % len(x)], rid=MAX_REQUESTS + i) for i in range(WAVE)]
        hdce, clf = engine.live_vars()
        epoch = engine.swap_params(hdce.state_dict(), clf.state_dict())["epoch"]
        for f in futs:
            outcome["served" if isinstance(f.result(timeout=60.0), Prediction) else "other"] += 1
        sent += WAVE
        health = pool.health()
    finally:
        pool.stop()
    witness = lockdep.witness_summary()
    rec = {
        "lockdep": witness,
        "edges": [list(e) for e in lockdep.witnessed_edges()],
        "fired": bool(plan.fired),
        "restarts": health["restarts"],
        "faults": dict(pool.merged_metrics().faults),
        "outcome": outcome,
        "sent": sent,
        "swap_epoch": epoch,
        "device": str(engine.device),
        "seconds": round(time.perf_counter() - t0, 3),
    }
    print(json.dumps(rec), flush=True)
    ok = (rec["fired"] and rec["restarts"] >= 1 and epoch == 1 and witness["inversions"] == 0
          and witness["locks"] > 0 and witness["edges"] > 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
