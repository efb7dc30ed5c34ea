"""Circuit forward micro-benchmark (``scripts/r3_quantum_microbench.py:79-104``) on the port.

    python -m qdml_tpu_torch.scripts.quantum_microbench [out.json] [--device=cpu]

At the JAX script's shape (n=6 qubits, L=3 layers, batch 2304; angles
U(-1, 1) and weights U(-3, 3) from ``np.random.default_rng(0)``) it times four
forward formulations of the reference circuit, angles -> per-wire <Z>:

- ``dense``: the ansatz unitary on the closed-form product state;
- ``pallas``: impl ``pallas``, the QSC kernel (``csrc/qsc_expvals.cu``);
- ``tensor``: the gate-by-gate statevector;
- ``pallas_old``: the embedding as gates on |0...0>, the ansatz unitary, and
  the unitary kernel (``csrc/unitary_expvals.cu``, the JAX package's
  ``fused_unitary_expvals``).

Each row reports ``fwd_<row>_us`` (microseconds per call, mean over 50 calls
after one warm-up, the device synchronized before and after the timed loop)
and ``fwd_<row>_sps`` (samples per second), beside ``backend``, ``batch``,
``n`` and ``layers``: the JAX script's keys. The JSON goes to ``out.json``
(default ``runs/quantum_microbench.json``). The JAX script's train-step rows
call ``bench.py``, the JAX package's benchmark, which the port does not have
yet; ``chip_smoke.py`` prints the port's step times. Runs on the card unless
``--device=cpu``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from qdml_tpu_torch.quantum import statevector as sv
from qdml_tpu_torch.quantum.circuits import angle_embed, ansatz_unitary, run_circuit
from qdml_tpu_torch.quantum.kernels import fused_unitary_expvals
from qdml_tpu_torch.utils.device import resolve_device

BATCH = 2304
N, L = 6, 3
REPS = 50


def inputs(batch: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX script's inputs: ``default_rng(0)`` angles (batch, N) in
    U(-1, 1), then weights (L, N, 2) in U(-3, 3), as float32."""
    rng = np.random.default_rng(0)
    angles = rng.uniform(-1, 1, (batch, N)).astype(np.float32)
    w = rng.uniform(-3, 3, (L, N, 2)).astype(np.float32)
    return torch.tensor(angles, device=device), torch.tensor(w, device=device)


def old_pallas(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The round-2 psi-input formulation (``scripts/r3_quantum_microbench.py:98-100``)."""
    psi = angle_embed(sv.zero_state(N, (a.shape[0],), device=a.device), a, N)
    return fused_unitary_expvals(psi, ansatz_unitary(w, N, L), N)


ROWS: dict[str, Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = {
    "dense": lambda a, w: run_circuit(a, w, N, L, "dense"),
    "pallas": lambda a, w: run_circuit(a, w, N, L, "pallas"),
    "tensor": lambda a, w: run_circuit(a, w, N, L, "tensor"),
    "pallas_old": old_pallas,
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, args, device: torch.device) -> tuple[float, torch.Tensor]:
    """Seconds per call over ``REPS`` calls after one warm-up call, the
    device synchronized before and after the loop; and the warm-up's output."""
    out = fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / REPS, out


def run(
    batch: int = BATCH, device: str | torch.device | None = None
) -> tuple[dict, dict[str, torch.Tensor]]:
    """Every row at ``batch``: the JAX script's result dict and each row's
    <Z> (batch, N)."""
    dev = resolve_device(device)
    angles, w = inputs(batch, dev)
    res: dict = {"backend": dev.type, "batch": batch, "n": N, "layers": L}
    outs = {}
    with torch.inference_mode():
        for name, fn in ROWS.items():
            dt, outs[name] = timed(fn, (angles, w), dev)
            res[f"fwd_{name}_us"] = round(dt * 1e6, 1)
            res[f"fwd_{name}_sps"] = round(batch / dt, 1)
    return res, outs


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device, out_path = None, "runs/quantum_microbench.json"
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            out_path = arg
    res, _ = run(BATCH, device)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
