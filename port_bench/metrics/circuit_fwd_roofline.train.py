"""The hand circuit kernel's (B.2, ``csrc/circuit_expvals.cu``) share of its
roofline in the training step: the least time one launch can take
(:func:`port_bench.work_qsc.bound_s` of ``circuit_work`` at the step's
batch, the final state written for the adjoint) over the traced device time
a launch. The launches are the program's counter over the traced calls
(``ctx.run["launches"]``), checked against the trace's count of the
kernel's events; where the two differ, or either is missing, nothing is
read."""

import sys

from port_bench import work_qsc

KERNEL = "circuit_expvals_kernel"
COUNTER = "circuit_expvals"


def read(ctx):
    launches = ctx.run.get("launches", {}).get(COUNTER)
    events = [(s, e) for name, s, e in ctx.device_events if KERNEL in name]
    if not launches or len(events) != launches:
        print(f"circuit_fwd_roofline: {launches} launches counted, {len(events)} {KERNEL} events traced",
              file=sys.stderr)
        return None
    per_launch_s = sum(e - s for s, e in events) / 1e6 / launches
    q = ctx.cfg.quantum
    bound = work_qsc.bound_s(work_qsc.circuit_work(ctx.run["circuit_batch"], q.n_qubits, q.n_layers, with_state=True))
    return 100.0 * bound / per_launch_s
