"""The hand adjoint kernel's (B.2's backward, ``csrc/circuit_adjoint.cu``)
share of its roofline in the training step: the least time one launch can
take (:func:`port_bench.work_qsc.bound_s` of ``adjoint_work`` at the step's
batch) over the traced device time a launch, which is the adjoint kernel's
and its fold kernel's (``circuit_adjoint_fold_kernel``, the weights'
gradient summed over the blocks) together. The launches are the program's
counter over the traced calls (``ctx.run["launches"]``), checked against
the trace's count of the adjoint kernel's events; where the two differ, or
either is missing, nothing is read."""

import sys

from port_bench import work_qsc

KERNEL = "circuit_adjoint_kernel"
FAMILY = "circuit_adjoint_"  # the adjoint kernel and its fold kernel
COUNTER = "circuit_adjoint"


def read(ctx):
    launches = ctx.run.get("launches", {}).get(COUNTER)
    counted = sum(1 for name, _, _ in ctx.device_events if KERNEL in name)
    if not launches or counted != launches:
        print(f"circuit_adj_roofline: {launches} launches counted, {counted} {KERNEL} events traced",
              file=sys.stderr)
        return None
    device_s = sum(e - s for name, s, e in ctx.device_events if FAMILY in name) / 1e6
    q = ctx.cfg.quantum
    bound = work_qsc.bound_s(work_qsc.adjoint_work(ctx.run["circuit_batch"], q.n_qubits, q.n_layers))
    return 100.0 * bound / (device_s / launches)
