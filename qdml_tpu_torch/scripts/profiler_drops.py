"""``chip_smoke.py`` whole, with a torch-profiler probe after each of its phases.

    python3 qdml_tpu_torch/scripts/profiler_drops.py

Run it as a file from the checkout's root, on the card: it imports
``chip_smoke`` from there and runs its ``main`` unchanged, but every phase
function is wrapped so that, once the phase returns, the same four calls
each go through ``ROUNDS`` pairs of profiler sessions
(``chip_smoke.profiled_device_us``), one with no idle time around its calls
inside the profiler's window and one with the smoke's
``PROFILE_PAD_S`` at each end: the launch floor (a one-element ``add_``),
the QSC kernel at n=6, B=64, the unitary kernel at n=6, B=2304 and the
complex64 ``torch.matmul`` of the same product. A session whose trace holds
no device time reads None; one that reads under ``SHORT`` of the same
call's padded reading after the first phase lost part of its calls. The
line after each phase counts both for each kind of session, so the first
phase after which they appear is the one that leaves the profiler so, and
the two kinds side by side show whether the window's padding keeps the
calls in the trace. The probes' launches are taken out of the kernels' path
counters again. The smoke's own lines print as it prints them, with the
card's name and power limit first; the last line is one JSON object: the
smoke's exit code and each probe's readings.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

ROUNDS = 2  # sessions of each call and kind a probe
SHORT = 0.8  # a reading under this share of the first padded one lost calls

# every phase function chip_smoke.main runs, in its order
PHASES = (
    "check_kernels", "lint_phase", "autotune_phase", "serve", "serve_dispatch", "microbench",
    "serve_tier_phase", "mesh_serve_phase", "control_phase", "fleet_phase", "train", "dce_phase",
    "evaluate", "interop_phase", "nat_sweep_phase", "trajectories_phase", "scan_phase", "routing_phase",
    "lowp_phase", "mps_phase", "scaling_phase", "bench_phase", "multirank_phase", "telemetry_phase",
    "profile_phase",
)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    sys.argv[1:] = []  # the smoke's default run
    import numpy as np
    import torch

    import chip_smoke as S
    from qdml_tpu_torch.quantum import circuits
    from qdml_tpu_torch.quantum import kernels as K
    from qdml_tpu_torch.utils.complexops import CArr

    probes: list[dict] = []
    calls: dict = {}

    def make_calls() -> None:
        dev = torch.device("cuda")
        rng = np.random.default_rng(S.SEED + 4)
        w6 = torch.tensor(rng.uniform(0, 2 * np.pi, (3, 6, 2)), dtype=torch.float32, device=dev)
        u6 = circuits.ansatz_unitary(w6, 6, 3)
        ur, ui = u6.re.contiguous(), u6.im.contiguous()
        a6 = torch.tensor(rng.uniform(-1, 1, (S.SERVE_BATCH, 6)), dtype=torch.float32, device=dev)
        p_re = torch.tensor(rng.standard_normal((S.WIDE_BATCH, 1 << S.UNI_N)), dtype=torch.float32, device=dev)
        p_im = torch.tensor(rng.standard_normal((S.WIDE_BATCH, 1 << S.UNI_N)), dtype=torch.float32, device=dev)
        psi, u = CArr(p_re, p_im), CArr(ur, ui)
        psi_c, ut_c = torch.complex(p_re, p_im), torch.complex(ur, ui).T.contiguous()
        one = torch.zeros(1, device=dev)
        calls.update({
            "floor": (lambda: one.add_(1.0), "elementwise_kernel"),
            "qsc_expvals": (lambda: K.fused_qsc_expvals(a6, ur, ui, 6), "qsc_expvals_kernel"),
            "unitary_expvals": (lambda: K.fused_unitary_expvals(psi, u, S.UNI_N), "unitary_expvals_"),
            "matmul": (lambda: torch.matmul(psi_c, ut_c), None),
        })

    fresh: dict = {}  # each call's padded reading in the first probe

    def probe(after: str) -> None:
        t = time.perf_counter()
        saved = dict(K.launches)
        us: dict = {"bare": {}, "padded": {}}
        with torch.no_grad():
            if not calls:
                make_calls()
            for _ in range(ROUNDS):
                for name, (fn, kname) in calls.items():
                    us["bare"].setdefault(name, []).append(S.profiled_device_us(torch, fn, kname, pad_s=0.0))
                    us["padded"].setdefault(name, []).append(S.profiled_device_us(torch, fn, kname))
        K.launches.update(saved)
        if not fresh:
            fresh.update({name: got[0] for name, got in us["padded"].items()})
        counts = {
            kind: {
                "empty": sum(v is None for got in byname.values() for v in got),
                "short": sum(bool(v is not None and fresh[name] and v < SHORT * fresh[name])
                             for name, got in byname.items() for v in got),
                "of": ROUNDS * len(byname),
            }
            for kind, byname in us.items()
        }
        probes.append({"after": after, **counts, "us": us})
        S.log(f"profiler probe after {after}: {json.dumps(counts)}, device us a call {json.dumps(us)} "
              f"({time.perf_counter() - t:.2f} s)")

    def wrapped(name, fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            probe(name)
            return out

        return run

    for name in PHASES:
        setattr(S, name, wrapped(name, getattr(S, name)))
    rc = S.main()
    print(json.dumps({"smoke_rc": rc, "probes": probes}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
