"""``chip_smoke.py``'s fleet phase (6e) alone, from a given checkout, with every wire failure logged.

    python3 qdml_tpu_torch/scripts/fleet_phase_alone.py CHECKOUT [--stub-report]

Run it as a file, not with ``-m``: the checkout goes first on ``sys.path``,
so its own ``chip_smoke.py`` and ``qdml_tpu_torch`` are the ones imported,
and two checkouts (a parent and a change, say) can be compared on one card
in one call. It builds the four kernels the phases launch, runs the
autotune phase (the impl table) and the control phase (the fleet serves
its card-trained models), then the fleet phase, and prints ``DIAG`` lines
on the process clock:

- each loadgen window's start and end, and at its end the
  ``ServeClient.call`` failures of the window (port, seconds the client sat
  idle before the call, whether its socket was reused, the error), so that
  a failure on a pooled connection the backend reaped after
  ``serve.conn_timeout_s`` reads ``reused`` with an idle time past it;
- each spawned backend's port;
- the count of dropped sockets a client replaced before a send, where the
  checkout's client has that check (``ServeClient._dropped``).

``--stub-report`` replaces the kill class's ``report`` round trip with a
stub that writes the line the phase reads. Needs a CUDA card; the phase's
own lines (windows, startup, stall) print as the smoke prints them.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time


def main(argv: list[str]) -> int:
    if not argv or argv[0].startswith("-") or set(argv[1:]) - {"--stub-report"}:
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[0])
    stub_report = "--stub-report" in argv[1:]
    os.chdir(tree)
    sys.path.insert(0, tree)
    t_start = time.monotonic()

    def stamp(msg: str) -> None:
        print(f"DIAG {time.monotonic() - t_start:8.3f} {msg}", flush=True)

    import torch

    import chip_smoke as S
    from qdml_tpu_torch import cli
    from qdml_tpu_torch import config as cfg_mod
    from qdml_tpu_torch.data import datasets
    from qdml_tpu_torch.quantum import autotune
    from qdml_tpu_torch.quantum import kernels as K
    from qdml_tpu_torch.serve import batching_autotune
    from qdml_tpu_torch.train import dce as dce_mod
    from qdml_tpu_torch.train import hdce as hdce_mod
    from qdml_tpu_torch.train import qsc as train_qsc
    from qdml_tpu_torch.train import scan as scan_mod
    from qdml_tpu_torch.utils.device import resolve_device

    resolve_device()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    stamp(f"tree {tree} stub_report {stub_report} card {card}")
    K.build(tuple(k for k in K.KERNELS if k != "unitary_expvals"))
    shutil.rmtree(S.EVAL_WORK, ignore_errors=True)
    autotune.set_table_path(str(S.TUNE_DIR / "qsc_impl.json"))
    batching_autotune.set_table_path(str(S.TUNE_DIR / "serve_batching.json"))
    mods = {"config": cfg_mod, "datasets": datasets, "hdce": hdce_mod, "qsc": train_qsc, "cli": cli,
            "dce": dce_mod, "scan": scan_mod}
    S.autotune_phase(torch, K, cfg_mod, card)
    S.control_phase(torch, K, mods, card)
    stamp("control done")

    import qdml_tpu_torch.fleet as F
    from qdml_tpu_torch.serve import client as C
    from qdml_tpu_torch.serve import loadgen as LG

    fails: list[dict] = []
    drops = [0]
    ports: list[int] = []
    call0 = C.ServeClient.call

    def call(self, msg, *a, **kw):
        t = time.monotonic()
        idle = t - getattr(self, "_diag_last", t)
        reused = self._sock is not None
        try:
            return call0(self, msg, *a, **kw)
        except Exception as e:
            fails.append({"t": round(t - t_start, 3), "port": self.port, "idle_s": round(idle, 3), "reused": reused,
                          "op": msg.get("op", "infer"), "err": f"{type(e).__name__}: {str(e)[-70:]}"})
            raise
        finally:
            self._diag_last = time.monotonic()

    C.ServeClient.call = call
    if hasattr(C.ServeClient, "_dropped"):
        dropped0 = C.ServeClient._dropped

        def dropped(self):
            r = dropped0(self)
            drops[0] += bool(r)
            return r

        C.ServeClient._dropped = dropped
    spawn0 = F.spawn_backend

    def spawn_backend(*a, **kw):
        b = spawn0(*a, **kw)
        ports.append(b.port)
        stamp(f"spawned backend on port {b.port}")
        return b

    F.spawn_backend = spawn_backend
    loadgen0 = LG.run_loadgen_socket

    def run_loadgen_socket(*a, **kw):
        n0 = len(fails)
        stamp(f"window start (front {a[1]})")
        try:
            return loadgen0(*a, **kw)
        finally:
            stamp(f"window end: {len(fails) - n0} wire failures: {json.dumps(fails[n0:][:12])}")

    LG.run_loadgen_socket = run_loadgen_socket
    try:
        import qdml_tpu_torch.telemetry.report as R
    except ImportError:  # a checkout from before the report command
        R = None
    if R is not None and stub_report:
        def report_main(args):
            for a in args:
                if a.startswith("--out="):
                    with open(a[len("--out="):], "w") as fh:
                        fh.write("- fleet: stubbed, via router over -\n")
            return 0

        R.report_main = report_main
    t = time.perf_counter()
    ok = True
    try:
        S.fleet_phase(torch, K, mods, card)
    except Exception as e:  # lint: disable=broad-except(the phase's failure of any type is this measurement's outcome: it is printed and becomes the exit code)
        ok = False
        stamp(f"fleet phase FAILED: {type(e).__name__}: {e}")
    stamp(f"fleet phase ok {ok} wall {time.perf_counter() - t:.2f} s; backend ports {ports}; "
          f"total wire failures {len(fails)}; dropped sockets replaced before a send {drops[0]}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
