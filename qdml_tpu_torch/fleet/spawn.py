"""Spawn and supervise real backend ``serve`` processes (``qdml_tpu/fleet/spawn.py``).

A fleet's backends are genuine ``python -m qdml_tpu_torch.cli serve``
processes: own interpreter, own CUDA context, own warmup, own request-path
work counters. :func:`spawn_backend` launches one with ``--serve.port=0``
(or a fixed port a respawn reuses), reads the banner ``run_server`` prints
after warmup and bind (with the actual port and the stable ``host_id``),
and returns a handle that can kill (SIGKILL: backend loss), stall
(SIGSTOP/SIGCONT: a hung host) and reap the process.

Unlike the JAX package's spawner, which defaults its children to
``JAX_PLATFORMS=cpu``, this one sets no device: a child runs on the card
unless ``--device=cpu`` is among its overrides, and a child that finds no
card exits before its banner, so :func:`spawn_backend` raises with the
child's last lines.

Real deployments run one ``serve`` per host under their own supervisor and
hand the router ``fleet.backends``; this module gives the tests, the
lifecycle manager and ``chip_smoke.py`` the same process topology on one
machine.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field


@dataclass
class BackendProc:
    """One spawned ``serve`` process and its learned identity."""

    proc: subprocess.Popen
    host: str
    port: int
    host_id: str
    banner: dict
    log_path: str | None = None
    _stopped: bool = field(default=False, repr=False)

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL: backend loss (no drain, no goodbye)."""
        self._stopped = True
        if self.alive():
            self.proc.kill()
        self.proc.wait(timeout=30.0)

    def stall(self) -> None:
        """SIGSTOP: a hung host holds its sockets and answers nothing; the
        router must eject it on timeouts."""
        os.kill(self.proc.pid, signal.SIGSTOP)

    def resume(self) -> None:
        os.kill(self.proc.pid, signal.SIGCONT)

    def terminate(self, timeout_s: float = 30.0) -> None:
        """Polite stop: SIGINT first (``run_server`` flushes its counters on
        KeyboardInterrupt), then SIGKILL."""
        self._stopped = True
        if not self.alive():
            self.proc.wait(timeout=timeout_s)
            return
        self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=timeout_s)


def spawn_backend(
    overrides: list[str],
    port: int = 0,
    host: str = "127.0.0.1",
    env: dict | None = None,
    log_path: str | None = None,
    timeout_s: float = 600.0,
    python: str | None = None,
) -> BackendProc:
    """Launch ``python -m qdml_tpu_torch.cli serve`` with ``overrides``
    (dotted config flags, ``--train.workdir=...`` so the backend restores
    the fleet's checkpoints, ``--device=cpu`` to keep it off the card) and
    block until its banner names the actual port. ``env`` is laid over this
    process's environment (``CUDA_VISIBLE_DEVICES`` picks the child's card).
    After the banner the child's output goes to ``log_path`` (stderr follows
    stdout); a child that exits or stays silent past ``timeout_s`` raises
    with its last lines."""
    cmd = [
        python or sys.executable, "-m", "qdml_tpu_torch.cli", "serve",
        f"--serve.host={host}", f"--serve.port={port}", *overrides,
    ]
    child_env = dict(os.environ)
    # the child resolves qdml_tpu_torch from THIS package's root, not from
    # the caller's working directory
    import qdml_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(qdml_tpu_torch.__file__)))
    child_env["PYTHONPATH"] = pkg_root + (
        os.pathsep + child_env["PYTHONPATH"] if child_env.get("PYTHONPATH") else ""
    )
    if env:
        child_env.update(env)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=child_env, text=True, bufsize=1,
    )
    # the deadline must hold against a child that hangs silently (a wedged
    # warmup prints nothing): a reader thread feeds a queue and the deadline
    # governs the queue waits
    out_q: queue.Queue = queue.Queue()

    def _pump():
        try:
            for pumped in proc.stdout:
                out_q.put(pumped)
        except ValueError:
            pass  # stdout closed at reap
        out_q.put(None)  # EOF sentinel

    threading.Thread(target=_pump, daemon=True, name="backend-banner-pump").start()
    deadline = time.monotonic() + timeout_s
    lines: list[str] = []
    banner = None
    while banner is None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            proc.wait(timeout=30.0)
            raise TimeoutError(
                f"backend produced no startup banner within {timeout_s}s:\n"
                + "".join(lines[-30:])
            )
        try:
            line = out_q.get(timeout=min(remaining, 1.0))
        except queue.Empty:
            continue
        if line is None:
            proc.wait(timeout=30.0)
            raise RuntimeError(
                "backend exited before announcing "
                f"(rc={proc.returncode}):\n" + "".join(lines[-30:])
            )
        lines.append(line)
        if '"serving"' in line:
            try:
                banner = json.loads(line)
            except json.JSONDecodeError:
                continue  # a log line that merely mentions the key
    bound = int(banner["serving"].rsplit(":", 1)[1])
    handle = BackendProc(
        proc=proc, host=host, port=bound,
        host_id=str(banner.get("host_id") or f"{host}:{bound}"),
        banner=banner, log_path=log_path,
    )

    # keep draining the pump's queue so the child never blocks on a full
    # pipe (warmup races and telemetry echoes are chatty): the pump thread
    # owns proc.stdout, this one owns the queue
    def _drain():
        sink = open(log_path, "a") if log_path else None
        try:
            while True:
                out_line = out_q.get()
                if out_line is None:
                    break  # EOF: the pump saw stdout close
                if sink is not None:
                    sink.write(out_line)
                    sink.flush()
        finally:
            if sink is not None:
                sink.close()

    threading.Thread(target=_drain, daemon=True, name=f"backend-log-{bound}").start()
    return handle
