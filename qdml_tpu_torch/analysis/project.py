"""The port's lint maps (``qdml_tpu/analysis/project.py`` over the port's
tree): what makes the rules this repo's linter and not a generic checker.

Every entry encodes a hazard the code base has shipped or guarded against;
README's lint gate carries the rule table. The keys are the port's paths and
names, never the JAX package's:

- :data:`DEFAULT_PATHS`: what ``python -m qdml_tpu_torch.cli lint`` scans.
  ``tests/`` is excluded from the AST rules (the fixtures under
  ``tests/fixtures/lint/`` hold intentional violations); test wall-clock
  budgets are the slow-marker rule's, over a ``--durations`` report;
- :data:`LOCK_MAP`: thread-shared attributes and the lock that must be held
  to touch them (the shape of ``MicroBatcher._q`` mutated while a worker
  drains it);
- :data:`COLLECTIVE_CALLS`: ``torch.distributed`` collectives and the
  port's wrappers of them. Guarding one behind a rank-0 check deadlocks
  every other rank at the collective;
- :data:`TYPED_EXCEPTIONS`: the typed error contracts a broad ``except``
  can silently swallow (``DivergenceError`` exits the CLI with code 4).

- :data:`CAPTURE_ENTRY_POINTS`, :data:`HOT_HOST_FUNCS` and the tracing
  rules' name sets: the port's counterpart of JAX's jit reachability is
  code that runs while a CUDA graph is captured or inside a kernel wrapper
  (``ModuleContext.captured``), plus the serve request path;
- the concurrency pass's tables (:data:`BLOCKING_CALLS` ...
  :data:`THREAD_ROOT_CALLS`): JAX's, with torch's device fences among the
  blocking calls.

JAX's ``SHARD_AXIS_CALLS`` and ``TRAIN_MAKER_PATTERN`` have no entry: the
rules that read them (``collective-outside-shardmap``,
``train-step-jit-audit``) have no torch counterpart (README, the port's
lint gate).
"""

from __future__ import annotations

# Paths scanned by default (repo-relative; directories recurse over *.py).
DEFAULT_PATHS: tuple[str, ...] = (
    "qdml_tpu_torch",
    "chip_smoke.py",
)

# Thread-shared state -> required lock, per file and class. Attribute reads
# AND writes outside a ``with self.<lock>:`` block are findings (``__init__``
# is exempt: construction happens-before any sharing).
LOCK_MAP: dict[str, dict[str, dict[str, str]]] = {
    "qdml_tpu_torch/serve/batcher.py": {"MicroBatcher": {"_q": "_lock"}},
    # hot-swap epoch state: the live (hdce, clf) modules and their epoch
    # counter swap atomically between batches; a read outside the lock can
    # see a torn checkpoint mid-swap. The sparse-dispatch overflow counters
    # are incremented by every worker thread's infer() and read by
    # dispatch_summary(): unlocked access would drop counts under the
    # multi-worker interleaving a soak test catches.
    "qdml_tpu_torch/serve/engine.py": {
        "ServeEngine": {
            "_live": "_swap_lock",
            "_swap_epoch": "_swap_lock",
            "_overflow_rows": "_dispatch_lock",
            "_routed_rows": "_dispatch_lock",
        }
    },
    # pool-wide worker-exit accounting: every replica's workers share one
    # coordinator, and an unlocked read is the "crashed worker sheds a queue
    # its peers are draining" race the counter exists to prevent. The
    # elastic replica list is resized by the autoscaler thread while
    # loadgen/metrics threads iterate it (retired replicas ride the same
    # lock: merged_metrics must never miss a scale-down's served history).
    "qdml_tpu_torch/serve/server.py": {
        "ExitCoordinator": {"_live": "_lock"},
        # _quarantined rides _pool_lock like the replica/retired lists: the
        # supervisor thread moves crash-looping replicas there while health/
        # metrics readers iterate; the dedup cache's entry map is shared
        # between the event loop (inserts) and worker threads (the
        # forget-unless-served done-callbacks)
        "ReplicaPool": {
            "_replicas": "_pool_lock",
            "_retired": "_pool_lock",
            "_quarantined": "_pool_lock",
        },
        "DedupCache": {"_entries": "_lock"},
    },
    # breaker state machine: every submit (any thread) runs allow() and the
    # health/metrics paths read summary(); all transitions and counters
    # live under the one lock
    "qdml_tpu_torch/serve/breaker.py": {
        "CircuitBreaker": {
            "_state": "_lock",
            "_opens": "_lock",
            "_fast_fails": "_lock",
        }
    },
    # fleet-router cross-thread state: the per-backend ejection state
    # machine is driven by request executor threads AND the health poll
    # thread at once (an unlocked transition could re-admit a host
    # mid-ejection); the fleet-wide dedup table is shared by every
    # front-door request thread; the wire-metrics ledger and the connection
    # pool are touched by every concurrent forward.
    "qdml_tpu_torch/fleet/router.py": {
        "BackendState": {
            "_state": "_lock",
            "_fails": "_lock",
            "_oks": "_lock",
            "_opened_at": "_lock",
            "_ejections": "_lock",
            "_readmissions": "_lock",
        },
        "Backend": {
            "_latency": "_mlock",
            "_forwarded": "_mlock",
            "_failed": "_mlock",
            # in-flight forward count: incremented by request executors,
            # read by the retirement drain wait; an unlocked read could
            # terminate a backend with a forward still on the wire
            "_inflight": "_mlock",
            "_clients": "_clients_lock",
            "_made": "_clients_lock",
        },
        "RouterDedup": {"_entries": "_lock"},
        # traced-request net-wire histogram: fed by every request executor
        # thread that traced a forward, read by the metrics aggregation;
        # the consistent-hash ring + member table are REPLACED (never
        # mutated) under _ring_lock on admission/retirement while every
        # request thread snapshots them
        "FleetRouter": {
            "_trace_wire": "_trace_lock",
            "_ring": "_ring_lock",
            "_ring_idx": "_ring_lock",
        },
    },
    # elastic-fleet lifecycle state: the member/process tables are written
    # by scale operations (controller thread) while status() serves
    # concurrent front-door reads
    "qdml_tpu_torch/fleet/lifecycle.py": {
        "BackendLifecycle": {
            "_members": "_lock",
            "_procs": "_lock",
        },
    },
    # fleet-control shared state: the controller tick thread writes these
    # while status/report paths read them
    "qdml_tpu_torch/control/drift.py": {
        # detector windows: per-(scenario, signal) PH state + debounce/latch
        "DriftMonitor": {"_windows": "_lock"},
    },
    "qdml_tpu_torch/control/autoscale.py": {
        # the autoscaler's current target replica count (hysteresis state)
        "Autoscaler": {"_target": "_lock"},
    },
    "qdml_tpu_torch/control/fleet_scale.py": {
        # fleet-tier twin: target backend count + streaks + planner pin
        "FleetAutoscaler": {"_target": "_lock", "_planner": "_lock"},
    },
    "qdml_tpu_torch/control/deploy.py": {
        # the post-deploy rollback watch window
        "Deployer": {"_watch": "_lock"},
    },
    # event-spine ring state: publishers are request workers, supervisors
    # and poll threads while tails come from the asyncio verb handlers; an
    # unlocked append/evict pair could tear seq/dropped accounting and make
    # loss silent, the one thing the spine exists to prevent
    "qdml_tpu_torch/telemetry/events.py": {
        "EventBus": {
            "_ring": "_lock",
            "_seq": "_lock",
            "_dropped": "_lock",
        },
    },
    # the port's alone: the sanitizer is a dispatch mode, and the autograd
    # engine carries it to its device threads (sanitizer.py's docstring), so
    # a checked step's backward ops allocate check codes from another thread
    # than its forward ops; the code table and its index move together
    # under _lock. (_state, the per-device error tensors, is read without
    # the lock by design: entries are only ever added, by setdefault under
    # it.)
    "qdml_tpu_torch/telemetry/sanitizer.py": {
        "Sanitizer": {"_table": "_lock", "_codes": "_lock"},
    },
}

# Call names that are (or wrap) collectives: every rank of the group must
# reach them. Matched on the callee's last name segment, so only names that
# mean a collective wherever they appear are listed: torch.distributed's
# ``gather``/``scatter``/``reduce`` are not (``torch.gather`` and
# ``functools.reduce`` would trip). The port's ``save_checkpoint`` is a plain
# ``torch.save`` on the calling rank, not a collective, so it is not listed.
COLLECTIVE_CALLS: frozenset[str] = frozenset(
    {
        # torch.distributed
        "all_reduce",
        "all_gather",
        "all_gather_object",
        "all_gather_into_tensor",
        "reduce_scatter",
        "reduce_scatter_tensor",
        "all_to_all",
        "all_to_all_single",
        "broadcast",
        "broadcast_object_list",
        "gather_object",
        "scatter_object_list",
        "barrier",
        "monitored_barrier",
        "batch_isend_irecv",
        "new_group",
        # the port's wrappers: parallel/collectives.py
        "all_reduce_",
        "all_reduce_many_",
        "all_reduce_mean_",
        "exchange",
        "psum_replicated",
        "enter_replicated",
        "psum_parts",
        "all_gather_cols",
        "broadcast_",
        "broadcast_object",
        # ... parallel/dp.py, parallel/federated.py, train/qsc.py
        "reduce_over_",
        "replicate",
        "gather_hdce_state",
        "data_mean",
        # parallel/mesh.py: a barrier before the world is torn down
        "leave_world",
    }
)

# Guard predicates that make a block primary-only: telemetry/core.is_primary,
# parallel/mesh.world_rank and torch.distributed.get_rank.
PRIMARY_GUARDS: frozenset[str] = frozenset({"is_primary", "world_rank", "get_rank"})

# Typed exceptions a broad except can swallow (rule broad-except's message
# names them so the fix is obvious): telemetry/numerics.DivergenceError.
TYPED_EXCEPTIONS: tuple[str, ...] = ("DivergenceError", "KeyboardInterrupt")

# Socket/stream IO calls a retry loop re-attempts (rule retry-without-backoff):
# matched on the callee's last attribute segment inside a try body inside a
# host-side loop. Deliberately narrow: `result`/`get` are far too generic,
# and flagging them would make the rule cry wolf on every future drain.
RETRY_IO_CALLS: frozenset[str] = frozenset(
    {
        "create_connection",
        "connect",
        "connect_ex",
        "open_connection",
        "sendall",
        "send",
        "recv",
        "recv_into",
        "readline",
        "readexactly",
        "readuntil",
        "urlopen",
    }
)

# Calls that count as backoff between retry attempts (rule
# retry-without-backoff looks for ANY of these in the loop body; the
# sanctioned shape is serve/client.ServeClient._backoff -> time.sleep).
BACKOFF_CALLS: frozenset[str] = frozenset({"sleep", "wait", "backoff", "_backoff"})

# Exception names whose catch marks a loop's try as a transient-IO retry
# (serve/client.ServeClientError is a ConnectionError).
TRANSIENT_IO_EXCEPTIONS: frozenset[str] = frozenset(
    {
        "ConnectionError",
        "ConnectionResetError",
        "ConnectionRefusedError",
        "BrokenPipeError",
        "OSError",
        "IOError",
        "TimeoutError",
        "timeout",
        "ServeClientError",
    }
)

# Async stream reads that must be timeout-bounded in serve paths (rule
# unbounded-readline): a bare `await reader.readline()` is how one dead peer
# pins a connection slot forever; the sanctioned form routes through
# asyncio.wait_for (serve/server._read_line).
UNBOUNDED_READ_CALLS: frozenset[str] = frozenset(
    {"readline", "readexactly", "readuntil"}
)

# Cumulative run-lifetime counters (serve/metrics.py ServeMetrics,
# fleet/router.py, serve/breaker.py): dividing one by a wall-clock span is
# an UNWINDOWED rate: it averages the counter's entire lifetime, so a
# restarted process reports garbage and a long-running one can never
# surface a regression. Windowed rates come from snapshot differencing
# (telemetry/timeseries.counter_delta; that module is sanctioned,
# RATE_SANCTIONED_MODULES). Matched on the numerator's last
# (underscore-stripped) name segment; run-level SUMMARY rates over an
# explicit full-run span are sanctioned by suppression at the site.
CUMULATIVE_COUNTERS: frozenset[str] = frozenset(
    {
        "completed",
        "rows_useful",
        "rows_padded",
        "shed",
        "forwarded",
        "failed_forwards",
        "failovers",
        "fast_fails",
        "admitted",
        "dedup_hits",
        "give_ups",
        "slo_met",
        "slo_total",
        "restarts",
        "ejections",
        "readmissions",
    }
)

# Wall-time denominators for unwindowed-cumulative-rate: the clock reads that
# measure spans plus any local name assigned from an expression containing
# one (elapsed = time.monotonic() - t0).
WALL_TIME_CALLS: frozenset[str] = frozenset({"time", "monotonic", "perf_counter"})

# Modules allowed to divide counters by time: the snapshot-differencing
# helpers themselves (they difference FIRST, then divide the delta by the
# window width: the pattern the rule funnels everything through).
RATE_SANCTIONED_MODULES: tuple[str, ...] = ("qdml_tpu_torch/telemetry/timeseries.py",)

# ---------------------------------------------------------------------------
# The tracing rules' maps (qdml_tpu_torch/analysis/rules.py)
# ---------------------------------------------------------------------------

# (file, Class.method) host-side hot paths audited for device->host syncs:
# the serve request path, where a sync is sometimes THE point (the reply
# fetch) but must carry a written reason. Captured code is found by
# ModuleContext.captured.
HOT_HOST_FUNCS: dict[str, tuple[str, ...]] = {
    "qdml_tpu_torch/serve/engine.py": ("ServeEngine.infer",),
    "qdml_tpu_torch/serve/server.py": ("ServeLoop._serve_one",),
}

# Calls whose function-valued arguments run while a CUDA graph is captured
# (matched on the callee's last name segment, names found anywhere in the
# call, as through ``_step_fn(model, opt)``): the K-step runner
# (train/scan.make_scan_steps) and torch's own graphed callables.
CAPTURE_ENTRY_POINTS: frozenset[str] = frozenset({"make_scan_steps", "make_graphed_callables"})

# The raw kernel launch (quantum/kernels._launch): a function of the module
# that reaches it is a kernel wrapper, captured code (the launch is what a
# graph records), and its callers' loops are launch loops.
KERNEL_LAUNCH_CALLS: frozenset[str] = frozenset({"_launch"})

# The kernel wrappers other modules call (quantum/kernels.py), each one
# launch (or one launch stack) a call: called from a host-side loop over
# layers or gates, every iteration is a launch with a device-memory round
# trip between them (rule pallas-host-loop).
KERNEL_WRAPPER_CALLS: frozenset[str] = frozenset(
    {
        "_launch",
        "fused_qsc_expvals",
        "fused_circuit_expvals",
        "fused_circuit_expvals_ensemble",
        "circuit_adjoint",
        "circuit_adjoint_ensemble",
        "apply_rotation_layer",
        "fused_unitary_expvals",
    }
)

# Names whose call is a device->host sync when it appears in captured code
# or a HOT_HOST_FUNCS request path: torch's fetches and fences
# (``torch.cuda.synchronize``, ``Stream``/``Event.synchronize``).
HOST_SYNC_ATTRS: frozenset[str] = frozenset({"item", "cpu", "tolist", "synchronize"})
HOST_SYNC_NAMES: frozenset[str] = frozenset({"float", "int", "bool"})

# Wall-clock sources read once while a graph is captured: every replay
# reuses the capture's value.
WALL_CLOCK_CALLS: frozenset[str] = frozenset(
    {"time", "monotonic", "perf_counter", "process_time", "now", "utcnow", "today"}
)

# torch calls whose OUTPUT SHAPE depends on input VALUES: each syncs the
# host to size its result, which a CUDA graph cannot capture (rule
# data-dependent-shape-in-jit). Matched on the callee's last segment under
# the torch namespace; torch.where is handled separately (only its
# one-argument nonzero form is data-dependent).
DATA_DEP_SHAPE_CALLS: frozenset[str] = frozenset(
    {
        "nonzero",
        "argwhere",
        "masked_select",
        "unique",
        "unique_consecutive",
    }
)

# Request-tracing construction/stamping API (telemetry/tracing.py), host
# side only: inside captured code a stamp is read once, at capture (rule
# trace-in-jit-path).
TRACE_STAMP_CALLS: frozenset[str] = frozenset({"TraceContext", "trace_sampled", "add_phase"})

# Per-gate matrix constructors of the port's quantum/ (circuits.rot_gate;
# JAX's gate_h and gate_rx have no port, nothing on the port's paths builds
# an H or RX matrix): one inside a host-side Python loop rebuilds the gate
# matrix every iteration (rule gate-matrix-in-loop).
GATE_MATRIX_CONSTRUCTORS: frozenset[str] = frozenset({"rot_gate"})

# torch.cuda calls that do not initialise CUDA: allowed at import (rule
# import-time-jnp flags every other torch.cuda call at module level).
CUDA_QUERY_CALLS: frozenset[str] = frozenset({"is_available", "device_count", "is_initialized"})

# ---------------------------------------------------------------------------
# The concurrency pass's tables (qdml_tpu_torch/analysis/concurrency.py)
# ---------------------------------------------------------------------------

# Calls that can block the calling thread for unbounded (or scheduling-
# dependent) time. Reachable inside a held-lock region they serialize every
# peer of that lock behind one slow operation (rule blocking-under-lock).
# Matched on the callee's LAST name/attribute segment; deliberately narrow:
# `.get()`/`.pop()` are far too generic to flag.
BLOCKING_CALLS: frozenset[str] = frozenset(
    {
        # host scheduling
        "sleep",
        "wait",            # Event.wait / Condition.wait / Popen.wait
        "join",            # Thread.join / Process.join
        "result",          # concurrent.futures drain
        # device fences: a lock held across a device sync serializes every
        # submit behind the fence (the swap path suppresses WITH a reason).
        # JAX's block_until_ready/device_get, and torch's
        # torch.cuda.synchronize (Stream/Event.synchronize too) and the
        # fetches that wait for the card: .item(), .cpu(), .tolist()
        "block_until_ready",
        "device_get",
        "synchronize",
        "item",
        "cpu",
        "tolist",
        # socket / stream IO
        "create_connection",
        "connect",
        "accept",
        "recv",
        "recv_into",
        "sendall",
        "readline",
        "readexactly",
        "urlopen",
        # subprocess
        "check_output",
        "check_call",
        "communicate",
        "popen",
        "Popen",
    }
)

# Synchronous calls that stall the event loop when reached from an
# ``async def`` handler without an executor hop (rule sync-io-in-async).
# time.sleep is the classic; asyncio.sleep resolves to a different canonical
# name and is exempt. The sanctioned escape hatches are the loop's
# run_in_executor / asyncio.to_thread (the callable is PASSED, not called).
ASYNC_BLOCKING_CALLS: frozenset[str] = frozenset(
    {
        "sleep",
        "create_connection",
        "connect",
        "accept",
        "recv",
        "recv_into",
        "sendall",
        "urlopen",
        "check_output",
        "check_call",
        "communicate",
        "result",          # concurrent.futures .result() parks the loop
        "join",
        "run",             # subprocess.run
    }
)

# Files whose ``async def`` handlers are on the serving event loop and are
# therefore in scope for sync-io-in-async (a stalled loop stops EVERY
# connection, not one request).
ASYNC_SCOPED_FILES: tuple[str, ...] = (
    "qdml_tpu_torch/serve/server.py",
    "qdml_tpu_torch/fleet/router.py",
)

# Executor escape hatches: a callable passed INTO one of these runs off the
# event loop, so sync work inside it is sanctioned.
EXECUTOR_CALLS: frozenset[str] = frozenset(
    {"run_in_executor", "to_thread", "run_coroutine_threadsafe"}
)

# Call sites whose function-valued arguments become THREAD ENTRY POINTS:
# the roots the unmapped-shared-state rule counts distinct writers from.
THREAD_ROOT_CALLS: frozenset[str] = frozenset(
    {
        "Thread",
        "Timer",
        "add_done_callback",
        "call_soon_threadsafe",
        "submit",  # executor.submit(fn, ...)
    }
)
