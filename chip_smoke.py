#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``qdml_tpu_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py        # from the repo root; needs one CUDA GPU and nvcc
    python3 chip_smoke.py --only=multirank   # the build, phase 8k alone and, on 4+
                                             # cards (NCCL, one a rank), phase 6c
                                             # over the real cards

Phases, each of which exits non-zero on failure:

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile the five circuit kernels from ``qdml_tpu_torch/csrc/`` with
   nvcc for sm_90a, in parallel (the unitary kernel's in a thread that the
   kernel phase joins before its unitary checks), and print the build
   seconds and ptxas reports;
3. kernels: hold each kernel against its plain PyTorch version on the card,
   over qubit counts (the rotation layer to n=20, the unitary kernel to
   n=14), layer counts and batch sizes, plus the autograd
   gradients of the QSC, rotation-layer and unitary kernels against autograd
   through the plain versions, the adjoint kernel against autograd through
   the plain forward, and the out-of-window qubit counts that must raise.
   The rotation-layer kernel's entry point is the sharded statevector
   (phase 8k; the JAX package reaches its own only from
   ``tests/test_pallas.py``);
3b. lint: ``python -m qdml_tpu_torch.cli lint --baseline --lockgraph-check
   --json=build/chip_smoke/lint.json`` in a process of its own, through a
   ``-c`` wrapper that calls ``cli.main`` and then reports
   ``torch.cuda.is_initialized()`` and whether the kernels' module was
   loaded: it fails unless the gate (the whole-program concurrency pass
   among it) exits 0 with no new finding and the committed lock graph
   fresh, without a CUDA context and without the kernels' module, in under
   ``LINT_MAX_S`` (its seconds logged);
4. autotune: the circuit-impl race (``quantum/autotune.ensure``, forced) on
   the card at n=6 L=3 buckets 64 and 4096 (the training step's 2304 rows)
   and n=8 L=3 bucket 64, into a table under ``build/chip_smoke/autotune/``;
   every candidate's ``fwd_ms`` and ``train_ms`` and the winners are printed.
   It fails if a candidate records an error, if the QSC kernel, the circuit
   forward or its adjoint was not launched by the race, or if a second
   ``prewarm`` measures anything;
5. serving: four full-width engines (S=3 trunks of 32 features on the
   16x8x2 image, the 4096->2048 head, seeded random weights) — quantum n=6
   L=3 through impl ``pallas``, quantum n=8 L=3 through impl
   ``pallas_circuit``, quantum n=6 L=3 at impl ``auto`` (each bucket's impl
   from the race's table, tuned at warmup where missing), and the classical
   SCP128 — answer batches of 1, 5, 64 and 100 requests over buckets (1, 8,
   64); the kernels' launch counters are zeroed just before and read just
   after, and every answer is held against the same engine built on the CPU
   from the same weights. Then, counters zeroed again: a forced
   ``serve.dispatch=sparse`` engine on a balanced and on a skewed batch (every
   row to one scenario, so it overflows) against the dense one; a forced
   ``serve.batching=ragged`` engine at every fill 1..64 with NaN in the pad
   rows against the bucket engine; ``swap_params`` of the ``auto`` engine to a
   second set of weights against a fresh engine on them, and a mismatched
   state dict that must raise. No engine may measure, write a table or build
   a kernel in ``infer`` after its warmup;
6. microbench: the port's circuit micro-benchmark
   (``qdml_tpu_torch.scripts.quantum_microbench``) at its full shape (n=6,
   L=3, B=2304), counters zeroed before and read after; every row's <Z> is
   held against the ``dense`` row's within 1e-5. Its ``pallas_old`` row is
   the unitary kernel's path;
6b. serve_tier: the serving tier at full width (QSC n=6 L=3, buckets
   1..64), counters zeroed at its start and read at its end: a workdir of
   seeded weights written by ``save_checkpoint`` (``*_best`` and ``*_v2``),
   ``ServeEngine.from_workdir`` and ``warmup()`` at ``serve.batching=auto``
   (each tier's race and impl logged); ``run_loadgen`` with 4096 requests,
   deadline 16 ms, through 2 replicas of 2 workers, poisson at 2000 rps and
   bursty (burstiness 4) at 8000 rps, each once with ``batching=bucket``
   (max_wait 2 ms) and once ``ragged``: rps, p50/p99, SLO, sheds, padding
   waste, fill and B.2 launches logged, and it fails on a stranded future,
   request-path work, a served ``h`` off the CPU twin's ``offline_forward``
   by more than 1e-4 max|h| + 1e-5 (rows routed alike; routes equal where
   the margin exceeds 1e-4) or B.2 launches in the traffic window (after
   run_loadgen's offline reference and warmup) other than one a served
   batch; beside it, below saturation (poisson 1000 rps, 2048 requests,
   ragged, every request traced, under the torch profiler), the 2x2 pool
   against one replica of one worker: latency, SLO, phases, the
   per-replica completion split and the card's busy share, and each run's
   window (its ``serve_summary``) replayed by the capacity planner (logged:
   under the profiler the pools may shed, which the planner does not
   model); a third traced run, the one worker at poisson 500 rps (1024
   requests) without the profiler, is the planner's window, through ``cli
   plan`` (its host-side dispatch in ``cli.main``): ``--validate`` exit 0 (its phases replay its own p99
   within 2x and its rps within 15%), and ``--target-rps=2000 --p99-ms=16
   --emit-target`` exit 0 with the target read back by
   ``load_planner_target``, or exit 3 with the null answer the loader
   refuses; then
   ``run_server`` on port 0 in a thread with the port's ``ServeClient``
   (256 requests against the twin, a retried id that must not dispatch
   again, ``health``, ``metrics``, a ``swap`` to the ``v2`` tags whose
   answers must follow the v2 twin), ``run_loadgen_socket`` with 1024,
   and a clean stop; last, one injected ``worker_exception`` on replica 1's
   second batch, traffic offered in waves until it has fired: its batch's
   futures fail, the supervisor restarts the replica, every other request
   is served, and the per-replica batch split is logged;
6b'. lockdep: that crash and one ``swap_params`` with a wave in flight, in
   a process of its own with ``QDML_LOCKDEP=1``
   (``qdml_tpu_torch/scripts/lockdep_witness.py`` on the serve_tier
   workdir, as JAX's ``scripts/chaos_dryrun.py`` witnesses its replica
   crash): it fails unless the fault fired, the replica restarted, the swap
   advanced the epoch and the witness saw no inversion and some locks and
   edges, in under ``LOCKDEP_MAX_S``; each witnessed edge is logged beside
   whether the committed static lock graph has it;
6c. mesh_serve: the engine over a ``(fed, data, model)`` mesh at full width
   (QSC n=6 L=3 ``auto``, buckets 1, 8, 64, seeded weights): in the default
   run over logical positions on ``cuda:0`` (``make_local_mesh``, each
   position its own copy of the weights; JAX's tests use virtual devices
   alike), under ``--only=multirank`` with 4+ cards over the real cards
   (``serve_mesh``). Layouts: data=4 (bucket), and fed=3 with expert
   sharding, data=2 on one card / data=1 on the real cards, dense bucket and
   forced sparse ragged. Requests of 1, 5, 64 and 100 rows against the CPU
   twin without a mesh (1e-4 max|h| + 1e-5 on rows routed alike, as phase
   6b), the counters zeroed just before: B.2 launched once a row slice (D a
   data-sharded batch, 1 a replicated one), every bucket's impl
   ``pallas_circuit``; NaN/Inf pad tails at fills 3 and 37 of the sparse
   ragged 64-row tier leave the valid rows bit for bit and every row finite;
   then a 2x2 pool on the data=4 engine under ``run_loadgen``, ragged,
   poisson 1000 rps, 2048 requests (cut for time), with one ``swap_params``
   mid-traffic: every row held against the old or the new weights' CPU twin
   (both must appear), B.2 launches in the traffic window equal to the row
   slices of the served batches, no request-path work, p50/p99 and the
   device busy share under the profiler beside the one-device 2x2 engine
   at the same rate;
6d. control: the control loop at full width on the data=4 mesh of logical
   positions, ``scripts/control_dryrun.py``'s control settings (drift of
   scenario 0 at step 4; ft_steps 300, ft_batch 32, probe_n 96, min gain
   0.3 dB, tol 0.5 dB, watch 2 ticks, no autoscaling): HDCE and QSC (n=6
   L=3 ``auto``) trained on the card (data_len 512 a cell, 4 epochs of
   batch 32: cut from 20000 and the dryrun's 6/10 epochs, for time) into a
   workdir under ``build/chip_smoke/control/``; a 2x2 pool on the mesh
   engine under ``run_loadgen`` (poisson 500 rps, 1536 requests, cut for
   time, drift from the middle) while a dry-run ``FleetController`` on
   ``PoolPoller`` watches (no drift event on scenarios 1-2 before the drift
   may fire); the loadgen's drift-scenario windows replayed into
   ``observe_parity`` (scenario 0 must be detected); one ``tick()``:
   fine-tune (its validation NMSE must improve; head and trunks 1-2 of
   ``hdce_last`` bit-equal to ``hdce_best``), canary (must pass), the
   explicit-tag swap (tags ``hdce_last``/``qsc_best``, no work); all-drifted
   traffic after it held against the CPU twin of ``hdce_last`` (B.2 once a
   row slice), its parity into the watch until ``deploy_confirmed`` or a
   rollback; last ``python -m qdml_tpu_torch.cli serve`` and ``cli control
   --ticks=3 --control.dry_run=true`` as processes: JAX's header line,
   exit 0. Fine-tune wall and steps/s, canary seconds, swap ms and p50
   before and after are logged;
6e. fleet: the fleet tier (``qdml_tpu_torch.fleet``) at full width,
   ``scripts/fleet_router_dryrun.py`` and ``fleet_elastic_dryrun.py`` with
   their traffic (windows of 240 requests, bursty at 300 rps, deadline 500
   ms, through ``run_loadgen_socket`` with 8 clients): a fresh workdir under
   ``build/chip_smoke/fleet/`` holding copies of the ``hdce_best`` /
   ``qsc_best`` phase 6d trained on the card; two backends spawned by
   ``spawn_backend`` as ``cli serve`` processes on the card (QSC n=6 L=3
   forced to ``pallas_circuit``, so a B.2 that fails to build or launch
   kills the backend at warmup; buckets 1/8/64, a 2x2 pool each; the
   kernels loaded from phase 2's build; with 2+ visible cards a card
   each), each holding a context on the card (nvidia-smi: its pid, or,
   where nvidia-smi shows another pid namespace, one more context a live
   backend), each passing ``verify_warm``; the port's ``FleetRouter`` and
   ``route_async`` on port 0 in a thread. Windows: baseline (every answer
   within 1e-4 max|h| + 1e-5 of the CPU twin's ``offline_forward`` on rows
   routed alike, both backends serving), ``{"op": "swap"}`` fanned out
   under traffic (both to swap epoch 1), router-side garbage (typed
   replies), SIGKILL of backend 1 (ejected, failovers, the survivor
   serving, its context freed; respawned on its port, re-admitted), SIGSTOP
   for 5 s (the context kept, ejected, re-admitted after SIGCONT); in every
   window zero stranded futures and no give-up before the deadline; a
   same-id retry answered by the router's dedup with no dispatch on any
   backend, healthy, across the kill and after a retirement. From the
   baseline to the stall's recovery window the port's ``MonitorScraper``
   (0.4 s windows, ``scripts/monitor_dryrun.py``'s alerter) runs in a
   dry-run ``MonitorAttachment`` on the front door (``live_fleet_dryrun``'s
   invariants): only ``health``, ``metrics`` and ``events`` sent, an idle
   probe completes no request, a burn alert fires in the stall window and
   none in the baseline (the stall's mark is kept 2.0 s past its traffic
   before the recovery window's, as the dryruns keep theirs, and each
   scrape around the stall's end is logged with the router rule's burns
   and debounce count), ``event_drops`` 0, no give-up, every backend's
   request-path work still zero; the rendered timeline shows the alert and
   the router's ejection and re-admission, and ``report`` over the baseline
   window and the monitor stream exits 0 with its monitoring gates armed;
   then ``cli events`` (exit 0, the kill window's ejection envelope among
   its output) and ``cli monitor --attach --dry-run --interval=0.5
   --duration=5`` (exit 0, no give-up, ``event_drops`` 0, and no context of
   its own on the card while it runs, by nvidia-smi's count) as processes
   against the front door. Elastic: a
   ``FleetAutoscaler`` pinned to a hand-written target in ``emit_target``'s
   shape (``backends_needed`` 3, then 2) drives ``BackendLifecycle.scale_to``:
   a third backend spawned, verified warm and admitted while windows run
   (ring keys move only to it), then drained and terminated, each
   ``fleet_scale_event`` carrying the target's sha; a standby killed
   between spawn and verification is quarantined. Then ``FleetController``
   over ``FleetPoller``: drift from a replayed parity feed (as the dryrun),
   single-trunk fine-tune on the card, canary, the tagged swap fanned to
   both backends (no work), answers after it against the CPU twin of
   ``hdce_last``, the watch confirming; zero request-path work on every
   surviving backend by its own ``metrics`` verb; ``cli route
   --fleet.elastic=true`` as a process (banner), ``cli fleet-scale
   --backends=3`` against it exit 0 (its backends spawned without
   ``serve.buckets``, which ``fleet.spawn_overrides`` cannot carry: the
   default buckets), ``cli fleet-scale`` against the in-process router
   without a lifecycle: typed ``fleet_scale_unavailable``, exit 3; every
   process stopped and every backend's context gone. Cut for time: one
   window a fault class and one recovery window (the dryrun's best of 3
   trials), no second adapt episode with a backend ejected, and of the
   dryrun's report round trips the kill class's alone: the recovery
   window's manifest-headed stream against the baseline window's through
   ``report`` (threshold 50%, the dryrun's), its exit code and ``via router
   over`` line printed (exit 2 fails; 0 and 3 are logged). The B.2
   launches happen in the backend processes: the smoke's counters do not
   count them;
7. training: at full width on data synthesized on the card (data_len 2048 per
   cell, cut from the reference's 20000 for time), five trainers each run one
   epoch (7 steps of 256 rows per cell, 2304 a step) and validate: HDCE
   (Adam), SC (Adam), QSC n=6 L=3 under impl ``pallas`` (AdamW, QuantumNAT
   sigma 0.01), QSC n=8 L=3 under impl ``pallas_circuit`` (AdamW, quantile
   gradient pruning 0.5) and QSC n=6 L=3 at impl ``auto``, which must log its
   ``quantum_autotune`` entry from the race's table without measuring; the
   counters are zeroed just before and read just after each; the first 2
   steps of the first four are run again on a CPU twin from the same weights
   and batches (the same QuantumNAT noise) and held against it. The HDCE, SC
   and n=6 ``pallas`` QSC write their checkpoints under ``build/chip_smoke/``.
   The K-step path logs a chunk's losses only on the flight recorder's
   cadence, so this phase, 7b, 8e and 8g, which hold every step's logged
   loss, run at ``train.probe_every=1``; every other phase keeps the
   trainers' default of 100;
8. eval: ``python -m qdml_tpu_torch.cli eval`` over those checkpoints (the
   SNR sweep 5..15 dB, batch 200, test_len 2000 per point, cut from the
   reference's 10000 for time), results under ``build/chip_smoke/``, counters
   zeroed before and read after; one SNR point's per-batch sums are held
   against the same per-batch function on the CPU with the same weights and
   the same test batches; then one SNR point of the sweep with
   ``dispatch="sparse"`` against ``dense`` at rtol 1e-4;
   The eval's workdir also holds the DCE (phase 7b), so the sweep reports
   the monolithic DCE curve and the CPU twin holds its ``err_dce`` sums;
7b. dce: the monolithic DCE at full width (one ``ConvP128`` of 32 features,
   the 4096->2048 head) on the training grid: its first 2 steps against a
   CPU twin, then one epoch of ``train_dce`` (counters zeroed before, read
   after: it launches no circuit kernel), writing ``dce_best`` for eval;
8b. interop: ``export-torch`` of the card-trained HDCE, SC and QSC as the
   reference's ``.pth`` files, ``import-torch`` into a fresh workdir, and
   both sets of weights on the card: equal tensors, forwards equal bit for
   bit;
8c. nat_sweep: the noise-sweep ensemble at the shipped n=6, L=3, E=4 sigmas,
   batch 256 a cell: the member-axis circuit forward and adjoint (one launch
   each for the whole ensemble) against their plain versions and each
   member bit for bit against a one-member launch, also at n 2, 8, 12; the
   first 2 ensemble steps against a CPU twin (the same member weights,
   batches and noise); then two epochs of ``train_nat_sweep`` at the
   ``nat_sweep`` preset's impl ``auto`` (prewarm, then the table's train and
   infer winners; data_len 2560 a cell, cut from 20000 for time but kept
   wide enough that the validation split still fills a batch of 256, the
   shape the shipped config validates at) whose
   counters must show one forward
   launch per step and validation batch, one adjoint launch per step and no
   one-member launch, and, at the default ``probe_every`` (100) on the
   K-step path, the first chunk's losses alone fetched and logged;
8d. trajectories: the trajectory simulator at p=0 against the clean
   ``tensor`` circuit, the one-wire anchor <Z> -> (1 - 4p/3) <Z> within its
   Monte-Carlo band, and the peak memory (and, in phase 9, the device time)
   of n=6, L=3, B=2304, 32 trajectories;
8e. scan: K steps as one CUDA graph (``train/scan.py``; every trainer above
   already trained at the default ``train.scan_steps=1``, one step a
   graph): HDCE, SC, QSC n=6 ``auto`` under QuantumNAT, the DCE and the
   ensemble each run one epoch of 9 steps at ``scan_steps`` 0, 4 and 1 from
   the same init; every K holds the per-step path's step losses (rtol 1e-5)
   and parameters (the Adam bound), counts the same kernel launches, and
   captures at most two graphs; bitwise equality and the host wall per step
   of each path are printed;
8f. routing: ``serve.dispatch=auto`` at S=3 resolves dense and times
   nothing; the routing race at S=8 and S=64 (JAX's reduced geometry) with
   ``dispatch_agreement`` within 1e-5;
8g. lowp: synthesis of the full grid at ``data.trig_impl`` direct and
   split (seconds, and the grids against each other); HDCE and DCE at
   ``model.dtype=bfloat16`` and HDCE with bfloat16 Adam moments: 2 steps
   against a CPU twin in bfloat16 (rtol 2e-3, the bound the CPU tests hold
   the port to against JAX), one epoch at ``scan_steps`` 0 and 4 held to
   each other, the host ms a step of each, and mu bfloat16 / nu float32 on
   the card after a step;
8h. mps: the bond-chi MPS at full chi against B.2 at n 6 and 8 (values
   1e-5, gradients 1e-4); n=16, chi=16, B=64 forward and backward with its
   host synchronisations and time by ``torch.linalg.svd`` driver; a QSC at
   n=16, ``impl=auto`` (mps, the only candidate) one epoch on the card
   against a CPU twin, with its ``scan_dispatch`` record (declined: an SVD
   cannot be captured);
8i. scaling: the bench's ``qsc_scaling`` over n = 4..24, counters zeroed
   before and read after (the race launches B.1 and B.2), each point's
   winner, step time, samples/s and agreement (past 1e-4 fails);
8j. bench: ``python -m qdml_tpu_torch.bench`` in-process (48 steps a row,
   ``qsc_scaling`` at n 4 and 16), its one JSON line printed; every row
   must be measured;
8k. multirank: worlds of ranks that all compute on ``cuda:0`` and exchange
   over gloo staged through host memory (``QDML_TORCH_DIST_BACKEND=gloo``,
   ``--device=cuda:0``; NCCL refuses two ranks of one communicator on one
   card), started by ``parallel/selfcheck.spawn_world`` (ranks log to files
   under ``build/chip_smoke/multirank/``; a rank that exits non-zero or a
   world past 300 s, killed, fails the smoke): the sharded statevector at
   n=16, L=3, B=64 on 2 and 4 ranks against the one-rank ``tensor`` path
   on the card (rtol 1e-3 / atol 1e-4 for <Z> and the gradients; each
   shard on ``cuda:0``; L B.3 launches a forward on every rank; each rank's
   forward and forward+backward ms and the share in exchanges);
   ``train-qsc --preset=sharded_16q`` on 4 ranks (2 steps of 144 rows, cut
   for time and the one-rank reference's memory) against one rank, B.3
   launched L times a forward on every rank; ``dp_8q`` ``train-hdce`` and
   ``train-qsc`` on 2 ranks through ``torch.distributed.run`` (4 steps of
   2304 rows each, full width) against one rank, B.2's forward and adjoint
   launched on both ranks; ``federated`` ``train-hdce`` (4 steps), ``eval``
   (two SNR points of 400 samples) and rank 0's checkpoint restored on the
   mesh (each scenario's rows through its own rank's trunk) on 3 ranks,
   the losses, the per-SNR NMSE and that ``h`` against one rank's
   (rtol 1e-4). The kernel launches of the training worlds, summed over
   their ranks (each rank counts from 0 at each step), join the path's
   launches: B.3's are the sharded_16q world's;
8l. telemetry: the device half of ``qdml_tpu_torch.telemetry`` at full
   width on phase 7's training grid (``build/chip_smoke/telemetry/``).
   Probes: HDCE, QSC n=6 L=3 ``pallas_circuit`` and the ``nat_sweep``
   ensemble (E=4, per-member vectors) one epoch each at ``scan_steps`` 0 and
   4 with ``probe_every=1`` from the same init: every ``numerics`` value of
   K=4 equal to the per-step path's (rtol 1e-5; the ensemble's after step 1
   at 1e-3, its K-step path not being its per-step path bit for bit, as
   phase 8e shows; the quantum runs' update norm's square within n lr^2,
   as below); their first 2 steps'
   probes against a CPU twin (rtol 1e-4; the QSC update norm's square
   within n lr^2, the RZ weights of the last layer having a rounding-noise
   gradient); QSC at K=4 and ``probe_every=0``: ``host_transfers`` 0, the
   same graphs and B.2 launches as with probes. Cost: each run's ``cost``
   record (H100 row, ridge 20) printed, and the HDCE step's flops against 3
   x the bench's forward model (within 5%, else the ops that differ are
   printed). Step ms at the bench's 2304 rows: HDCE K=16 graph with probes
   and at ``probe_every=0``; the HDCE and QSC ``pallas_circuit`` per-step
   paths with the probe (a cadence step), without it (every other step, and
   ``probe_every=0``), and under the sanitizer without it (its fetch a step);
   the achieved roofline of those steps; the card's memory snapshot.
   Watchdog: QSC under QuantumNAT ``noise_level=inf`` raises
   ``DivergenceError``, its bundle's ``last_good`` restores finite on the
   card; ``cli train-qsc`` with those flags (300 samples a cell: one step)
   prints ``DIVERGED:`` and exits 4. The native loader: ``save_npy_cache``
   of this grid from the card, ``NpyGridLoader`` through the C++ library
   (built with g++ under ``build/``, required) for one epoch against
   ``DMLGridLoader`` (rtol 1e-5, atol 1e-6, JAX's tolerance), one HDCE step
   fed from each (losses rtol 1e-5, parameters within the Adam bound), and
   its host ms a step beside the K=16 HDCE step's. Sanitizer (JAX's rule: an
   op's output NaN trips whatever its inputs held): HDCE and QSC 2 steps checked
   and unchecked equal bit for bit (under deterministic cuDNN and
   scatter-add, whose default kernels sum with atomics); ``scan_dispatch``
   declines; Inf pilots
   trip naming an aten op, the ``inf`` noise naming ``circuit_expvals``, a
   label of 7 as an out-of-bounds index, and a clean step runs after it;
   one NaN in an HDCE batch trips the flight recorder at the convolution.
   ``serve.checkify``: a full-width engine (QSC n=6 L=3 ``pallas_circuit``,
   buckets 1/8/64; its warmup's ``cost`` records counted into an active
   sink, the unchecked engine's, without one, not counted) equal to the
   unchecked one and within 1e-4 max|h| + 1e-5
   of the CPU twin, B.2 launched, no request-path work; a poisoned batch
   raises, so does a request with one NaN pilot (bucket 8 and the
   classifier's front-end kernel ``qsc_front_fwd`` named), the next
   serves; the ragged tier with NaN/Inf pads at fills 3
   and 37 passes; a 2x2 pool fails only the poisoned future. World: ``dp_8q
   train-qsc`` on 2 ranks (as phase 8k; 600 samples a cell: 2 steps, cut for
   time), rank 0's numerics against one rank's (rtol 1e-5). Report: the
   phase's QSC stream and phase 8j's bench line each against themselves
   exit 0, the bench line against a copy with doubled throughput exits 3;
9. times: each kernel and its plain version at its path's shapes (CUDA
   events), the member-axis forward and adjoint beside E one-member
   launches of the same work, each kernel's device time per launch (torch profiler) over batch
   sizes (the adjoint at n 8 and 12, L=3, B 64 and 2304; the forward at n 8
   and 12, L=3, B 1 and 64, and 2304 with the state; the QSC kernel at the
   batches its launches run at; the rotation layer at its main-path shape
   (n=14, B=144) and at n 8 and 14, B 1 and
   2304, and at n 20, B 64; the unitary kernel at n 6, B 2304, n 10, B 1 and
   2304, and n 14, B 1, and the complex64 ``torch.matmul`` alone beside
   it, both always as CUDA graph replays between events; the BatchNorm +
   ReLU pair at a trunk site, 768 x 32 x 16 x 8, against the plain path,
   with the cuDNN chain it replaced beside it, by graph replays), each with its
   bound, the card's launch floor (the device time of a one-element
   in-place ``add_``, a yardstick on no path), the
   adjoint's resident blocks per SM (occupancy query), each bucket's
   ``infer`` latency and each trainer's step time with its
   forward/backward/update split (host clock), and each phase's wall time;
10. profile: ``python -m qdml_tpu_torch.cli profile`` at the default config
   (12 traced HDCE steps of 2304 rows): samples/sec, step percentiles and
   the device-busy share of the traced window, after every other timing;
   then the device-busy share of the HDCE and QSC ``auto`` steps on the
   per-step path and as K=16 graph replays.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX, and
writes only under ``build/``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np

SEED = 2026
BUCKETS = (1, 8, 64)
REQUEST_SIZES = (1, 5, 64, 100)
SERVE_BATCH = 64
# training: samples per (scenario, user) cell, cut from the reference's
# 20000 for time only; 256 rows per cell and step, as the reference
TRAIN_DATA_LEN = 2048
TRAIN_BATCH = 256
TWIN_STEPS = 2
DEVICE = "cuda"
# eval: the trainers' checkpoints and the sweep's results, under build/
EVAL_WORK = Path(__file__).resolve().parent / "build" / "chip_smoke"
# test samples per SNR point, cut from the reference's 10000 for time only
EVAL_TEST_LEN = 2000
# the trainers whose checkpoints the eval phase restores
EVAL_TRAINERS = ("hdce", "sc", "qsc_n6_pallas")
# the impl race's table, under build/ (results_torch/ is the port's default,
# results/ the JAX package's)
TUNE_DIR = EVAL_WORK / "autotune"
# (n, L, batch) of the race: the serving bucket at n=6 and n=8, and the
# training step's 2304 rows (bucket 4096) at n=6
RACE_SHAPES = ((6, 3, 64), (6, 3, 2304), (8, 3, 64))
# the serving tier: loadgen requests, arrival processes (rps), deadline (ms)
TIER_REQUESTS = 4096
TIER_ARRIVALS = (("poisson", 2000.0), ("bursty", 8000.0))
TIER_DEADLINE_MS = 16.0
# below saturation: both pools complete about 1720 rps at the 2000 rps point
TIER_BELOW_RPS = 1000.0
TIER_BELOW_REQUESTS = 2048
# the planner's window (the one-worker pool, traced, without the profiler:
# about a third of its 1720 rps) and the capacity question put to the
# planner over it: the tier's poisson rate at its deadline
TIER_PLAN_WINDOW_RPS, TIER_PLAN_WINDOW_REQUESTS = 500.0, 1024
TIER_PLAN_RPS = 2000.0
# the fault phase offers waves of 16 until the fault fired (at least 512
# requests, at most this many)
FAULT_MAX_REQUESTS = 8192
TIER_WORK = EVAL_WORK / "serve_tier"
# the rotation-layer kernel's timed shape, and the unitary kernel's (the microbench's)
UNI_N, WIDE_BATCH = 6, 2304
# B.3's main-path shape: a shard's local wires in the sharded_16q world (4
# ranks, 2^14 amplitudes a shard) over the 144 rows of a training step
ROT_N, ROT_BATCH = 14, 144
# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and fp32 non-tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def qsc_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (angles in, U re/im in, <Z> out, each once) and flops of one QSC call."""
    dim = 1 << n
    bytes_moved = 4 * (batch * n + 2 * dim * dim + batch * n)
    flops = batch * dim * n + 4 * batch * dim * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def adjoint_work(batch: int, n: int, layers: int) -> tuple[float, float]:
    """Bytes (final state, cotangent, angles and gate table in; dangles and
    dweights out, each once) and flops of one adjoint call: the cotangent's
    start (n + 3 per amplitude), 64 flops per amplitude pair per wire per
    layer (two gradient terms and two rotations undone on psi and lambda),
    and the embedding cotangent as the function needs it, the backward pass
    of the product-state build (``qdml_tpu/quantum/statevector.py:161``):
    about 2 per amplitude to rebuild it and 8 for its backward. The kernel
    itself spends n + 2 per amplitude per wire there, which is not counted."""
    dim = 1 << n
    bytes_moved = 4 * (2 * batch * dim + 2 * batch * n + layers * n * 4 + batch * n + layers * n * 2)
    flops = batch * (dim * (n + 3) + 32 * layers * n * dim + 10 * dim)
    return bytes_moved, flops


def circuit_work(batch: int, n: int, layers: int, with_state: bool = False) -> tuple[float, float]:
    """Bytes (angles and gate table in, <Z> out, and the final state's re and
    im out when it is written) and flops of one circuit call: embedding, 24
    flops per amplitude pair per wire per layer (RY then RZ), and the <Z>
    contraction."""
    dim = 1 << n
    bytes_moved = 4 * (batch * n + layers * n * 4 + batch * n + (2 * batch * dim if with_state else 0))
    flops = batch * dim * n + 12 * batch * layers * n * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def rotation_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (the state's re and im in and out, the gate table in, each once)
    and flops of one rotation layer: about 12 per amplitude per wire (RY's
    two real 2x2 products, 6 flops a component pair, and RZ's complex phase,
    6 more)."""
    dim = 1 << n
    bytes_moved = 4 * (4 * batch * dim + 4 * n)
    flops = 12 * batch * dim * n
    return bytes_moved, flops


def unitary_work(batch: int, n: int) -> tuple[float, float]:
    """Bytes (psi re and im and U re and im in, <Z> out, each once) and flops
    of one unitary call, counted as the least the function needs: three real
    B x 2^n x 2^n products (Gauss's trick, as the TPU kernel does it), |c|^2
    (3 per amplitude) and the sign contraction (2n per amplitude)."""
    dim = 1 << n
    bytes_moved = 4 * (2 * batch * dim + 2 * dim * dim + batch * n)
    flops = 3 * 2 * batch * dim * dim + 3 * batch * dim + 2 * batch * dim * n
    return bytes_moved, flops


def event_ms(torch, fn, reps: int = 25, inner: int = 20) -> float:
    """Median over ``reps`` of the per-call device time of ``inner`` back-to-back
    calls, bracketed by CUDA events, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 20) -> tuple[float, float]:
    """Median and minimum host-clock milliseconds of ``fn`` over ``reps``
    calls, each ended by a device synchronisation, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    lat = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return statistics.median(lat), min(lat)


# idle host time at each end of a profiler window: late in a long process the
# trace drops the device events of whole sessions, and this halves the share
# dropped (qdml_tpu_torch/scripts/profiler_drops.py)
PROFILE_PAD_S = 0.005


def profiled_device_us(
    torch, fn, kernel: str | None, calls: int = 20, pad_s: float = PROFILE_PAD_S
) -> float | None:
    """Device time per call of ``fn`` spent in the kernels whose name holds
    ``kernel`` (every device kernel when None), over ``calls`` calls, read
    from the torch profiler's CUDA trace; None when the trace holds no device
    time for them. A call may launch several (the unitary kernel's second
    pass sums its column tiles). The window opens ``pad_s`` seconds before
    the first call and closes ``pad_s`` after the card has finished. Early
    in a long process every duration can read low by one common factor
    (down to 0.55 of a fresh process's); later readings are right or None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    total = 0.0
    for evt in prof.events():
        if "CUDA" in str(getattr(evt, "device_type", "")) and (kernel is None or kernel in evt.name):
            total += evt.time_range.elapsed_us()
    return total / calls if total > 0 else None


def graph_device_us(torch, K, fn, calls: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn`` without the host's launch time:
    ``calls`` calls captured into one CUDA graph (the wrappers' launches go
    to ``K.counting_capture``'s tally, not to the path's counters), replayed
    ``replays`` times between CUDA events after a warm-up replay; the median
    replay over ``calls``. Inside the graph the calls run back to back, so a
    call's time includes the gap between two kernels of the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with K.counting_capture(), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    del graph
    return statistics.median(times)


def device_sweep(torch, K, circuits, card: str, floor_us) -> None:
    """Each kernel's device time per launch (profiler) over batch sizes, at
    the serving qubit counts and the circuit kernel's largest: shows whether
    a kernel's time follows its work or is fixed per block. The QSC kernel
    runs at B 64 (serving), 200 (eval) and 2304 (microbench, training); the
    adjoint at 2304 (training) and 64. Each line carries the bound and the
    card's launch floor."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 3)
    for n, batches in ((6, (1, 64, 200, 2304)), (8, (64, 2304))):
        w = torch.tensor(rng.uniform(0, 2 * np.pi, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3)
        ur, ui = u.re.contiguous(), u.im.contiguous()
        for b in batches:
            a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
            us = profiled_device_us(torch, lambda: K.fused_qsc_expvals(a, ur, ui, n), "qsc_expvals_kernel")
            bnd, by = bound(*qsc_work(b, n))
            log(f"device sweep qsc_expvals n={n} B={b}: {us} us per launch, bound {1e3 * bnd:.5f} us "
                f"({by}), launch floor {floor_us} us [{card}]")
    for n in (8, 12):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        for b in (64, 2304):
            a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
            g = torch.tensor(rng.standard_normal((b, n)), dtype=torch.float32, device=dev)
            _, fre, fim = K.fused_circuit_expvals(a, w, n, 3, return_state=True)
            us = profiled_device_us(
                torch, lambda: K.circuit_adjoint(fre, fim, g, a, w, n, 3), "circuit_adjoint_"
            )
            bnd, by = bound(*adjoint_work(b, n, 3))
            log(f"device sweep circuit_adjoint n={n} L=3 B={b}: {us} us per launch, bound "
                f"{1e3 * bnd:.5f} us ({by}), launch floor {floor_us} us [{card}]")
    # the forward at the serving batches (no state) and at the training
    # launch's B=2304 with the state written for the adjoint
    for n in (8, 12):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        for b, state in ((1, False), (64, False), (2304, True)):
            a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
            us = profiled_device_us(
                torch, lambda: K.fused_circuit_expvals(a, w, n, 3, return_state=state), "circuit_expvals_kernel"
            )
            bnd, by = bound(*circuit_work(b, n, 3, with_state=state))
            log(f"device sweep circuit_expvals n={n} L=3 B={b}{' with the state' if state else ''}: {us} us "
                f"per launch, bound {1e3 * bnd:.5f} us ({by}), launch floor {floor_us} us [{card}]")
    from qdml_tpu_torch.utils.complexops import CArr

    # the rotation layer: every pass of a call summed (one launch a pass)
    for n, batches in ((8, (1, 2304)), (14, (1, 2304)), (20, (64,))):
        w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
        for b in batches:
            psi = CArr(torch.randn(b, 1 << n, device=dev), torch.randn(b, 1 << n, device=dev))
            us = profiled_device_us(torch, lambda: K.apply_rotation_layer(psi, w, n), "rotation_layer_kernel")
            bnd, by = bound(*rotation_work(b, n))
            tile_bits, reg_bits, passes = K.rotation_layer_plan(b, n)
            log(f"device sweep rotation_layer n={n} B={b}: {us} us per call ({passes} pass(es) of 2^{tile_bits} "
                f"tiles, 2^{reg_bits} amplitudes a thread), bound {1e3 * bnd:.5f} us ({by}), launch floor "
                f"{floor_us} us [{card}]")
            del psi
    # the unitary kernel (both of its passes) beside the complex product alone,
    # torch.matmul on complex64, which the port never calls
    for n, batches in ((6, (2304,)), (10, (1, 2304)), (14, (1,))):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3 if n <= 12 else 1)  # one layer at n = 14: U is 2 GB
        u = CArr(u.re.contiguous(), u.im.contiguous())
        ut_c = torch.complex(u.re, u.im).T.contiguous()
        for b in batches:
            psi = CArr(torch.randn(b, 1 << n, device=dev), torch.randn(b, 1 << n, device=dev))
            psi_c = torch.complex(psi.re, psi.im)
            us = graph_device_us(torch, K, lambda: K.fused_unitary_expvals(psi, u, n))
            mm_us = graph_device_us(torch, K, lambda: torch.matmul(psi_c, ut_c))
            bnd, by = bound(*unitary_work(b, n))
            log(f"device sweep unitary_expvals n={n} B={b}: {us} us per launch, complex64 torch.matmul alone "
                f"{mm_us} us (both by CUDA graph replays), bound {1e3 * bnd:.5f} us ({by}), launch floor "
                f"{floor_us} us [{card}]")


def check_kernels(torch, K, circuits, unitary_ready=lambda: None) -> dict[str, float]:
    """Each kernel against its plain version on the card; returns the largest
    absolute error seen per kernel. Raises on any mismatch. ``unitary_ready``
    returns once the unitary kernel is built: its checks come last."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    worst = {name: 0.0 for name in K.KERNELS}

    def close(name, got, want, rtol, atol, what):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        worst[name] = max(worst[name], err)
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise AssertionError(f"{name} {what}: max abs err {err:.3e} (rtol {rtol}, atol {atol})")
        return err

    # QSC: rtol 1e-4 / atol 1e-5, as tests/test_pallas.py:33 holds the TPU
    # kernel; every n of its window, at the batches its launches run at
    for n in range(1, 9):
        w = torch.tensor(rng.uniform(0, 2 * np.pi, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3) if n >= 2 else circuits.rot_gate(w[0, 0, 0], w[0, 0, 1])  # lint: disable=gate-matrix-in-loop(the loop is the check's sweep over n, not a circuit's layers: rot_gate is the whole one-qubit ansatz at the n=1 point)
        ur, ui = u.re.contiguous(), u.im.contiguous()
        for b in (1, 37, 64, 200, 2304, 4096):
            a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
            got = K.fused_qsc_expvals(a, ur, ui, n)
            want = K.qsc_expvals_plain(a, ur, ui, n)
            close("qsc_expvals", got, want, 1e-4, 1e-5, f"n={n} B={b}")
        # gradients through the kernel's autograd.Function vs the plain version
        a = torch.tensor(rng.uniform(-1, 1, (37, n)), dtype=torch.float32, device=dev)
        g = torch.tensor(rng.standard_normal((37, n)), dtype=torch.float32, device=dev)
        grads = []
        for fn in (K.fused_qsc_expvals, K.qsc_expvals_plain):
            xs = [t.clone().requires_grad_(True) for t in (a, ur, ui)]
            (fn(*xs, n) * g).sum().backward()
            grads.append([t.grad for t in xs])
        for k, (gk, gp) in enumerate(zip(*grads)):
            close("qsc_expvals", gk, gp, 1e-4, 1e-5, f"n={n} grad of input {k}")
        log(f"check qsc_expvals n={n}: ok")

    # circuit: atol 2e-5 — fp32 rounding over 2nL gate updates taken in
    # another order (and with fused multiply-adds) than the plain version's;
    # every n (one kernel instantiation each), at the serving batches and the
    # training launch's 2304
    for n in range(2, 13):
        for layers in (1, 3):
            w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32, device=dev)
            for b in (1, 37, 64, 2304, 4096):
                b = min(b, max(1, (1 << 21) >> n))  # cap B * 2^n at 2^21 amplitudes
                a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
                ev, fre, fim = K.fused_circuit_expvals(a, w, n, layers, return_state=True)
                pev, pre, pim = K.circuit_expvals_plain(a, w, n, layers)
                for got, want, what in ((ev, pev, "<Z>"), (fre, pre, "re"), (fim, pim, "im")):
                    close("circuit_expvals", got, want, 0.0, 2e-5, f"n={n} L={layers} B={b} {what}")
                ev_only = K.fused_circuit_expvals(a, w, n, layers)
                close("circuit_expvals", ev_only, pev, 0.0, 2e-5, f"n={n} L={layers} B={b} no-state")
        log(f"check circuit_expvals n={n}: ok")

    # adjoint: atol 2e-5 of the largest cotangent plus 1e-6 — fp32 rounding
    # over 2nL rotations undone and a batch sum taken in another order; every
    # n (one kernel instantiation each), and dweights bitwise equal on a
    # second launch (no atomics)
    for n in range(2, 13):
        ratio = 0.0
        for layers in (1, 3, 5):
            w = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32, device=dev)
            for b in (1, 64, 2304):
                a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
                g = torch.tensor(rng.standard_normal((b, n)), dtype=torch.float32, device=dev)
                _, fre, fim = K.fused_circuit_expvals(a, w, n, layers, return_state=True)
                got = K.circuit_adjoint(fre, fim, g, a, w, n, layers)
                again = K.circuit_adjoint(fre, fim, g, a, w, n, layers)
                torch.cuda.synchronize()
                if not torch.equal(again[1], got[1]):
                    raise AssertionError(f"circuit_adjoint n={n} L={layers} B={b}: dweights differ run to run")
                want = K.circuit_adjoint_plain(fre, fim, g, a, w, n, layers)
                refs = [want]
                if b <= 64:  # autograd keeps every gate's state: small batches only
                    xs = [t.clone().requires_grad_(True) for t in (a, w)]
                    (K.circuit_expvals_plain(*xs, n, layers)[0] * g).sum().backward()
                    refs.append([t.grad for t in xs])
                for ref in refs:
                    for x, y, what in zip(got, ref, ("dangles", "dweights")):
                        tol = 2e-5 * y.abs().max().item() + 1e-6
                        err = close("circuit_adjoint", x, y, 0.0, tol, f"n={n} L={layers} B={b} {what}")
                        ratio = max(ratio, err / tol)
        log(f"check circuit_adjoint n={n}: ok, largest error {100 * ratio:.1f}% of its tolerance "
            f"(2e-5 * max|ref| + 1e-6; against the plain adjoint and autograd of the plain forward)")

    from qdml_tpu_torch.quantum import statevector as sv
    from qdml_tpu_torch.utils.complexops import CArr

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev)

    def embedded(b, n):
        a = torch.tensor(rng.uniform(-1, 1, (b, n)), dtype=torch.float32, device=dev)
        return circuits.angle_embed(sv.zero_state(n, (b,), device=dev), a, n)

    # rotation layer: atol 2e-6 of the largest amplitude through n = 14, fp32
    # rounding of 2n gate updates (fused multiply-adds in the kernel, rounded
    # products in the plain version); from n = 15 8n unit roundoffs (2^-24)
    # of it, the same rounding's bound: 2n rotations, each rounding a
    # two-term sum twice, in two implementations. On unnormalised random
    # states and embedded ones, at batches that reach every tile plan (2^10,
    # 2^12, 2^14) and pass count (one pass to n = 12, two from n = 13 at
    # small B and from n = 15)
    rot_batches = {13: (1, 11, 64, 264, 2304), 14: (1, 11, 64, 132, 2304), 15: (1, 2, 64), 16: (1, 2, 64),
                   20: (1, 2, 64)}
    for n in (1, 3, 6, 7, 8, 12, 13, 14, 15, 16, 20):
        w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
        for b in rot_batches.get(n, (1, 11, 64, 2304)):
            for kind, psi in (("random", CArr(randn(b, 1 << n), randn(b, 1 << n))), ("embedded", embedded(b, n))):
                before = K.launches["rotation_layer"]
                got = K.apply_rotation_layer(psi, w, n)
                if K.launches["rotation_layer"] != before + 1:
                    raise AssertionError(f"rotation_layer n={n} B={b}: not one kernel call")
                want = K.rotation_layer_plain(psi.re, psi.im, w, n)
                amax = max(want.re.abs().max().item(), want.im.abs().max().item())
                tol = (2e-6 if n <= 14 else 8 * n * 2.0**-24) * amax
                for x, y, what in ((got.re, want.re, "re"), (got.im, want.im, "im")):
                    close("rotation_layer", x, y, 0.0, tol, f"n={n} B={b} {kind} {what}")
                del psi, got, want
        tile_bits, reg_bits, passes = K.rotation_layer_plan(b, n)
        log(f"check rotation_layer n={n}: ok (at B={b}: {passes} pass(es) of 2^{tile_bits} tiles, "
            f"2^{reg_bits} amplitudes a thread)")

    unitary_ready()
    # unitary: atol 5e-6 on unit-norm states, fp32 sums over 2^n terms (each
    # a 2^n-term product) taken in another order than the plain matmuls';
    # every n, at batches that reach each tile plan of the launcher, and the
    # same bits on a second launch (no atomics)
    # n = 13, 14 at one layer (U is 0.5 and 2 GB; the three-layer product
    # alone would take 17 TFLOP at n = 14) and at batches that reach the
    # three plans those n select
    for n in range(1, 15):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        layers = 3 if n <= 12 else 1
        u = circuits.ansatz_unitary(w, n, layers) if n >= 2 else circuits.rot_gate(w[0, 0, 0], w[0, 0, 1])  # lint: disable=gate-matrix-in-loop(the loop is the check's sweep over n, not a circuit's layers: rot_gate is the whole one-qubit ansatz at the n=1 point)
        for b in (1, 3, 9, 33, 64, 600, 2304) if n <= 12 else (1, 9, 64, 1024) if n == 13 else (1, 9, 64):
            re, im = randn(b, 1 << n), randn(b, 1 << n)
            norm = torch.sqrt((re * re + im * im).sum(-1, keepdim=True))
            for kind, psi in (("random", CArr(re / norm, im / norm)), ("embedded", embedded(b, n))):
                got = K.fused_unitary_expvals(psi, u, n)
                again = K.fused_unitary_expvals(psi, u, n)
                want = K.unitary_expvals_plain(psi.re, psi.im, u.re, u.im, n)
                close("unitary_expvals", got, want, 0.0, 5e-6, f"n={n} B={b} {kind}")
                if not torch.equal(got, again):
                    raise AssertionError(f"unitary_expvals n={n} B={b} {kind}: outputs differ run to run")
        log(f"check unitary_expvals n={n}: ok")

    # both backwards are autograd through the plain versions: the same values
    for n in (3, 8):
        psi = CArr(randn(37, 1 << n), randn(37, 1 << n))
        w = torch.tensor(rng.uniform(-3, 3, (n, 2)), dtype=torch.float32, device=dev)
        g_re, g_im = randn(37, 1 << n), randn(37, 1 << n)
        grads = []
        for fn in (lambda p, w_: K.apply_rotation_layer(p, w_, n),
                   lambda p, w_: K.rotation_layer_plain(p.re, p.im, w_, n)):
            xs = [t.clone().requires_grad_(True) for t in (psi.re, psi.im, w)]
            out = fn(CArr(xs[0], xs[1]), xs[2])
            (out.re * g_re + out.im * g_im).sum().backward()
            grads.append([t.grad for t in xs])
        for k, (gk, gp) in enumerate(zip(*grads)):
            close("rotation_layer", gk, gp, 1e-5, 1e-6, f"n={n} grad of input {k}")
    for n in (2, 6):
        w = torch.tensor(rng.uniform(-3, 3, (3, n, 2)), dtype=torch.float32, device=dev)
        u = circuits.ansatz_unitary(w, n, 3)
        ins = (randn(37, 1 << n), randn(37, 1 << n), u.re.contiguous(), u.im.contiguous())
        g = randn(37, n)
        grads = []
        for fn in (lambda a, b, c, d: K.fused_unitary_expvals(CArr(a, b), CArr(c, d), n),
                   lambda a, b, c, d: K.unitary_expvals_plain(a, b, c, d, n)):
            xs = [t.clone().requires_grad_(True) for t in ins]
            (fn(*xs) * g).sum().backward()
            grads.append([t.grad for t in xs])
        for k, (gk, gp) in enumerate(zip(*grads)):
            close("unitary_expvals", gk, gp, 1e-5, 1e-6, f"n={n} grad of input {k}")
    log("check rotation_layer and unitary_expvals gradients: ok")

    # outside their windows both wrappers raise before any launch (the
    # rotation layer past n = 32 through its launch path: the state would
    # not fit; a unitary of n = 15 is checked with a stand-in U of 1 x 1,
    # since the window is checked first)
    before = dict(K.launches)
    refusals = (
        ("rotation_layer n=0", lambda: K.apply_rotation_layer(
            CArr(torch.zeros(1, 1, device=dev), torch.zeros(1, 1, device=dev)), torch.zeros(1, 2, device=dev), 0)),
        ("rotation_layer n=33", lambda: K._rotation_launch(
            torch.zeros(1, 1, device=dev), torch.zeros(1, 1, device=dev), torch.zeros(33, 2, device=dev), 33)),
    ) + tuple(
        (f"unitary_expvals n={n}", lambda n=n: K.fused_unitary_expvals(
            CArr(torch.zeros(1, 1 << n, device=dev), torch.zeros(1, 1 << n, device=dev)),
            CArr(torch.zeros(1, 1, device=dev), torch.zeros(1, 1, device=dev)), n))
        for n in (0, 15)
    )
    for what, call in refusals:
        try:
            call()
        except ValueError:
            pass
        else:
            raise AssertionError(f"{what} was accepted")
    if K.launches != before:
        raise AssertionError("an out-of-window call launched a kernel")
    log("check out-of-window n raises (rotation_layer n=0, 33; unitary_expvals n=0, 15): ok")
    return worst


def autotune_phase(torch, K, cfg_mod, card: str) -> dict[str, int]:
    """The circuit-impl race on the card at :data:`RACE_SHAPES`, forced, into
    the table under :data:`TUNE_DIR`, with the counters zeroed just before and
    read just after. Fails on a candidate error, on a kernel of the race not
    launched, and on a second ``prewarm`` that measures. Returns the race's
    launches."""
    from dataclasses import replace

    from qdml_tpu_torch.quantum import autotune
    from qdml_tpu_torch.utils.tune_table import activity

    K.reset_launch_counts()
    entries = {}
    for n, layers, batch in RACE_SHAPES:
        entry = autotune.ensure(n, layers, batch, force=True, device=DEVICE)
        entries[(n, layers, batch)] = entry
        for impl, rec in entry["candidates"].items():
            if "error" in rec:
                raise AssertionError(f"autotune n={n} L={layers} B={batch}: candidate {impl} failed: {rec['error']}")
            log(f"autotune n={n} L={layers} bucket {entry['batch_bucket']} {impl}: fwd_ms {rec['fwd_ms']}, "
                f"train_ms {rec['train_ms']} (median of reps, host clock, synchronized) [{card}]")
        log(f"autotune n={n} L={layers} bucket {entry['batch_bucket']}: winners train {entry['best_train']}, "
            f"infer {entry['best_fwd']} [{card}]")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    log(f"autotune race launches: {json.dumps(counts)}; table {autotune.table_path()}")
    for k in ("qsc_expvals", "circuit_expvals", "circuit_adjoint"):
        if counts[k] == 0:
            raise AssertionError(f"the impl race never launched kernel {k}")
    # a warm table: prewarm reads, and measures and writes nothing
    base = cfg_mod.ExperimentConfig()
    before = dict(activity)
    for (n, layers, batch), entry in entries.items():
        cfg = replace(base, quantum=replace(base.quantum, n_qubits=n, n_layers=layers))
        again = autotune.prewarm(cfg, batch=batch, device=DEVICE)
        if again is None or again["ts"] != entry["ts"]:
            raise AssertionError(f"prewarm n={n} B={batch} did not return the race's entry")
    if activity != before:
        raise AssertionError(f"a second prewarm measured or wrote: {before} -> {dict(activity)}")
    log("autotune: a second prewarm of every shape read the table without measuring: ok")
    return counts


def serve(torch, K, cfg_mod, engine_mod, hdce_mod, qsc_mod):
    """Build the four engines on the card and on the CPU, drive the card's
    through the request sizes with the launch counters zeroed, and hold every
    answer against the CPU twin. Returns per-kernel launches, the engines and
    the requests."""
    from dataclasses import replace

    base = cfg_mod.ExperimentConfig()
    variants = {
        "qsc_n6_pallas": (replace(base, quantum=replace(base.quantum, n_qubits=6, n_layers=3, impl="pallas")), True),
        "qsc_n8_pallas_circuit": (replace(base, quantum=replace(base.quantum, n_qubits=8, n_layers=3, impl="pallas_circuit")), True),
        # impl auto: each bucket's impl from the race's table (tuned at warmup
        # where the table has no entry); its CPU twin runs the heuristic's
        "qsc_n6_auto": (replace(base, quantum=replace(base.quantum, n_qubits=6, n_layers=3)), True),
        "sc_classical": (base, False),
    }
    gen = torch.Generator().manual_seed(SEED)
    hdce_sd = hdce_mod.build_hdce(base, device="cpu", generator=gen).state_dict()
    engines = {}
    for name, (cfg, quantum) in variants.items():
        clf_sd = qsc_mod.build_classifier(cfg, quantum, device="cpu", generator=gen).state_dict()
        gpu = engine_mod.ServeEngine(cfg, hdce_sd, clf_sd, quantum=quantum, buckets=BUCKETS)
        cpu = engine_mod.ServeEngine(cfg, hdce_sd, clf_sd, quantum=quantum, buckets=BUCKETS, device="cpu")
        warm = gpu.warmup()
        cpu.warmup()
        log(f"engine {name}: warm {json.dumps(warm)}")
        if gpu.quantum_impl:
            log(f"engine {name}: per-bucket circuit impl "
                f"{json.dumps({b: r['impl'] for b, r in gpu.quantum_impl.items()})}")
        engines[name] = (gpu, cpu)

    rng = np.random.default_rng(SEED + 1)
    hw = base.image_hw
    requests = {n: rng.standard_normal((n, *hw, 2)).astype(np.float32) for n in REQUEST_SIZES}

    # the main path: counters zeroed just before, read just after; the work
    # counters (measurements, table writes, kernel builds) must not move
    work0 = {name: gpu.request_path_work() for name, (gpu, _) in engines.items()}
    K.reset_launch_counts()
    answers = {}
    per_engine = {}
    for name, (gpu, _) in engines.items():
        before = dict(K.launches)
        answers[name] = {n: gpu.infer(x) for n, x in requests.items()}
        torch.cuda.synchronize()
        per_engine[name] = {k: K.launches[k] - before[k] for k in K.launches}
    launches = dict(K.launches)
    log(f"main-path launches per engine: {json.dumps(per_engine)}")
    if per_engine["qsc_n6_pallas"]["qsc_expvals"] == 0:
        raise AssertionError("the n=6 pallas engine never launched the QSC kernel")
    if per_engine["qsc_n8_pallas_circuit"]["circuit_expvals"] == 0:
        raise AssertionError("the n=8 pallas_circuit engine never launched the circuit kernel")
    for k in ("qsc_expvals", "circuit_expvals"):  # the serving path's kernels
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the serving path")

    for name, (gpu, cpu) in engines.items():
        for n, x in requests.items():
            h, pred, conf, info = answers[name][n]
            h_ref, pred_ref, conf_ref, _ = cpu.infer(x)
            if h.shape != (n, base.h_out_dim) or pred.shape != (n,) or conf.shape != (n,):
                raise AssertionError(f"{name} n={n}: shapes {h.shape} {pred.shape} {conf.shape}")
            if not (np.isfinite(h).all() and np.isfinite(conf).all()):
                raise AssertionError(f"{name} n={n}: non-finite output")
            with torch.inference_mode():
                logp = cpu.clf(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
            top2 = np.sort(logp, axis=-1)[:, -2:]
            sure = (top2[:, 1] - top2[:, 0]) > 1e-4
            if not np.array_equal(pred[sure], pred_ref[sure]):
                raise AssertionError(f"{name} n={n}: routed scenario differs from the CPU engine")
            same = pred == pred_ref
            tol = 1e-4 * np.abs(h_ref).max() + 1e-5
            err = np.abs(h[same] - h_ref[same]).max() if same.any() else 0.0
            if err > tol:
                raise AssertionError(f"{name} n={n}: |h - h_cpu| {err:.3e} > {tol:.3e}")
            cerr = np.abs(conf - conf_ref).max()
            if cerr > 1e-4:
                raise AssertionError(f"{name} n={n}: |conf - conf_cpu| {cerr:.3e}")
            log(
                f"serve {name} n={n}: bucket {info.bucket} chunks {info.chunks} "
                f"rows {info.rows}, max|h-h_cpu| {err:.3e} (tol {tol:.3e}), "
                f"routed rows agreeing {int(same.sum())}/{n}, sure {int(sure.sum())}"
            )
        if gpu.request_path_work() != work0[name]:
            raise AssertionError(f"{name}: the request path measured, wrote a table or built a kernel: "
                                 f"{work0[name]} -> {gpu.request_path_work()}")
    log("serve: no engine measured, wrote a table or built a kernel on its request path")
    return launches, engines, requests


def serve_close(a, b, what: str) -> float:
    """The serving tolerance: ``h`` within 1e-4 max|h| + 1e-5."""
    tol = 1e-4 * np.abs(b).max() + 1e-5
    err = float(np.abs(a - b).max()) if a.size else 0.0
    if err > tol:
        raise AssertionError(f"{what}: max |h - h_ref| {err:.3e} > {tol:.3e}")
    return err


def serve_dispatch(torch, K, cfg_mod, engine_mod, hdce_mod, qsc_mod, engines, card: str) -> dict[str, int]:
    """Sparse, ragged and hot-swapped engines on the card, counters zeroed
    just before and read just after, each held against its twin at the
    serving tolerance. Returns the launches."""
    from dataclasses import replace

    from qdml_tpu_torch.ops.routing import expert_capacity

    base = cfg_mod.ExperimentConfig()
    # the classical engine's weights: its bucket engine is the ragged one's twin
    bucket_eng = engines["sc_classical"][0]
    hdce_sd = {k: v.cpu() for k, v in bucket_eng.hdce.state_dict().items()}
    sc_sd = {k: v.cpu() for k, v in bucket_eng.clf.state_dict().items()}
    hw = base.image_hw
    rng = np.random.default_rng(SEED + 11)
    K.reset_launch_counts()

    # sparse at S=3, forced: a balanced batch (no scenario past its capacity)
    # picked from a pool by the dense engine's routing, and a skewed one
    sparse_cfg = replace(base, serve=replace(base.serve, dispatch="sparse"))
    cap = expert_capacity(SERVE_BATCH, 3, base.serve.capacity_factor)
    for kind in ("balanced", "skewed"):
        clf_sd = dict(sc_sd)
        if kind == "skewed":  # every row to scenario 1
            clf_sd["FC.bias"] = torch.tensor([0.0, 50.0, 0.0])
        dense = engine_mod.ServeEngine(base, hdce_sd, clf_sd, buckets=BUCKETS)
        sparse = engine_mod.ServeEngine(sparse_cfg, hdce_sd, clf_sd, buckets=BUCKETS)
        dense.warmup()
        sparse.warmup()
        pool = rng.standard_normal((1024, *hw, 2)).astype(np.float32)
        _, pool_pred, _, _ = dense.infer(pool)
        if kind == "balanced":
            rows = np.concatenate([np.flatnonzero(pool_pred == s)[:22] for s in range(3)])[:SERVE_BATCH]
            if len(rows) < SERVE_BATCH or max(np.bincount(pool_pred[rows], minlength=3)) > cap:
                raise AssertionError(f"no balanced batch in the pool: {np.bincount(pool_pred, minlength=3)}")
            x = pool[rows]
        else:
            x = pool[:SERVE_BATCH]
        work0 = sparse.request_path_work()
        h, pred, conf, info = sparse.infer(x)
        hd, pd, cd, _ = dense.infer(x)
        if not np.array_equal(pred, pd):
            raise AssertionError(f"sparse {kind}: routing differs from the dense engine")
        err = serve_close(h, hd, f"sparse {kind}")
        summary = sparse.dispatch_summary()
        log(f"serve sparse S=3 {kind} batch of {SERVE_BATCH}: scenarios {np.bincount(pred, minlength=3).tolist()}, "
            f"capacity {cap} a scenario, overflow rows {summary['overflow_rows']}, max|h - h_dense| {err:.3e}, "
            f"|conf - conf_dense| {np.abs(conf - cd).max():.3e}")
        if (summary["overflow_rows"] > 0) != (kind == "skewed"):
            raise AssertionError(f"sparse {kind}: overflow rows {summary['overflow_rows']}")
        if sparse.request_path_work() != work0:
            raise AssertionError("the sparse engine's request path measured, wrote or built")

    # ragged, forced, at every fill with NaN in the pad rows
    ragged = engine_mod.ServeEngine(
        replace(base, serve=replace(base.serve, batching="ragged")), hdce_sd, sc_sd, buckets=BUCKETS
    )
    ragged.warmup()
    x = rng.standard_normal((SERVE_BATCH, *hw, 2)).astype(np.float32)
    worst = 0.0
    for n in range(1, SERVE_BATCH + 1):
        b = next(bb for bb in BUCKETS if bb >= n)
        xp = np.full((b, *hw, 2), np.nan, np.float32)
        xp[:n] = x[:n]
        h, pred, conf, _ = ragged.forward_tier(xp, n)
        if not (torch.isfinite(h).all() and torch.isfinite(conf).all()):
            raise AssertionError(f"ragged fill {n}: a NaN pad row reached the outputs")
        hb, pb, _, _ = bucket_eng.infer(x[:n])
        if not np.array_equal(pred[:n].cpu().numpy(), pb):
            raise AssertionError(f"ragged fill {n}: routing differs from the bucket engine")
        worst = max(worst, serve_close(h[:n].cpu().numpy(), hb, f"ragged fill {n}"))
    log(f"serve ragged: fills 1..{SERVE_BATCH} with NaN pad rows, all outputs finite, max|h - h_bucket| "
        f"{worst:.3e}; batching {json.dumps(ragged.batching_summary())}")

    # hot-swap of the auto engine to a second set of weights
    auto, _ = engines["qsc_n6_auto"]
    gen2 = torch.Generator().manual_seed(SEED + 7)
    new_h = hdce_mod.build_hdce(base, device="cpu", generator=gen2).state_dict()
    new_c = qsc_mod.build_classifier(auto.cfg, True, device="cpu", generator=gen2).state_dict()
    fresh = engine_mod.ServeEngine(auto.cfg, new_h, new_c, quantum=True, buckets=BUCKETS)
    fresh.warmup()
    rec = auto.swap_params(new_h, new_c)
    work0 = auto.request_path_work()
    if rec["epoch"] != 1 or any(rec["work"].values()):
        raise AssertionError(f"swap_params: {rec}")
    for n in REQUEST_SIZES:
        x = rng.standard_normal((n, *hw, 2)).astype(np.float32)
        h, pred, conf, _ = auto.infer(x)
        hf, pf, cf, _ = fresh.infer(x)
        if not np.array_equal(pred, pf) or np.abs(conf - cf).max() > 1e-4:
            raise AssertionError(f"swapped engine n={n}: routing or confidence differs from a fresh engine")
        err = serve_close(h, hf, f"swapped engine n={n}")
    bad = dict(new_h)
    bad["head.FC.bias"] = torch.zeros(7)
    try:
        auto.swap_params(bad, new_c)
    except ValueError:
        pass
    else:
        raise AssertionError("swap_params accepted a mismatched state dict")
    if auto.swap_epoch != 1 or auto.request_path_work() != work0:
        raise AssertionError("the swapped engine moved its epoch or did request-path work")
    log(f"serve swap_params: epoch {rec['epoch']}, against a fresh engine on the new weights max|h - h_fresh| "
        f"{err:.3e} at n={REQUEST_SIZES[-1]}; a mismatched state dict raised")
    torch.cuda.synchronize()
    counts = dict(K.launches)
    log(f"serve dispatch/ragged/swap launches: {json.dumps(counts)}")
    return counts


def _tier_workdir(torch, mods, cfg) -> str:
    """The serving tier's workdir: an HDCE and a QSC at n=6, L=3 from seeded
    weights, written by the port's ``save_checkpoint`` as ``*_best`` and, a
    second set, as ``*_v2`` (the swap's target)."""
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.checkpoint import save_checkpoint
    from qdml_tpu_torch.train.torch_interop import qsc_meta_from_state

    wd = mods["cli"].workdir_of(cfg)
    for tag, seed in (("best", SEED + 31), ("v2", SEED + 32)):
        gen = torch.Generator().manual_seed(seed)
        hdce_sd = mods["hdce"].build_hdce(cfg, "cpu", generator=gen).state_dict()
        qsc_sd = build_classifier(cfg, True, "cpu", generator=gen).state_dict()
        save_checkpoint(wd, f"hdce_{tag}", {"params": hdce_sd}, {})
        save_checkpoint(wd, f"qsc_{tag}", {"params": qsc_sd}, {"quantum": qsc_meta_from_state(qsc_sd)})
    return wd


def _twin_reference(torch, cpu, x: np.ndarray) -> tuple:
    """The CPU twin's ``offline_forward`` on the requests and its classifier's
    log-probs: ``(h, pred, logp)``."""
    h_ref, pred_ref, _ = cpu.offline_forward(x)
    _, clf = cpu.live_vars()
    with torch.inference_mode():
        logp = clf(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    return h_ref, pred_ref, logp


def _hold_served(ref: tuple, h: np.ndarray, pred: np.ndarray, what: str) -> dict:
    """Served answers against the CPU twin's (``ref``, :func:`_twin_reference`
    on the same requests): the routed scenario on every row whose top-two
    log-prob margin (the CPU's) exceeds 1e-4, and ``h`` within 1e-4 max|h| +
    1e-5 on the rows routed alike."""
    h_ref, pred_ref, logp = ref
    top2 = np.sort(logp, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4
    if not np.array_equal(pred[sure], pred_ref[sure]):
        raise AssertionError(f"{what}: routed scenario differs from the CPU twin")
    if not np.isfinite(h).all():
        raise AssertionError(f"{what}: non-finite h")
    same = pred == pred_ref
    err = serve_close(h[same], h_ref[same], what)
    return {"max_abs_err": err, "tol": 1e-4 * float(np.abs(h_ref).max()) + 1e-5, "rows": len(h),
            "routed_alike": int(same.sum()), "sure": int(sure.sum())}


class _ServeTally:
    """A telemetry sink: the launch counters when the span ``mark`` closes,
    the bucket of every served batch (``serve_batch`` records), and every
    counters record with its wall time (drift and control events)."""

    active = True

    def __init__(self, K, mark: str | None = None):
        self.K, self.mark, self.at = K, mark, None
        self.buckets: list[int] = []
        self.records: list[tuple[float, str, dict]] = []
        self.spans: dict[str, float] = {}
        self._lock = threading.Lock()

    def write_raw(self, rec: dict) -> None:
        if rec.get("name") == self.mark:
            self.at = dict(self.K.launches)
        if rec.get("kind") == "span":
            with self._lock:
                self.spans[rec["name"]] = rec["dur_s"]
                self.spans[rec["name"] + ".ts"] = rec["ts"]

    def emit(self, kind: str, **fields) -> None:
        with self._lock:
            if kind == "span" and fields.get("name") == "serve_batch":
                self.buckets.append(int(fields["bucket"]))
            elif kind == "counters":
                self.records.append((time.time(), fields.get("name"), fields))


def _traffic_run(K, run):
    """``run()`` (a ``run_loadgen`` call) with a :class:`_ServeTally` as the
    global span sink: ``(summary, B.2 launches in the traffic window)``.
    ``run_loadgen``'s ``serve_warmup`` span closes after its offline
    reference and its warmup forwards, so the launches after it are the
    traffic's alone."""
    from qdml_tpu_torch.telemetry.spans import get_sink, set_sink

    mark, prev = _ServeTally(K, "serve_warmup"), get_sink()
    set_sink(mark)
    try:
        sm = run()
    finally:
        set_sink(prev)
    if mark.at is None:
        raise AssertionError("serve_tier: run_loadgen closed no serve_warmup span")
    return sm, K.launches["circuit_expvals"] - mark.at["circuit_expvals"]


def _below_saturation(torch, cfg, wd, samples, card: str) -> None:
    """The 2x2 pool against one replica of one worker at poisson
    ``TIER_BELOW_RPS``, ``TIER_BELOW_REQUESTS`` requests, ragged, every
    request traced, each run once under the torch profiler: latency, SLO,
    sheds, per-phase p50, the per-replica completion split, and the card's
    busy share (the union of device activities over the call's wall, which
    also holds the offline reference's one forward and the warmup's seven).
    Logged; it fails on a stranded future or request-path work.

    Each run's window (its manifest-headed ``serve_summary``) is written and
    its self-replay through the capacity planner logged: under the profiler
    the pools may shed at this rate, and the planner, which replays every
    offered request as completed, cannot match a window that shed. The
    planner's window is a third traced run of the one-worker pool without
    the profiler at ``TIER_PLAN_WINDOW_RPS``, below saturation, put through
    ``cli plan`` (``cli.main``): ``--validate`` must exit 0 (the window's
    phase distributions replay its own p99 and rps inside the planner's
    bands), and ``--target-rps=2000 --p99-ms=16 --emit-target`` must answer
    (exit 0, the target read back by ``load_planner_target``) or find the
    target unmeetable (exit 3, and the loader refuses the null answer)."""
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from qdml_tpu_torch import cli
    from qdml_tpu_torch.control.fleet_scale import load_planner_target
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.loadgen import run_loadgen
    from qdml_tpu_torch.telemetry import run_manifest
    from qdml_tpu_torch.telemetry.capacity import validate_window
    from qdml_tpu_torch.utils.metrics import MetricsLogger
    from qdml_tpu_torch.utils.profiling import device_busy_us

    zero = {"measure": 0, "table_write": 0, "kernel_build": 0}
    for reps, workers in ((2, 2), (1, 1)):
        dcfg = replace(cfg, serve=replace(cfg.serve, batching="ragged", replicas=reps, workers=workers,
                                          arrival="poisson", trace_sample=1.0))
        eng = ServeEngine.from_workdir(dcfg, wd, device=DEVICE)

        window_path = TIER_WORK / f"below_{reps}x{workers}.jsonl"
        wlog = MetricsLogger(str(window_path), echo=False, manifest=run_manifest(dcfg, argv=["loadgen", "below"]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sm = run_loadgen(dcfg, eng, rate=TIER_BELOW_RPS, n=TIER_BELOW_REQUESTS, deadline_ms=TIER_DEADLINE_MS,
                             samples=samples, logger=wlog)
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        wlog.close()
        busy = device_busy_us(prof.events())
        share = f"{busy / (window * 1e6):.4f}" if busy else "not measured (no device time in the trace)"
        srv = sm["server_metrics"]
        phases = {k: v.get("p50_ms") for k, v in (srv.get("phases") or {}).items()}
        lat = sm["latency_ms"] or {}
        log(f"serve_tier below saturation: ragged poisson {TIER_BELOW_RPS:g} rps n={TIER_BELOW_REQUESTS}, {reps} "
            f"replica(s) x {workers} worker(s), traced, under the profiler: rps {sm['rps']}, offered {sm['offered_rps']}, "
            f"p50 {lat.get('p50_ms')} ms, p99 {lat.get('p99_ms')} ms, SLO {json.dumps(sm['slo'])}, shed "
            f"{json.dumps(sm['shed'])}, batches {sm['batches']}, fill {json.dumps(sm['batch_fill'])}, phase p50 ms "
            f"{json.dumps(phases)}, replica_completed {srv.get('replica_completed')}, device busy {busy:.1f} us of a "
            f"{window * 1e3:.3f} ms call, share {share} [{card}]")
        if sm["stranded_futures"] or sm["failed_requests"] or sm["compile_cache_after_warmup"] != zero:
            raise AssertionError(f"serve_tier below saturation {reps}x{workers}: stranded {sm['stranded_futures']}, "
                                 f"failed {sm['failed_requests']}, work {sm['compile_cache_after_warmup']}")

    keys = ("mode", "measured_p99_ms", "predicted_p99_ms", "p99_ratio", "measured_rps", "predicted_rps", "rps_err",
            "ok")
    for tag in ("2x2", "1x1"):
        row = validate_window(str(TIER_WORK / f"below_{tag}.jsonl"))
        log(f"serve_tier plan: the profiled {tag} window's self-replay (logged): "
            f"{json.dumps({k: row.get(k) for k in keys})} [{card}]")
    # the planner's window: the one worker (the last run's engine), traced, without the profiler
    window_path = TIER_WORK / "plan_window.jsonl"
    wlog = MetricsLogger(str(window_path), echo=False, manifest=run_manifest(dcfg, argv=["loadgen", "plan"]))
    try:
        sm = run_loadgen(dcfg, eng, rate=TIER_PLAN_WINDOW_RPS, n=TIER_PLAN_WINDOW_REQUESTS,
                         deadline_ms=TIER_DEADLINE_MS, samples=samples, logger=wlog)
    finally:
        wlog.close()
    lat = sm["latency_ms"] or {}
    log(f"serve_tier plan window: ragged poisson {TIER_PLAN_WINDOW_RPS:g} rps n={TIER_PLAN_WINDOW_REQUESTS}, 1 "
        f"replica x 1 worker, traced: rps {sm['rps']}, offered {sm['offered_rps']}, p50 {lat.get('p50_ms')} ms, p99 "
        f"{lat.get('p99_ms')} ms, SLO {json.dumps(sm['slo'])}, shed {json.dumps(sm['shed'])} [{card}]")
    if sm["stranded_futures"] or sm["failed_requests"]:
        raise AssertionError(f"serve_tier plan window: stranded {sm['stranded_futures']}, failed "
                             f"{sm['failed_requests']}")
    def plan(*args: str) -> tuple[int, str]:
        """``cli plan`` through the CLI's host-side dispatch, in this process
        (a process of its own spends seconds importing torch)."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["plan", f"--trace={window_path}", *args])
        return rc, out.getvalue()

    target = TIER_WORK / "plan_target.json"
    t0 = time.perf_counter()
    val_rc, val_out = plan("--validate")
    ask_rc, ask_out = plan(f"--target-rps={TIER_PLAN_RPS:g}", f"--p99-ms={TIER_DEADLINE_MS:g}", f"--emit-target={target}")
    secs = time.perf_counter() - t0
    rows = json.loads(val_out)["plan_validation"]["rows"] if val_out.startswith("{") else []
    answer = json.loads(ask_out)["plan"] if ask_out.startswith("{") else {}
    shown = {k: rows[0].get(k) for k in keys} if rows else None
    log(f"serve_tier plan over that window: `plan --validate` exit {val_rc}: {json.dumps(shown)}; `plan "
        f"--target-rps={TIER_PLAN_RPS:g} --p99-ms={TIER_DEADLINE_MS:g}` exit {ask_rc}: backends_needed "
        f"{answer.get('backends_needed')}, sweep "
        f"{json.dumps([(r['backends'], r['utilization'], r['predicted_p99_ms']) for r in answer.get('sweep', [])])} "
        f"(backends, utilization, predicted p99 ms); both in {secs:.2f} s [{card}]")
    if val_rc != 0 or not rows or rows[0]["mode"] != "phases":
        raise AssertionError(f"serve_tier plan --validate: exit {val_rc}\n{val_out[-3000:]}")
    if ask_rc not in (0, 3) or (ask_rc == 3) != (answer.get("backends_needed") is None):
        raise AssertionError(f"serve_tier plan: exit {ask_rc}\n{ask_out[-3000:]}")
    try:
        loaded = json.dumps(load_planner_target(str(target)))
    except ValueError as e:
        if answer.get("backends_needed") is not None:
            raise
        loaded = f"refused: {e}"
    log(f"serve_tier plan target through load_planner_target: {loaded} [{card}]")


def _replica_batches(pool) -> dict[str, int]:
    """Batches served by each replica name, restarted loops included."""
    out: dict[str, int] = {}
    for loop in pool.replicas + pool._retired + pool._quarantined:
        out[loop.name] = out.get(loop.name, 0) + sum(m.batches for m in loop._worker_metrics)
    return out


def serve_tier_phase(torch, K, mods, card: str) -> dict[str, int]:
    """The serving tier at full width: ``ServeEngine.from_workdir``, warmup
    with ``serve.batching=auto`` (each tier's race logged), ``run_loadgen``
    through a 2-replica pool of 2 workers each (poisson 2000 rps and bursty
    8000 rps, 4096 requests, deadline 16 ms, once bucket with max_wait 2 ms
    and once ragged), the socket server with the port's client (256
    requests, a retried id, health, metrics, a swap to the ``v2`` tags,
    then ``run_loadgen_socket`` with 1024), and one injected
    ``worker_exception``. Counters zeroed at the start, read at the end."""
    from dataclasses import replace

    from qdml_tpu_torch.serve import batching_autotune
    from qdml_tpu_torch.serve.client import ServeClient
    from qdml_tpu_torch.serve.engine import ServeEngine, serve_mesh
    from qdml_tpu_torch.serve.faults import FaultInjected, FaultPlan, FaultSpec
    from qdml_tpu_torch.serve.loadgen import make_request_samples, run_loadgen, run_loadgen_socket
    from qdml_tpu_torch.serve.server import ReplicaPool, run_server
    from qdml_tpu_torch.serve.types import Prediction

    zero = {"measure": 0, "table_write": 0, "kernel_build": 0}
    cfg = mods["config"].from_args([
        f"--train.workdir={TIER_WORK / 'ws'}", "--quantum.n_qubits=6", "--quantum.n_layers=3",
        "--serve.replicas=2", "--serve.workers=2", "--serve.port=0",
    ])
    wd = _tier_workdir(torch, mods, cfg)
    serve_mesh(cfg, DEVICE)  # one visible card: unsharded
    K.reset_launch_counts()
    t0 = time.perf_counter()
    auto = ServeEngine.from_workdir(cfg, wd, device=DEVICE)
    warm = auto.warmup()
    log(f"serve_tier warmup (batching=auto) {time.perf_counter() - t0:.2f} s, table "
        f"{batching_autotune.table_path()} [{card}]")
    for b, entry in warm["batching"]["race"].items():
        times = {m: c.get("infer_ms") for m, c in entry["candidates"].items()}
        log(f"serve_tier batching race tier {b}: bucket {times['bucket']} ms, ragged {times['ragged']} ms "
            f"-> {entry['best_infer']}; impl {auto.quantum_impl[b]['impl']} [{card}]")
    log(f"serve_tier batching {json.dumps(auto.batching_summary())}; dispatch {warm['dispatch']['mode']}")
    if auto.request_path_work() != zero:
        raise AssertionError(f"serve_tier: work after warmup {auto.request_path_work()}")

    samples = make_request_samples(cfg, TIER_REQUESTS)
    x = samples["x"]
    ref = _twin_reference(torch, ServeEngine.from_workdir(cfg, wd, device="cpu"), x)
    for mode, extra in (("bucket", {"max_wait_ms": 2.0}), ("ragged", {})):
        mcfg = replace(cfg, serve=replace(cfg.serve, batching=mode, **extra))
        eng = ServeEngine.from_workdir(mcfg, wd, device=DEVICE)
        for process, rate in TIER_ARRIVALS:
            mcfg_p = replace(mcfg, serve=replace(mcfg.serve, arrival=process))
            results: list = []
            sm, b2 = _traffic_run(K, lambda: run_loadgen(
                mcfg_p, eng, rate=rate, n=TIER_REQUESTS, deadline_ms=TIER_DEADLINE_MS, samples=samples,
                results=results))
            served = [r for r in results if isinstance(r, Prediction)]
            ids = np.array([r.rid for r in served], dtype=np.int64)
            held = _hold_served(tuple(a[ids] for a in ref), np.stack([r.h for r in served]),
                                np.array([r.scenario for r in served]), f"serve_tier {mode} {process}")
            lat = sm["latency_ms"] or {}
            log(f"serve_tier loadgen {mode} {process} {rate:g} rps n={TIER_REQUESTS} deadline "
                f"{TIER_DEADLINE_MS:g} ms: rps {sm['rps']}, offered {sm['offered_rps']}, goodput {sm['goodput_rps']}, "
                f"p50 {lat.get('p50_ms')} ms, p99 {lat.get('p99_ms')} ms, SLO {json.dumps(sm['slo'])}, "
                f"shed {json.dumps(sm['shed'])}, padding waste {sm['padding_waste']}, fill "
                f"{json.dumps(sm['batch_fill'])}, batches {sm['batches']}, B.2 launches in the traffic window {b2}, "
                f"continuous {sm['batching']['continuous_admission']}, stranded {sm['stranded_futures']}, "
                f"parity {sm['parity_max_abs_err']:.3e} (CPU twin {held['max_abs_err']:.3e}, tol "
                f"{held['tol']:.3e}, routed alike {held['routed_alike']}/{held['rows']}) [{card}]")
            if sm["stranded_futures"] or sm["failed_requests"]:
                raise AssertionError(f"serve_tier {mode} {process}: stranded {sm['stranded_futures']}, "
                                     f"failed {sm['failed_requests']}")
            if sm["compile_cache_after_warmup"] != zero:
                raise AssertionError(f"serve_tier {mode} {process}: request-path work {sm['compile_cache_after_warmup']}")
            if sm["completed"] + sm["n_shed"] != TIER_REQUESTS or len(served) != sm["completed"]:
                raise AssertionError(f"serve_tier {mode} {process}: {sm['completed']} + {sm['n_shed']} answers")
            if sm["batching"]["continuous_admission"] != (mode == "ragged"):
                raise AssertionError(f"serve_tier {mode}: {sm['batching']}")
            if b2 != sm["batches"]:  # one launch a served batch at buckets <= 64
                raise AssertionError(f"serve_tier {mode} {process}: B.2 launched {b2} times for {sm['batches']} batches")

    # beside the 2x2 pool: one replica of one worker, ragged, poisson at the
    # same rate; logged
    one = replace(cfg, serve=replace(cfg.serve, batching="ragged", replicas=1, workers=1))
    sm = run_loadgen(one, ServeEngine.from_workdir(one, wd, device=DEVICE), rate=TIER_ARRIVALS[0][1],
                     n=TIER_REQUESTS, deadline_ms=TIER_DEADLINE_MS, samples=samples)
    lat = sm["latency_ms"] or {}
    log(f"serve_tier loadgen ragged poisson {TIER_ARRIVALS[0][1]:g} rps, 1 replica x 1 worker: rps {sm['rps']}, "
        f"p50 {lat.get('p50_ms')} ms, p99 {lat.get('p99_ms')} ms, SLO {json.dumps(sm['slo'])}, shed "
        f"{json.dumps(sm['shed'])}, batches {sm['batches']}, stranded {sm['stranded_futures']} [{card}]")
    if sm["stranded_futures"] or sm["compile_cache_after_warmup"] != zero:
        raise AssertionError(f"serve_tier 1x1: stranded {sm['stranded_futures']}, work {sm['compile_cache_after_warmup']}")
    _below_saturation(torch, cfg, wd, samples, card)

    # the socket server, the port's client, a swap to the v2 tags
    ready: Future = Future()
    server = threading.Thread(target=run_server, args=(cfg, auto), kwargs={"workdir": wd, "ready": ready},
                              daemon=True)
    server.start()
    handle = ready.result(timeout=120.0)
    try:
        with ServeClient("127.0.0.1", handle["port"], timeout_s=30.0, seed=SEED) as client:
            t1 = time.perf_counter()
            replies = [client.request(x[i], rid=f"sock-{i}") for i in range(256)]
            sock_s = time.perf_counter() - t1
            if not all(r.get("ok") and r["id"] == f"sock-{i}" for i, r in enumerate(replies)):
                raise AssertionError(f"serve_tier socket: a reply failed: {[r for r in replies if not r.get('ok')][:2]}")
            held = _hold_served(tuple(a[:256] for a in ref), np.asarray([r["h"] for r in replies], np.float32),
                                np.array([r["pred"] for r in replies]), "serve_tier socket")
            done = client.metrics()["metrics"]["completed"]
            again = client.request(x[0], rid="sock-0")
            if again["h"] != replies[0]["h"] or client.metrics()["metrics"]["completed"] != done:
                raise AssertionError("serve_tier socket: a retried id dispatched again")
            health = client.health()["health"]
            if not (health["warm"] and health["replicas_live"] == 2 and health["dedup_hits"] >= 1):
                raise AssertionError(f"serve_tier socket: health {health}")
            swap = client.swap(tags={"hdce": "hdce_v2", "qsc": "qsc_v2"})
            if not swap.get("ok") or swap["swap"]["work"] != zero:
                raise AssertionError(f"serve_tier socket: swap {swap}")
            twin2 = ServeEngine.from_workdir(cfg, wd, device="cpu", tags={"hdce": "hdce_v2", "qsc": "qsc_v2"})
            after = [client.request(x[i], rid=f"swap-{i}") for i in range(256, 320)]
            held2 = _hold_served(_twin_reference(torch, twin2, x[256:320]),
                                 np.asarray([r["h"] for r in after], np.float32),
                                 np.array([r["pred"] for r in after]), "serve_tier socket after swap")
            log(f"serve_tier socket: 256 requests in {sock_s:.3f} s ({256 / sock_s:.1f} rps, one client), "
                f"CPU twin {held['max_abs_err']:.3e}; retried id served once; swap epoch "
                f"{swap['swap']['epoch']} to v2, CPU twin on v2 {held2['max_abs_err']:.3e} "
                f"(tol {held2['tol']:.3e}) [{card}]")
        sk = run_loadgen_socket(cfg, ("127.0.0.1", handle["port"]), rate=4000.0, n=1024, clients=8,
                                timeout_s=30.0, x=x[:1024])
        lat = sk["latency_ms"] or {}
        log(f"serve_tier run_loadgen_socket 4000 rps n=1024 clients 8: rps {sk['rps']}, p50 {lat.get('p50_ms')} ms, "
            f"p99 {lat.get('p99_ms')} ms, shed {json.dumps(sk['shed'])}, give-ups {sk['give_ups']}, reconnects "
            f"{sk['reconnects']}, stranded {sk['stranded_futures']}, server work {sk['compile_cache_after_warmup']} [{card}]")
        if sk["completed"] != 1024 or sk["stranded_futures"] or sk["give_ups"] or \
                sk["compile_cache_after_warmup"] != zero:
            raise AssertionError(f"serve_tier socket loadgen: {json.dumps({k: sk[k] for k in ('completed', 'stranded_futures', 'give_ups', 'compile_cache_after_warmup')})}")
    finally:
        handle["stop"]()
        server.join(timeout=60.0)
    if server.is_alive():
        raise AssertionError("serve_tier: the socket server did not stop")

    # one injected worker_exception: replica 1's second batch. The replicas
    # share one feed and replica 1 dequeues only when its workers win the
    # race for it, so waves of 16 (each answered before the next: no queue
    # overflow) go on until the fault has fired
    plan = FaultPlan([FaultSpec("worker_exception", at=1, replica="serve-replica-1")], seed=SEED)
    eng = ServeEngine.from_workdir(replace(cfg, serve=replace(cfg.serve, batching="bucket")), wd, device=DEVICE)
    pool = ReplicaPool(eng, faults=plan).start()
    outcome = {"served": 0, "failed": 0, "other": 0}
    sent = 0
    try:
        while sent < FAULT_MAX_REQUESTS and (sent < 512 or not plan.fired):
            for f in [pool.submit(x[(sent + i) % len(x)], rid=sent + i) for i in range(16)]:
                try:
                    r = f.result(timeout=60.0)
                    outcome["served" if isinstance(r, Prediction) else "other"] += 1
                except FaultInjected:
                    outcome["failed"] += 1
            sent += 16
        deadline = time.monotonic() + 30.0
        while pool.health()["restarts"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        later = [f.result(timeout=60.0) for f in [pool.submit(x[i], rid=10_000 + i) for i in range(64)]]
        health = pool.health()
    finally:
        pool.stop()
    merged = pool.merged_metrics()
    log(f"serve_tier fault: worker_exception at serve-replica-1's batch #1: {json.dumps(outcome)} of {sent}, "
        f"restarts {health['restarts']}, faults {json.dumps(merged.faults)}, then 64 more served "
        f"{sum(isinstance(r, Prediction) for r in later)}; fired {json.dumps(plan.fired)}; batches by replica "
        f"{json.dumps(_replica_batches(pool))} [{card}]")
    if not plan.fired:
        raise AssertionError(f"serve_tier fault: serve-replica-1 took fewer than 2 batches of {sent} requests")
    if not (1 <= outcome["failed"] <= cfg.serve.max_batch and outcome["other"] == 0
            and outcome["served"] + outcome["failed"] == sent):
        raise AssertionError(f"serve_tier fault: {outcome}")
    if health["restarts"] != 1 or merged.faults != {"worker_exception": 1} or health["replicas_live"] != 2:
        raise AssertionError(f"serve_tier fault: health {health}, faults {merged.faults}")
    if not all(isinstance(r, Prediction) for r in later) or eng.request_path_work() != zero:
        raise AssertionError("serve_tier fault: the restarted pool did not serve, or did request-path work")
    counts = dict(K.launches)
    log(f"serve_tier launches: {json.dumps(counts)}")
    if counts["circuit_expvals"] == 0:
        raise AssertionError("serve_tier: B.2 was not launched")
    return counts


def microbench(torch, K, card: str) -> dict[str, int]:
    """The port's circuit micro-benchmark at its full shape on the card, the
    counters zeroed just before and read just after; every row's <Z> within
    1e-5 of the ``dense`` row's. Returns the launches."""
    from qdml_tpu_torch.scripts import quantum_microbench as mb

    K.reset_launch_counts()
    res, outs = mb.run(mb.BATCH, DEVICE)
    torch.cuda.synchronize()
    counts = dict(K.launches)
    ref = outs["dense"]
    for name, out in outs.items():
        err = (out - ref).abs().max().item()
        log(f"microbench fwd_{name}: {res[f'fwd_{name}_us']} us a call, {res[f'fwd_{name}_sps']} "
            f"samples/s (B={mb.BATCH}, n={mb.N}, L={mb.L}, mean of {mb.REPS}); max |<Z> - dense| "
            f"{err:.3e} (tol 1e-5) [{card}]")
        if out.shape != (mb.BATCH, mb.N) or not torch.isfinite(out).all() or err > 1e-5:
            raise AssertionError(f"microbench row {name}: shape {tuple(out.shape)}, max err {err:.3e}")
    log(f"microbench json: {json.dumps(res)}; launches {json.dumps(counts)}")
    if counts["unitary_expvals"] == 0 or counts["qsc_expvals"] == 0:
        raise AssertionError("the microbench never launched the unitary or the QSC kernel")
    return counts


def _cpu_batch(batch: dict) -> dict:
    from qdml_tpu_torch.utils.complexops import CArr

    return {k: CArr(v.re.cpu(), v.im.cpu()) if isinstance(v, CArr) else v.cpu() for k, v in batch.items()}


def evaluate(torch, K, mods, card: str) -> dict[str, int]:
    """``cli eval`` over the training phase's checkpoints, counters zeroed
    just before and read just after; then one SNR point's per-batch sums
    against the same per-batch function on the CPU (same weights, the same
    test batches drawn on the card and copied over): rtol 1e-4 (float32 sums
    in another order, cuDNN vs CPU convs), and the routed predictions equal
    wherever the top-two log-prob margin exceeds 1e-4. Returns the launches."""
    cli, cfg_mod = mods["cli"], mods["config"]
    from qdml_tpu_torch.data.baselines import beam_delay_profile
    from qdml_tpu_torch.data.channels import ChannelGeometry
    from qdml_tpu_torch.data.datasets import sweep_batch
    from qdml_tpu_torch.eval.sweep import batch_metrics, load_sweep_models

    overrides = [
        f"--train.workdir={EVAL_WORK / 'ws'}",
        f"--eval.results_dir={EVAL_WORK / 'results'}",
        f"--eval.test_len={EVAL_TEST_LEN}",
        "--quantum.n_qubits=6", "--quantum.n_layers=3", "--quantum.impl=pallas",
    ]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    if cli.main(["eval", *overrides]) != 0:
        raise AssertionError("cli eval failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    cfg = cfg_mod.from_args(overrides)
    workdir = cli.workdir_of(cfg)
    with open(EVAL_WORK / "results" / "quantum_classical_comparison.json") as fh:
        results = json.load(fh)
    curves, grid = results["nmse_db"], list(cfg.eval.snr_grid)
    if results["snr"] != grid or set(curves) != {"ls", "mmse", "mmse_oracle", "dce", "hdce_classical", "hdce_quantum"}:
        raise AssertionError(f"eval results: snr {results['snr']}, curves {sorted(curves)}")
    if not all(len(v) == len(grid) and np.isfinite(v).all() for v in curves.values()):
        raise AssertionError(f"eval results: non-finite or short curves {curves}")
    if not all(m < ls for m, ls in zip(curves["mmse"], curves["ls"])):
        raise AssertionError(f"eval: MMSE {curves['mmse']} not below LS {curves['ls']}")
    if set(results["acc"]) != {"classical", "quantum"}:
        raise AssertionError(f"eval accuracies: {results['acc']}")
    points = []
    with open(Path(workdir) / "eval.metrics.jsonl") as fh:
        points = [json.loads(line) for line in fh if '"snr_db"' in line][-len(grid):]
    log(f"eval: sweep over {len(grid)} SNR points of {EVAL_TEST_LEN} samples (cut from 10000 for time "
        f"only), batch {cfg.eval.batch_size}, wall {wall:.3f} s for the whole command; per point "
        f"{[round(r['seconds'], 4) for r in points]} s; launches {json.dumps(counts)} [{card}]")
    if counts["qsc_expvals"] == 0:
        raise AssertionError("eval never launched the QSC kernel (impl pallas)")

    # the CPU twin of one SNR point, over the models eval itself restores
    models = {}
    for dev in (DEVICE, "cpu"):
        cfg, models[dev] = load_sweep_models(cfg, workdir, dev)
    geom = ChannelGeometry.from_config(cfg.data)
    profile = beam_delay_profile(geom, device=DEVICE)
    snr, bs = float(grid[-1]), cfg.eval.batch_size
    worst, skipped = 0.0, 0
    with torch.inference_mode():
        for b in range(EVAL_TEST_LEN // bs):
            batch = sweep_batch(cfg.data, cfg.data.data_len * 3, b * bs, bs, snr, DEVICE, geom)
            got = batch_metrics(models[DEVICE], batch, snr, profile, geom)
            cb = _cpu_batch(batch)
            want = batch_metrics(models["cpu"], cb, snr, profile.cpu(), geom)
            x = batch["yp_img"].permute(0, 3, 1, 2).contiguous()
            routed_alike = {}
            for name, key in (("sc", "classical"), ("qsc", "quantum")):
                pred = getattr(models[DEVICE], name)(x).argmax(-1).cpu().numpy()
                logp = getattr(models["cpu"], name)(x.cpu()).numpy()
                top2 = np.sort(logp, axis=-1)[:, -2:]
                sure = (top2[:, 1] - top2[:, 0]) > 1e-4
                if not np.array_equal(pred[sure], logp.argmax(-1)[sure]):
                    raise AssertionError(f"eval twin batch {b}: {name} predictions differ on sure rows")
                routed_alike[key] = bool(np.array_equal(pred, logp.argmax(-1)))
            for key, value in want.items():
                if key.endswith(("_classical", "_quantum")) and not routed_alike[key.rsplit("_", 1)[1]]:
                    skipped += 1  # a near-tie row routed the other way: a different sum, not an error
                    continue
                g, w_ = float(got[key]), float(value)
                rel = abs(g - w_) / max(abs(w_), 1e-30)
                worst = max(worst, rel)
                if rel > 1e-4:
                    raise AssertionError(f"eval twin batch {b} {key}: card {g} vs CPU {w_} (rel {rel:.2e})")
    log(f"eval twin at {snr:g} dB over {EVAL_TEST_LEN // bs} batches: per-batch sums within rel "
        f"{worst:.3e} of the CPU's (rtol 1e-4); {skipped} sums skipped for near-tie routing")

    # one SNR point of the sweep routed sparse against dense, on the card
    from dataclasses import replace

    from qdml_tpu_torch.eval.sweep import run_snr_sweep

    point = replace(cfg, eval=replace(cfg.eval, snr_grid=(snr,)))
    by = {d: run_snr_sweep(point, models[DEVICE], device=DEVICE, dispatch=d) for d in ("dense", "sparse")}
    for key, dense_db in by["dense"]["nmse_db"].items():
        if not np.allclose(by["sparse"]["nmse_db"][key], dense_db, rtol=1e-4, atol=0.0):
            raise AssertionError(f"eval sparse {key}: {by['sparse']['nmse_db'][key]} dB vs dense {dense_db} dB")
    if by["sparse"]["acc"] != by["dense"]["acc"]:
        raise AssertionError(f"eval sparse accuracies {by['sparse']['acc']} vs dense {by['dense']['acc']}")
    log(f"eval sparse dispatch at {snr:g} dB: NMSE dB {json.dumps(by['sparse']['nmse_db'])} within rtol 1e-4 "
        f"of dense {json.dumps(by['dense']['nmse_db'])}")
    return counts


class Recorder:
    """Keeps what a trainer logs (each step's loss at print_freq 1)."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, step=None, **values) -> None:
        self.records.append({"step": step, **values, "t": time.perf_counter()})


def every_step_logged(cfg):
    """``cfg`` at ``train.probe_every=1``. The K-step path fetches and logs a
    chunk's losses only on the flight recorder's cadence (the run's first
    step and every ``probe_every``-th), so the phases that hold every step's
    logged loss (7, its DCE, 8e and lowp) set it; the others keep the
    trainers' default of 100, and the nat_sweep phase checks that a K-step
    run at that default logs its first chunk alone."""
    from dataclasses import replace

    return replace(cfg, train=replace(cfg.train, probe_every=1))


def trainer_configs(cfg_mod):
    """The four trainers at full width: (config, quantum) with quantum None
    for the HDCE."""
    from dataclasses import replace

    base = cfg_mod.ExperimentConfig()
    base = replace(
        base,
        data=replace(base.data, data_len=TRAIN_DATA_LEN),
        train=replace(base.train, batch_size=TRAIN_BATCH, n_epochs=1, print_freq=1),
    )
    q = base.quantum
    return {
        "hdce": (base, None),
        "sc": (base, False),
        "qsc_n6_pallas": (replace(base, quantum=replace(
            q, n_qubits=6, n_layers=3, impl="pallas", use_quantumnat=True, noise_level=0.01)), True),
        "qsc_n8_pallas_circuit": (replace(base, quantum=replace(
            q, n_qubits=8, n_layers=3, impl="pallas_circuit", use_gradient_pruning=True,
            gradient_prune_mode="quantile", gradient_threshold=0.5)), True),
        "qsc_n6_auto": (replace(base, quantum=replace(q, n_qubits=6, n_layers=3)), True),
    }


# impl auto picks one of the impls whose trainers the twin already holds
NO_TWIN = ("qsc_n6_auto",)


def trainee(mods, cfg, quantum, device, steps_per_epoch):
    """The trainer's own model and optimizer (``make_trainer``), and its step
    ``step(batch, noise) -> {"loss": ...}``. ``quantum``: None for the HDCE,
    ``"dce"`` for the DCE, else the classifier's flag."""
    if quantum == "dce":
        model, opt = mods["dce"].make_trainer(cfg, device, steps_per_epoch)
        return model, opt, lambda b, eps: mods["dce"].dce_train_step(model, opt, b)
    if quantum is None:
        model, opt = mods["hdce"].make_trainer(cfg, device, steps_per_epoch)
        return model, opt, lambda b, eps: mods["hdce"].hdce_train_step(model, opt, b)
    model, opt = mods["qsc"].make_trainer(cfg, quantum, device, steps_per_epoch)
    return model, opt, lambda b, eps: mods["qsc"].classifier_train_step(model, opt, b, noise=eps)


def _twin_params_close(
    got: dict, want: dict, lr: float, steps: int, what: str, tight_share: float | None = 0.01
) -> tuple[float, int, int]:
    """Parameters of a card run against its CPU twin: every entry within the
    Adam bound of ``steps`` updates, at most ``tight_share`` of them outside
    1e-5 + 1e-4|p| (None: the share is printed, not held)."""
    bound = 1.1 * steps * lr + 1e-5
    worst, outside, total = 0.0, 0, 0
    for k, w in want.items():
        diff = (got[k] - w).abs()
        worst = max(worst, diff.max().item())
        outside += int((diff > 1e-5 + 1e-4 * w.abs()).sum())
        total += w.numel()
    if worst > bound or (tight_share is not None and outside > tight_share * total):
        raise AssertionError(f"{what}: parameters differ from the CPU twin ({worst:.3e}, {outside}/{total})")
    return worst, outside, total


def cpu_twin(
    torch, mods, name, cfg, quantum, batches, steps_per_epoch, rtol=1e-4, grad_rtol=1e-4, tight_share=0.01
) -> None:
    """The first steps on the card and on the CPU from the same weights,
    batches and QuantumNAT noise. Losses: ``rtol`` (1e-4: fp32 sums over
    2304 rows in another order). The circuit weights' gradient of the first
    backward (before pruning), where the circuit kernels' autograd lands:
    within ``grad_rtol`` max|g| + 1e-7 of the twin's (1e-4), since Adam's
    first update is lr * sign(g) and hides a wrong magnitude from the
    parameters.
    Parameters: within 1e-5 + 1e-4 |p| except where a gradient is
    rounding-dominated, which Adam turns into up to lr per step either way
    (the last layer's RZ weights, whose gradient is zero, and entries at the
    pruning cutoff); every entry within that bound, and at most
    ``tight_share`` of entries outside the tight one."""
    qcfg = cfg.quantum
    gen = torch.Generator().manual_seed(SEED + 5)
    noises = [
        qcfg.noise_level * torch.randn((qcfg.n_layers, qcfg.n_qubits, 2), generator=gen)
        if quantum is True and qcfg.use_quantumnat else None
        for _ in batches
    ]
    runs = []
    for dev in (DEVICE, "cpu"):
        model, opt, step = trainee(mods, cfg, quantum, dev, steps_per_epoch)
        grads = []
        if quantum is True:  # the leaf's gradient as autograd delivers it, copied before pruning edits .grad in place
            hook = model.qlayer.weights.register_hook(lambda g: grads.append(g.detach().to("cpu", copy=True)))
        losses = []
        for b, eps in zip(batches, noises):
            b = {k: v.to(dev) for k, v in b.items()}
            losses.append(float(step(b, None if eps is None else eps.to(dev))["loss"]))
        if quantum is True:
            hook.remove()
        runs.append((losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}, grads))
    (gl, gp, gg), (cl, cp, cg) = runs
    if not np.allclose(gl, cl, rtol=rtol, atol=0.0):
        raise AssertionError(f"train {name}: losses {gl} on the card, {cl} on the CPU twin (rtol {rtol})")
    if quantum is True:
        gtol = grad_rtol * cg[0].abs().max().item() + 1e-7
        gerr = (gg[0] - cg[0]).abs().max().item()
        log(f"train {name}: circuit weights' first gradient, card vs CPU twin: max |diff| {gerr:.3e} "
            f"(tol {grad_rtol:g} max|g| + 1e-7 = {gtol:.3e}; max|g| {cg[0].abs().max().item():.3e})")
        if gerr > gtol:
            raise AssertionError(f"train {name}: circuit weights' gradient differs from the CPU twin")
    floats = {k: v for k, v in cp.items() if v.is_floating_point()}
    worst, outside, total = _twin_params_close(gp, floats, cfg.train.lr, TWIN_STEPS, f"train {name}", tight_share)
    share = "not held" if tight_share is None else f"at most {tight_share:.0%}"
    log(f"train {name}: CPU twin over {TWIN_STEPS} steps: losses card {gl}, cpu {cl} (rtol {rtol:g}); "
        f"params max |diff| {worst:.3e} (bound {1.1 * TWIN_STEPS * cfg.train.lr + 1e-5:.1e}), {outside}/{total} "
        f"entries outside 1e-5 + 1e-4|p| ({share})")


def train(torch, K, mods, card: str):
    """The training phase: per trainer, the CPU twin, then the main path with
    the launch counters zeroed just before and read just after, then its
    step times. Returns the launches summed over the trainers and the
    circuit_adjoint launches per training step."""
    data_cfg = trainer_configs(mods["config"])["hdce"][0].data
    t0 = time.perf_counter()
    data = mods["datasets"].GridData.synthesize(data_cfg, DEVICE)
    torch.cuda.synchronize()
    log(f"train data: {data_cfg.data_len} samples per cell (cut from 20000 for time only), "
        f"synthesized on the card in {time.perf_counter() - t0:.2f} s")
    loader = mods["datasets"].DMLGridLoader(data, TRAIN_BATCH, "train")
    spe = loader.steps_per_epoch
    batches = [
        {k: b[k] for k in ("yp_img", "h_label", "h_perf", "indicator")}
        for _, b in zip(range(TWIN_STEPS), loader.epoch(0))
    ]
    from qdml_tpu_torch.utils.tune_table import activity

    launches = {k: 0 for k in K.launches}
    per_step_adjoint = None
    for name, (cfg, quantum) in trainer_configs(mods["config"]).items():
        cfg = every_step_logged(cfg)  # the check below reads every step's loss
        if name not in NO_TWIN:
            cpu_twin(torch, mods, name, cfg, quantum, batches, spe)

        # the eval phase's checkpoints (cli eval's workdir scheme)
        workdir = mods["cli"].workdir_of(mods["config"].from_args([f"--train.workdir={EVAL_WORK / 'ws'}"]))
        workdir = workdir if name in EVAL_TRAINERS else None
        rec = Recorder()
        work0 = dict(activity)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        if quantum is None:
            _, hist = mods["hdce"].train_hdce(cfg, data=data, logger=rec, workdir=workdir)
        else:
            _, hist = mods["qsc"].train_classifier(cfg, quantum, data=data, logger=rec, workdir=workdir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(K.launches)
        for k in launches:
            launches[k] += counts[k]
        steps = [r["loss"] for r in rec.records if "loss" in r]
        log(f"train {name}: one epoch ({len(steps)} steps of {cfg.data.n_scenarios * cfg.data.n_users * TRAIN_BATCH} "
            f"rows) + validation in {wall:.2f} s; step losses {[round(x, 5) for x in steps]}; "
            f"history {json.dumps(hist)}; launches {json.dumps(counts)}")
        if len(steps) != spe or not all(np.isfinite(steps)):
            raise AssertionError(f"train {name}: step losses {steps}")
        if not all(np.isfinite(v).all() for v in hist.values()):
            raise AssertionError(f"train {name}: non-finite history {hist}")
        if quantum is None and not steps[-1] < steps[0]:
            raise AssertionError(f"train hdce: last step loss {steps[-1]} not below the first {steps[0]}")
        if name == "qsc_n6_pallas" and counts["qsc_expvals"] == 0:
            raise AssertionError("the pallas trainer never launched the QSC kernel")
        if name == "qsc_n8_pallas_circuit":
            if counts["circuit_expvals"] == 0 or counts["circuit_adjoint"] == 0:
                raise AssertionError("the pallas_circuit trainer never launched the circuit kernels")
            per_step_adjoint = counts["circuit_adjoint"] / spe
        if name == "qsc_n6_auto":
            tuned = [r for r in rec.records if r.get("kind") == "quantum_autotune"]
            if len(tuned) != 1 or activity != work0:
                raise AssertionError(f"train {name}: autotune records {tuned}, work {work0} -> {dict(activity)}")
            log(f"train {name}: quantum_autotune {tuned[0]['key']}: impl {tuned[0]['impl']} (train), "
                f"{tuned[0]['impl_infer']} (infer), read from the race's table without measuring")

        # step time and its split, on a fresh model: forward (loss), backward, update
        saved = dict(K.launches)
        model, opt, _ = trainee(mods, cfg, quantum, DEVICE, spe)
        b = {k: v for k, v in batches[0].items()}
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        parts = {"forward": [], "backward": [], "update": []}
        for i in range(13):
            marks = [time.perf_counter()]
            if quantum is None:
                loss, _ = mods["hdce"].hdce_loss(model.train(), b)
            else:
                loss = mods["qsc"].classifier_loss(model, b, generator=gen)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            opt.zero_grad()
            loss.backward()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            opt.step()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if i >= 3:  # after warm-up
                for part, t_a, t_b in zip(parts, marks, marks[1:]):
                    parts[part].append((t_b - t_a) * 1e3)
        K.launches.update(saved)  # timing launches are not main-path launches
        med = {k: statistics.median(v) for k, v in parts.items()}
        log(f"time train step {name}: median {sum(med.values()):.4f} ms = forward {med['forward']:.4f} "
            f"+ backward {med['backward']:.4f} + update {med['update']:.4f} ms (host clock, synchronized "
            f"after each part, 10 steps of {cfg.data.n_scenarios * cfg.data.n_users * TRAIN_BATCH} rows) [{card}]")
    log(f"main-path training launches: {json.dumps(launches)}; circuit_adjoint per training step "
        f"{per_step_adjoint}")
    return launches, per_step_adjoint, (data, batches, spe)


def dce_phase(torch, K, mods, card: str, train_data) -> dict[str, int]:
    """The monolithic DCE at full width (``ConvP128`` of 32 features, the
    4096->2048 head) on the training phase's grid: its first 2 steps on the
    card against a CPU twin (as the other trainers), then one epoch of
    ``train_dce`` with the counters zeroed just before and read just after,
    writing ``dce_best`` where ``cli eval`` finds it. The DCE runs no circuit
    kernel, so those launches must be 0; its one trunk launches the
    BatchNorm + ReLU pair at its 3 sites each way a step."""
    data, batches, spe = train_data
    cfg = every_step_logged(trainer_configs(mods["config"])["hdce"][0])  # every step's loss is read
    cpu_twin(torch, mods, "dce", cfg, "dce", batches, spe)
    workdir = mods["cli"].workdir_of(mods["config"].from_args([f"--train.workdir={EVAL_WORK / 'ws'}"]))
    rec = Recorder()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    _, hist = mods["dce"].train_dce(cfg, data=data, logger=rec, workdir=workdir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    steps = [r["loss"] for r in rec.records if "loss" in r]
    log(f"train dce: one epoch ({len(steps)} steps of {cfg.data.n_scenarios * cfg.data.n_users * TRAIN_BATCH} "
        f"rows) + validation in {wall:.2f} s; step losses {[round(x, 5) for x in steps]}; history "
        f"{json.dumps(hist)}; launches {json.dumps(counts)} [{card}]")
    if len(steps) != spe or not all(np.isfinite(steps)):
        raise AssertionError(f"train dce: step losses {steps}")
    bn = {"bn_relu_fwd": 3 * spe, "bn_relu_bwd": 3 * spe}
    if not all(np.isfinite(v).all() for v in hist.values()) or counts != {k: bn.get(k, 0) for k in counts}:
        raise AssertionError(f"train dce: history {hist}, launches {counts}, want {bn} and no other")
    return counts


def interop_phase(torch, mods, card: str) -> None:
    """``export-torch`` of the card-trained HDCE, SC and QSC (n=6, impl
    ``pallas``) as reference ``.pth`` files, ``import-torch`` of them into a
    fresh workdir, and both sets of tags restored on the card: equal state
    dicts, and forwards on the card bit for bit equal."""
    cli, cfg_mod = mods["cli"], mods["config"]
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.checkpoint import restore_params

    pth = EVAL_WORK / "pth"
    src_args = [f"--train.workdir={EVAL_WORK / 'ws'}"]
    dst_args = [f"--train.workdir={EVAL_WORK / 'imported'}"]
    if cli.main(["export-torch", *src_args, f"--out={pth}"]) != 0:
        raise AssertionError("cli export-torch failed")
    if cli.main(["import-torch", *dst_args, f"--out={pth}"]) != 0:
        raise AssertionError("cli import-torch failed")
    files = sorted(p.name for p in pth.glob("*.pth"))
    qargs = ["--quantum.n_qubits=6", "--quantum.n_layers=3", "--quantum.impl=pallas"]
    cfg = cfg_mod.from_args(qargs)
    x = torch.tensor(np.random.default_rng(SEED + 9).standard_normal((SERVE_BATCH, 2, 16, 8)),
                     dtype=torch.float32, device=DEVICE)
    checked = []
    for name, build in (
        ("hdce", lambda: mods["hdce"].build_hdce(cfg, DEVICE)),
        ("sc", lambda: build_classifier(cfg, False, DEVICE)),
        ("qsc", lambda: build_classifier(cfg, True, DEVICE)),
    ):
        outs = []
        for args in (src_args, dst_args):
            sd, _ = restore_params(cli.workdir_of(cfg_mod.from_args(args)), f"{name}_best", DEVICE)
            model = build()
            model.load_state_dict(sd["params"])
            with torch.inference_mode():
                outs.append((sd["params"], model(x.expand(cfg.data.n_scenarios, *x.shape) if name == "hdce" else x)))
        (sa, ya), (sb, yb) = outs
        if set(sa) != set(sb) or not all(torch.equal(sa[k], sb[k]) for k in sa) or not torch.equal(ya, yb):
            raise AssertionError(f"interop {name}: the imported tag differs from the exported one")
        checked.append(f"{name} ({len(sa)} tensors, forward {tuple(ya.shape)})")
    log(f"interop: export-torch wrote {len(files)} reference files {files}; import-torch into a fresh workdir: "
        f"{', '.join(checked)} equal bit for bit on the card [{card}]")


def nat_sweep_phase(torch, K, mods, card: str) -> tuple[dict[str, int], dict]:
    """The noise-sweep ensemble at the shipped n=6, L=3, E=4 sigmas and
    batch 256 a cell (2304 rows a step): the member-axis forward and adjoint
    against their plain versions at the one-member tolerances (2e-5
    absolute; 2e-5 of the largest cotangent plus 1e-6) and each member bit for bit
    against a one-member launch, there and at n 2, 8, 12; the first 2
    ensemble steps on the card against a CPU twin (the same member states,
    batches and noise: per-member losses rtol 1e-4, parameters within the
    Adam rule); then two epochs of ``train_nat_sweep`` at the ``nat_sweep``
    preset (impl ``auto``: ``prewarm`` at S*U*batch_size, then one
    resolution for train mode and one for infer mode, from the table under
    :data:`TUNE_DIR`; data_len 2560 a cell, cut from 20000 for time: the
    validation split, a tenth, still fills one batch of 256 a cell, so
    validation runs at the shipped config's shape, 2304 rows, as training
    does) with
    the counters zeroed just before and read just after, which must show one
    forward launch per step and validation batch, one adjoint launch per
    step, and no one-member launch. ``prewarm``'s own launches (a race, if
    the table lacks the shape) are read before that reset. Returns the
    launches of prewarm and training, and the timing shapes."""
    from dataclasses import replace

    from qdml_tpu_torch.quantum import autotune
    from qdml_tpu_torch.quantum.circuits import resolve_impl
    from qdml_tpu_torch.train import nat_sweep as ns
    from qdml_tpu_torch.utils.tune_table import activity

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 11)
    n, layers, members, rows = 6, 3, 4, 9 * TRAIN_BATCH
    worst = {"fwd": 0.0, "adj": 0.0}
    shapes = {}
    for sn, sb in ((n, rows), (2, 64), (8, 64), (12, 64)):
        a = torch.tensor(rng.uniform(-1, 1, (members, sb, sn)), dtype=torch.float32, device=dev)
        w = torch.tensor(rng.uniform(0, 2 * np.pi, (members, layers, sn, 2)), dtype=torch.float32, device=dev)
        g = torch.tensor(rng.standard_normal((members, sb, sn)), dtype=torch.float32, device=dev)
        ev, fre, fim = K.fused_circuit_expvals_ensemble(a, w, sn, layers, return_state=True)
        da, dw = K.circuit_adjoint_ensemble(fre, fim, g, a, w, sn, layers)
        torch.cuda.synchronize()
        for got, want in zip((ev, fre, fim), K.circuit_expvals_ensemble_plain(a, w, sn, layers)):
            err = (got - want).abs().max().item()
            worst["fwd"] = max(worst["fwd"], err)
            if err > 2e-5:
                raise AssertionError(f"nat_sweep forward n={sn} B={sb}: max abs err {err:.3e} (atol 2e-5)")
        for got, want in zip((da, dw), K.circuit_adjoint_ensemble_plain(fre, fim, g, a, w, sn, layers)):
            err, tol = (got - want).abs().max().item(), 2e-5 * want.abs().max().item() + 1e-6
            worst["adj"] = max(worst["adj"], err)
            if err > tol:
                raise AssertionError(f"nat_sweep adjoint n={sn} B={sb}: max abs err {err:.3e} (atol {tol:.3e})")
        for m in range(members):
            sev, sre, sim = K.fused_circuit_expvals(a[m], w[m], sn, layers, return_state=True)
            sda, sdw = K.circuit_adjoint(sre, sim, g[m].contiguous(), a[m], w[m], sn, layers)
            if not all(torch.equal(x, y) for x, y in ((ev[m], sev), (fre[m], sre), (fim[m], sim), (da[m], sda), (dw[m], sdw))):
                raise AssertionError(f"nat_sweep n={sn} B={sb}: member {m} differs from a one-member launch")
        if sn == n:
            shapes = {"a": a, "w": w, "g": g, "fre": fre, "fim": fim}
    log(f"check member axis E={members} L={layers} at n={n} B={rows} and n=2/8/12 B=64: forward max abs err "
        f"{worst['fwd']:.3e} (atol 2e-5), adjoint {worst['adj']:.3e} (atol 2e-5 max|ref| + 1e-6); every member "
        f"bit for bit equal to a one-member launch [{card}]")

    base = mods["config"].preset("nat_sweep")
    cfg = replace(
        base,
        data=replace(base.data, data_len=10 * TRAIN_BATCH),
        quantum=replace(base.quantum, n_qubits=n, n_layers=layers),
        train=replace(base.train, batch_size=TRAIN_BATCH, n_epochs=2, print_freq=1),
    )
    if (cfg.quantum.impl, cfg.quantum.backend) != ("auto", "auto"):
        raise AssertionError(f"the nat_sweep preset dispatches {cfg.quantum.impl!r}/{cfg.quantum.backend!r}, not auto")
    levels = cfg.quantum.noise_sweep
    # the preset's dispatch: prewarm at one member's flattened batch (as
    # train_nat_sweep calls it), then the impl each mode resolves to
    K.reset_launch_counts()
    before = dict(activity)
    entry = autotune.prewarm(cfg, batch=rows, device=DEVICE)
    torch.cuda.synchronize()
    prewarm_launches = dict(K.launches)
    if entry is None:
        raise AssertionError("nat_sweep: prewarm did not tune the preset's circuit")
    resolved = {m: resolve_impl("auto", "auto", n, layers, rows, mode=m, platform="cuda") for m in ("train", "infer")}
    log(f"nat_sweep prewarm n={n} L={layers} B={rows}: table {autotune.table_path()}, activity "
        f"{json.dumps({k: activity[k] - before.get(k, 0) for k in activity})}, launches {json.dumps(prewarm_launches)}; "
        f"resolved impl train {resolved['train']}, infer {resolved['infer']} [{card}]")
    data = mods["datasets"].GridData.synthesize(cfg.data, DEVICE)
    loader = mods["datasets"].DMLGridLoader(data, TRAIN_BATCH, "train")
    val_steps = mods["datasets"].DMLGridLoader(data, TRAIN_BATCH, "val").steps_per_epoch
    spe = loader.steps_per_epoch
    batches = [{k: b[k] for k in ("yp_img", "indicator")} for _, b in zip(range(TWIN_STEPS), loader.epoch(0))]
    states = ns.member_states(cfg, len(levels))
    noise = ns.epoch_noise(cfg, 0, TWIN_STEPS, len(levels))
    # the twin pins the impl the preset resolved to on the card, so the CPU
    # runs that impl's plain version
    twin_cfg = replace(cfg, quantum=replace(cfg.quantum, impl=resolved["train"]))
    runs = []
    saved = dict(K.launches)
    for d in (DEVICE, "cpu"):
        model, params, opt, sigmas = ns.init_sweep(twin_cfg, levels, spe, torch.device(d), states)
        losses = [ns.sweep_train_step(model, params, opt, sigmas, {k: v.to(d) for k, v in b.items()},
                                      noise[i].to(d))["loss"].cpu() for i, b in enumerate(batches)]
        runs.append((torch.stack(losses), {k: v.detach().cpu() for k, v in params.items()}))
    K.launches.update(saved)  # the twin's launches are not the main path's
    (gl, gp), (cl, cp) = runs
    if not torch.allclose(gl, cl, rtol=1e-4, atol=0.0):
        raise AssertionError(f"nat_sweep twin: per-member losses {gl.tolist()} on the card, {cl.tolist()} on the CPU")
    pw, out, tot = _twin_params_close(gp, cp, cfg.train.lr, TWIN_STEPS, "nat_sweep twin")
    log(f"nat_sweep CPU twin over {TWIN_STEPS} steps of E={len(levels)} members: per-member losses card "
        f"{[[round(x, 6) for x in r] for r in gl.tolist()]}, cpu {[[round(x, 6) for x in r] for r in cl.tolist()]} "
        f"(rtol 1e-4); params max |diff| {pw:.3e}, {out}/{tot} entries outside 1e-5 + 1e-4|p|")

    rec = Recorder()
    before = dict(activity)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    params, hist = ns.train_nat_sweep(cfg, data=data, logger=rec, workdir=str(EVAL_WORK / "nat_sweep"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    if activity != before:
        raise AssertionError(f"train_nat_sweep's prewarm measured or wrote after the phase's: {before} -> {activity}")
    epochs = cfg.train.n_epochs
    want = {"circuit_expvals_ensemble": epochs * (spe + val_steps), "circuit_adjoint_ensemble": epochs * spe}
    log(f"nat_sweep: {epochs} epochs of {spe} ensemble steps ({rows} rows, E={len(levels)} sigmas {list(levels)}) "
        f"+ validation in {wall:.2f} s; per-member val_acc {[a.tolist() for a in hist['val_acc']]}; "
        f"launches {json.dumps(counts)} [{card}]")
    if any(counts[k] != v for k, v in want.items()) or any(counts[k] for k in K.KERNELS):
        raise AssertionError(f"nat_sweep launches {counts}: want {want} and no one-member launch")
    if not all(np.isfinite(np.stack(v)).all() for v in hist.values()):
        raise AssertionError(f"nat_sweep: non-finite history {hist}")
    # the trainers' default cadence (probe_every 100) on the K-step path:
    # only the run's first chunk is fetched and logged
    logged = [r for r in rec.records if "loss" in r]
    log(f"nat_sweep at probe_every={cfg.train.probe_every}, scan_steps={cfg.train.scan_steps}: "
        f"{len(logged)} of {epochs * spe} steps' losses fetched and logged [{card}]")
    if cfg.train.probe_every != 100 or cfg.train.scan_steps < 1 or len(logged) != 1:
        raise AssertionError(f"nat_sweep: the default cadence logged {[r['step'] for r in logged]}")
    counts = {k: counts[k] + prewarm_launches[k] for k in counts}
    return counts, {"worst": worst, "shapes": shapes, "members": members, "n": n, "layers": layers, "rows": rows}


def ensemble_event_times(torch, K, ens: dict) -> dict:
    """Event-timed ms of the member-axis forward (with the states, as a
    training step writes them) and adjoint at the phase's shape, of E
    one-member launches of the same work, and of the plain versions."""
    sh, n, layers, members = ens["shapes"], ens["n"], ens["layers"], ens["members"]
    a, w, g, fre, fim = sh["a"], sh["w"], sh["g"], sh["fre"], sh["fim"]
    g_m = [g[m].contiguous() for m in range(members)]
    calls = {
        "fwd": lambda: K.fused_circuit_expvals_ensemble(a, w, n, layers, return_state=True),
        "fwd_single": lambda: [K.fused_circuit_expvals(a[m], w[m], n, layers, return_state=True) for m in range(members)],
        "adj": lambda: K.circuit_adjoint_ensemble(fre, fim, g, a, w, n, layers),
        "adj_single": lambda: [K.circuit_adjoint(fre[m], fim[m], g_m[m], a[m], w[m], n, layers) for m in range(members)],
    }
    out = {"calls": calls}
    for key, fn in calls.items():
        out[f"{key}_ms"] = event_ms(torch, fn)
    out["fwd_plain_ms"] = event_ms(torch, lambda: K.circuit_expvals_ensemble_plain(a, w, n, layers), reps=5, inner=2)
    out["adj_plain_ms"] = event_ms(
        torch, lambda: K.circuit_adjoint_ensemble_plain(fre, fim, g, a, w, n, layers), reps=5, inner=2
    )
    b = ens["rows"]
    fb, ff = circuit_work(b, n, layers, with_state=True)
    ab, af = adjoint_work(b, n, layers)
    out["fwd_bound"] = bound(members * fb, members * ff)
    out["adj_bound"] = bound(members * ab, members * af)
    return out


# one trunk's BatchNorm site in the HDCE step (2304 rows over 3 trunks, 32
# features on the 16 x 8 pilot image) and the trunks' torch momentum, 1 -
# 0.9 ** n_users at 3 users
BN_SHAPE = (768, 32, 16, 8)
BN_MOMENTUM = 1.0 - 0.9**3


def bn_relu_times(torch, K, card: str) -> dict:
    """The BatchNorm + ReLU pair at one trunk site of the HDCE step, forward
    and backward: the trunks' own call (``BatchNorm2d.forward_relu``, and
    ``torch.autograd.grad`` through it) against the plain path on the card
    on a twin module (``BatchNorm2d``'s own train forward and a ReLU;
    autograd through it with the kernel's ReLU mask, so an entry within
    rounding of 0 counts on the kernel's side): y, the three gradients and
    the running statistics, the largest errors raising past 1e-4 of the
    largest output, and ``num_batches_tracked`` equal; the wrapper's
    event-timed ms; the device time a launch by CUDA graph replays; the
    plain path's event-timed ms (forward: batch_norm, var_mean, two lerp_,
    the counter, relu; backward: autograd through it); its bound (bytes);
    and as the yardstick the cuDNN chain the port ran before, by graph
    replays: ``F.batch_norm`` + ``var_mean`` + ``relu``, and for the
    backward that chain with its autograd backward less the chain alone
    (``threshold_backward`` and cuDNN's backward). Returns ``{"fwd": {...},
    "bwd": {...}}``."""
    import torch.nn.functional as F

    from qdml_tpu_torch.models.cnn import BatchNorm2d
    from qdml_tpu_torch.telemetry.cost import bn_relu_work

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 22)
    n, c, h, w = BN_SHAPE
    off = rng.uniform(-1, 1, (1, c, 1, 1))
    x = torch.tensor(off + rng.standard_normal(BN_SHAPE), dtype=torch.float32, device=dev)
    dy = torch.tensor(rng.standard_normal(BN_SHAPE), dtype=torch.float32, device=dev)
    bn = BatchNorm2d(c, decay=1.0 - BN_MOMENTUM).to(dev).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32))
        bn.bias.copy_(torch.tensor(rng.uniform(-0.3, 0.3, c), dtype=torch.float32))
    wt, bs, eps = bn.weight.detach(), bn.bias.detach(), bn.eps
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    fused = BatchNorm2d(c, decay=1.0 - BN_MOMENTUM).to(dev).train()
    fused.load_state_dict(bn.state_dict())

    xf = x.clone().requires_grad_(True)
    y = fused.forward_relu(xf)
    dx, dw, db = torch.autograd.grad(y, (xf, fused.weight, fused.bias), dy)
    xr = x.clone().requires_grad_(True)
    z = bn(xr)
    want_y = F.relu(z)
    want_dx, want_dw, want_db = torch.autograd.grad(z * (y > 0), (xr, bn.weight, bn.bias), dy)
    errs = {}
    for what, got, want in (("y", y, want_y), ("running_mean", fused.running_mean, bn.running_mean),
                            ("running_var", fused.running_var, bn.running_var), ("dx", dx, want_dx),
                            ("dweight", dw, want_dw), ("dbias", db, want_db)):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(want.abs().max().item(), 1.0)
        errs[what] = err
        if not err <= 1e-4 * scale:
            raise AssertionError(f"bn_relu {what} at {BN_SHAPE}: max |diff| {err:.3e} against the plain path "
                                 f"(largest {scale:.3e})")
    if not int(fused.num_batches_tracked) == int(bn.num_batches_tracked) == 1:
        raise AssertionError(f"bn_relu num_batches_tracked {int(fused.num_batches_tracked)}, the plain path's "
                             f"{int(bn.num_batches_tracked)}")
    # the saved statistics the backward's timed launches take
    _, mean, invstd = K._bn_relu_fwd_launch(x, wt, bs, rm, rv, BN_MOMENTUM, eps)
    log(f"bn_relu at {BN_SHAPE} against the plain path on the card: max |diff| "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} [{card}]")

    xg = x.clone().requires_grad_(True)
    wg, bg = wt.clone().requires_grad_(True), bs.clone().requires_grad_(True)

    def library_fwd():
        out = F.relu(F.batch_norm(xg, None, None, wg, bg, True, 0.0, eps))
        torch.var_mean(xg.detach(), dim=(0, 2, 3), unbiased=False)
        return out

    def library_fwd_bwd():
        torch.autograd.grad(library_fwd(), (xg, wg, bg), dy)

    def plain_fwd_bwd():
        torch.autograd.grad(F.relu(bn(xg)), (xg, bn.weight, bn.bias), dy)

    out = {}
    for key, call, plain in (
        ("fwd", lambda: K._bn_relu_fwd_launch(x, wt, bs, rm, rv, BN_MOMENTUM, eps),
         lambda: F.relu(bn(xg))),
        ("bwd", lambda: K._bn_relu_bwd_launch(x, dy, wt, bs, mean, invstd), plain_fwd_bwd),
    ):
        bytes_moved, flops = bn_relu_work(n, c, h * w, key == "bwd")
        out[key] = {
            "ms": event_ms(torch, call),
            "device_us": graph_device_us(torch, K, call),
            "plain_ms": event_ms(torch, plain),
            "bound": bound(bytes_moved, flops),
            "max_abs_err": max(errs["y"], errs["running_mean"], errs["running_var"]) if key == "fwd"
            else max(errs["dx"], errs["dweight"], errs["dbias"]),
        }
    lib_fwd_us = graph_device_us(torch, K, library_fwd)
    lib_both_us = graph_device_us(torch, K, library_fwd_bwd)
    out["fwd"]["library_us"] = lib_fwd_us
    out["bwd"]["library_us"] = lib_both_us - lib_fwd_us
    # the plain backward's event time holds its forward too: less the forward's
    out["bwd"]["plain_ms"] -= out["fwd"]["plain_ms"]
    for key, t in out.items():
        log(f"time bn_relu_{key} {BN_SHAPE}: wrapper {t['ms']:.5f} ms, device {t['device_us']:.3f} us a launch "
            f"(graph replays), plain {t['plain_ms']:.5f} ms, cuDNN chain {t['library_us']:.3f} us (graph replays), "
            f"bound {t['bound'][0] * 1e3:.3f} us ({t['bound'][1]}) [{card}]")
    return out


# the QSC cell's front end: the flattened 3 x 3 grid's 2304 rows of 16 x 8
# pilot images, n = 8 angles (``qsc_train.dp_8q``)
QSC_FRONT_SHAPE = (2304, 2, 16, 8)
QSC_FRONT_N = 8


def qsc_front_times(torch, K, card: str) -> dict:
    """The quantum classifier's front end at the QSC cell's shape, forward
    and backward: the kernel pair (``kernels.qsc_front_end``, and
    ``torch.autograd.grad`` through it) against the plain path on the card
    (``QSCPreprocess``, cuDNN in float32; autograd through it): the angles
    and the six gradients, the largest errors raising past 1e-4 of the
    largest output (a pool window whose two largest entries differ by
    rounding alone may send one row's gradient to another entry; these
    images have none such at this bound); the wrapper's event-timed ms; the
    device time a launch by CUDA graph replays; the plain path's event-timed
    ms (backward: its forward and backward less the forward); the bound
    (operations); and as the yardstick the path the port ran before,
    ``QSCPreprocess``'s arithmetic (``kernels.qsc_front_end_plain``) on
    cuDNN's convolutions and torch's max-pool, by graph replays (backward:
    forward and backward less the forward).
    Returns ``{"fwd": {...}, "bwd": {...}}``."""
    from qdml_tpu_torch.models.cnn import QSCPreprocess
    from qdml_tpu_torch.telemetry.cost import qsc_front_work

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 24)
    b, _, h, w = QSC_FRONT_SHAPE
    n = QSC_FRONT_N
    pre = QSCPreprocess(n).to(dev)
    params = [pre[0].weight, pre[0].bias, pre[3].weight, pre[3].bias, pre[7].weight, pre[7].bias]
    x = torch.tensor(rng.standard_normal(QSC_FRONT_SHAPE), dtype=torch.float32, device=dev)
    dang = torch.tensor(rng.standard_normal((b, n)), dtype=torch.float32, device=dev)
    got = K.qsc_front_end(x, *params)
    got_grads = torch.autograd.grad(got, params, dang)
    want = pre(x)
    want_grads = torch.autograd.grad(want, params, dang)
    errs = {}
    names = ("angles", "conv1_w", "conv1_b", "conv2_w", "conv2_b", "fc_w", "fc_b")
    for what, g, wv in zip(names, (got, *got_grads), (want, *want_grads)):
        torch.cuda.synchronize()
        err = (g - wv).abs().max().item()
        scale = max(wv.abs().max().item(), 1.0)
        errs[what] = err
        if not err <= 1e-4 * scale:
            raise AssertionError(f"qsc_front {what} at {QSC_FRONT_SHAPE} n={n}: max |diff| {err:.3e} against the "
                                 f"plain path (largest {scale:.3e})")
    log(f"qsc_front at {QSC_FRONT_SHAPE} n={n} against the plain path on the card: max |diff| "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} [{card}]")

    pd = [p.detach() for p in params]
    # the yardstick's own leaves, used only inside its graphs
    wg = [p.detach().clone().requires_grad_(True) for p in params]

    def plain_fwd_bwd():
        torch.autograd.grad(pre(x), params, dang)

    def library_fwd():
        return K.qsc_front_end_plain(x, *wg)

    def library_fwd_bwd():
        torch.autograd.grad(library_fwd(), wg, dang)

    out = {}
    for key, call, plain in (
        ("fwd", lambda: K.qsc_front_end(x, *pd), lambda: pre(x)),
        ("bwd", lambda: K._qsc_front_bwd_launch(x, *pd, dang), plain_fwd_bwd),
    ):
        bytes_moved, flops = qsc_front_work(b, n, h, w, key == "bwd")
        out[key] = {
            "ms": event_ms(torch, call),
            "device_us": graph_device_us(torch, K, call),
            "plain_ms": event_ms(torch, plain),
            "bound": bound(bytes_moved, flops),
            "max_abs_err": errs["angles"] if key == "fwd" else max(errs[k] for k in names[1:]),
        }
    lib_fwd_us = graph_device_us(torch, K, library_fwd)
    lib_both_us = graph_device_us(torch, K, library_fwd_bwd)
    out["fwd"]["library_us"] = lib_fwd_us
    out["bwd"]["library_us"] = lib_both_us - lib_fwd_us
    out["bwd"]["plain_ms"] -= out["fwd"]["plain_ms"]
    for key, t in out.items():
        log(f"time qsc_front_{key} {QSC_FRONT_SHAPE} n={n}: wrapper {t['ms']:.5f} ms, device {t['device_us']:.3f} us "
            f"a launch (graph replays), plain {t['plain_ms']:.5f} ms, cuDNN + max-pool path {t['library_us']:.3f} us "
            f"(graph replays), bound {t['bound'][0] * 1e3:.3f} us ({t['bound'][1]}) [{card}]")
    return out


def trajectories_phase(torch, card: str):
    """The trajectory simulator on the card: p=0 against the clean ``tensor``
    circuit (atol 1e-6), the one-wire anchor <Z> -> (1 - 4p/3) <Z> within its
    5-sigma Monte-Carlo band, and the peak memory of n=6, L=3, B=2304, 32
    trajectories. Returns that call for the profiler's device time."""
    from qdml_tpu_torch.quantum import circuits
    from qdml_tpu_torch.quantum import statevector as sv
    from qdml_tpu_torch.quantum import trajectories as tr

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 13)
    a = torch.tensor(rng.uniform(-1, 1, (64, 6)), dtype=torch.float32, device=dev)
    w = torch.tensor(rng.uniform(0, 2 * np.pi, (3, 6, 2)), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    got = tr.run_circuit_trajectories(a, w, 6, 3, 0.0, gen, n_traj=4)
    err = (got - circuits.run_circuit(a, w, 6, 3, impl="tensor")).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"trajectories p=0: {err:.3e} from the clean circuit")
    p, b, n_traj = 0.3, 2304, 32
    angles = torch.linspace(-1.2, 1.2, b, device=dev)[:, None]
    clean = torch.cos(angles[:, 0])
    psi = circuits.angle_embed(sv.zero_state(1, (n_traj, b), device=dev), angles.expand(n_traj, b, 1), 1)
    z = sv.expvals_z(tr.apply_random_paulis(psi, tr.draw_outcomes(gen, (n_traj, b, 1), p), 1), 1)[..., 0].mean(0)
    ratio = float((z * clean).sum() / (clean * clean).sum())
    band = 5.0 / np.sqrt(b * n_traj) / float(clean.abs().mean())
    if abs(ratio - (1 - 4 * p / 3)) > band:
        raise AssertionError(f"trajectories anchor: ratio {ratio} vs {1 - 4 * p / 3} (band {band:.3e})")
    a_big = torch.tensor(rng.uniform(-1, 1, (b, 6)), dtype=torch.float32, device=dev)

    def call():
        return tr.run_circuit_trajectories(a_big, w, 6, 3, 0.05, gen, n_traj=n_traj)

    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"trajectories: p=0 within {err:.1e} of the clean tensor circuit (atol 1e-6); one-wire anchor at p={p}: "
        f"<Z> ratio {ratio:.5f} vs 1 - 4p/3 = {1 - 4 * p / 3:.5f} (5-sigma band {band:.2e}); n=6 L=3 B={b} "
        f"{n_traj} trajectories: peak memory {peak / 2**20:.1f} MiB above the inputs [{card}]")
    return call


def profile_phase(torch, mods, card: str) -> dict:
    """``cli profile`` at the default config (HDCE, S=3 trunks of 32 features,
    the 4096->2048 head, 256 rows a cell): samples/sec, step percentiles and
    the device-busy share of the traced window. The busy time is read a
    second way, from the Chrome trace the command wrote: the union of its
    kernel, memcpy and memset events must match the summary's within 1%;
    the trace's GPU user annotations (``record_function`` ranges mirrored
    onto the device) are printed beside it, counted in neither."""
    from qdml_tpu_torch.utils.profiling import union_us

    out = EVAL_WORK / "profile"
    if mods["cli"].main(["profile", f"--out={out}"]) != 0:
        raise AssertionError("cli profile failed")
    with open(out / "summary.json") as fh:
        summary = json.load(fh)
    share = summary["device_busy_share"]
    if summary["backend"] != "cuda" or not summary["samples_per_sec"] > 0 or share is None or not 0 < share <= 1.05:
        raise AssertionError(f"profile summary {summary}")
    with open(out / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    annotations = [e["dur"] for e in events if e.get("cat") == "gpu_user_annotation" and "dur" in e]
    busy = union_us(spans)
    log(f"profile trace.json: {len(spans)} device activities, {sum(s[1] - s[0] for s in spans):.1f} us summed, "
        f"{busy:.1f} us as a union; {len(annotations)} GPU user annotations, {sum(annotations):.1f} us; summary "
        f"device_busy_us {summary['device_busy_us']:.1f} [{summary['card']}]")
    if not spans or abs(busy - summary["device_busy_us"]) > 0.01 * busy:
        raise AssertionError(f"profile: the trace's device activities cover {busy:.1f} us, the summary says "
                             f"{summary['device_busy_us']:.1f}")
    log(f"profile HDCE: {summary['samples_per_sec']} samples/s over {summary['steps_traced']} traced steps of "
        f"{summary['rows_per_step']} rows; step ms {json.dumps(summary['step_ms'])}; device busy "
        f"{summary['device_busy_us']:.1f} us of a {summary['window_s'] * 1e3:.3f} ms window, share {share:.4f}; "
        f"memory {json.dumps(summary['memory'])} [{summary['card']}]")
    graph_busy_share(torch, mods, summary["card"])
    return summary


GRAPH_K = 16
GRAPH_CHUNKS = 2  # profiled chunks a path (the profiler's own processing grows with the events)


def graph_busy_share(torch, mods, card: str) -> None:
    """The device-busy share of the HDCE and the QSC n=6 ``auto`` step at
    2304 rows (the bench's batch, gathered from the grid each step) on the
    per-step path and as K=16 graph replays: 32 steps under the profiler,
    no host read between steps, the window's host wall ended by one sync;
    busy time the union of device activities (``profiling.device_busy_us``).
    The profiler adds host time to the eager steps, so their share reads
    low; replays have one launch a chunk to slow. After every other timing."""
    from torch.profiler import ProfilerActivity, profile

    from qdml_tpu_torch import bench
    from qdml_tpu_torch.utils.profiling import device_busy_us

    dev = torch.device(DEVICE)
    cfg = bench._grid_cfg()
    data, idx, snr = bench._grid(cfg, dev)
    idx_k = np.broadcast_to(idx, (GRAPH_K, *idx.shape)).copy()
    snr_k = np.full(GRAPH_K, snr, np.float32)
    idx_t, snr_t = torch.as_tensor(idx_k, device=dev), torch.as_tensor(snr_k, device=dev)
    trainers = {
        "hdce": lambda: mods["hdce"].make_trainer(cfg, dev, steps_per_epoch=10**6),
        "qsc_n6_auto": lambda: mods["qsc"].make_trainer(cfg, True, dev, steps_per_epoch=10**6),
    }
    for name, make in trainers.items():
        model, opt = make()
        model.train()
        if name == "hdce":
            def step(batch, _noise, model=model, opt=opt):
                return mods["hdce"].hdce_train_step(model, opt, batch)
        else:
            def step(batch, _noise, model=model, opt=opt):
                return mods["qsc"].classifier_train_step(model, opt, batch)
        run = mods["scan"].make_scan_steps(step, data, opt, GRAPH_K)
        for _ in range(3):  # eager warm-up chunk, capture, one replay
            run(idx_k, snr_k)

        def eager(step=step):
            for j in range(GRAPH_K):
                step(data.batch(idx_t[j], snr_t[j]), None)

        shares = {}
        for path, fn in (("per-step", eager), (f"K={GRAPH_K} graph", lambda: run(idx_k, snr_k))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(GRAPH_CHUNKS):
                    fn()
                torch.cuda.synchronize()
                window = time.perf_counter() - t0
            busy = device_busy_us(prof.events())
            shares[path] = (busy, window)
        log(f"profile {name} {GRAPH_CHUNKS * GRAPH_K} steps of 2304 rows: " + "; ".join(
            f"{path} device busy {busy:.1f} us of a {w * 1e3:.3f} ms window, share "
            + (f"{busy / (w * 1e6):.4f}" if busy else "not measured (no device time in the trace)")
            for path, (busy, w) in shares.items()) + f" [{card}]")

SCAN_DATA_LEN = 10 * TRAIN_BATCH  # 9 training steps an epoch and one validation batch
# the per-step path twice (whether two eager runs agree bit for bit), then K = 4 and 1
SCAN_RUNS = (("eager", 0), ("eager again", 0), ("K=4", 4), ("K=1", 1))


def _step_losses(records: list[dict]) -> list:
    """Each step's loss from a trainer's log at print_freq 1: one record a
    step on the per-step path, one a chunk (``losses``) on the K-step path."""
    out = []
    for r in records:
        if "losses" in r:
            out.extend(r["losses"])
        elif "loss" in r:
            out.append(r["loss"])
    return out


def scan_phase(torch, K, mods, card: str) -> dict[str, int]:
    """K steps as one CUDA graph (``train/scan.py``) for every trainer at
    full width: HDCE, SC, QSC n=6 L=3 at impl ``auto`` (the race's table;
    QuantumNAT sigma 0.01, its generator registered with the graphs), the
    DCE and the ``nat_sweep`` preset's ensemble (n=6, L=3, E=4), each one
    epoch from the same init at ``scan_steps`` 0 (twice), 4 and 1 (9 steps of
    2304 rows: K=4 runs an eager warm-up chunk, a graph of 4 and a tail graph
    of 1). Every K must give the per-step path's step losses within rtol
    1e-5 and its parameters within the Adam bound (1e-5 + 1e-4|p|, every
    entry within 1.1 * steps * lr), the same kernel launches counted, at
    most two captured graphs, and a ``scan_dispatch`` record with
    ``eligible: true``; whether losses and parameters were equal bit for bit
    is printed. Host wall per step on each path: the epoch (warm-up, capture
    and one validation batch included) over its 9 steps, and the median
    between consecutive step logs after the first two chunks (print_freq 1:
    one host read a chunk). Returns the launches of the K >= 1 runs."""
    from dataclasses import replace

    from qdml_tpu_torch.train import nat_sweep as ns

    base = every_step_logged(trainer_configs(mods["config"])["hdce"][0])  # every K's step losses are compared
    base = replace(base, data=replace(base.data, data_len=SCAN_DATA_LEN))
    data = mods["datasets"].GridData.synthesize(base.data, DEVICE)
    spe = mods["datasets"].DMLGridLoader(data, TRAIN_BATCH, "train").steps_per_epoch
    q6 = replace(base.quantum, n_qubits=6, n_layers=3, use_quantumnat=True, noise_level=0.01)
    sweep = mods["config"].preset("nat_sweep")
    sweep = replace(base, quantum=replace(sweep.quantum, n_qubits=6, n_layers=3))
    runs = {
        "hdce": lambda c, rec: mods["hdce"].train_hdce(c, data=data, logger=rec)[0].state_dict(),
        "sc": lambda c, rec: mods["qsc"].train_classifier(c, False, data=data, logger=rec)[0].state_dict(),
        "qsc_n6_auto": lambda c, rec: mods["qsc"].train_classifier(
            replace(c, quantum=q6), True, data=data, logger=rec)[0].state_dict(),
        "dce": lambda c, rec: mods["dce"].train_dce(c, data=data, logger=rec)[0].state_dict(),
        "nat_sweep": lambda c, rec: ns.train_nat_sweep(
            replace(c, quantum=sweep.quantum), data=data, logger=rec)[0],
    }
    total = {k: 0 for k in K.launches}
    for name, fn in runs.items():
        got = compare_paths(torch, K, name, fn, base, SCAN_RUNS, spe, card)
        for label, k in SCAN_RUNS:
            if k:
                for c in total:
                    total[c] += got[label]["launches"][c]
    return total


def compare_paths(torch, K, name, fn, base, paths, spe, card) -> dict:
    """One trainer ``fn(cfg, logger) -> state dict`` run for an epoch at each
    ``(label, scan_steps)`` of ``paths`` from the same init, every run held
    to the first (a per-step run): step losses within rtol 1e-5, parameters
    within the Adam bound, the same kernel launches, at most two graphs and
    a ``scan_dispatch`` record eligible exactly when K >= 1. Prints bitwise
    equality and the host wall per step; returns each run's readings."""
    from dataclasses import replace

    from qdml_tpu_torch.train import scan

    got = {}
    for label, k in paths:
        cfg = replace(base, train=replace(base.train, scan_steps=k))
        rec = Recorder()
        before = dict(scan.activity)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        params = fn(cfg, rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = [r for r in rec.records if "loss" in r]
        stamps = [r["t"] for r in steps]
        per = [(b - a) / (len(r.get("losses", [0]))) for a, b, r in zip(stamps, stamps[1:], steps[1:])]
        got[label] = {
            "losses": np.asarray(_step_losses(rec.records), dtype=np.float64),
            "params": {p: v.detach().cpu() for p, v in params.items()},
            "launches": dict(K.launches),
            "captures": scan.activity["captures"] - before["captures"],
            "replays": scan.activity["replays"] - before["replays"],
            "dispatch": [r for r in rec.records if r.get("kind") == "scan_dispatch"],
            "wall_ms_per_step": 1e3 * wall / spe,
            "steady_ms_per_step": 1e3 * statistics.median(per[2:]) if len(per) > 2 else None,
        }
    ref = got[paths[0][0]]
    if len(ref["losses"].ravel()) != spe * (ref["losses"].shape[1] if ref["losses"].ndim > 1 else 1):
        raise AssertionError(f"scan {name}: per-step path logged {ref['losses'].shape} losses for {spe} steps")
    lr = base.train.lr
    for label, k in paths[1:]:
        run = got[label]
        if run["losses"].shape != ref["losses"].shape or not np.allclose(
                run["losses"], ref["losses"], rtol=1e-5, atol=0.0):
            raise AssertionError(f"scan {name} {label}: losses {run['losses'].tolist()} vs per-step "
                                 f"{ref['losses'].tolist()} (rtol 1e-5)")
        floats = {p: v for p, v in ref["params"].items() if v.is_floating_point()}
        worst, outside, tot = _twin_params_close(run["params"], floats, lr, spe, f"scan {name} {label}")
        if any(not torch.equal(run["params"][p], v) for p, v in ref["params"].items() if p not in floats):
            raise AssertionError(f"scan {name} {label}: integer buffers differ")
        if run["launches"] != ref["launches"]:
            raise AssertionError(f"scan {name} {label}: launches {run['launches']} vs per-step {ref['launches']}")
        if run["captures"] > 2 or not run["dispatch"] or run["dispatch"][0]["eligible"] != (k > 0):
            raise AssertionError(f"scan {name} {label}: {run['captures']} graphs, dispatch {run['dispatch']}")
        bitwise = bool(np.array_equal(run["losses"], ref["losses"])) and all(
            torch.equal(run["params"][p], v) for p, v in ref["params"].items())
        log(f"scan {name} {label} against the per-step path: {spe} steps, {run['captures']} graphs captured, {run['replays']} replays; "
            f"losses max rel diff {float(np.max(np.abs(run['losses'] - ref['losses']) / np.abs(ref['losses']))):.3e} "
            f"(rtol 1e-5); params max |diff| {worst:.3e}, {outside}/{tot} outside 1e-5 + 1e-4|p|; bitwise "
            f"{'yes' if bitwise else 'no'}; launches {json.dumps({c: v for c, v in run['launches'].items() if v})}")
    walls = ", ".join(
        f"{label} {got[label]['wall_ms_per_step']:.3f}" + (
            f" (steady {got[label]['steady_ms_per_step']:.3f})" if got[label]["steady_ms_per_step"] else "")
        for label, _ in paths)
    log(f"time scan {name}: host wall ms per step, epoch incl. warm-up/capture/validation: {walls} [{card}]")
    return got


# per-step path against K = 4 graphs, for the low-precision runs
LOWP_RUNS = (("eager", 0), ("K=4", 4))
# the HDCE and DCE bfloat16 histories sit within rtol 2e-3 of JAX's on the
# CPU (tests/test_torch_port_lowp.py): the card's twin is held to the same
LOWP_TWIN_RTOL = 2e-3


def lowp_phase(torch, K, mods, card: str) -> dict[str, int]:
    """The low-precision levers at full width. Synthesis of the full grid
    (20000 samples a cell) at ``data.trig_impl`` direct, split and direct
    again, the two grids within 1e-4 of the largest entry of each other.
    Then HDCE and DCE at ``model.dtype=bfloat16`` and HDCE with
    ``train.moments_dtype=bfloat16`` too: the first 2 steps against a CPU
    twin in bfloat16 (losses within rtol 2e-3, parameters within the Adam
    bound), then one epoch (9 steps of 2304 rows) at ``scan_steps`` 0 and 4
    held to each other as the scan phase holds them, and the bfloat16-moments
    Adam's state on the card after a step: mu bfloat16, nu float32. Returns
    the kernel launches of the K = 4 runs (none: no circuit on this path)."""
    from dataclasses import replace

    from qdml_tpu_torch.train.optim import AdamLowp

    full = mods["config"].DataConfig()
    grids, secs = {}, []
    for trig in ("direct", "split", "direct"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = mods["datasets"].GridData.synthesize(replace(full, trig_impl=trig), DEVICE)
        torch.cuda.synchronize()
        secs.append((trig, time.perf_counter() - t0))
        grids.setdefault(trig, grid)
    a, b = grids["direct"].rows["h_perf"], grids["split"].rows["h_perf"]
    delta = float((a - b).abs().max()) / float(a.abs().max())
    del grids, grid, a, b
    log(f"lowp synthesis of the full grid ({full.n_scenarios}x{full.n_users} cells of {full.data_len}): "
        + ", ".join(f"trig_impl={t} {x:.3f} s" for t, x in secs)
        + f"; split vs direct h_perf max |diff| {delta:.3e} of the largest entry [{card}]")
    if delta > 1e-4:
        raise AssertionError(f"lowp: trig_impl split differs from direct by {delta:.3e}")

    base = every_step_logged(trainer_configs(mods["config"])["hdce"][0])  # every K's step losses are compared
    base = replace(base, data=replace(base.data, data_len=SCAN_DATA_LEN), model=replace(base.model, dtype="bfloat16"))
    bf16m = replace(base, train=replace(base.train, moments_dtype="bfloat16"))
    data = mods["datasets"].GridData.synthesize(base.data, DEVICE)
    loader = mods["datasets"].DMLGridLoader(data, TRAIN_BATCH, "train")
    spe = loader.steps_per_epoch
    batches = [{k: bt[k] for k in ("yp_img", "h_label", "h_perf", "indicator")}
               for _, bt in zip(range(TWIN_STEPS), loader.epoch(0))]
    runs = {
        "hdce_bf16": (base, None, lambda c, rec: mods["hdce"].train_hdce(c, data=data, logger=rec)[0].state_dict()),
        "dce_bf16": (base, "dce", lambda c, rec: mods["dce"].train_dce(c, data=data, logger=rec)[0].state_dict()),
        "hdce_bf16_bf16m": (bf16m, None,
                            lambda c, rec: mods["hdce"].train_hdce(c, data=data, logger=rec)[0].state_dict()),
    }
    total = {k: 0 for k in K.launches}
    for name, (cfg, quantum, fn) in runs.items():
        cpu_twin(torch, mods, name, cfg, quantum, batches, spe, rtol=LOWP_TWIN_RTOL)
        got = compare_paths(torch, K, name, fn, cfg, LOWP_RUNS, spe, card)
        for c in total:
            total[c] += got["K=4"]["launches"][c]
        losses = got["eager"]["losses"]
        if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"lowp {name}: step losses {losses.tolist()}")

    model, opt, step = trainee(mods, bf16m, None, DEVICE, spe)
    step({k: v for k, v in batches[0].items()}, None)
    torch.cuda.synchronize()
    states = [opt.opt.state[p] for p in opt.params]
    kinds = {(str(s["exp_avg"].dtype), str(s["exp_avg_sq"].dtype), s["step"].device.type) for s in states}
    if not isinstance(opt.opt, AdamLowp) or kinds != {("torch.bfloat16", "torch.float32", torch.device(DEVICE).type)}:
        raise AssertionError(f"lowp: bf16-moments Adam state {type(opt.opt).__name__} {kinds}")
    log(f"lowp: bf16-moments Adam after a step on the card: {len(states)} parameters, mu bfloat16, nu float32, "
        f"count on the card ({sum(s['exp_avg'].numel() for s in states)} entries a moment) [{card}]")
    return total


def mps_phase(torch, K, mods, card: str) -> None:
    """The bond-chi MPS impl on the card. At full chi against the circuit
    kernel B.2 (``pallas_circuit``) at n = 6 and 8, L = 3, B = 64: values
    within 1e-5, weight and angle gradients within 1e-4. At n = 16, chi = 16,
    B = 64: forward and backward finite, their host times, the host
    synchronisations one forward makes (``torch.cuda.set_sync_debug_mode``)
    and the forward-and-backward time at each ``torch.linalg.svd`` driver;
    and at chi = 8 (``quantum.mps_chi``'s default) and 16 how far the card's
    <Z> sits from the CPU's on the same inputs, printed only. Then a QSC at
    ``quantum.n_qubits=16``, ``impl=auto``, ``mps_chi=16`` (the race's only
    candidate, mps; chi 16, not the default 8, where the truncated state
    depends on the SVD library, ROADMAP section C) trains one epoch of 9
    steps of 288 rows on the card,
    its first 2 steps against a CPU twin (losses rtol 1e-3, the circuit
    weights' first gradient within 5e-3 max|g|: a truncating split's backward
    divides by its spectral gap in float32, tests/test_torch_port_mps.py;
    parameters within the Adam bound),
    and prints its ``scan_dispatch`` record."""
    import warnings
    from dataclasses import replace

    from qdml_tpu_torch.quantum import mps as M
    from qdml_tpu_torch.quantum.circuits import run_circuit

    dev = torch.device(DEVICE)
    saved = dict(K.launches)
    for n in (6, 8):
        rng = np.random.default_rng(SEED + n)
        a0, w0 = rng.uniform(-1, 1, (SERVE_BATCH, n)), rng.uniform(0, 2 * np.pi, (3, n, 2))
        res = {}
        for impl in ("pallas_circuit", "mps"):
            a = torch.tensor(a0, dtype=torch.float32, device=dev, requires_grad=True)
            w = torch.tensor(w0, dtype=torch.float32, device=dev, requires_grad=True)
            ev = run_circuit(a, w, n, 3, impl=impl, mps_chi=1 << (n // 2))
            (ev**2).sum().backward()
            res[impl] = (ev.detach(), w.grad, a.grad)
        errs = [(x - y).abs().max().item() for x, y in zip(res["mps"], res["pallas_circuit"])]
        log(f"mps n={n} L=3 B={SERVE_BATCH} chi={1 << (n // 2)} (full) against pallas_circuit on the card: "
            f"<Z> max |diff| {errs[0]:.3e} (1e-5), weight grad {errs[1]:.3e}, angle grad {errs[2]:.3e} (1e-4) [{card}]")
        if errs[0] > 1e-5 or max(errs[1:]) > 1e-4:
            raise AssertionError(f"mps n={n}: {errs} against pallas_circuit")
    K.launches.update(saved)  # comparison launches are not main-path launches

    n = 16
    rng = np.random.default_rng(SEED + n)
    a16 = torch.tensor(rng.uniform(-1, 1, (SERVE_BATCH, n)), dtype=torch.float32, device=dev)
    w16 = torch.tensor(rng.uniform(0, 2 * np.pi, (3, n, 2)), dtype=torch.float32, device=dev, requires_grad=True)

    def fwd():
        with torch.no_grad():
            return M.mps_circuit(a16, w16, n, 3, chi=16)

    def fwd_bwd():
        w16.grad = None
        ev = M.mps_circuit(a16, w16, n, 3, chi=16)
        (ev**2).sum().backward()
        return ev

    ev = fwd_bwd()
    torch.cuda.synchronize()
    if not (torch.isfinite(ev).all() and torch.isfinite(w16.grad).all()):
        raise AssertionError("mps n=16: non-finite <Z> or gradient")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fwd()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    f_ms, _ = host_ms(torch, fwd, reps=5)
    drivers = {}
    committed = M._svd
    for driver in (None, "gesvdj", "gesvda", "gesvd"):
        M._svd = lambda theta, d=driver: committed(theta, d)
        try:
            if driver == "gesvd":  # about 10 s a call: one timed call, no warm-up
                t0 = time.perf_counter()
                fwd_bwd()
                torch.cuda.synchronize()
                drivers[driver] = round(1e3 * (time.perf_counter() - t0), 3)
            else:
                drivers[str(driver)] = round(host_ms(torch, fwd_bwd, reps=5)[0], 3)
        except RuntimeError as e:  # a driver cuSOLVER refuses for these shapes
            drivers[str(driver)] = f"{type(e).__name__}: {str(e)[:120]}"
        finally:
            M._svd = committed
    log(f"mps n=16 L=3 B={SERVE_BATCH} chi=16: forward {f_ms:.3f} ms, {syncs} host synchronisations a forward "
        f"(3 x (15 + 29) = 132 splits); forward+backward ms by svd driver (None = torch's choice, the one "
        f"committed): {json.dumps(drivers)} [{card}]")
    with torch.no_grad():
        card8 = M.mps_circuit(a16, w16, n, 3, chi=8)
        cpu8 = M.mps_circuit(a16.cpu(), w16.detach().cpu(), n, 3, chi=8)
        card16 = M.mps_circuit(a16, w16, n, 3, chi=16)
        cpu16 = M.mps_circuit(a16.cpu(), w16.detach().cpu(), n, 3, chi=16)
    log(f"mps n=16 L=3 card (cuSOLVER) vs CPU (LAPACK) <Z> max |diff|: chi=8 {(card8.cpu() - cpu8).abs().max().item():.3e}, "
        f"chi=16 {(card16.cpu() - cpu16).abs().max().item():.3e} (printed only; ROADMAP section C) [{card}]")

    base = trainer_configs(mods["config"])["hdce"][0]
    cfg = replace(base, data=replace(base.data, data_len=320), train=replace(base.train, batch_size=32),
                  quantum=replace(base.quantum, n_qubits=16, n_layers=3, mps_chi=16))
    data = mods["datasets"].GridData.synthesize(cfg.data, DEVICE)
    loader = mods["datasets"].DMLGridLoader(data, 32, "train")
    spe = loader.steps_per_epoch
    batches = [{k: bt[k] for k in ("yp_img", "h_label", "h_perf", "indicator")}
               for _, bt in zip(range(TWIN_STEPS), loader.epoch(0))]
    # the truncating splits' backward agrees to 5e-3 of the largest gradient,
    # not entry by entry, and Adam's normalised step magnifies a small
    # entry's relative gap: the first gradient is held, the tight share not
    cpu_twin(torch, mods, "qsc_n16_mps", cfg, True, batches, spe, rtol=1e-3, grad_rtol=5e-3, tight_share=None)
    rec = Recorder()
    t0 = time.perf_counter()
    _, hist = mods["qsc"].train_classifier(cfg, True, data=data, logger=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tuned = [r for r in rec.records if r.get("kind") == "quantum_autotune"]
    dispatch = [r for r in rec.records if r.get("kind") == "scan_dispatch"]
    steps = [r["loss"] for r in rec.records if "loss" in r]
    if len(tuned) != 1 or tuned[0]["impl"] != "mps" or len(steps) != spe or not np.all(np.isfinite(steps)):
        raise AssertionError(f"mps qsc n=16: autotune {tuned}, losses {steps}")
    if not dispatch or dispatch[0]["eligible"]:
        raise AssertionError(f"mps qsc n=16: scan_dispatch {dispatch}")
    log(f"mps qsc n=16 L=3 chi=16 impl=auto -> {tuned[0]['impl']} ({json.dumps(tuned[0]['candidates'])}): one epoch "
        f"({spe} steps of {9 * 32} rows) + validation in {wall:.2f} s, losses {[round(x, 5) for x in steps]}, "
        f"history {json.dumps(hist)}; scan_dispatch {json.dumps({k: dispatch[0][k] for k in ('eligible', 'scan_steps', 'reason')})} [{card}]")


def scaling_phase(torch, K, card: str) -> dict[str, int]:
    """The bench's ``qsc_scaling`` over the whole qubit grid (n = 4..24, L = 3,
    each point's batch and chi as JAX's axis sets them, 0.25 s a candidate),
    the kernels' launch counters zeroed before and read after: the race runs
    B.1 (n <= 8) and the B.2 forward and adjoint (n <= 12) for real. Each
    point's winner, train step, samples/s and agreement are printed; a point
    that fails, or an agreement past 1e-4 where a reference exists, fails
    the run (at n = 13-14, where the reference or the winner is mps, the
    exact-chi agreement is the one held, the race chi's is printed beside
    it). Returns the launches."""
    from qdml_tpu_torch import bench

    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = bench.bench_qsc_scaling(torch.device(DEVICE), budget_s=0.25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    for p in out["points"]:
        if "error" in p:
            raise AssertionError(f"scaling n={p['n_qubits']}: {p['error']}")
        held = p.get("agreement_exact_chi", p["agreement"])
        times = {k: v.get("train_ms", v.get("error")) for k, v in p["candidates"].items()}
        log(f"scaling n={p['n_qubits']} b{p['batch']}: {p['quantum_impl']} wins (train_ms {json.dumps(times)}); "
            f"step {p['train_ms']} ms, {p['samples_per_sec']} samples/s; agreement {json.dumps(p['agreement'])}"
            + (f", at exact chi {json.dumps(p['agreement_exact_chi'])}" if "agreement_exact_chi" in p else "")
            + f" [{card}]")
        if held["reference"] is not None and held["max_abs_delta"] > 1e-4:
            raise AssertionError(f"scaling n={p['n_qubits']}: agreement {held}")
    log(f"scaling: {len(out['points'])} points in {wall:.2f} s; launches {json.dumps(counts)}")
    for k in ("qsc_expvals", "circuit_expvals", "circuit_adjoint"):
        if counts[k] == 0:
            raise AssertionError(f"scaling: the race never launched {k}")
    return counts


def routing_phase(torch, mods, card: str) -> None:
    """``serve.dispatch=auto`` at the shipped S=3: a full-width engine
    resolves ``dense`` at warmup and times nothing. Then the race itself
    (``ensure_route``, forced) at S=8 and S=64 at JAX's reduced geometry
    (8x4 pilots, 16 channels, a 256-wide head, 64 rows), and
    ``dispatch_agreement`` (balanced and skewed loads) within 1e-5 at each."""
    from qdml_tpu_torch import bench
    from qdml_tpu_torch.eval.sweep import dispatch_agreement
    from qdml_tpu_torch.models.cnn import seeded_init_
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.ops import dispatch_autotune as da
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.utils.tune_table import activity

    da.set_table_path(str(TUNE_DIR / "routing_dispatch.json"))
    from dataclasses import replace

    cfg = mods["config"].ExperimentConfig()
    # batching forced: the check below is that the routing race times nothing
    cfg = replace(cfg, serve=replace(cfg.serve, buckets=(SERVE_BATCH,), batching="bucket"))
    gen = torch.Generator().manual_seed(SEED + 17)
    engine = ServeEngine(cfg, mods["hdce"].build_hdce(cfg, "cpu", generator=gen).state_dict(),
                         build_classifier(cfg, False, "cpu", generator=gen).state_dict(), device=DEVICE)
    before = dict(activity)
    warm = engine.warmup()
    race = warm["dispatch"]["race"][str(SERVE_BATCH)]
    if warm["dispatch"]["mode"] != {str(SERVE_BATCH): "dense"} or activity != before or "only_candidate" not in \
            race["candidates"]["dense"]:
        raise AssertionError(f"routing S=3: {warm['dispatch']}, activity {before} -> {activity}")
    log(f"routing S=3 engine (serve.dispatch=auto): bucket {SERVE_BATCH} -> dense, nothing timed "
        f"({race['excluded'][0]['reason']}) [{card}]")
    dev = torch.device(DEVICE)
    for s in (8, 64):
        model = mods["hdce"].HDCE(s, bench.SCALING_FEATURES, out_dim=bench.SCALING_OUT, image_hw=bench.SCALING_HW)
        model = seeded_init_(model, torch.Generator().manual_seed(s)).to(dev).eval()
        x = torch.tensor(np.random.default_rng(s).standard_normal((SERVE_BATCH, 2, *bench.SCALING_HW)),
                         dtype=torch.float32, device=dev)
        entry = da.ensure_route(model, x, s, force=True)
        agree = dispatch_agreement(s, batch=SERVE_BATCH, device=DEVICE)
        if set(entry["candidates"]) != {"dense", "sparse"} or any("error" in c for c in entry["candidates"].values()):
            raise AssertionError(f"routing S={s}: {entry}")
        if agree["max_abs_delta"] > 1e-5 or agree["overflow_balanced"] != 0:
            raise AssertionError(f"routing S={s}: agreement {agree}")
        log(f"routing race S={s} b{SERVE_BATCH} (8x4 pilots, {bench.SCALING_FEATURES} channels): "
            f"{json.dumps(entry['candidates'])} -> {entry['best_infer']}; agreement {json.dumps(agree)} "
            f"(max |sparse - dense| <= 1e-5) [{card}]")


# the multirank phase: with fewer than 4 visible cards every rank of a world
# computes on cuda:0 and exchanges over gloo, staged through host memory
# (NCCL refuses two ranks of one communicator on one card); with 4 or more,
# rank r runs on cuda:r and the worlds take NCCL, the port's default on the
# card. The one-rank references run on cuda:0. Logs and results under
# build/chip_smoke/multirank
MR_WORK = EVAL_WORK / "multirank"
MR_DEVICE = "cuda:0"
MR_SHARED_ENV = {"QDML_TORCH_DIST_BACKEND": "gloo"}
MR_TIMEOUT_S = 300
# the sharded statevector's check: n=16, L=3, B=64 on 2 and 4 ranks (k = 1, 2)
MR_SHARDED = (16, 3, 64)
# dp_8q and federated at full width: data_len 1140 a cell gives 1026 train
# rows (4 steps of 256) and 114 validation rows (one batch), cut for time
MR_DATA_LEN, MR_STEPS = 1140, 4
# sharded_16q: 2 steps of 16 rows a cell (144 rows x 2^16 amplitudes a step;
# the one-rank tensor reference keeps every gate's state for its backward),
# data_len 36 (32 train rows, 4 validation rows), cut for time and memory
MR_SHARDED_ARGS = ("--data.data_len=36", "--train.batch_size=16")
MR_SHARDED_STEPS, MR_SHARDED_VAL = 2, 1
# the federated eval: two SNR points of 400 test samples, cut for time
MR_EVAL_TEST_LEN = 400
MR_EVAL_ARGS = (f"--eval.test_len={MR_EVAL_TEST_LEN}", "--eval.snr_grid=5,15")


def _mr_world(
    name: str, nproc: int, steps: list[str], shared: bool, inp: Path | None = None, launcher: bool = False
) -> list[dict]:
    """Run ``selfcheck`` STEPS as a world of ``nproc`` ranks, all on
    ``cuda:0`` over gloo when ``shared``, else one card a rank over NCCL;
    every rank's record, in rank order. A rank that exits non-zero, or a
    world past its timeout (killed), fails the smoke."""
    from qdml_tpu_torch.parallel.selfcheck import read_ranks, spawn_world

    out, logs = MR_WORK / name / "out", MR_WORK / name / "logs"
    argv = ["-m", "qdml_tpu_torch.parallel.selfcheck", *steps, f"--out={out}"]
    if shared:
        argv.append(f"--device={MR_DEVICE}")
    if inp is not None:
        argv.append(f"--in={inp}")
    t0 = time.perf_counter()
    rcs = spawn_world(nproc, argv, logs, env=MR_SHARED_ENV if shared else {}, timeout_s=MR_TIMEOUT_S,
                      launcher=launcher)
    if any(rcs):
        report = {}
        for f in sorted(logs.glob("*.log")):
            lines = f.read_text(errors="replace").splitlines()
            errors = [ln for ln in lines if "Error" in ln or "error" in ln or "WARN" in ln][:12]
            report[f.name] = errors + lines[-8:]
        raise AssertionError(f"multirank world {name}: exit codes {rcs}; log lines {json.dumps(report, indent=1)}")
    log(f"multirank world {name}: {nproc} ranks{' via torch.distributed.run' if launcher else ''}, "
        f"{time.perf_counter() - t0:.2f} s wall")
    return read_ranks(out, nproc)


def _mr_history(path: Path, keys: tuple[str, ...]) -> list[list[float]]:
    rows = [json.loads(line) for line in open(path) if '"epoch"' in line and "train_loss" in line]
    return [[r[k] for k in keys] for r in rows]


def _mr_same(got, want, rtol: float, what: str, card: str) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))) if want.size else 0.0
    log(f"multirank {what}: max relative error {err:.3e} (rtol {rtol}) [{card}]")
    if got.shape != want.shape or err > rtol:
        raise AssertionError(f"multirank {what}: {got.tolist()} vs one rank {want.tolist()}")
    return err


def multirank_phase(torch, K, mods, card: str) -> dict[str, int]:
    """The multi-rank paths on the card: worlds whose ranks all use
    ``cuda:0`` over host-staged gloo, or, with 4 or more visible cards, one
    card a rank over NCCL; each held against the one-rank run of the same
    work on ``cuda:0``. Returns the kernel launches of the entry-point runs
    (the training worlds), summed over their ranks."""
    from qdml_tpu_torch.quantum.circuits import run_circuit

    cli, cfg_mod = mods["cli"], mods["config"]
    shared = torch.cuda.device_count() < 4
    flag = f" --device={MR_DEVICE}" if shared else ""
    how = "host-staged gloo, ranks share one card" if shared else "NCCL, one card a rank"
    log(f"multirank: {how} ({torch.cuda.device_count()} visible cards) [{card}]")
    shutil.rmtree(MR_WORK, ignore_errors=True)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks' own
    main_path = {k: 0 for k in K.COUNTERS}

    # 1. the sharded statevector against the one-rank tensor path, n=16 L=3 B=64
    n, layers, batch = MR_SHARDED
    rng = np.random.default_rng(SEED + 12)
    a = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32)
    w = torch.tensor(rng.uniform(0, 2 * np.pi, (layers, n, 2)), dtype=torch.float32)
    a_ref, w_ref = a.to(MR_DEVICE).requires_grad_(True), w.to(MR_DEVICE).requires_grad_(True)
    want = run_circuit(a_ref, w_ref, n, layers, impl="tensor")
    (want**2).sum().backward()
    want, ga, gw = (t.detach().cpu().numpy() for t in (want, a_ref.grad, w_ref.grad))
    inp = MR_WORK / "circuit_in"
    inp.mkdir(parents=True)
    torch.save({"cases": [{"n": n, "layers": layers, "angles": a, "weights": w}], "reps": 5}, inp / "circuit.pt")
    for k_ranks in (2, 4):
        for r in _mr_world(f"sharded_k{k_ranks}", k_ranks, ["circuit"], shared, inp):
            got = r["steps"][0]["cases"][0]
            errs = {key: float(np.max(np.abs(np.asarray(got[key]) - ref)))
                    for key, ref in (("ev", want), ("g_angles", ga), ("g_weights", gw))}
            for key, ref in (("ev", want), ("g_angles", ga), ("g_weights", gw)):
                np.testing.assert_allclose(got[key], ref, rtol=1e-3, atol=1e-4, err_msg=f"rank {r['rank']} {key}")
            want_dev = MR_DEVICE if shared else f"cuda:{r['rank']}"
            if got["device"] != want_dev:
                raise AssertionError(f"sharded rank {r['rank']} ran on {got['device']}, not {want_dev}")
            if got["rotation_layer_launches_per_forward"] != layers:
                raise AssertionError(f"sharded rank {r['rank']}: {got['rotation_layer_launches_per_forward']} "
                                     f"B.3 launches a forward, want {layers}")
            log(f"multirank sharded n={n} L={layers} B={batch} ranks={k_ranks} rank {r['rank']}: shard "
                f"({batch}, {got['shard_amplitudes']}) on {got['device']}, B.3 launches a forward "
                f"{got['rotation_layer_launches_per_forward']}, max abs err vs one-rank tensor {errs}, "
                f"fwd {got['fwd_ms']:.3f} ms (exchanges {got['fwd_exchange_ms']:.3f} ms, "
                f"{got['fwd_exchange_ms'] / got['fwd_ms']:.1%}), fwd+bwd {got['fwd_bwd_ms']:.3f} ms "
                f"(exchanges {got['fwd_bwd_exchange_ms']:.3f} ms, "
                f"{got['fwd_bwd_exchange_ms'] / got['fwd_bwd_ms']:.1%}); {how} "
                f"[{card}]")

    def one_rank(argv: list[str]) -> None:
        if cli.main([*argv, f"--device={MR_DEVICE}"]) != 0:
            raise AssertionError(f"one-rank cli {argv} failed")

    def add(ranks: list[dict]) -> None:
        for r in ranks:
            for step in r["steps"]:
                for k, v in step["launches"].items():
                    main_path[k] += v

    # 2. train-qsc --preset=sharded_16q on 4 ranks against one rank (tensor at n=16)
    wd = MR_WORK / "sharded_16q"
    args = ["train-qsc", "--preset=sharded_16q", *MR_SHARDED_ARGS, "--train.n_epochs=1"]
    ranks = _mr_world("sharded_16q", 4, [f"cli:{' '.join(args)}{flag} --train.workdir={wd / 'many'}"], shared)
    one_rank([*args, f"--train.workdir={wd / 'one'}"])
    keys = ("train_loss", "val_loss", "val_acc")
    _mr_same(_mr_history(wd / "many" / "Pn_128" / "sharded_16q" / "train-qsc.metrics.jsonl", keys),
             _mr_history(wd / "one" / "Pn_128" / "sharded_16q" / "train-qsc.metrics.jsonl", keys),
             1e-4, "sharded_16q train-qsc 4 ranks vs 1 (train loss, val loss, val acc)", card)
    b3 = [r["steps"][0]["launches"]["rotation_layer"] for r in ranks]
    want_b3 = 3 * (MR_SHARDED_STEPS + MR_SHARDED_VAL)  # L forwards a training step and a validation batch
    log(f"multirank sharded_16q: B.3 launches by rank {b3} (want {want_b3} each) [{card}]")
    if b3 != [want_b3] * 4:
        raise AssertionError(f"sharded_16q: B.3 launches by rank {b3}, want {want_b3} on every rank")
    add(ranks)

    # 3. dp_8q: train-hdce and train-qsc on 2 ranks (through torch.distributed.run)
    wd = MR_WORK / "dp_8q"
    common = ["--preset=dp_8q", f"--data.data_len={MR_DATA_LEN}", "--train.n_epochs=1",
              f"--quantum.autotune_table={wd / 'qsc_impl.json'}"]
    ranks = _mr_world("dp_8q", 2, [
        f"cli:{cmd} {' '.join(common)}{flag} --train.workdir={wd / 'many'}"
        for cmd in ("train-hdce", "train-qsc")
    ], shared, launcher=True)
    for cmd in ("train-hdce", "train-qsc"):
        one_rank([cmd, *common, f"--train.workdir={wd / 'one'}"])
    for cmd, keys in (("train-hdce", ("train_loss", "val_nmse")), ("train-qsc", ("train_loss", "val_loss", "val_acc"))):
        _mr_same(_mr_history(wd / "many" / "Pn_128" / "dp_8q" / f"{cmd}.metrics.jsonl", keys),
                 _mr_history(wd / "one" / "Pn_128" / "dp_8q" / f"{cmd}.metrics.jsonl", keys),
                 1e-4, f"dp_8q {cmd} 2 ranks vs 1 ({', '.join(keys)})", card)
    for r in ranks:
        qsc = r["steps"][1]["launches"]
        log(f"multirank dp_8q rank {r['rank']} train-qsc launches: {json.dumps(qsc)} [{card}]")
        if qsc["circuit_expvals"] < MR_STEPS or qsc["circuit_adjoint"] < MR_STEPS:
            raise AssertionError(f"dp_8q rank {r['rank']}: B.2 forward/adjoint launches {qsc}")
    add(ranks)

    # 4. federated: train-hdce on 3 ranks, then eval and the restored h on 3 ranks
    wd = MR_WORK / "federated"
    common = ["--preset=federated", f"--data.data_len={MR_DATA_LEN}", "--train.n_epochs=1"]
    one_rank(["train-sc", *common, f"--train.workdir={wd / 'many'}"])  # the classifier eval restores
    cfg = cfg_mod.from_args([*common, f"--train.workdir={wd / 'many'}"])
    x = torch.tensor(np.random.default_rng(SEED + 13).standard_normal((3, 64, 2, *cfg.image_hw)), dtype=torch.float32)
    hin = MR_WORK / "hdce_h_in"
    hin.mkdir(parents=True)
    torch.save({"cfg": cfg, "workdir": cli.workdir_of(cfg), "tag": "hdce_last", "x": x}, hin / "hdce_h.pt")
    ranks = _mr_world("federated", 3, [
        f"cli:train-hdce {' '.join(common)}{flag} --train.workdir={wd / 'many'}",
        f"cli:eval {' '.join(common)} {' '.join(MR_EVAL_ARGS)}{flag} "
        f"--train.workdir={wd / 'many'} --eval.results_dir={wd / 'results_many'}",
        "hdce-h",
    ], shared, hin)
    one_rank(["train-hdce", *common, f"--train.workdir={wd / 'one'}"])
    one_rank(["eval", *common, *MR_EVAL_ARGS, f"--train.workdir={wd / 'many'}", f"--eval.results_dir={wd / 'results_one'}"])
    _mr_same(_mr_history(wd / "many" / "Pn_128" / "federated" / "train-hdce.metrics.jsonl", ("train_loss", "val_nmse")),
             _mr_history(wd / "one" / "Pn_128" / "federated" / "train-hdce.metrics.jsonl", ("train_loss", "val_nmse")),
             1e-4, "federated train-hdce 3 ranks vs 1 (train loss, val nmse)", card)
    got = json.loads((wd / "results_many" / "quantum_classical_comparison.json").read_text())
    ref = json.loads((wd / "results_one" / "quantum_classical_comparison.json").read_text())
    if got["snr"] != ref["snr"] or set(got["nmse_db"]) != set(ref["nmse_db"]) or set(got["acc"]) != set(ref["acc"]):
        raise AssertionError(f"federated eval: {got} vs one rank {ref}")
    for clf in ref["acc"]:  # the same predictions, but for a row on a cuDNN rounding tie
        np.testing.assert_allclose(got["acc"][clf], ref["acc"][clf], rtol=0, atol=1.01 / MR_EVAL_TEST_LEN, err_msg=clf)
    _mr_same([got["nmse_db"][c] for c in sorted(ref["nmse_db"])], [ref["nmse_db"][c] for c in sorted(ref["nmse_db"])],
             1e-4, "federated eval 3 ranks vs 1 (per-SNR NMSE dB of every curve)", card)
    hdce = mods["hdce"].build_hdce(cfg, MR_DEVICE)
    from qdml_tpu_torch.train.checkpoint import restore_params

    hdce.load_state_dict(restore_params(cli.workdir_of(cfg), "hdce_last", MR_DEVICE)[0]["params"])
    with torch.no_grad():
        h_one = hdce(x.to(MR_DEVICE)).cpu().numpy()
    h_many = torch.load(MR_WORK / "federated" / "out" / "h.pt").numpy()
    h_err = float(np.max(np.abs(h_many - h_one)))
    log(f"multirank federated: rank 0's checkpoint on one rank vs the 3-rank model, h of a fixed (3, 64) batch: "
        f"max abs err {h_err:.3e} (max |h| {np.abs(h_one).max():.3e}) [{card}]")
    np.testing.assert_allclose(h_many, h_one, rtol=1e-4, atol=1e-5)
    add(ranks)
    log(f"multirank main-path launches (training worlds, summed over ranks): {json.dumps(main_path)} [{card}]")
    return main_path


# mesh serving: buckets (1, 8, 64); the data=4 layout and the expert-sharded
# fed=3 layout (data=2 over logical positions on one card, data=1 over real
# cards); loadgen through 2 replicas x 2 workers at poisson 1000 rps, 2048
# requests (cut for time), with one hot-swap mid-traffic
MESH_BUCKETS = "1,8,64"
MESH_RPS, MESH_REQUESTS = 1000.0, 2048
# the control loop (scripts/control_dryrun.py's settings): drift of scenario
# 0 at step 4; HDCE and QSC trained 4 epochs on data_len 512 a cell, batch 32
# (cut from 20000 and the dryrun's 6/10 epochs, for time); loadgen 1536
# requests at 500 rps, drift from the middle (cut for time)
CTL_WORK = EVAL_WORK / "control"
CTL_DRIFT_SCENARIO, CTL_DRIFT_STEP = 0, 4
CTL_ARGS = (
    "--name=control", "--quantum.n_qubits=6", "--quantum.n_layers=3", "--data.data_len=512",
    "--train.batch_size=32", "--train.n_epochs=4", f"--serve.buckets={MESH_BUCKETS}", "--serve.max_batch=64",
    "--serve.batching=bucket", "--serve.max_wait_ms=2", f"--serve.drift_step={CTL_DRIFT_STEP}",
    f"--serve.drift_scenario={CTL_DRIFT_SCENARIO}", "--serve.replicas=2", "--serve.workers=2",
    "--control.ft_steps=300", "--control.ft_batch=32", "--control.probe_n=96", "--control.min_gain_db=0.3",
    "--control.tol_db=0.5", "--control.watch_ticks=2", "--control.autoscale=false",
)
CTL_RPS, CTL_REQUESTS = 500.0, 1536


def _hold_either(refs: list[tuple], h: np.ndarray, pred: np.ndarray, what: str) -> list[int]:
    """Each served row against one of several CPU twins (a hot-swap: the old
    weights' and the new): held as :func:`_hold_served` holds a row, against
    the twin it matches; the rows each twin explains."""
    tols = [1e-4 * float(np.abs(r[0]).max()) + 1e-5 for r in refs]
    counts = [0] * len(refs)
    for i in range(len(h)):
        for k, (h_ref, pred_ref, logp) in enumerate(refs):
            if pred[i] == pred_ref[i] and float(np.abs(h[i] - h_ref[i]).max()) <= tols[k]:
                counts[k] += 1
                break
        else:
            unsure = all(float(np.diff(np.sort(r[2][i])[-2:])[0]) <= 1e-4 for r in refs)
            if not unsure:
                raise AssertionError(f"{what}: row {i} matches no CPU twin")
    if not np.isfinite(h).all():
        raise AssertionError(f"{what}: non-finite h")
    return counts


def _profiled_loadgen(torch, run) -> tuple[dict, float, float]:
    """``run()`` (a ``run_loadgen`` call) under the torch profiler:
    ``(summary, busy us, window s)``, busy the union of the device
    activities of every card."""
    from torch.profiler import ProfilerActivity, profile

    from qdml_tpu_torch.utils.profiling import device_busy_us

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sm = run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return sm, device_busy_us(prof.events()), window


def mesh_serve_phase(torch, K, mods, card: str, real: bool) -> dict[str, int]:
    """Mesh serving at full width (QSC n=6 L=3 ``auto``, buckets 1, 8, 64):
    the engine over ``make_local_mesh`` positions on ``cuda:0`` (one card) or
    ``serve_mesh`` over the real cards (``real``), data=4, then fed=3 with
    expert sharding dense and forced sparse + ragged; every answer against
    the CPU twin without a mesh, B.2 launched once a row slice, a NaN/Inf
    pad tail inert; then a 2x2 pool under ``run_loadgen`` at poisson 1000
    rps with one hot-swap mid-traffic, beside the one-device engine at the
    same rate. Returns the traffic windows' launches."""
    from dataclasses import replace

    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.parallel.mesh import make_local_mesh, serve_mesh
    from qdml_tpu_torch.serve.batcher import pick_bucket
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.loadgen import make_request_samples, run_loadgen
    from qdml_tpu_torch.serve.server import ReplicaPool
    from qdml_tpu_torch.serve.types import Prediction
    from qdml_tpu_torch.telemetry.spans import get_sink, set_sink

    zero = {"measure": 0, "table_write": 0, "kernel_build": 0}
    base = mods["config"].from_args(["--quantum.n_qubits=6", "--quantum.n_layers=3", f"--serve.buckets={MESH_BUCKETS}",
                                     "--serve.max_batch=64"])
    weights = []
    for seed in (SEED + 41, SEED + 42):
        gen = torch.Generator().manual_seed(seed)
        weights.append((mods["hdce"].build_hdce(base, "cpu", generator=gen).state_dict(),
                        build_classifier(base, True, "cpu", generator=gen).state_dict()))
    twins = [ServeEngine(base, *w, quantum=True, device="cpu") for w in weights]
    how = "the real cards (serve_mesh)" if real else "logical positions on cuda:0 (make_local_mesh)"

    def layout(fed: int, data: int, **serve):
        cfg = replace(base, mesh=replace(base.mesh, fed_axis=fed, data_axis=data, model_axis=1),
                      serve=replace(base.serve, **serve))
        mesh = serve_mesh(cfg, DEVICE) if real else make_local_mesh(cfg.mesh, [torch.device("cuda", 0)] * (fed * data))
        if mesh is None or mesh.shape != {"fed": fed, "data": data, "model": 1}:
            raise AssertionError(f"mesh_serve: no {fed}x{data}x1 mesh ({mesh})")
        return cfg, mesh

    fed_data = 1 if real else 2
    rng = np.random.default_rng(SEED + 43)
    requests = {n: rng.standard_normal((n, *base.image_hw, 2)).astype(np.float32) for n in REQUEST_SIZES}
    refs = {n: _twin_reference(torch, twins[0], x) for n, x in requests.items()}
    launches = {k: 0 for k in K.COUNTERS}
    for name, (fed, data), knobs in (
        ("data4", (1, 4), {"batching": "bucket"}),
        (f"fed3_data{fed_data}_dense_bucket", (3, fed_data), {"expert_sharding": True, "batching": "bucket"}),
        (f"fed3_data{fed_data}_sparse_ragged", (3, fed_data),
         {"expert_sharding": True, "dispatch": "sparse", "batching": "ragged"}),
    ):
        cfg, mesh = layout(fed, data, **knobs)
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, *weights[0], quantum=True, mesh=mesh)
        warm = eng.warmup()
        impls = {b: (r["impl"], r["slice_batch"]) for b, r in eng.quantum_impl.items()}
        log(f"mesh_serve {name} over {how}: devices {[str(d) for d in mesh.devices.flat]}, warmup "
            f"{time.perf_counter() - t0:.2f} s, sharding {json.dumps(warm['sharding'])}, mesh {json.dumps(warm['mesh'])}, "
            f"dispatch {json.dumps(warm['dispatch']['mode'])}, batching {json.dumps(warm['batching']['mode'])}, "
            f"impl (raced at the bucket, slice rows) {json.dumps(impls)} [{card}]")
        if {i for i, _ in impls.values()} != {"pallas_circuit"}:
            raise AssertionError(f"mesh_serve {name}: a bucket does not run B.2: {impls}")
        if name.endswith("sparse_ragged"):
            # NaN/Inf in the pad tail of the 64-row tier: valid rows unchanged and finite
            x = requests[64]
            for n in (3, 37):
                xz = np.zeros((64, *base.image_hw, 2), np.float32)
                xz[:n] = x[:n]
                clean = eng.forward_tier(xz, n)[0][:n].cpu()
                xp = np.full_like(xz, np.nan)
                xp[n + 1 :: 3] = np.inf
                xp[:n] = x[:n]
                h, _, conf, _ = eng.forward_tier(xp, n)
                if not (torch.isfinite(h).all() and torch.isfinite(conf).all() and torch.equal(h[:n].cpu(), clean)):
                    raise AssertionError(f"mesh_serve {name}: the NaN/Inf pad tail reached a row (n={n})")
            log(f"mesh_serve {name}: NaN/Inf pad tails at fills 3 and 37 of 64 left the valid rows bit for bit "
                f"and every row finite [{card}]")
        work0 = eng.request_path_work()
        K.reset_launch_counts()
        slices, errs = 0, {}
        for n, x in requests.items():
            h, pred, conf, info = eng.infer(x)
            errs[n] = _hold_served(refs[n], h, pred, f"mesh_serve {name} n={n}")["max_abs_err"]
            slices += sum(eng._slices(pick_bucket(min(64, n - lo), eng.buckets)) for lo in range(0, n, 64))
        torch.cuda.synchronize()
        b2 = K.launches["circuit_expvals"]
        for k in launches:
            launches[k] += K.launches[k]
        log(f"mesh_serve {name}: requests {list(requests)} against the CPU twin max|h - h_cpu| "
            f"{json.dumps({n: f'{e:.3e}' for n, e in errs.items()})}; B.2 launches {b2} for {slices} row slices "
            f"[{card}]")
        if b2 != slices:
            raise AssertionError(f"mesh_serve {name}: B.2 launched {b2} times for {slices} row slices")
        if eng.request_path_work() != work0 or work0 != zero:
            raise AssertionError(f"mesh_serve {name}: request-path work {eng.request_path_work()}")

    # a 2x2 pool on the data=4 engine under poisson traffic, one hot-swap
    # mid-traffic, beside the one-device engine at the same rate
    cfg, mesh = layout(1, 4, batching="ragged", replicas=2, workers=2)
    eng = ServeEngine(cfg, *weights[0], quantum=True, mesh=mesh)
    eng.warmup()
    samples = make_request_samples(cfg, MESH_REQUESTS)
    x = samples["x"]
    refs2 = [_twin_reference(torch, t, x) for t in twins]
    tally = _ServeTally(K, "loadgen_offline_reference")
    pool = ReplicaPool(eng, sink=tally, log_requests=False).start()
    swap: dict = {}

    def swapper():
        # from the first served batch on: on a slow host the traffic's queue
        # sheds its tail, so a swap timed by the clock could land after the
        # last served row
        while tally.at is None or not tally.buckets:
            time.sleep(0.005)
        t = time.perf_counter()
        swap.update(eng.swap_params(*weights[1]))
        swap["ms"] = (time.perf_counter() - t) * 1e3

    results: list = []
    prev = get_sink()
    K.reset_launch_counts()
    set_sink(tally)
    th = threading.Thread(target=swapper, daemon=True)
    th.start()
    try:
        sm, busy, window = _profiled_loadgen(torch, lambda: run_loadgen(
            cfg, eng, rate=MESH_RPS, n=MESH_REQUESTS, deadline_ms=TIER_DEADLINE_MS, samples=samples, pool=pool,
            results=results))
        th.join(timeout=60.0)
    finally:
        set_sink(prev)
        pool.stop()
    b2 = K.launches["circuit_expvals"] - tally.at["circuit_expvals"]
    slices = sum(eng._slices(b) for b in tally.buckets)
    for k in launches:
        launches[k] += K.launches[k] - tally.at[k]
    served = [r for r in results if isinstance(r, Prediction)]
    ids = np.array([r.rid for r in served], dtype=np.int64)
    explained = _hold_either([tuple(a[ids] for a in r) for r in refs2], np.stack([r.h for r in served]),
                             np.array([r.scenario for r in served]), "mesh_serve 2x2 loadgen across the swap")
    lat = sm["latency_ms"] or {}
    log(f"mesh_serve loadgen data=4 over {how}, 2 replicas x 2 workers, ragged, poisson {MESH_RPS:g} rps "
        f"n={MESH_REQUESTS} deadline {TIER_DEADLINE_MS:g} ms, under the profiler: rps {sm['rps']}, offered "
        f"{sm['offered_rps']}, p50 {lat.get('p50_ms')} ms, p99 {lat.get('p99_ms')} ms, SLO {json.dumps(sm['slo'])}, "
        f"shed {json.dumps(sm['shed'])}, batches {len(tally.buckets)}, B.2 launches in the traffic window {b2} for "
        f"{slices} row slices, hot-swap mid-traffic epoch {swap.get('epoch')} in {swap.get('ms', float('nan')):.2f} ms "
        f"work {json.dumps(swap.get('work'))}; rows explained by the old / new weights' CPU twin {explained}; "
        f"request-path work {json.dumps(sm['compile_cache_after_warmup'])}; device busy {busy:.1f} us of a "
        f"{window * 1e3:.3f} ms call, share {busy / (window * 1e6):.4f} [{card}]")
    if sm["stranded_futures"] or sm["failed_requests"] or sm["completed"] + sm["n_shed"] != MESH_REQUESTS:
        raise AssertionError(f"mesh_serve loadgen: stranded {sm['stranded_futures']}, failed {sm['failed_requests']}")
    if sm["compile_cache_after_warmup"] != zero or swap.get("work") != zero or eng.swap_epoch != 1:
        raise AssertionError(f"mesh_serve loadgen: request-path work {sm['compile_cache_after_warmup']}, swap {swap}")
    if b2 != slices:
        raise AssertionError(f"mesh_serve loadgen: B.2 launched {b2} times for {slices} row slices")
    if min(explained) == 0:
        raise AssertionError(f"mesh_serve loadgen: the swap did not land mid-traffic ({explained})")
    one = replace(base, serve=replace(base.serve, batching="ragged", replicas=2, workers=2))
    eng1 = ServeEngine(one, *weights[0], quantum=True, device=DEVICE)
    sm1, busy1, window1 = _profiled_loadgen(torch, lambda: run_loadgen(
        one, eng1, rate=MESH_RPS, n=MESH_REQUESTS, deadline_ms=TIER_DEADLINE_MS, samples=samples))
    lat1 = sm1["latency_ms"] or {}
    log(f"mesh_serve loadgen beside it, the one-device engine on {DEVICE}, 2 replicas x 2 workers, ragged, poisson "
        f"{MESH_RPS:g} rps n={MESH_REQUESTS}, under the profiler: rps {sm1['rps']}, p50 {lat1.get('p50_ms')} ms, "
        f"p99 {lat1.get('p99_ms')} ms, SLO {json.dumps(sm1['slo'])}, batches {sm1['batches']}, parity "
        f"{sm1['parity_max_abs_err']:.3e}, device busy share {busy1 / (window1 * 1e6):.4f} [{card}]")
    if sm1["stranded_futures"] or sm1["compile_cache_after_warmup"] != zero:
        raise AssertionError(f"mesh_serve one-device loadgen: {sm1['stranded_futures']}, {sm1['compile_cache_after_warmup']}")
    log(f"mesh_serve launches (traffic windows): {json.dumps(launches)} [{card}]")
    return launches


def control_phase(torch, K, mods, card: str) -> dict[str, int]:
    """The control loop at full width on the mesh of the mesh_serve phase
    (data=4 logical positions on ``cuda:0``), ``scripts/control_dryrun.py``'s
    settings: HDCE and QSC (n=6 L=3 ``auto``) trained on the card, a 2x2
    pool on the mesh engine under ``run_loadgen`` with drift from the middle
    while a dry-run ``FleetController`` on ``PoolPoller`` watches, the
    loadgen's drift-scenario windows replayed into ``observe_parity``, then
    one tick: fine-tune -> canary -> explicit-tag swap -> watch -> confirm
    or rollback; last, ``cli serve`` and ``cli control --ticks=3
    --control.dry_run=true`` as processes. Returns the traffic windows'
    launches."""
    from dataclasses import replace

    from qdml_tpu_torch.control.loop import FleetController, PoolPoller
    from qdml_tpu_torch.parallel.mesh import make_local_mesh
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.loadgen import arrival_times, make_request_samples, run_loadgen
    from qdml_tpu_torch.serve.server import ReplicaPool
    from qdml_tpu_torch.serve.types import Prediction
    from qdml_tpu_torch.telemetry.spans import get_sink, set_sink
    from qdml_tpu_torch.train.checkpoint import restore_params

    zero = {"measure": 0, "table_write": 0, "kernel_build": 0}
    shutil.rmtree(CTL_WORK, ignore_errors=True)
    cfg = mods["config"].from_args([*CTL_ARGS, f"--train.workdir={CTL_WORK / 'ws'}", "--mesh.data_axis=4"])
    wd = mods["cli"].workdir_of(cfg)
    t0 = time.perf_counter()
    mods["hdce"].train_hdce(cfg, device=DEVICE, workdir=wd)
    t_h = time.perf_counter() - t0
    mods["qsc"].train_classifier(cfg, quantum=True, device=DEVICE, workdir=wd)
    log(f"control: trained HDCE {t_h:.2f} s and QSC (n=6 L=3 auto) {time.perf_counter() - t0 - t_h:.2f} s on the card "
        f"(data_len {cfg.data.data_len}, {cfg.train.n_epochs} epochs, batch {cfg.train.batch_size}) [{card}]")
    mesh = make_local_mesh(cfg.mesh, [torch.device("cuda", 0)] * 4)

    class TimedPoller(PoolPoller):
        def __init__(self, *args):
            super().__init__(*args)
            self.swap_ms: list[float] = []

        def swap(self, tags):
            t = time.perf_counter()
            rec = super().swap(tags)
            self.swap_ms.append((time.perf_counter() - t) * 1e3)
            return rec

    engine = ServeEngine.from_workdir(cfg, wd, mesh=mesh)
    engine.warmup()
    tally = _ServeTally(K, "loadgen_offline_reference")
    pool = ReplicaPool(engine, sink=tally, log_requests=False).start()
    poller = TimedPoller(pool, engine, wd)
    ctrl = FleetController(cfg, wd, poller, engine=engine, sink=tally, drift_step_hint=CTL_DRIFT_STEP)
    ctrl.dry_run = True  # detection only while traffic runs, as the dryrun
    samples = make_request_samples(cfg, CTL_REQUESTS, drift_at=CTL_REQUESTS // 2, drift_step=CTL_DRIFT_STEP,
                                   drift_scenario=CTL_DRIFT_SCENARIO)
    launches = {k: 0 for k in K.COUNTERS}
    prev = get_sink()
    set_sink(tally)
    K.reset_launch_counts()
    thread, stop = ctrl.run_in_thread(interval_s=0.25)
    try:
        sm_b = run_loadgen(cfg, engine, rate=CTL_RPS, n=CTL_REQUESTS, deadline_ms=2000.0, samples=samples,
                           pool=pool, drift_at=CTL_REQUESTS // 2)
    finally:
        stop.set()
        thread.join(timeout=10.0)
        set_sink(prev)
    b2 = K.launches["circuit_expvals"] - tally.at["circuit_expvals"]
    slices = sum(engine._slices(b) for b in tally.buckets)
    for k in launches:
        launches[k] += K.launches[k] - tally.at[k]
    if b2 != slices:
        raise AssertionError(f"control: B.2 launched {b2} times for {slices} row slices")
    # the drift's wall time: the traffic span's start plus the schedule's arrival at drift_at
    t_drift = tally.spans["loadgen_traffic.ts"] + arrival_times(
        CTL_REQUESTS, CTL_RPS, np.random.default_rng(0), process=cfg.serve.arrival,
        burstiness=cfg.serve.burstiness)[CTL_REQUESTS // 2]
    live_events = [(t, r) for t, name, r in tally.records if name == "drift_event"]
    early = [r for t, r in live_events if t < t_drift and r["scenario"] != CTL_DRIFT_SCENARIO]
    win = sm_b["windows"]
    parity = [ctrl.observe_parity(CTL_DRIFT_SCENARIO, c["nmse_db_drift_scenario"])
              for c in win["chunks"] if c.get("nmse_db_drift_scenario") is not None]
    parity = [e for e in parity if e]
    lat_b = sm_b["latency_ms"] or {}
    log(f"control traffic: 2x2 pool on the data=4 mesh, poisson {CTL_RPS:g} rps n={CTL_REQUESTS}, drift of scenario "
        f"{CTL_DRIFT_SCENARIO} at step {CTL_DRIFT_STEP} from request {CTL_REQUESTS // 2}: rps {sm_b['rps']}, p50 "
        f"{lat_b.get('p50_ms')} ms, NMSE of the drifting family pre {win['pre_drift']['nmse_db_drift_scenario']} dB, "
        f"post {win['post_drift']['nmse_db_drift_scenario']} dB; live detector events {[r for _, r in live_events]}, "
        f"before the drift on scenarios 1-2: {early}; parity replay events {parity}; active {ctrl.monitor.active()}; "
        f"B.2 launches {b2} for {slices} row slices [{card}]")
    if early:
        raise AssertionError(f"control: drift events on undrifted scenarios before the drift: {early}")
    if not any(s == CTL_DRIFT_SCENARIO for s, _ in ctrl.monitor.active()):
        raise AssertionError("control: the drift of scenario 0 was never detected")
    if sm_b["stranded_futures"] or sm_b["failed_requests"] or sm_b["compile_cache_after_warmup"] != zero:
        raise AssertionError(f"control traffic: {sm_b['stranded_futures']}, {sm_b['compile_cache_after_warmup']}")

    # adapt: fine-tune -> canary -> explicit-tag swap
    ctrl.dry_run = ctrl.deployer.dry_run = False
    base_sd = restore_params(wd, "hdce_best")[0]["params"]
    t = time.perf_counter()
    set_sink(tally)  # the fine-tune's and the canary's spans
    try:
        out = ctrl.tick()
    finally:
        set_sink(prev)
    tick_s = time.perf_counter() - t
    adapted = [e for e in out["events"] if e.get("action") == "adapted"]
    if not adapted:
        raise AssertionError(f"control: adaptation did not complete: {out['events']}")
    rec = adapted[0]
    ft, canary, dep = rec["finetune"], rec["canary"], rec["deploy"]
    new_sd = restore_params(wd, "hdce_last")[0]["params"]
    frozen = [k for k in base_sd if not k.startswith(f"trunks.{CTL_DRIFT_SCENARIO}.")]
    same = all(torch.equal(base_sd[k].view(torch.int32) if base_sd[k].dtype == torch.float32 else base_sd[k],
                           new_sd[k].view(torch.int32) if new_sd[k].dtype == torch.float32 else new_sd[k])
               for k in frozen)
    ft_s = tally.spans.get("control_finetune")
    log(f"control adapt: fine-tune {json.dumps(ft)} in {ft_s:.3f} s ({ft['steps'] / ft_s:.1f} steps/s); canary "
        f"passed {canary['passed']} gain {canary['gain_db']} dB (min {canary['min_gain_db']}), worst base regress "
        f"{canary['worst_base_regress_db']} dB in {tally.spans.get('control_canary', float('nan')):.3f} s; swap tags "
        f"{json.dumps(dep['swap']['tags'])} work {json.dumps(dep['swap']['work'])} in {poller.swap_ms[-1]:.2f} ms; "
        f"head and trunks 1-2 of hdce_last bit-equal to hdce_best: {same} ({len(frozen)} tensors); tick {tick_s:.2f} s "
        f"[{card}]")
    if not ft["val_nmse_db_after"] < ft["val_nmse_db_before"]:
        raise AssertionError(f"control: the fine-tune did not improve its validation NMSE: {ft}")
    if not same:
        raise AssertionError("control: hdce_last's head or an undrifted trunk differs from the base")
    if canary["passed"] is not True or dep["swap"]["work"] != zero:
        raise AssertionError(f"control: canary {canary['passed']}, swap work {dep['swap']['work']}")
    if dep["swap"]["tags"] != {"hdce": "hdce_last", "qsc": "qsc_best"}:
        raise AssertionError(f"control: swap tags {dep['swap']['tags']}")

    # after the swap: all-drifted traffic on the same pool, served against the
    # CPU twin of hdce_last, its parity fed to the watch
    after = make_request_samples(cfg, CTL_REQUESTS // 2, drift_at=0, drift_step=CTL_DRIFT_STEP,
                                 drift_scenario=CTL_DRIFT_SCENARIO)
    results: list = []
    prev = get_sink()
    set_sink(tally)
    tally.at = None
    K.reset_launch_counts()
    nb = len(tally.buckets)
    try:
        sm_c = run_loadgen(cfg, engine, rate=CTL_RPS, n=CTL_REQUESTS // 2, deadline_ms=2000.0, samples=after,
                           pool=pool, drift_at=0, results=results)
    finally:
        set_sink(prev)
        pool.stop()
    b2 = K.launches["circuit_expvals"] - tally.at["circuit_expvals"]
    slices = sum(engine._slices(b) for b in tally.buckets[nb:])
    for k in launches:
        launches[k] += K.launches[k] - tally.at[k]
    served = [r for r in results if isinstance(r, Prediction)]
    ids = np.array([r.rid for r in served], dtype=np.int64)
    twin = ServeEngine.from_workdir(cfg, wd, device="cpu", tags={"hdce": "hdce_last"})
    held = _hold_served(tuple(a[ids] for a in _twin_reference(torch, twin, after["x"])),
                        np.stack([r.h for r in served]), np.array([r.scenario for r in served]),
                        "control after the swap")
    post_db = sm_c["windows"]["post_drift"]["nmse_db_drift_scenario"]
    verdict = None
    for _ in range(cfg.control.watch_ticks + 1):
        ctrl.observe_parity(CTL_DRIFT_SCENARIO, post_db)
        for e in ctrl.tick()["events"]:
            if e.get("action") in ("deploy_confirmed", "rollback"):
                verdict = e
    lat_c = sm_c["latency_ms"] or {}
    log(f"control after the swap: all-drifted traffic n={CTL_REQUESTS // 2}: p50 {lat_c.get('p50_ms')} ms (before "
        f"{lat_b.get('p50_ms')} ms), NMSE of the drifting family {post_db} dB (canary's candidate "
        f"{canary['drifted_probes']['cand_db']} dB), against the CPU twin of hdce_last {held['max_abs_err']:.3e} "
        f"(tol {held['tol']:.3e}, routed alike {held['routed_alike']}/{held['rows']}); B.2 launches {b2} for {slices} "
        f"row slices; watch verdict {json.dumps(verdict)} [{card}]")
    if b2 != slices or sm_c["compile_cache_after_warmup"] != zero or sm_c["stranded_futures"]:
        raise AssertionError(f"control after the swap: B.2 {b2} for {slices} slices, work "
                             f"{sm_c['compile_cache_after_warmup']}")
    if verdict is None:
        raise AssertionError("control: the watch window closed with neither deploy_confirmed nor a rollback")

    # remote: `cli serve` and `cli control --ticks=3 --control.dry_run=true` as processes
    flags = [*CTL_ARGS, f"--train.workdir={CTL_WORK / 'ws'}"]
    root = Path(__file__).resolve().parent
    env = {**os.environ, "QDML_TORCH_SERVE_BATCHING_TABLE": str(TUNE_DIR / "serve_batching.json")}
    t = time.perf_counter()
    server = subprocess.Popen([sys.executable, "-m", "qdml_tpu_torch.cli", "serve", *flags, "--serve.port=0",
                               f"--quantum.autotune_table={TUNE_DIR / 'qsc_impl.json'}"], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner: dict = {}

        def read_banner():
            for line in server.stdout:
                if line.startswith('{"serving"'):
                    banner.update(json.loads(line))
                    return

        reader = threading.Thread(target=read_banner, daemon=True)
        reader.start()
        reader.join(timeout=300.0)
        if not banner:
            raise AssertionError(f"control: `cli serve` printed no banner: {server.stderr.read() if server.poll() is not None else 'still starting'}")
        port = int(banner["serving"].rsplit(":", 1)[1])
        t_up = time.perf_counter() - t
        ctl = subprocess.run([sys.executable, "-m", "qdml_tpu_torch.cli", "control", "--ticks=3",
                              "--control.dry_run=true", *flags, f"--serve.port={port}"],
                             cwd=root, env=env, capture_output=True, text=True, timeout=300)
    finally:
        server.send_signal(2)
        try:
            server.wait(timeout=60.0)
        finally:
            if server.poll() is None:
                server.kill()
    lines = ctl.stdout.strip().splitlines()
    header = json.loads(lines[0]) if lines and lines[0].startswith("{") else None
    log(f"control remote: `cli serve` up in {t_up:.2f} s on port {port} (mesh {banner.get('mesh')}); `cli control "
        f"--ticks=3 --control.dry_run=true` exit {ctl.returncode}, header {json.dumps(header)}, {len(lines)} lines "
        f"[{card}]")
    want = {"control", "workdir", "dry_run", "interval_s", "autoscale", "drift_step_hint"}
    if ctl.returncode != 0 or header is None or set(header) != want or header["dry_run"] is not True:
        raise AssertionError(f"control remote: exit {ctl.returncode}, stdout {ctl.stdout[-2000:]}, stderr {ctl.stderr[-2000:]}")
    log(f"control launches (traffic windows): {json.dumps(launches)} [{card}]")
    return launches


# the fleet (scripts/fleet_router_dryrun.py and fleet_elastic_dryrun.py):
# their traffic a window (240 requests, bursty at 300 rps, deadline 500 ms,
# seeds from 0) through the router's front door; backends of the control
# phase's models (QSC n=6 L=3 forced to pallas_circuit, buckets 1/8/64, a
# 2x2 pool each) restored from one fresh workdir under build/chip_smoke/fleet/
FLEET_WORK = EVAL_WORK / "fleet"
FLEET_N, FLEET_RPS, FLEET_DEADLINE_MS = 240, 300.0, 500.0
FLEET_ARGS = (
    "--name=fleet", "--quantum.impl=pallas_circuit", f"--serve.buckets={MESH_BUCKETS}", "--serve.max_batch=64",
    "--serve.batching=bucket", "--serve.max_wait_ms=2", "--serve.replicas=2", "--serve.workers=2",
    "--serve.dedup_ttl_s=300", "--serve.conn_timeout_s=5", "--serve.arrival=bursty",
    f"--serve.drift_step={CTL_DRIFT_STEP}", f"--serve.drift_scenario={CTL_DRIFT_SCENARIO}",
    "--control.ft_steps=300", "--control.ft_batch=32", "--control.probe_n=96", "--control.min_gain_db=0.3",
    "--control.tol_db=0.5", "--control.watch_ticks=2", "--control.autoscale=false",
    "--control.fleet_cooldown_ticks=0",
)
# the backends' device flags: none, so every backend runs on the card
FLEET_DEVICE_ARGS: tuple[str, ...] = ()


def _compute_apps() -> list[tuple[int, int]]:
    """``(pid, used MiB)`` of every process holding a context on the cards
    (``nvidia-smi --query-compute-apps``)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return [tuple(int(v) for v in line.split(",")) for line in out.strip().splitlines() if line.strip()]


def _hold_contexts(procs, base: int, what: str) -> str:
    """Each live backend holds a context on the card: its pid among
    nvidia-smi's compute apps, or, where nvidia-smi reports pids of another
    namespace (a container may show every process as pid 1), one more context per
    live backend than ``base`` (the count before any backend started). A
    context appears and goes with some delay: polled for up to 15 s."""
    deadline = time.monotonic() + 15.0
    while True:
        apps = _compute_apps()
        pids = sorted({p for p, _ in apps})
        live = [b.proc.pid for b in procs if b.alive()]
        if live and all(p in pids for p in live):
            return f"pids {live} listed by nvidia-smi ({len(apps)} contexts)"
        if len(apps) == base + len(live):
            return (f"{len(apps)} contexts = {base} + {len(live)} live backends (nvidia-smi lists pids {pids}, not "
                    f"the backends' {live}: another pid namespace), {sum(m for _, m in apps)} MiB")
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: {len(apps)} contexts on the card (nvidia-smi pids {pids}), want {base} + "
                                 f"{len(live)} live backends")
        time.sleep(0.25)


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


class _VerbAudit:
    """The monitor's poller with the three read verbs alone on it
    (``scripts/live_fleet_dryrun.py``'s audit): a scraper reaching for any
    other verb would fail into a scrape error, and ``calls`` names the verbs
    it sent."""

    def __init__(self, inner):
        self._inner = inner
        self.calls: set = set()

    def health(self):
        self.calls.add("health")
        return self._inner.health()

    def metrics(self):
        self.calls.add("metrics")
        return self._inner.metrics()

    def events(self, cursor=None, limit=512):
        self.calls.add("events")
        return self._inner.events(cursor, limit=limit)


def fleet_phase(torch, K, mods, card: str) -> None:
    """The fleet tier at full width (``scripts/fleet_router_dryrun.py`` and
    ``fleet_elastic_dryrun.py``, with their traffic): backends of the control
    phase's models spawned as ``cli serve`` processes on the card, the port's
    router in front, kill / stall / garbage / swap under traffic, the
    controller over the router, elastic admission and retirement, and the
    ``route`` and ``fleet-scale`` commands as processes. The B.2 launches
    are the backends' own, in their processes: the smoke's counters do not
    see them."""
    import asyncio
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from qdml_tpu_torch.control.fleet_scale import FleetAutoscaler, load_planner_target
    from qdml_tpu_torch.control.loop import FleetController, SocketPoller
    from qdml_tpu_torch.fleet import BackendLifecycle, FleetPoller, FleetRouter, route_async, spawn_backend, verify_warm
    from qdml_tpu_torch.serve.client import ServeClient
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.loadgen import make_request_samples, run_loadgen_socket
    from qdml_tpu_torch.telemetry import run_manifest
    from qdml_tpu_torch.telemetry.cost import detect_platform
    from qdml_tpu_torch.telemetry.attach import MonitorAttachment
    from qdml_tpu_torch.telemetry.burnrate import BurnAlerter, BurnRateRule
    from qdml_tpu_torch.telemetry.report import report_main
    from qdml_tpu_torch.telemetry.timeseries import MonitorScraper, monitor_main
    from qdml_tpu_torch.utils.metrics import MetricsLogger
    from qdml_tpu_torch.telemetry.spans import get_sink, set_sink

    t_phase = time.perf_counter()
    zero = {"measure": 0, "table_write": 0, "kernel_build": 0}
    platform = "cpu" if "--device=cpu" in FLEET_DEVICE_ARGS else "cuda"
    cost_platform = detect_platform(platform)  # the label of each warmup bucket's cost record
    shutil.rmtree(FLEET_WORK, ignore_errors=True)
    flags = [*FLEET_ARGS, *FLEET_DEVICE_ARGS, f"--train.workdir={FLEET_WORK / 'ws'}",
             f"--quantum.autotune_table={TUNE_DIR / 'qsc_impl.json'}"]
    cfg = mods["config"].from_args([a for a in flags if not a.startswith("--device=")])
    wd = mods["cli"].workdir_of(cfg)
    src = mods["cli"].workdir_of(mods["config"].from_args([*CTL_ARGS, f"--train.workdir={CTL_WORK / 'ws'}"]))
    os.makedirs(wd)
    for tag in ("hdce_best", "qsc_best"):  # the control phase's card-trained models
        for path in Path(src).glob(f"{tag}.*"):
            shutil.copy2(path, Path(wd) / path.name)
    env = {"QDML_TORCH_SERVE_BATCHING_TABLE": str(TUNE_DIR / "serve_batching.json")}
    n_cards = torch.cuda.device_count() if platform == "cuda" else 0

    def card_env(i: int) -> dict:
        return {**env, "CUDA_VISIBLE_DEVICES": str(i % n_cards)} if n_cards >= 2 else env

    procs: list = []  # every backend this phase started, for the teardown

    def addr(b) -> str:
        return f"{b.host}:{b.port}"

    def recorded(i: int):
        """``spawn_backend`` for a lifecycle: on card ``i`` of several, and
        the process kept for the teardown."""
        def spawn_fn(*a, **kw):
            p = spawn_backend(*a, env=card_env(i), **kw)
            procs.append(p)
            return p
        return spawn_fn

    def spawn(i: int, port: int = 0):
        b = spawn_backend(flags, port=port, env=card_env(i), log_path=str(FLEET_WORK / f"backend{i}.log"),
                          timeout_s=300.0)
        procs.append(b)
        if b.banner["compile_cache_after_warmup"] != zero or any(
                c["platform"] != cost_platform for c in b.banner["cost"].values()):
            raise AssertionError(f"fleet: backend {i} banner {b.banner}")
        return b

    base = len(_compute_apps())
    ports = [_free_port(), _free_port()]  # fixed: a respawned backend takes its old address
    aloop = asyncio.new_event_loop()
    loop_thread = threading.Thread(target=aloop.run_forever, daemon=True)
    router = route_proc = mon_proc = None
    tally = _ServeTally(K)
    prev_sink = get_sink()
    monitor: dict = {}  # the attached monitor while it runs: its scraper, stop event and thread
    window_walls: dict = {}  # each window's wall-clock (time.time) start and end
    try:
        t = time.perf_counter()
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(spawn, i, ports[i]) for i in range(2)]
            backends = [f.result() for f in futs]
        spawn_s = time.perf_counter() - t
        ctx = _hold_contexts(backends, base, "fleet spawn")
        facts = [verify_warm(b.host, b.port, timeout_s=30.0) for b in backends]
        log(f"fleet: 2 backends (`cli serve`, 2x2 pool, pallas_circuit at buckets {MESH_BUCKETS}) up in {spawn_s:.2f} s "
            f"together; on the card: {ctx}; verify_warm {[f['warm'] for f in facts]}, work "
            f"{[f['compile_cache_after_warmup'] for f in facts]}; first forward s "
            f"{[{k: c['first_forward_s'] for k, c in b.banner['cost'].items()} for b in backends]} [{card}]")

        router = FleetRouter([b.addr for b in backends], balance="hash", timeout_s=2.0, retries=0, eject_failures=2,
                             eject_s=0.5, readmit_probes=1, poll_interval_s=0.2, failover=2, dedup_ttl_s=300.0,
                             seed=0).start()
        loop_thread.start()
        ready: Future = Future()
        asyncio.run_coroutine_threadsafe(
            route_async(router, "127.0.0.1", 0, ready, conn_timeout_s=5.0, max_line_bytes=1 << 20), aloop)
        front = ("127.0.0.1", ready.result(timeout=30.0))
        samples = make_request_samples(cfg, FLEET_N)
        x = samples["x"]
        twin = ServeEngine.from_workdir(cfg, wd, device="cpu")
        ref = _twin_reference(torch, twin, x)
        seq = [0]

        def direct(b, verb: str = "metrics") -> dict | None:
            """One backend's own view (not through the router); None when it is down."""
            try:
                with ServeClient(b.host, b.port, timeout_s=5.0, retries=0) as c:
                    return (c.metrics() if verb == "metrics" else c.health()).get(verb)
            except (ConnectionError, OSError):
                return None

        def completed() -> list:
            return [None if (m := direct(b)) is None else int(m["completed"]) for b in backends]

        def window(tag: str, during=None, hold=True, jsonl: Path | None = None) -> dict:
            side_err: list = []
            side = None
            if during is not None:
                def run_side():
                    try:
                        during()
                    except Exception as e:  # lint: disable=broad-except(the injection side thread must report its failure into the window's result, not die silently and fake a passing window)
                        side_err.append(f"{type(e).__name__}: {e}")

                side = threading.Thread(target=run_side, daemon=True)
                side.start()
            if monitor.get("scraper") is not None:
                monitor["scraper"].mark(tag)  # the windows the monitor's alerts are judged by
            r0, c0 = router.router_summary(), completed()
            t_wall = time.time()
            seq[0] += 1
            replies: list = []
            # the window's manifest-headed stream, for the report round trip
            wlog = None if jsonl is None else MetricsLogger(str(jsonl), echo=False, manifest=run_manifest(cfg))
            try:
                sm = run_loadgen_socket(cfg, front, rate=FLEET_RPS, n=FLEET_N, seed=1000 * seq[0],
                                        deadline_ms=FLEET_DEADLINE_MS, clients=8, x=x, results=replies,
                                        logger=wlog)
            finally:
                if wlog is not None:
                    wlog.close()
            if side is not None:
                side.join(timeout=120.0)
                if side.is_alive() or side_err:
                    raise AssertionError(f"fleet {tag}: the injection failed: {side_err or 'still running'}")
            r1, c1 = router.router_summary(), completed()
            window_walls[tag] = (t_wall, time.time())
            ok = [i for i, r in enumerate(replies) if r is not None and r.get("ok")]
            held = None
            if hold and ok:
                held = _hold_served(tuple(a[ok] for a in ref), np.asarray([replies[i]["h"] for i in ok], np.float32),
                                    np.array([replies[i]["pred"] for i in ok]), f"fleet {tag}")
            typed = dict(sm["shed"])
            lat = sm["latency_ms"] or {}
            d = {k: r1[k] - r0[k] for k in ("failovers", "ejections", "readmissions", "dedup_hits", "no_backend")}
            split = [None if a is None or b is None else a - b for a, b in zip(c1, c0)]
            err = "-" if held is None else f"{held['max_abs_err']:.3e} (tol {held['tol']:.3e})"
            log(f"fleet window {tag}: rps {sm['rps']} (offered {sm['offered_rps']}), p50 {lat.get('p50_ms')} ms, p99 "
                f"{lat.get('p99_ms')} ms, SLO {json.dumps(sm['slo'])}, completed {sm['completed']}/{FLEET_N}, typed "
                f"replies {json.dumps(typed)}, give-ups {sm['give_ups']} (deadline {sm['deadline_give_ups']}), "
                f"stranded {sm['stranded_futures']}; router {json.dumps(d)}; completions by backend {split}; "
                f"CPU twin {err} [{card}]")
            if sm["stranded_futures"]:
                raise AssertionError(f"fleet {tag}: {sm['stranded_futures']} stranded futures")
            if sm["give_ups"] != sm["deadline_give_ups"]:
                raise AssertionError(f"fleet {tag}: {sm['give_ups'] - sm['deadline_give_ups']} give-ups before the "
                                     "deadline")
            faults = [k for k in typed if k.startswith(("server_error", "bad_request", "router_error"))]
            if faults:
                raise AssertionError(f"fleet {tag}: failed replies {faults}")
            return {"sm": sm, "delta": d, "split": split}

        # the monitor on the front door through the baseline, kill and stall
        # windows (scripts/monitor_dryrun.py, live_fleet_dryrun.py): the three
        # read verbs audited, a dry-run FleetAutoscaler ticked each window
        # through a separate actuator, the dryruns' alerter (for_run at their
        # 30 s / 0.4 s geometry and their router rule)
        zero_work = [(direct(b) or {}).get("compile_cache_after_warmup") for b in backends]
        mon_path = FLEET_WORK / "monitor.jsonl"
        mlog = MetricsLogger(str(mon_path), echo=False, manifest=run_manifest(cfg, argv=["monitor", "fleet"]))
        audit = _VerbAudit(SocketPoller(*front, timeout_s=5.0))
        alerter = BurnAlerter.for_run(duration_s=30.0, interval_s=0.4, slo_target=0.99, threshold=8.0, debounce=2)
        alerter.rules["router"] = BurnRateRule("router", budget=0.02, fast_s=1.2, slow_s=3.6, threshold=3.0,
                                               debounce=2)
        scraper = MonitorScraper(audit, sink=mlog, interval_s=0.4, alerter=alerter, tail_events=True)
        actuator = SocketPoller(*front, timeout_s=120.0)
        attachment = MonitorAttachment(scraper, FleetAutoscaler(
            lambda k: actuator.fleet(backends=k), min_backends=2, max_backends=3, queue_high=10.0, queue_low=2.0,
            debounce=2, cooldown_ticks=6, sink=mlog, dry_run=True), max_reconnects=8)
        # each scrape on the process clock: its mark, the router rule's burns
        # and debounce count, so the stall's page is read against the end of
        # the stall window
        scrapes: list = []
        scrape_once, router_rule = scraper.scrape_once, alerter.rules["router"]

        def scrape_logged():
            rec = scrape_once() or {}
            burn = (rec.get("burn") or {}).get("router") or {}
            scrapes.append({"t": time.monotonic(), "mark": rec.get("mark"), "fast": burn.get("fast"),
                            "slow": burn.get("slow"), "pending": router_rule.pending, "firing": router_rule.firing,
                            "paged": router_rule.firing and "router" in (rec.get("alerts") or ())})
            return rec or None

        scraper.scrape_once = scrape_logged
        monitor.update(scraper=scraper, stop=threading.Event(), log=mlog)
        monitor["thread"] = threading.Thread(target=attachment.run, args=(900.0, monitor["stop"]), daemon=True)
        scraper.mark("baseline")
        monitor["thread"].start()

        # healthy fleet: both backends serve, every answer against the CPU twin
        base_w = window("baseline", jsonl=FLEET_WORK / "baseline.jsonl")
        if not all(v for v in base_w["split"]):
            raise AssertionError(f"fleet baseline: a backend served nothing: {base_w['split']}")
        # no traffic: the monitor's scrapes complete no request on any backend
        scraper.mark("idle_probe")
        seq0, idle0 = scraper.seq, completed()
        time.sleep(1.6)
        idle = (scraper.seq - seq0, completed())
        log(f"fleet monitor idle probe: {idle[0]} scrapes in 1.6 s without traffic, backend completions {idle0} -> "
            f"{idle[1]} [{card}]")
        if idle[0] < 2 or idle[1] != idle0:
            raise AssertionError(f"fleet monitor idle probe: {idle[0]} scrapes, completions {idle0} -> {idle[1]}")
        # the same traffic straight to backend 0: what the router's hop costs
        sm = run_loadgen_socket(cfg, backends[0].addr, rate=FLEET_RPS, n=FLEET_N, seed=999,
                                deadline_ms=FLEET_DEADLINE_MS, clients=8, x=x)
        lat, lat_r = sm["latency_ms"] or {}, base_w["sm"]["latency_ms"] or {}
        log(f"fleet direct to backend 0, same traffic: rps {sm['rps']}, p50 {lat.get('p50_ms')} ms, p99 "
            f"{lat.get('p99_ms')} ms, SLO {json.dumps(sm['slo'])}, stranded {sm['stranded_futures']}; through the "
            f"router p50 {lat_r.get('p50_ms')} ms, p99 {lat_r.get('p99_ms')} ms [{card}]")
        if sm["stranded_futures"] or sm["completed"] != FLEET_N:
            raise AssertionError(f"fleet direct: {sm['completed']} of {FLEET_N}, stranded {sm['stranded_futures']}")

        # {"op": "swap"} fanned out under traffic: every backend to swap epoch 1
        swap_box: dict = {}

        def inject_swap():
            time.sleep((FLEET_N // 3) / FLEET_RPS)
            with ServeClient(*front, timeout_s=120.0) as c:
                t0 = time.perf_counter()
                swap_box["reply"] = c.swap()
                swap_box["ms"] = (time.perf_counter() - t0) * 1e3

        window("fanout_swap", during=inject_swap)
        rep = swap_box["reply"]
        epochs = [(direct(b, "health") or {}).get("swap_epoch") for b in backends]
        log(f"fleet swap fan-out under traffic: {swap_box['ms']:.2f} ms, ok {rep.get('ok')}, fanned to "
            f"{rep.get('swap', {}).get('fanned_to')}, epochs {epochs}, work "
            f"{[v.get('swap', {}).get('work') for v in rep.get('swap', {}).get('backends', {}).values()]} [{card}]")
        if not rep.get("ok") or rep["swap"]["fanned_to"] != 2 or epochs != [1, 1]:
            raise AssertionError(f"fleet swap: {rep}, epochs {epochs}")

        # router-side socket garbage under traffic: typed replies, the router keeps serving
        def inject_garbage():
            import socket

            time.sleep((FLEET_N // 4) / FLEET_RPS)
            with socket.create_connection(front, timeout=10.0) as sk:
                sk.sendall(b"NOT JSON {{{\n")
                if json.loads(sk.makefile("rb").readline()) != {"ok": False, "reason": "bad_json"}:
                    raise AssertionError("garbage: no typed bad_json")
            with socket.create_connection(front, timeout=10.0) as sk:
                sk.sendall(b'{"id": "frag", "x": [[')  # a partial line, then the peer vanishes
            with socket.create_connection(front, timeout=10.0) as sk:
                sk.sendall(b'{"id": 1, "x": "' + b"a" * (1 << 21) + b'"}\n')
                got = json.loads(sk.makefile("rb").readline())
                if got.get("ok") is not False or "max_line_bytes" not in got.get("reason", ""):
                    raise AssertionError(f"garbage: oversized line answered {got}")

        window("router_garbage", during=inject_garbage)

        def rid_for(b) -> str:
            """A request id whose ring primary is backend ``b``."""
            return next(f"pin-{k}" for k in range(100_000) if router._candidates(f"pin-{k}")[0].addr == addr(b))

        def dedup_pin(rid: str, rep1: dict, what: str) -> None:
            """A retry of an answered id: the same reply, one router dedup hit,
            no dispatch on any live backend."""
            c0, hits = completed(), router.dedup.hits
            with ServeClient(*front, timeout_s=10.0, retries=1, seed=SEED) as c:
                rep2 = c.request(x[0], rid=rid)
            c1 = completed()
            same = [a == b for a, b in zip(c0, c1) if a is not None and b is not None]
            log(f"fleet dedup {what}: retry of {rid} identical {rep2.get('h') == rep1.get('h')}, dedup hits "
                f"{hits} -> {router.dedup.hits}, backend completions {c0} -> {c1} [{card}]")
            if not (rep1.get("ok") and rep2.get("ok") and rep2["h"] == rep1["h"] and rep2["pred"] == rep1["pred"]
                    and router.dedup.hits == hits + 1 and same and all(same)):
                raise AssertionError(f"fleet dedup {what}: dispatched again or answered differently")

        with ServeClient(*front, timeout_s=10.0, retries=1, seed=SEED) as c:
            quiet = c.request(x[0], rid="pin-quiet")
        dedup_pin("pin-quiet", quiet, "(healthy fleet)")

        # SIGKILL of backend 1 mid-traffic, with a dedup pin spanning the kill
        kill_rid = rid_for(backends[1])
        with ServeClient(*front, timeout_s=10.0, retries=1, seed=SEED) as c:
            kill_rep = c.request(x[0], rid=kill_rid)
        smi_box: dict = {}

        def inject_kill():
            time.sleep((FLEET_N // 3) / FLEET_RPS)
            backends[1].kill()
            time.sleep(0.5)
            smi_box["after_kill"] = _hold_contexts(backends, base, "fleet kill")

        w = window("backend_kill", during=inject_kill)
        if not (w["delta"]["ejections"] >= 1 and w["delta"]["failovers"] >= 1 and w["sm"]["completed"] > 0
                and w["split"][0]):
            raise AssertionError(f"fleet kill: no ejection/failover or the survivor did not serve: {w['delta']}")
        dedup_pin(kill_rid, kill_rep, "across the kill (its backend dead and ejected)")
        t = time.perf_counter()
        backends[1] = spawn(1, ports[1])
        respawn_s = time.perf_counter() - t
        deadline = time.monotonic() + 30.0
        while len(router.live_backends()) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        log(f"fleet kill: the killed backend's context freed ({smi_box['after_kill']}); respawned on :{ports[1]} in "
            f"{respawn_s:.2f} s, live {len(router.live_backends())}; {_hold_contexts(backends, base, 'respawn')} "
            f"[{card}]")
        w = window("backend_kill_recovery", jsonl=FLEET_WORK / "backend_kill_recovery.jsonl")
        if len(router.live_backends()) != 2 or router.router_summary()["readmissions"] < 1:
            raise AssertionError("fleet kill: the respawned backend was not re-admitted")
        # the kill class's report round trip (scripts/fleet_router_dryrun.py:417-423):
        # the recovery window against the baseline window, the dryrun's 50% threshold
        report_md = FLEET_WORK / "report_backend_kill.md"
        with contextlib.redirect_stdout(io.StringIO()):  # the markdown goes to report_md
            rc = report_main([f"--current={FLEET_WORK / 'backend_kill_recovery.jsonl'}",
                              f"--baseline={FLEET_WORK / 'baseline.jsonl'}", "--threshold=50", f"--out={report_md}"])
        fleet_line = next((ln.strip() for ln in report_md.read_text().splitlines() if "via router over" in ln), None)
        log(f"fleet report backend_kill (recovery vs baseline): exit {rc}; {fleet_line} [{card}]")
        if rc not in (0, 3):
            raise AssertionError(f"fleet report: exit {rc} (usage), fleet line {fleet_line!r}")

        # SIGSTOP of backend 1 for 5 s mid-traffic, then SIGCONT
        def inject_stall():
            time.sleep((FLEET_N // 3) / FLEET_RPS)
            backends[1].stall()
            try:
                time.sleep(0.5)
                smi_box["stalled"] = _hold_contexts(backends, base, "fleet stall")
                time.sleep(4.5)
            finally:
                backends[1].resume()

        r_before = router.router_summary()
        t_stall = time.monotonic()
        w = window("backend_stall", during=inject_stall)
        t_stall_end = time.monotonic()
        # late burn transitions still attribute to backend_stall
        # (scripts/monitor_dryrun.py:338): the router rule's 3.6 s slow
        # window, debounce 2 and 0.4 s scrapes can latch up to about a second
        # after the stall's traffic ends
        time.sleep(2.0)
        deadline = time.monotonic() + 30.0
        while len(router.live_backends()) < 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        r_after = router.router_summary()
        log(f"fleet stall: contexts while stopped: {smi_box['stalled']}; ejections "
            f"{r_after['ejections'] - r_before['ejections']}, readmissions "
            f"{r_after['readmissions'] - r_before['readmissions']}, live {len(router.live_backends())} [{card}]")
        if not (r_after["ejections"] > r_before["ejections"] and r_after["readmissions"] > r_before["readmissions"]
                and w["sm"]["completed"] > 0 and len(router.live_backends()) == 2):
            raise AssertionError("fleet stall: the stalled backend was not ejected and re-admitted")
        t_recovery = time.monotonic()
        window("backend_stall_recovery")
        time.sleep(1.2)  # the last windows' scrapes
        monitor["stop"].set()
        monitor["thread"].join(timeout=60.0)
        for s in scrapes:
            if t_stall_end - 1.0 <= s["t"] <= t_recovery + 1.0:
                log(f"fleet monitor scrape {s['t'] - t_stall_end:+.3f} s from the stall window's end (recovery mark "
                    f"at {t_recovery - t_stall_end:+.3f} s): mark {s['mark']}, router fast/slow burn {s['fast']}/"
                    f"{s['slow']}, pending {s['pending']}, firing {s['firing']}, paged {s['paged']} [{card}]")
        page = next((s for s in scrapes if s["paged"] and s["t"] >= t_stall), None)
        log(f"fleet monitor router page in or after the stall window: "
            + ("none" if page is None else f"mark {page['mark']} at {page['t'] - t_stall_end:+.3f} s from the stall "
               f"window's end, fast/slow burn {page['fast']}/{page['slow']}") + f" [{card}]")
        expect = {"fired": ["backend_stall"], "quiet": ["baseline", "idle_probe"]}
        summary = scraper.finish(extra={"expect": expect, "handsoff": attachment.summary()})
        mlog.close()
        monitor.clear()
        fired = [a for a in scraper.alerts if a.get("state") == "firing"]
        fired_marks = sorted({a.get("mark") for a in fired})
        work_after = [(direct(b) or {}).get("compile_cache_after_warmup") for b in backends]
        log(f"fleet monitor (in process, 0.4 s windows, dry-run attachment): {summary['windows']} windows, alerts "
            f"fired {json.dumps([(a['signal'], a['mark'], a['fast_burn'], a['slow_burn']) for a in fired])}, by mark "
            f"{json.dumps(summary['alerts']['by_mark'])}; peak burn {json.dumps(summary['peak_burn'])}; verbs "
            f"{sorted(audit.calls)}; spine {json.dumps(summary['spine'])}, event_drops {summary['event_drops']}; "
            f"scrape errors {summary['scrape_errors']}, counter resets {summary['counter_resets']}; hands-off "
            f"{json.dumps({k: v for k, v in summary['handsoff'].items() if k != 'scale_events'})}, decisions "
            f"{json.dumps(summary['handsoff']['scale_events'])}; request-path work {zero_work} -> {work_after} "
            f"[{card}]")
        if not ("backend_stall" in fired_marks and "baseline" not in fired_marks and "idle_probe" not in fired_marks):
            raise AssertionError(f"fleet monitor: alerts fired in {fired_marks}, want backend_stall and not the "
                                 f"baseline; peak burn {summary['peak_burn']}")
        if not (sorted(audit.calls) == ["events", "health", "metrics"] and summary["event_drops"] == 0
                and attachment.give_up is None and zero_work == work_after == [zero, zero]):
            raise AssertionError(f"fleet monitor: verbs {audit.calls}, event_drops {summary['event_drops']}, give-up "
                                 f"{attachment.give_up}, work {zero_work} -> {work_after}")
        timeline = FLEET_WORK / "timeline.md"
        with contextlib.redirect_stdout(io.StringIO()):
            rc_render = monitor_main(["--render", f"--current={mon_path}", f"--out={timeline}"])
        md = timeline.read_text()
        corr = [ln.strip() for ln in md.splitlines() if ln.strip().startswith("- correlated events")]
        log(f"fleet monitor timeline: render exit {rc_render}; alert rows {md.count('**ALERT')}; the stall alert's "
            f"{corr[-1] if corr else 'no correlated events'} [{card}]")
        if not (rc_render == 0 and "**ALERT" in md and "backend_ejected" in md and "backend_readmitted" in md):
            raise AssertionError(f"fleet monitor timeline: render exit {rc_render}, {timeline}")
        rep_json = FLEET_WORK / "report_monitor.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = report_main([f"--current={FLEET_WORK / 'baseline.jsonl'},{mon_path}",
                              f"--baseline={FLEET_WORK / 'baseline.jsonl'}", "--threshold=50",
                              f"--out={FLEET_WORK / 'report_monitor.md'}", f"--json={rep_json}"])
        gates = {g["metric"]: g["status"] for g in json.loads(rep_json.read_text()).get("gates", [])
                 if g.get("kind") == "monitor"}
        log(f"fleet monitor report (baseline + monitor stream against the baseline): exit {rc}, monitoring gates "
            f"{json.dumps(gates)} [{card}]")
        want_gates = {"monitor.alerts[backend_stall]", "monitor.alerts[baseline]", "monitor.event_drops",
                      "monitor.handsoff"}
        if rc != 0 or not want_gates <= set(gates) or any(v != "ok" for v in gates.values()):
            raise AssertionError(f"fleet monitor report: exit {rc}, gates {gates}")

        # `cli monitor --attach --dry-run` and `cli events` as processes against the front door, side by side
        root = Path(__file__).resolve().parent
        addr_front = f"{front[0]}:{front[1]}"
        cli_cmd = [sys.executable, "-m", "qdml_tpu_torch.cli"]
        t = time.perf_counter()
        mon_proc = subprocess.Popen(
            [*cli_cmd, "monitor", f"--addr={addr_front}", "--attach", "--dry-run", "--interval=0.5", "--duration=5",
             f"--out={FLEET_WORK / 'monitor_cli.jsonl'}"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        ev_box: dict = {}

        def run_events():
            t_ev = time.perf_counter()
            ev_box["proc"] = subprocess.run([*cli_cmd, "events", f"--addr={addr_front}", "--limit=4096"], cwd=root,
                                            capture_output=True, text=True, timeout=120)
            ev_box["s"] = time.perf_counter() - t_ev

        ev_thread = threading.Thread(target=run_events, daemon=True)
        ev_thread.start()
        seen = []
        while mon_proc.poll() is None and time.perf_counter() - t < 120.0:
            apps = _compute_apps()
            seen.append((len(apps), mon_proc.pid in {p for p, _ in apps}))
            time.sleep(0.5)
        out, err = mon_proc.communicate(timeout=60.0)
        mon_rc, mon_proc = mon_proc.returncode, None
        mon_s = time.perf_counter() - t
        ev_thread.join(timeout=120.0)
        ev = ev_box.get("proc")
        if ev is None:
            raise AssertionError("fleet cli events: no result")
        envs = [json.loads(ln) for ln in ev.stdout.splitlines() if ln.startswith("{")]
        k0, k1 = window_walls["backend_kill"]
        kill_ej = [e for e in envs if e.get("kind") == "backend_ejected" and k0 <= e.get("ts", 0) <= k1]
        log(f"fleet `cli events`: exit {ev.returncode} in {ev_box['s']:.2f} s, {len(envs)} envelopes "
            f"({json.dumps({k: sum(e.get('kind') == k for e in envs) for k in ('backend_ejected', 'backend_readmitted', 'monitor_alert')})}); "
            f"the kill window's ejection {json.dumps(kill_ej[0]) if kill_ej else None} [{card}]")
        if ev.returncode != 0 or not kill_ej or any("spine_loss" in e for e in envs):
            raise AssertionError(f"fleet cli events: exit {ev.returncode}, {ev.stderr[-1500:]}")
        msum = json.loads(out.strip().splitlines()[-1])["monitor"] if out.strip().startswith("{") else {}
        live = len([b for b in backends if b.alive()])
        log(f"fleet `cli monitor --attach --dry-run`: exit {mon_rc} in {mon_s:.2f} s, {msum.get('windows')} windows, "
            f"give_up {(msum.get('handsoff') or {}).get('give_up')}, event_drops {msum.get('event_drops')}; contexts "
            f"on the card while it ran (and `cli events` beside it) {sorted({n for n, _ in seen})} over {len(seen)} "
            f"readings (base {base} + {live} live backends), its pid listed {any(p for _, p in seen)} [{card}]")
        if not (mon_rc == 0 and msum.get("handsoff", {}).get("give_up", 1) is None and msum.get("event_drops") == 0
                and len(seen) >= 4 and all(n == base + live and not p for n, p in seen)):
            raise AssertionError(f"fleet cli monitor: exit {mon_rc}, summary {msum}, contexts {seen}\n{err[-1500:]}")

        # elastic: a FleetAutoscaler pinned to a hand-written target in emit_target's shape
        basis = {"trace": "hand-written", "target_rps": FLEET_RPS, "p99_target_ms": FLEET_DEADLINE_MS,
                 "workers_per_backend": 4, "sweep": [{"backends": 2, "meets_target": False},
                                                     {"backends": 3, "meets_target": True}]}
        sha = hashlib.sha256(json.dumps(basis, sort_keys=True).encode()).hexdigest()
        target_path = FLEET_WORK / "target.json"
        target_path.write_text(json.dumps({"fleet_target": {
            "backends_needed": 3, **{k: basis[k] for k in ("target_rps", "p99_target_ms", "workers_per_backend",
                                                            "trace")}, "assumptions_sha": sha}}))
        lifecycle = BackendLifecycle(router, spawn_overrides=flags, spawn_timeout_s=300.0, verify_timeout_s=30.0,
                                     drain_wait_s=30.0, log_dir=str(FLEET_WORK), spawn_fn=recorded(2))
        scaler = FleetAutoscaler.from_config(cfg.control, lifecycle.scale_to)  # 1..4 backends, no cooldown
        scaler.set_planner_target(load_planner_target(str(target_path)))
        ids = [f"ring-{i}" for i in range(2000)]
        before = {k: router._candidates(k)[0].addr for k in ids}
        events: list = []
        up = threading.Thread(target=lambda: events.append(scaler.observe(0.0, lifecycle.fleet_size())))
        up.start()
        n_w = 0
        while up.is_alive():  # traffic through the front door while the third backend spawns and warms
            window(f"scale_up_{n_w}")
            n_w += 1
        up.join()
        ev = events[0]
        act = (ev or {}).get("result", {}).get("actions", [{}])[0]
        if not (ev and ev["direction"] == "up" and ev["backends"] == 3 and ev["result"]["ok"]
                and act.get("stage") == "admitted" and act["verified"]["compile_cache_after_warmup"] == zero):
            raise AssertionError(f"fleet scale_to(3): {ev}")
        new = next(b for b in router.backends if b.addr == act["addr"])
        after_ring = {k: router._candidates(k)[0].addr for k in ids}
        moved = [k for k in ids if after_ring[k] != before[k]]
        log(f"fleet scale_to(3) by the autoscaler (planner sha {ev['planner_sha'][:12]}): admitted {new.host_id} at "
            f"{act['addr']} {act['elapsed_s']} s from spawn, warm verified, work "
            f"{act['verified']['compile_cache_after_warmup']}; {n_w} windows of traffic meanwhile; ring keys moved "
            f"{len(moved)}/{len(ids)}, all to the new host {all(after_ring[k] == new.addr for k in moved)}; "
            f"{_hold_contexts(procs, base, 'scale up')} [{card}]")
        if not moved or not all(after_ring[k] == new.addr for k in moved) or scaler.observe(0.0, 3) is not None:
            raise AssertionError("fleet scale_to(3): keys moved between surviving hosts, or the policy did not converge")
        rid3 = next(f"new-{k}" for k in range(100_000) if router._candidates(f"new-{k}")[0].addr == new.addr)
        with ServeClient(*front, timeout_s=10.0, retries=1, seed=SEED) as c:
            rep3 = c.request(x[1], rid=rid3)
        scaler.set_planner_target({**load_planner_target(str(target_path)), "backends_needed": 2})
        ev2 = scaler.observe(0.0, lifecycle.fleet_size(), slo_attainment=1.0)
        down = (ev2 or {}).get("result", {}).get("actions", [{}])[0]
        retired = [p for p in procs if f"{p.host}:{p.port}" == new.addr]
        log(f"fleet scale_to(2): {json.dumps({k: down.get(k) for k in ('stage', 'addr', 'drained', 'terminated', 'inflight_at_removal')})}, "
            f"process alive {[p.alive() for p in retired]}; events' planner sha {[e['planner_sha'] == sha for e in (ev, ev2)]} "
            f"[{card}]")
        if not (ev2 and ev2["direction"] == "down" and down.get("stage") == "retired" and down.get("drained")
                and down.get("terminated") and not any(p.alive() for p in retired)
                and all(e["planner_sha"] == sha for e in (ev, ev2)) and len(router.backends) == 2):
            raise AssertionError(f"fleet scale_to(2): {ev2}")
        dedup_pin(rid3, rep3, "after its backend retired")

        # a standby killed between spawn and verification: quarantined, never admitted
        def kill_then_verify(host, port, timeout_s=10.0):
            procs[-1].kill()
            return verify_warm(host, port, timeout_s=timeout_s)

        standby = BackendLifecycle(router, spawn_overrides=flags, spawn_timeout_s=300.0, log_dir=str(FLEET_WORK),
                                   spawn_fn=recorded(3), verify_fn=kill_then_verify)
        q = standby.scale_up()
        log(f"fleet quarantine: {json.dumps({k: q.get(k) for k in ('ok', 'stage', 'reason')})}, router members "
            f"{len(router.backends)}, standby alive {procs[-1].alive()} [{card}]")
        if q["ok"] or q["stage"] != "quarantined" or len(router.backends) != 2 or procs[-1].alive():
            raise AssertionError(f"fleet quarantine: {q}")

        # `cli route --fleet.elastic=true` as a process, started now: it comes up while the controller runs
        route_flags = [a for a in flags if not a.startswith("--serve.buckets=")]  # spawn_overrides splits on commas
        route_env = {**os.environ, **card_env(2)}
        t_route = time.perf_counter()
        route_proc = subprocess.Popen(
            [sys.executable, "-m", "qdml_tpu_torch.cli", "route",
             f"--fleet.backends={','.join(addr(b) for b in backends)}", "--fleet.port=0", "--fleet.elastic=true",
             f"--fleet.spawn_overrides={','.join(route_flags)}", "--fleet.spawn_timeout_s=300", *route_flags],
            cwd=root, env=route_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        banner: dict = {}

        def read_banner():
            for line in route_proc.stdout:
                if line.startswith('{"routing"'):
                    banner.update(json.loads(line))
                    break
            for _ in route_proc.stdout:  # keep the pipe drained
                pass

        threading.Thread(target=read_banner, daemon=True).start()

        # the controller over the router: drift -> fine-tune -> canary -> tagged fan-out swap -> watch
        poller = FleetPoller(router)
        ctrl = FleetController(cfg, wd, poller, sink=tally, drift_step_hint=CTL_DRIFT_STEP, device=DEVICE)
        with ServeClient(*front, timeout_s=30.0) as c:
            for i in range(24):
                c.request(x[i], rid=f"ctl-{i}")
        ctrl.tick()
        epochs0 = [(direct(b, "health") or {}).get("swap_epoch") for b in backends]
        for v in [-12.0] * 8 + [-5.5] * 10:
            ctrl.observe_parity(CTL_DRIFT_SCENARIO, v)
        adapted = None
        set_sink(tally)
        try:
            t = time.perf_counter()
            for _ in range(4):
                adapted = next((e for e in ctrl.tick()["events"] if e.get("action") == "adapted"), None)
                if adapted:
                    break
            adapt_s = time.perf_counter() - t
        finally:
            set_sink(prev_sink)
        if not adapted:
            raise AssertionError("fleet controller: no adaptation over the router")
        ft, canary, dep = adapted["finetune"], adapted["canary"], adapted["deploy"]
        fan = dep["swap"]
        epochs1 = [(direct(b, "health") or {}).get("swap_epoch") for b in backends]
        ft_s = tally.spans.get("control_finetune")
        with ServeClient(*front, timeout_s=30.0) as c:
            after = [c.request(x[i], rid=f"ctl-after-{i}") for i in range(64)]
        twin_last = ServeEngine.from_workdir(cfg, wd, device="cpu", tags={"hdce": "hdce_last"})
        held = _hold_served(_twin_reference(torch, twin_last, x[:64]), np.asarray([r["h"] for r in after], np.float32),
                            np.array([r["pred"] for r in after]), "fleet after the controller's swap")
        confirmed = None
        for _ in range(cfg.control.watch_ticks + 1):
            ctrl.observe_parity(CTL_DRIFT_SCENARIO, canary["drifted_probes"]["cand_db"])
            confirmed = next((e for e in ctrl.tick()["events"] if e.get("action") == "deploy_confirmed"), confirmed)
        log(f"fleet controller over the router: adapted in {adapt_s:.2f} s, fine-tune {ft['steps']} steps in "
            f"{ft_s:.3f} s ({ft['steps'] / ft_s:.1f} steps/s) val NMSE {ft['val_nmse_db_before']} -> "
            f"{ft['val_nmse_db_after']} dB; canary passed {canary['passed']} gain {canary['gain_db']} dB; swap fanned to "
            f"{fan['fanned_to']} ok {fan['ok_count']}, tags {[v['swap']['tags'] for v in fan['backends'].values()]}, "
            f"epochs {epochs0} -> {epochs1}; answers after it against the CPU twin of hdce_last "
            f"{held['max_abs_err']:.3e} (tol {held['tol']:.3e}); watch {json.dumps(confirmed)} [{card}]")
        if not (fan["ok"] and fan["fanned_to"] == 2 and all(v["swap"]["work"] == zero for v in fan["backends"].values())
                and all(b > a for a, b in zip(epochs0, epochs1)) and confirmed is not None):
            raise AssertionError(f"fleet controller: swap {fan}, epochs {epochs0} -> {epochs1}, watch {confirmed}")

        work = [(direct(b) or {}).get("compile_cache_after_warmup") for b in backends]
        log(f"fleet: request-path work on every surviving backend (its own metrics verb): {work} [{card}]")
        if work != [zero, zero]:
            raise AssertionError(f"fleet: request-path work after warmup: {work}")

        # `cli route`'s banner, `cli fleet-scale` against it and against the in-process router
        while not banner and route_proc.poll() is None and time.perf_counter() - t_route < 120.0:
            time.sleep(0.05)
        if not banner:
            raise AssertionError(f"fleet: `cli route` printed no banner (exit {route_proc.poll()})")
        route_up = time.perf_counter() - t_route
        cmd = [sys.executable, "-m", "qdml_tpu_torch.cli", "fleet-scale"]
        t = time.perf_counter()
        grow = subprocess.run([*cmd, f"--addr={banner['routing']}", "--backends=3", "--timeout-s=600"], cwd=root,
                              capture_output=True, text=True, timeout=900)
        grow_s = time.perf_counter() - t
        plain = subprocess.run([*cmd, f"--addr={front[0]}:{front[1]}", "--backends=3"], cwd=root, capture_output=True,
                               text=True, timeout=120)
        grown = json.loads(grow.stdout) if grow.stdout.startswith("{") else {}
        refused = json.loads(plain.stdout) if plain.stdout.startswith("{") else {}
        contexts = _hold_contexts(backends, base + 1, "route's spawned backend")  # its backend: one context more
        route_proc.send_signal(2)
        route_rc = route_proc.wait(timeout=120.0)
        log(f"fleet `cli route --fleet.elastic=true`: banner {json.dumps({k: banner[k] for k in ('routing', 'elastic', 'backends_live')})} "
            f"{route_up:.2f} s after its start; `fleet-scale --backends=3` exit {grow.returncode} in {grow_s:.2f} s "
            f"({(grown.get('fleet') or {}).get('backends')} backends, {contexts}); against the router without a "
            f"lifecycle exit {plain.returncode}, {refused.get('reason')}; route stopped with exit {route_rc}, "
            f"{_hold_contexts(backends, base, 'route stopped')} [{card}]")
        if not (banner.get("elastic") is True and banner.get("backends_live") == 2 and grow.returncode == 0
                and grown.get("ok") and grown["fleet"]["backends"] == 3 and plain.returncode == 3
                and str(refused.get("reason")).startswith("fleet_scale_unavailable") and route_rc == 0):
            raise AssertionError(f"fleet commands: grow {grow.returncode} {grow.stdout[-1500:]} {grow.stderr[-1500:]}; "
                                 f"plain {plain.returncode} {plain.stdout[-500:]}; route exit {route_rc}")
        route_proc = None
    finally:
        if monitor:
            monitor["stop"].set()
            if "thread" in monitor:
                monitor["thread"].join(timeout=60.0)
            monitor["log"].close()
        for proc in (route_proc, mon_proc):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60.0)
        if router is not None:
            router.stop()
        if loop_thread.is_alive():
            async def cancel_all():
                live = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
                for task in live:
                    task.cancel()
                await asyncio.gather(*live, return_exceptions=True)

            asyncio.run_coroutine_threadsafe(cancel_all(), aloop).result(timeout=60.0)
            aloop.call_soon_threadsafe(aloop.stop)
            loop_thread.join(timeout=60.0)
        aloop.close()
        for p in procs:
            if p.alive():
                p.terminate()
    stopped = _hold_contexts([], base, "fleet teardown")
    log(f"fleet: router stopped, every backend process ended ({stopped}); phase wall "
        f"{time.perf_counter() - t_phase:.2f} s [{card}]")



# the telemetry phase: the training grid of phase 7; its files under build/
TELE_WORK = EVAL_WORK / "telemetry"
# the CLI's forced-NaN run: 300 samples a cell give one training step of 256
# rows a cell (cut for time: the trip comes at step 1)
TELE_CLI_DATA_LEN = 300
# the world: dp_8q train-qsc, data_len 600 a cell gives 540 train rows (2
# steps of 256) and 60 validation rows, cut for time
TELE_WORLD_DATA_LEN = 600
# timed dispatches of each step variant (the K=16 graph: 3 replays)
TELE_TIMED_STEPS = 16


def _jsonl(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _flat_numerics(records: list[dict], key: str) -> list:
    """A key of every ``numerics`` record, step by step: a K-step record's
    (K,) or (K, E) values flattened in step order."""
    out = []
    for r in records:
        if r.get("kind") == "numerics":
            v = r[key]
            if isinstance(v, dict):  # branch_grad_norm
                out.append(v)
            else:
                out.extend(np.ravel(v).tolist())
    return out


def _probes_close(got: dict, want: dict, rtol: float, what: str, lr: float | None = None, n: int = 0) -> float:
    """Two fetched probes key for key within ``rtol``; with ``lr`` the update
    norm's square within ``n`` lr^2 per member (the last layer's RZ weights:
    their gradient is rounding noise, which Adam turns into up to lr a step
    either way). Returns the worst relative difference held to ``rtol``."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: probe keys {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for k, w in want.items():
        if isinstance(w, dict):
            worst = max(worst, _probes_close(got[k], w, rtol, f"{what}.{k}"))
            continue
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        if lr is not None and k in ("update_norm", "update_ratio"):
            gu, wu = np.asarray(got["update_norm"], np.float64), np.asarray(want["update_norm"], np.float64)
            if np.any(np.abs(gu**2 - wu**2) > n * lr**2 * 1.1):
                raise AssertionError(f"{what}: update norm {gu} vs {wu} beyond {n} lr^2")
            continue
        err = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))
        if not np.allclose(g, w, rtol=rtol, atol=0.0):
            raise AssertionError(f"{what}.{k}: {g.tolist()} vs {w.tolist()} (rtol {rtol})")
        worst = max(worst, err)
    return worst


def telemetry_phase(torch, K, mods, card: str) -> dict[str, int]:
    """Phase 8l: the device half of telemetry at full width (see the module
    docstring). Returns the kernel launches of its trainer and serving runs."""
    from dataclasses import replace

    from qdml_tpu_torch import bench
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.server import ReplicaPool
    from qdml_tpu_torch.serve.types import Prediction
    from qdml_tpu_torch.telemetry import DivergenceError, FlightRecorder, device_memory_snapshot, run_manifest, set_sink
    from qdml_tpu_torch.telemetry.cost import achieved_roofline, analyze
    from qdml_tpu_torch.telemetry.numerics import fetch
    from qdml_tpu_torch.telemetry.report import report_main
    from qdml_tpu_torch.telemetry.sanitizer import checkify_step, error_message
    from qdml_tpu_torch.train import nat_sweep as ns
    from qdml_tpu_torch.train import scan
    from qdml_tpu_torch.train.checkpoint import restore_checkpoint
    from qdml_tpu_torch.utils.metrics import MetricsLogger

    hdce_mod, qsc_mod, ds = mods["hdce"], mods["qsc"], mods["datasets"]
    shutil.rmtree(TELE_WORK, ignore_errors=True)
    TELE_WORK.mkdir(parents=True)
    base = trainer_configs(mods["config"])["hdce"][0]
    base = replace(base, eval=replace(base.eval, results_dir=str(TELE_WORK / "results")))
    t0 = time.perf_counter()
    data = ds.GridData.synthesize(base.data, DEVICE)
    loader = ds.DMLGridLoader(data, TRAIN_BATCH, "train")
    spe = loader.steps_per_epoch
    batches = [{k: b[k] for k in ("yp_img", "h_label", "h_perf", "indicator")}
               for _, b in zip(range(TWIN_STEPS), loader.epoch(0))]
    log(f"telemetry data: the training grid ({base.data.data_len} a cell, {spe} steps of "
        f"{9 * TRAIN_BATCH} rows) in {time.perf_counter() - t0:.2f} s")
    q6 = replace(base.quantum, n_qubits=6, n_layers=3, impl="pallas_circuit")
    qcfg = replace(base, quantum=q6)
    sweep_q = replace(mods["config"].preset("nat_sweep").quantum, n_qubits=6, n_layers=3, impl="pallas_circuit")
    scfg = replace(base, quantum=sweep_q)
    levels = [float(s) for s in sweep_q.noise_sweep]
    launches = {k: 0 for k in K.COUNTERS}

    def epoch(tag: str, fn, cfg, k: int, probe_every: int = 1) -> dict:
        """One epoch of ``fn(cfg, logger)`` at ``scan_steps`` k into a
        manifest-headed JSONL, also the process-global sink; the launch
        counters zeroed just before and read just after."""
        cfg = replace(cfg, train=replace(cfg.train, scan_steps=k, probe_every=probe_every))
        path = TELE_WORK / f"{tag}.jsonl"
        logger = MetricsLogger(str(path), echo=False, manifest=run_manifest(cfg, argv=[tag]))
        set_sink(logger)
        before = dict(scan.activity)
        K.reset_launch_counts()
        # the process's high-water mark restarts here, so the run's first
        # dispatch raises it and its cost record carries its own peak (the
        # counting never resets the mark); the earlier runs' garbage is
        # freed first, or memory it releases during this run would leave
        # the mark above anything a lean step allocates
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        try:
            fn(cfg, logger)
            torch.cuda.synchronize()
        finally:
            set_sink(None)
            logger.close()
        counts = dict(K.launches)
        for c in launches:
            launches[c] += counts[c]
        return {"recs": _jsonl(path), "launches": counts, "path": path, "wall": time.perf_counter() - t,
                "captures": scan.activity["captures"] - before["captures"]}

    # -- probes: K=4 against the per-step path, the first steps against a CPU twin
    trainers = {
        "hdce": (base, lambda c, lg: hdce_mod.train_hdce(c, data=data, logger=lg), 1),
        "qsc": (qcfg, lambda c, lg: qsc_mod.train_classifier(c, True, data=data, logger=lg), 1),
        "nat_sweep": (scfg, lambda c, lg: ns.train_nat_sweep(c, data=data, logger=lg), len(levels)),
    }
    runs = {}
    for name, (cfg, fn, members) in trainers.items():
        r0, r4 = epoch(f"{name}_k0", fn, cfg, 0), epoch(f"{name}_k4", fn, cfg, 4)
        worst = 0.0
        for key in ("grad_norm", "param_norm", "update_norm", "update_ratio", "nonfinite", "branch_grad_norm"):
            a, b = _flat_numerics(r0["recs"], key), _flat_numerics(r4["recs"], key)
            if name != "hdce" and key in ("update_norm", "update_ratio"):
                # the circuit's last-layer RZ weights: a rounding-noise gradient
                # that Adam turns into up to lr a step on either path
                if key == "update_norm":
                    lr, n = cfg.train.lr, cfg.quantum.n_qubits
                    gap = np.abs(np.square(b) - np.square(a))
                    if len(b) != len(a) or np.any(gap > n * lr**2 * 1.1):
                        raise AssertionError(f"telemetry {name}: K=4 update norm {b} vs {a} beyond {n} lr^2")
                continue
            if key == "branch_grad_norm":
                a = {br: np.concatenate([np.ravel(x[br]) for x in a]) for br in a[0]}
                b = {br: np.concatenate([np.ravel(x[br]) for x in b]) for br in b[0]}
                if members == 1:
                    worst = max(worst, _probes_close(b, a, 1e-5, f"telemetry {name} K=4 branches"))
                else:
                    first = {br: v[:members] for br, v in a.items()}
                    _probes_close({br: v[:members] for br, v in b.items()}, first, 1e-5, f"telemetry {name} step 1")
                    _probes_close(b, a, 1e-3, f"telemetry {name} K=4 branches")
                continue
            # the ensemble's K-step path is not its per-step path bit for bit
            # on the card (phase 8e: losses at 1e-5, parameters at the Adam
            # bound), and a gradient norm follows the parameters: step 1 (the
            # same parameters on both paths) at 1e-5, later steps at 1e-3
            later = 1e-5 if members == 1 else 1e-3
            if len(a) != spe * members or len(b) != len(a) or not (
                    np.allclose(b[:members], a[:members], rtol=1e-5, atol=0.0)
                    and np.allclose(b[members:], a[members:], rtol=later, atol=0.0)):
                raise AssertionError(f"telemetry {name}: K=4 {key} {b} vs per-step {a} (rtol 1e-5, later {later})")
            worst = max(worst, float(np.max(np.abs(np.subtract(b, a)) / np.maximum(np.abs(a), 1e-30))))
        costs = {r["name"]: r for rec in (r0, r4) for r in rec["recs"] if r.get("kind") == "cost"}
        log(f"telemetry {name}: {len(_flat_numerics(r0['recs'], 'grad_norm'))} probe values a path, K=4 vs "
            f"per-step max rel diff {worst:.3e} (rtol 1e-5); branches {sorted(_flat_numerics(r0['recs'], 'branch_grad_norm')[0])}; "
            f"graphs {r4['captures']}; cost records {sorted(costs)}; epoch wall per-step {r0['wall']:.2f} s, "
            f"K=4 {r4['wall']:.2f} s [{card}]")
        runs[name] = (r0, r4, costs)

    def twin(name: str, make, lr=None, n=0) -> None:
        got = {}
        for dev in (DEVICE, "cpu"):
            step = make(dev)
            got[dev] = [fetch(step({k: v.to(dev) for k, v in b.items()}, j)["probe"]) for j, b in enumerate(batches)]
        worst = max(_probes_close(g, c, 1e-4, f"telemetry {name} twin step {j}", lr, n)
                    for j, (g, c) in enumerate(zip(got[DEVICE], got["cpu"])))
        log(f"telemetry {name}: first {TWIN_STEPS} steps' probes, card vs CPU twin: max rel diff {worst:.3e} "
            f"(rtol 1e-4{'; update norm within n lr^2' if lr else ''}); step 1 {json.dumps(got[DEVICE][0], default=lambda v: np.asarray(v).tolist())} [{card}]")

    def hdce_maker(dev):
        model, opt = hdce_mod.make_trainer(base, dev, spe)
        return lambda b, j: hdce_mod.hdce_train_step(model, opt, b, probes=True)

    def qsc_maker(dev):
        model, opt = qsc_mod.make_trainer(qcfg, True, dev, spe)
        model.train()
        return lambda b, j: qsc_mod.classifier_train_step(model, opt, b, probes=True)

    def sweep_maker(dev):
        model, params, opt, sigmas = ns.init_sweep(scfg, levels, spe, torch.device(dev))
        noise = ns.epoch_noise(scfg, 0, TWIN_STEPS, len(levels))
        return lambda b, j: ns.sweep_train_step(model, params, opt, sigmas, b, noise[j].to(dev), probes=True)

    twin("hdce", hdce_maker)
    twin("qsc", qsc_maker, qcfg.train.lr, q6.n_qubits)
    twin("nat_sweep", sweep_maker, scfg.train.lr, sweep_q.n_qubits)

    # probe_every=0 at K=4: no host transfer before the epoch's sum; probes on
    # and off capture the same graphs and launch the same B.2 work
    p0 = epoch("qsc_k4_p0", trainers["qsc"][1], qcfg, 4, probe_every=0)
    p1 = runs["qsc"][1]
    counters = [r for r in p0["recs"] if r.get("kind") == "counters"]
    b2 = ("circuit_expvals", "circuit_adjoint")
    log(f"telemetry qsc K=4 probe_every=0: host_transfers {[c['host_transfers'] for c in counters]}, steady "
        f"dispatches {[c['step']['n'] if c['step'] else 0 for c in counters]}, numerics records "
        f"{len(_flat_numerics(p0['recs'], 'grad_norm'))}; graphs {p0['captures']} vs {p1['captures']} with probes; "
        f"B.2 launches {[p0['launches'][k] for k in b2]} vs {[p1['launches'][k] for k in b2]} [{card}]")
    if [c["host_transfers"] for c in counters] != [0] or _flat_numerics(p0["recs"], "grad_norm"):
        raise AssertionError(f"telemetry: probe_every=0 at K=4 made host transfers: {counters}")
    if p0["captures"] != p1["captures"] or any(p0["launches"][k] != p1["launches"][k] for k in b2):
        raise AssertionError("telemetry: probes changed the graphs captured or the B.2 launches")
    if not all(p1["launches"][k] for k in b2):
        raise AssertionError(f"telemetry: the QSC epochs did not launch B.2: {p1['launches']}")

    # -- cost records of the trainer runs. A record carries its dispatch's
    # own peak only where the dispatch raised the high-water mark reset
    # before the run; a QSC step on the front-end kernel pair allocates less
    # than building its first batch did, so its peak is unknown (None, as
    # telemetry/cost.py documents) and every other record must carry one
    for name, (_, _, costs) in runs.items():
        for cname, c in costs.items():
            lean = "qsc_front_fwd" in c.get("kernels", {}) and c["peak_temp_bytes"] is None
            if not (c["available"] and c["platform"] == "gpu-h100" and c["flops"] > 0 and c["bytes_accessed"] > 0
                    and (c["peak_temp_bytes"] or lean) and c["ridge_intensity"] == 20.0):
                raise AssertionError(f"telemetry {name}: cost record {cname} {c}")
            log(f"telemetry cost {cname}: flops {c['flops']:.4e}, bytes {c['bytes_accessed']:.4e}, peak temp "
                f"{c['peak_temp_bytes']} B, intensity {c['arithmetic_intensity']}, ridge {c['ridge_intensity']} "
                f"({c['platform']} {c['dtype']}), {c['roofline']}; hand kernels {json.dumps(c['kernels'])} [{card}]")
    hstep = runs["hdce"][2]["hdce_train_step"]
    rows = 9 * TRAIN_BATCH
    model_flops = 3 * bench.hdce_fwd_flops_per_sample(base) * rows
    off = hstep["flops"] / model_flops - 1
    log(f"telemetry cost: HDCE step counted {hstep['flops']:.6e} flops vs 3 x hdce_fwd_flops_per_sample x {rows} "
        f"rows = {model_flops:.6e} ({off:+.3%}); by op {json.dumps(hstep['flops_by_op'])} [{card}]")
    if abs(off) > 0.05:
        log(f"telemetry cost: the HDCE step's flops differ from the bench model by {off:+.2%}: the ops above "
            "(the model counts 3 x the forward's convolutions and head product; the first convolution needs "
            "no input gradient)")

    # -- step times: probes at the default, probes off, the sanitizer on
    gcfg = bench._grid_cfg()
    gdata, gidx, gsnr = bench._grid(gcfg, torch.device(DEVICE))
    gbatch = gdata.batch(torch.as_tensor(gidx, device=DEVICE), float(gsnr))
    idx16, snr16 = np.broadcast_to(gidx, (16, *gidx.shape)).copy(), np.full(16, gsnr, np.float32)
    dev = torch.device(DEVICE)
    times = {}
    for probes in (True, False):
        model, opt = hdce_mod.make_trainer(gcfg, DEVICE, 10**6)
        run = hdce_mod.make_hdce_scan_steps(model, opt, gdata, 16, probes=probes)
        times[f"hdce_k16_{'probes' if probes else 'p0'}"] = bench._rate(
            lambda: run(idx16, snr16), dev, max(1, TELE_TIMED_STEPS // 16) + 2)["ms"] / 16
    qgcfg = replace(gcfg, quantum=replace(gcfg.quantum, impl="pallas_circuit"))
    for fam, cfg_ in (("hdce", gcfg), ("qsc", qgcfg)):
        for label, probes, ck in (("probes", True, False), ("p0", False, False), ("checkify", False, True)):
            if fam == "hdce":
                model, opt = hdce_mod.make_trainer(cfg_, DEVICE, 10**6)
                step = hdce_mod._step_fn(model, opt, probes, ck)
            else:
                model, opt = qsc_mod.make_trainer(cfg_, True, DEVICE, 10**6)
                model.train()
                step = qsc_mod._step_fn(model, opt, None, probes=probes, checkify_errors=ck)

            def call(step=step, ck=ck):
                m = step(gbatch, None)
                if ck and error_message(m["checkify_err"]) is not None:  # the mode's fetch a step
                    raise AssertionError(f"telemetry: a clean {fam} step tripped the sanitizer")
                return m

            times[f"{fam}_step_{label}"] = bench._rate(call, dev, TELE_TIMED_STEPS)["ms"]
    log(f"time telemetry step ms (2304 rows; probes = the probe computed in the step, as the K-step graph "
        f"does every step at the default probe_every=100 and the per-step path on its cadence steps only, 1 "
        f"in 100; p0 = no probe, the per-step path's other steps and probe_every=0; checkify = the sanitizer "
        f"on a step without the probe, with its fetch a step): "
        f"{json.dumps({k: round(v, 4) for k, v in times.items()})} [{card}]")
    # the roofline of the HDCE and QSC steps at their measured per-step rates
    for fam, cfg_ in (("hdce", gcfg), ("qsc", qgcfg)):
        if fam == "hdce":
            model, opt = hdce_mod.make_trainer(cfg_, DEVICE, 10**6)
            fn = lambda: hdce_mod.hdce_train_step(model, opt, gbatch, probes=True)  # noqa: E731
        else:
            model, opt = qsc_mod.make_trainer(cfg_, True, DEVICE, 10**6)
            model.train()
            fn = lambda: qsc_mod.classifier_train_step(model, opt, gbatch, probes=True)  # noqa: E731
        _, c = analyze(fn, device=DEVICE)
        for label in ("probes", "p0"):
            roof = achieved_roofline(c, 1e3 / times[f"{fam}_step_{label}"])
            log(f"telemetry roofline {fam} step ({label}): flops {c['flops']:.4e}, bytes {c['bytes_accessed']:.4e}, "
                f"intensity {c['arithmetic_intensity']}, {c['roofline']}; achieved "
                f"{roof['achieved_tflops_per_s']} of {roof['ceiling_tflops_per_s']} TFLOP/s = fraction "
                f"{roof['fraction']} ({roof['bound']}-bound) [{card}]")
    log(f"telemetry memory: {json.dumps(device_memory_snapshot())} [{card}]")

    # -- the native .npy loader over this grid, written by save_npy_cache from the card
    from qdml_tpu_torch.runtime import native_io

    npy_dir = TELE_WORK / "npy"
    t = time.perf_counter()
    ds.save_npy_cache(str(npy_dir), base.data, DEVICE)
    save_s = time.perf_counter() - t
    lib = native_io.library_path()
    if not native_io.native_available() or EVAL_WORK.parent not in lib.parents:
        raise AssertionError(f"native loader: library {lib}, available {native_io.native_available()}: "
                             f"{native_io.build_error}")
    npy = ds.NpyGridLoader(str(npy_dir), base.data, TRAIN_BATCH, device=DEVICE)
    worst, n_batches = 0.0, 0
    for a, b in zip(npy.epoch(0), loader.epoch(0)):
        for k in ("yp_img", "h_label", "h_perf", "indicator"):
            if a[k].shape != b[k].shape or a[k].device != b[k].device:
                raise AssertionError(f"native loader {k}: {a[k].shape} on {a[k].device}, want {b[k].shape}")
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6)
            worst = max(worst, (a[k].double() - b[k].double()).abs().max().item())
        n_batches += 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in npy.epoch(1):
        pass
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / spe
    stepped = []
    for b in (next(iter(npy.epoch(0))), next(iter(loader.epoch(0)))):
        model, opt = hdce_mod.make_trainer(base, DEVICE, spe)
        m = hdce_mod.hdce_train_step(model, opt, b)
        stepped.append((m["loss"].item(), {k: v.detach().cpu() for k, v in model.state_dict().items()
                                           if v.is_floating_point()}))
    pw, pout, ptot = _twin_params_close(stepped[0][1], stepped[1][1], base.train.lr, TWIN_STEPS,
                                        "native loader HDCE step")
    log(f"native loader: save_npy_cache of the grid from the card in {save_s:.2f} s; library {lib.relative_to(EVAL_WORK.parent.parent)} "
        f"native {npy.is_native}; one epoch ({n_batches} batches) against DMLGridLoader's: max |diff| {worst:.3e} "
        f"(rtol 1e-5, atol 1e-6); one HDCE step fed from each: loss {stepped[0][0]:.7f} vs {stepped[1][0]:.7f}, "
        f"params max |diff| {pw:.3e}, {pout}/{ptot} outside 1e-5 + 1e-4|p| [{card}]")
    log(f"time native loader: {host_ms:.3f} ms a step of {9 * TRAIN_BATCH} rows on the host (mmap, C++ gather, "
        f"copy to the card; an epoch with nothing else to do), beside the K=16 HDCE step's "
        f"{times['hdce_k16_probes']:.3f} ms ({times['hdce_k16_p0']:.3f} ms without the probe; graph replays, "
        f"wall between synchronizations) [{card}]")
    if n_batches != spe or not npy.is_native or abs(stepped[0][0] - stepped[1][0]) > 1e-5 * abs(stepped[1][0]):
        raise AssertionError(f"native loader: {n_batches} batches, native {npy.is_native}, losses {stepped}")
    npy.close()

    # -- the watchdog: QuantumNAT noise_level=inf, NaN generated inside B.2
    nat_inf = replace(q6, use_quantumnat=True, noise_level=float("inf"))
    ncfg = replace(qcfg, quantum=nat_inf, train=replace(qcfg.train, probe_every=1, scan_steps=1))
    try:
        qsc_mod.train_classifier(ncfg, True, data=data, logger=Recorder())
        raise AssertionError("telemetry: the noise_level=inf run did not diverge")
    except DivergenceError as e:
        err = e
    bundle = json.loads((Path(err.dump_dir) / "bundle.json").read_text())
    restored, meta = restore_checkpoint(err.dump_dir, bundle["last_good"]["checkpoint"], map_location=DEVICE)
    model = build_classifier(ncfg, True, DEVICE)
    model.load_state_dict(restored["params"])
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    log(f"telemetry watchdog: {err.reason!r} at step {bundle['step']}; bundle {sorted(bundle)}; probe history "
        f"{len(bundle['probe_history'])}, batch_info {bundle['batch_info'] is not None}, rng {bundle['rng_key']}; "
        f"last_good step {meta['step']} restored on the card, finite {finite} [{card}]")
    if not (bundle["reason"] == err.reason and bundle["probe_history"] and bundle["batch_info"] and finite):
        raise AssertionError(f"telemetry watchdog: bundle {bundle}")
    cli_args = ["train-qsc", "--quantum.n_qubits=6", "--quantum.n_layers=3", "--quantum.impl=pallas_circuit",
                "--quantum.use_quantumnat=true", "--quantum.noise_level=inf", f"--data.data_len={TELE_CLI_DATA_LEN}",
                f"--train.workdir={TELE_WORK / 'cli'}", f"--eval.results_dir={TELE_WORK / 'cli_results'}"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "qdml_tpu_torch.cli", *cli_args], capture_output=True, text=True,
                         timeout=300, env=env, cwd=str(Path(__file__).resolve().parent))
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("DIVERGED:")), None)
    log(f"telemetry cli train-qsc noise_level=inf: exit {out.returncode} in {time.perf_counter() - t:.2f} s; {line} [{card}]")
    if out.returncode != 4 or line is None:
        raise AssertionError(f"telemetry cli: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")

    # -- the sanitizer in training: bit for bit needs deterministic kernels on
    # the card (cuDNN's weight gradients and the NLL's scatter-add use atomics)
    deterministic = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    for fam in ("hdce", "qsc"):
        res = []
        for ck in (False, True):
            if fam == "hdce":
                model, opt = hdce_mod.make_trainer(base, DEVICE, spe)
                step = hdce_mod._step_fn(model, opt, True, ck)
            else:
                model, opt = qsc_mod.make_trainer(qcfg, True, DEVICE, spe)
                model.train()
                step = qsc_mod._step_fn(model, opt, None, probes=True, checkify_errors=ck)
            losses = []
            for b in batches:
                m = step(b, None)
                if ck and error_message(m["checkify_err"]) is not None:
                    raise AssertionError(f"telemetry checkify {fam}: a clean step tripped")
                losses.append(m["loss"].item())
            res.append((losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}))
        same = res[0][0] == res[1][0] and all(torch.equal(v, res[1][1][k]) for k, v in res[0][1].items())
        log(f"telemetry checkify {fam}: {TWIN_STEPS} steps checked and unchecked, losses {res[1][0]}, "
            f"bit for bit {'yes' if same else 'no'} [{card}]")
        if not same:
            raise AssertionError(f"telemetry checkify {fam}: checked {res[1][0]} vs unchecked {res[0][0]}")
    torch.backends.cudnn.deterministic = deterministic[0]
    torch.use_deterministic_algorithms(deterministic[1])
    rec = Recorder()
    ccfg = replace(qcfg, train=replace(qcfg.train, checkify=True, scan_steps=4))
    if scan.scan_eligible(ccfg, rec, torch.device(DEVICE)) or not rec.records[0]["reason"].startswith("checkify:"):
        raise AssertionError(f"telemetry checkify: scan_dispatch {rec.records}")
    model, opt = hdce_mod.make_trainer(base, DEVICE, spe)
    bad = dict(batches[0], yp_img=torch.full_like(batches[0]["yp_img"], float("inf")))
    msgs = {"inf_pilots": error_message(hdce_mod._step_fn(model, opt, True, True)(bad, None)["checkify_err"])}
    model, opt = qsc_mod.make_trainer(replace(qcfg, quantum=nat_inf), True, DEVICE, spe)
    model.train()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    msgs["noise_inf"] = error_message(
        qsc_mod._step_fn(model, opt, gen, probes=True, checkify_errors=True)(batches[0], None)["checkify_err"])
    model, opt = qsc_mod.make_trainer(qcfg, True, DEVICE, spe)
    model.train()
    step = qsc_mod._step_fn(model, opt, None, probes=True, checkify_errors=True)
    label = batches[0]["indicator"].clone()
    label.view(-1)[0] = 7
    msgs["label_7"] = error_message(step(dict(batches[0], indicator=label), None)["checkify_err"])
    after = step(batches[1], None)
    msgs["clean_after"] = error_message(after["checkify_err"])
    torch.cuda.synchronize()
    log(f"telemetry checkify trips: {json.dumps(msgs)}; the step after the bad label: loss {after['loss'].item():.6f}, "
        f"the context alive; scan_dispatch {rec.records[0]['reason']!r} [{card}]")
    if not (msgs["inf_pilots"] or "").startswith("nan generated by primitive: aten."):
        raise AssertionError(f"telemetry checkify inf pilots: {msgs['inf_pilots']}")
    if "circuit_expvals" not in (msgs["noise_inf"] or ""):
        raise AssertionError(f"telemetry checkify noise inf: {msgs['noise_inf']}")
    if not (msgs["label_7"] or "").startswith("out-of-bounds indexing") or msgs["clean_after"] is not None \
            or not np.isfinite(after["loss"].item()):
        raise AssertionError(f"telemetry checkify label: {msgs}")
    # one NaN in a checked HDCE step's batch: it trips where the data meets
    # the first convolution, through the flight recorder (JAX's rule)
    model, opt = hdce_mod.make_trainer(base, DEVICE, spe)
    one_nan = batches[0]["yp_img"].clone()
    one_nan[1, 2, 17, 5, 3, 0] = float("nan")
    rec = FlightRecorder("telemetry_nan_batch", base)
    rec.note_good(model.state_dict)
    m = hdce_mod._step_fn(model, opt, True, True)(dict(batches[0], yp_img=one_nan), None)
    try:
        rec.on_step(0, m, loss=float(m["loss"]), params=model.state_dict)
        raise AssertionError("telemetry checkify: one NaN in the batch did not trip")
    except DivergenceError as e:
        nan_trip = e
    log(f"telemetry checkify one NaN in an HDCE batch: {nan_trip.reason!r}, bundle under "
        f"{Path(nan_trip.dump_dir).relative_to(TELE_WORK)} [{card}]")
    if not (nan_trip.reason.startswith("checkify: nan generated by primitive: aten.") and "conv" in nan_trip.reason
            and (Path(nan_trip.dump_dir) / "bundle.json").exists()):
        raise AssertionError(f"telemetry checkify NaN batch: {nan_trip.reason}")

    # -- serve.checkify at full width
    sbase = mods["config"].ExperimentConfig()
    sq = replace(sbase.quantum, n_qubits=6, n_layers=3, impl="pallas_circuit")
    s_plain = replace(sbase, quantum=sq, serve=replace(sbase.serve, batching="bucket"))
    s_ck = replace(s_plain, serve=replace(s_plain.serve, checkify=True))
    gen = torch.Generator().manual_seed(SEED + 40)
    hdce_sd = hdce_mod.build_hdce(s_plain, device="cpu", generator=gen).state_dict()
    clf_sd = qsc_mod.build_classifier(s_plain, True, device="cpu", generator=gen).state_dict()
    checked = ServeEngine(s_ck, hdce_sd, clf_sd, quantum=True, buckets=BUCKETS, device=DEVICE)
    plain = ServeEngine(s_plain, hdce_sd, clf_sd, quantum=True, buckets=BUCKETS, device=DEVICE)
    cpu = ServeEngine(s_plain, hdce_sd, clf_sd, quantum=True, buckets=BUCKETS, device="cpu")
    # the checked engine's warmup counts each bucket into an active sink, from
    # a fresh high-water mark (see epoch above); the others count nothing
    serve_log = MetricsLogger(str(TELE_WORK / "serve_warmup.jsonl"), echo=False,
                              manifest=run_manifest(s_ck, argv=["serve_warmup"]))
    set_sink(serve_log)
    torch.cuda.reset_peak_memory_stats()
    try:
        checked.warmup()
    finally:
        set_sink(None)
        serve_log.close()
    for e in (plain, cpu):
        e.warmup()
    if plain.bucket_cost[str(BUCKETS[-1])]["available"]:
        raise AssertionError(f"telemetry: a warmup without a sink counted: {plain.bucket_cost}")
    for b, c in checked.bucket_cost.items():
        if not (c["available"] and c["platform"] == "gpu-h100" and c["flops"] > 0 and c["peak_temp_bytes"]
                and c["ridge_intensity"] == 20.0):
            raise AssertionError(f"telemetry serve cost bucket {b}: {c}")
        log(f"telemetry cost serve_bucket {b}: flops {c['flops']:.4e}, bytes {c['bytes_accessed']:.4e}, peak temp "
            f"{c['peak_temp_bytes']} B, intensity {c['arithmetic_intensity']}, {c['roofline']} [{card}]")
    rng = np.random.default_rng(SEED + 41)
    reqs = {n: rng.standard_normal((n, *sbase.image_hw, 2)).astype(np.float32) for n in REQUEST_SIZES}
    work0 = checked.request_path_work()
    K.reset_launch_counts()
    got = {n: checked.infer(x) for n, x in reqs.items()}
    torch.cuda.synchronize()
    counts = dict(K.launches)
    for c in launches:
        launches[c] += counts[c]
    for n, x in reqs.items():
        h, pred, conf, _ = got[n]
        h0, pred0, conf0, _ = plain.infer(x)
        hc, predc, _, _ = cpu.infer(x)
        same = pred == predc
        tol = 1e-4 * np.abs(hc).max() + 1e-5
        err = float(np.abs(h[same] - hc[same]).max()) if same.any() else 0.0
        log(f"telemetry serve checkify n={n}: equal to the unchecked engine "
            f"{np.array_equal(h, h0) and np.array_equal(pred, pred0)}, max|h - h_cpu| {err:.3e} (tol {tol:.3e}) on "
            f"{int(same.sum())}/{n} rows routed alike [{card}]")
        if not (np.array_equal(h, h0) and np.array_equal(pred, pred0) and np.array_equal(conf, conf0)) or err > tol:
            raise AssertionError(f"telemetry serve checkify n={n}")
    if checked.request_path_work() != work0 or counts["circuit_expvals"] == 0:
        raise AssertionError(f"telemetry serve: work {checked.request_path_work()} vs {work0}, launches {counts}")
    try:
        checked.infer(np.full((3, *sbase.image_hw, 2), np.inf, np.float32))
        raise AssertionError("telemetry serve: the poisoned batch served")
    except DivergenceError as e:
        poisoned = str(e)
    nan_pilot = reqs[5].copy()
    nan_pilot[2, 4, 3, 1] = np.nan  # one pilot of one request
    try:
        checked.infer(nan_pilot)
        raise AssertionError("telemetry serve: the NaN-pilot request served")
    except DivergenceError as e:
        nan_served = str(e)
    # the first op to meet the pilot is the classifier's front end, on the
    # card its hand-written kernel pair
    if nan_served != "serve checkify tripped on bucket 8: nan generated by primitive: qsc_front_fwd.":
        raise AssertionError(f"telemetry serve NaN pilot: {nan_served}")
    h1 = checked.infer(reqs[5])[0]
    if not np.array_equal(h1, got[5][0]):
        raise AssertionError("telemetry serve: the batch after the trip differs")
    ragged = ServeEngine(replace(s_ck, serve=replace(s_ck.serve, batching="ragged")), hdce_sd, clf_sd,
                         quantum=True, buckets=BUCKETS, device=DEVICE)
    ragged.warmup()
    for fill in (3, 37):
        xp = rng.standard_normal((64, *sbase.image_hw, 2)).astype(np.float32)
        clean = ragged.forward_tier(xp.copy(), fill)[0][:fill].cpu()
        xp[fill:] = np.nan
        xp[fill + 1::2] = np.inf
        h = ragged.forward_tier(xp, fill)[0].cpu()
        if not (torch.equal(h[:fill], clean) and bool(torch.isfinite(h).all())):
            raise AssertionError(f"telemetry serve ragged fill {fill}: NaN pads reached the output")
    pool = ReplicaPool(checked, replicas=2, workers=2, log_requests=False).start()
    x64 = reqs[64]
    try:
        first = [f.result(timeout=60) for f in [pool.submit(x64[i], rid=i) for i in range(32)]]
        try:
            pool.submit(np.full(x64.shape[1:], np.inf, np.float32), rid="poisoned").result(timeout=60)
            typed = None
        except DivergenceError as e:
            typed = type(e).__name__
        later = [f.result(timeout=60) for f in [pool.submit(x64[i], rid=100 + i) for i in range(32)]]
    finally:
        pool.stop()
    served = sum(isinstance(r, Prediction) for r in first + later)
    log(f"telemetry serve: poisoned batch {poisoned!r}, a NaN-pilot request {nan_served!r}, the next served; "
        f"ragged NaN pads at fills 3 and 37 pass; "
        f"2x2 pool: the poisoned future failed {typed}, {served}/64 others served [{card}]")
    if typed != "DivergenceError" or served != 64:
        raise AssertionError(f"telemetry serve pool: {typed}, served {served}")

    # -- a world of 2 ranks on the card: the global probe
    shared = torch.cuda.device_count() < 4
    flag = f" --device={MR_DEVICE}" if shared else ""
    wd = TELE_WORK / "dp"
    args = ["train-qsc", "--preset=dp_8q", f"--data.data_len={TELE_WORLD_DATA_LEN}", "--train.n_epochs=1",
            "--train.probe_every=1", f"--quantum.autotune_table={wd / 'qsc_impl.json'}",
            f"--eval.results_dir={wd / 'results'}"]
    _mr_world("telemetry_dp", 2, [f"cli:{' '.join(args)}{flag} --train.workdir={wd / 'many'}"], shared, launcher=True)
    if mods["cli"].main([*args, f"--train.workdir={wd / 'one'}", f"--device={MR_DEVICE}"]) != 0:
        raise AssertionError("telemetry world: the one-rank run failed")
    many = _jsonl(wd / "many" / "Pn_128" / "dp_8q" / "train-qsc.metrics.jsonl")
    one = _jsonl(wd / "one" / "Pn_128" / "dp_8q" / "train-qsc.metrics.jsonl")
    keys = ("grad_norm", "param_norm", "update_norm", "update_ratio", "nonfinite")
    probes = [{k: np.asarray(_flat_numerics(recs, k)) for k in keys} for recs in (many, one)]
    if [len(p["grad_norm"]) for p in probes] != [2, 2]:
        raise AssertionError(f"telemetry world: {[len(p['grad_norm']) for p in probes]} steps, want 2 each")
    wcfg = mods["config"].from_args(args[1:])
    worst = _probes_close(*probes, 1e-5, "telemetry world", wcfg.train.lr, wcfg.quantum.n_qubits)
    log(f"telemetry world dp_8q train-qsc on 2 ranks: rank 0's numerics against one rank's over 2 steps, max rel "
        f"diff {worst:.3e} (rtol 1e-5; the update norm's square within n lr^2), grad norms "
        f"{probes[0]['grad_norm'].tolist()} vs {probes[1]['grad_norm'].tolist()} [{card}]")

    # -- report over the phase's own stream and phase 8j's bench line
    qsc_jsonl = runs["qsc"][0]["path"]
    bench_line = EVAL_WORK / "bench.json"
    doubled = TELE_WORK / "bench_doubled.json"

    def double(node):
        if isinstance(node, dict):
            return {k: (2 * v if k == "samples_per_sec" and isinstance(v, (int, float)) else double(v))
                    for k, v in node.items()}
        return [double(v) for v in node] if isinstance(node, list) else node

    doubled.write_text(json.dumps(double(json.loads(bench_line.read_text()))))
    rcs = {}
    for tag, cur, ref in (("train_jsonl_vs_itself", qsc_jsonl, qsc_jsonl), ("bench_vs_itself", bench_line, bench_line),
                          ("bench_vs_doubled", bench_line, doubled)):
        with contextlib.redirect_stdout(io.StringIO()):  # the markdown goes to the .md file
            rcs[tag] = report_main([f"--current={cur}", f"--baseline={ref}", f"--out={TELE_WORK / (tag + '.md')}"])
    log(f"telemetry report exit codes: {json.dumps(rcs)} (want 0, 0, 3) [{card}]")
    if rcs != {"train_jsonl_vs_itself": 0, "bench_vs_itself": 0, "bench_vs_doubled": 3}:
        raise AssertionError(f"telemetry report: {rcs}")
    return launches


def bench_phase(card: str) -> None:
    """``python -m qdml_tpu_torch.bench`` in this process at 48 timed steps
    a row (3 dispatches of K=16 on the scan rows), ``qsc_scaling`` at n = 4
    and 16 (the scaling phase ran the whole grid): its JSON line is printed
    here; it must exit 0 (every row measured)."""
    from qdml_tpu_torch import bench

    rc = bench.main(["--steps=48", "--scan-steps=16", "--qubits=4,16", f"--out={EVAL_WORK / 'bench.json'}"])
    if rc != 0:
        raise AssertionError(f"qdml_tpu_torch.bench exited {rc}")
    log(f"bench: one JSON line above, also in {EVAL_WORK / 'bench.json'} [{card}]")


# the lint phase's process: the port's CLI, then what it left in the process
LINT_WRAPPER = (
    "import json, sys, torch\n"
    "from qdml_tpu_torch import cli\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print(json.dumps({'rc': rc, 'cuda_initialized': torch.cuda.is_initialized(),\n"
    "                  'kernels_loaded': 'qdml_tpu_torch.quantum.kernels' in sys.modules}))\n"
)
LINT_MAX_S = 15.0


def lint_phase(card: str) -> None:
    """``python -m qdml_tpu_torch.cli lint --baseline --lockgraph-check
    --json=build/chip_smoke/lint.json`` through a ``-c`` wrapper that calls
    ``cli.main`` and then reports ``torch.cuda.is_initialized()`` and whether
    the kernels' module was loaded: the gate, the whole-program concurrency
    pass among it, must pass (exit 0, no new finding, the committed lock
    graph fresh) without a CUDA context or a kernel, in under
    ``LINT_MAX_S`` seconds. A host tool must not hold memory on a serving
    card."""
    out = EVAL_WORK / "lint.json"
    t = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-c", LINT_WRAPPER, "lint", "--baseline", "--lockgraph-check", f"--json={out}"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=120,
    )
    secs = time.perf_counter() - t
    lines = run.stdout.strip().splitlines()
    if run.returncode != 0 or not lines:
        raise AssertionError(f"lint wrapper exited {run.returncode}: {run.stdout[-2000:]} {run.stderr[-2000:]}")
    proc = json.loads(lines[-1])
    gate = json.loads(out.read_text())
    for line in lines[:-1]:
        log(f"lint: {line}")
    log(f"lint: exit {proc['rc']}, new findings {gate['new_findings']}, suppressed {gate['suppressed']}, "
        f"baselined {gate['baselined']}, CUDA initialised {proc['cuda_initialized']}, kernels module loaded "
        f"{proc['kernels_loaded']}, {secs:.2f} s for the process (limit {LINT_MAX_S:g} s) [{card}]")
    if proc["rc"] != 0 or gate["new_findings"] != 0 or not gate["ok"]:
        raise AssertionError(f"lint gate failed: exit {proc['rc']}, {gate['per_rule']}, {gate['errors']}")
    if proc["cuda_initialized"] or proc["kernels_loaded"]:
        raise AssertionError(f"lint touched the card: {proc}")
    if secs > LINT_MAX_S:
        raise AssertionError(f"lint took {secs:.2f} s, over {LINT_MAX_S:g} s")


LOCKDEP_MAX_S = 40.0


def lockdep_phase(card: str) -> None:
    """The serving tier's locks witnessed at run time
    (``qdml_tpu_torch/scripts/lockdep_witness.py`` in a process of its own
    with ``QDML_LOCKDEP=1``, on the serve_tier phase's workdir, as JAX's
    ``scripts/chaos_dryrun.py`` witnesses its replica crash): one injected
    ``worker_exception`` and the supervised restart, then one
    ``swap_params`` with a wave in flight. Fails unless the witness saw no
    inversion and some locks and edges, in under ``LOCKDEP_MAX_S``; each
    witnessed edge is logged beside whether the committed static lock graph
    has it."""
    root = Path(__file__).resolve().parent
    t = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "qdml_tpu_torch.scripts.lockdep_witness", "--device=cuda",
         f"--train.workdir={TIER_WORK / 'ws'}", "--quantum.n_qubits=6", "--quantum.n_layers=3",
         "--serve.workers=2", f"--quantum.autotune_table={TUNE_DIR / 'qsc_impl.json'}"],
        cwd=root, env={**os.environ, "QDML_LOCKDEP": "1"}, capture_output=True, text=True, timeout=120,
    )
    secs = time.perf_counter() - t
    lines = run.stdout.strip().splitlines()
    if not lines:
        raise AssertionError(f"lockdep witness exited {run.returncode}: {run.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    graph = json.loads((root / "qdml_tpu_torch" / "analysis" / "lockgraph" / "lockgraph.json").read_text())
    static = {(e["src"], e["dst"]) for e in graph["edges"]}
    for a, b in rec["edges"]:
        log(f"lockdep witnessed edge {a} -> {b}: in the static graph {(a, b) in static} [{card}]")
    w = rec["lockdep"]
    log(f"lockdep witness (QDML_LOCKDEP=1, own process on {rec['device']}): exit {run.returncode}, locks "
        f"{w['locks']}, edges {w['edges']}, max held {w['max_held']}, inversions {w['inversions']}; fault fired "
        f"{rec['fired']}, restarts {rec['restarts']}, faults {json.dumps(rec['faults'])}, swap epoch "
        f"{rec['swap_epoch']}, requests {json.dumps(rec['outcome'])} of {rec['sent']}; {rec['seconds']:.2f} s in "
        f"the witness, {secs:.2f} s for the process (limit {LOCKDEP_MAX_S:g} s) [{card}]")
    if run.returncode != 0 or w["inversions"] != 0 or w["locks"] <= 0 or w["edges"] <= 0:
        raise AssertionError(f"lockdep witness failed: exit {run.returncode}, {rec}, {run.stderr[-2000:]}")
    if secs > LOCKDEP_MAX_S:
        raise AssertionError(f"lockdep witness took {secs:.2f} s, over {LOCKDEP_MAX_S:g} s")


def main() -> int:
    t_main = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    only_multirank = sys.argv[1:] == ["--only=multirank"]
    if sys.argv[1:] and not only_multirank:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; want none or --only=multirank", file=sys.stderr)
        return 2

    from qdml_tpu_torch import cli
    from qdml_tpu_torch import config as cfg_mod
    from qdml_tpu_torch.data import datasets
    from qdml_tpu_torch.models import qsc as qsc_mod
    from qdml_tpu_torch.quantum import circuits
    from qdml_tpu_torch.quantum import kernels as K
    from qdml_tpu_torch.serve import engine as engine_mod
    from qdml_tpu_torch.train import dce as dce_mod
    from qdml_tpu_torch.train import hdce as hdce_mod
    from qdml_tpu_torch.train import qsc as train_qsc
    from qdml_tpu_torch.utils.device import resolve_device

    resolve_device()  # float32 matmuls and convs (no TF32)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = cards[0]
    for i, c in enumerate(cards):
        log(f"gpu{'' if i == 0 else f' {i}'}: {c}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    def log_build(secs: dict, t0: float) -> None:
        log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} wall {time.perf_counter() - t0:.2f} s")
        for name in secs:
            for line in K.build_log.get(name, "").splitlines():
                if ("ptxas" in line and ("registers" in line or "smem" in line or "Compiling entry" in line)
                        or "spill" in line):
                    log(f"ptxas {name}: {line.strip()}")

    # every kernel's nvcc starts now; the unitary kernel's source (three tile
    # plans for each n up to 14) compiles longest, so its build runs in a
    # thread beside the other four kernels' checks, which come first
    t0 = time.perf_counter()
    slow = "unitary_expvals"
    slow_build: dict = {}

    def build_slow():
        try:
            slow_build["secs"] = K.build((slow,))
        except Exception as e:  # lint: disable=broad-except(the build thread hands any failure to the main thread, which re-raises it in unitary_ready)
            slow_build["error"] = e

    slow_thread = threading.Thread(target=build_slow)
    slow_thread.start()
    log_build(K.build(tuple(k for k in K.SOURCES if k != slow)), t0)

    def unitary_ready() -> None:
        t = time.perf_counter()
        slow_thread.join()
        if "error" in slow_build:
            raise slow_build["error"]
        log_build(slow_build["secs"], t0)
        log(f"build: waited {time.perf_counter() - t:.2f} s for {slow} after the other kernels' checks")

    # the adjoint's resident blocks and warps per SM (L=3), beside ptxas's registers
    for n in (6, 8, 10, 12):
        blocks, threads = K.circuit_adjoint_occupancy(n, 3)
        log(f"occupancy circuit_adjoint n={n} L=3: {blocks} resident blocks of {threads} threads per SM, "
            f"{blocks * threads // 32} warps (cudaOccupancyMaxActiveBlocksPerMultiprocessor) [{card}]")

    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t, 2)
        return out

    from qdml_tpu_torch.train import scan as scan_mod

    mods = {"config": cfg_mod, "datasets": datasets, "hdce": hdce_mod, "qsc": train_qsc, "cli": cli, "dce": dce_mod,
            "scan": scan_mod}
    if only_multirank:
        unitary_ready()
        launches = phase("multirank", multirank_phase, torch, K, mods, card)
        log(f"multirank launches: {json.dumps(launches)} [{card}]")
        if torch.cuda.device_count() >= 4:  # mesh serving over the real cards
            from qdml_tpu_torch.quantum import autotune
            from qdml_tpu_torch.serve import batching_autotune

            autotune.set_table_path(str(TUNE_DIR / "qsc_impl.json"))
            batching_autotune.set_table_path(str(TUNE_DIR / "serve_batching.json"))
            launches = phase("mesh_serve", mesh_serve_phase, torch, K, mods, card, True)
        log(f"phase wall seconds: {json.dumps(phase_s)} [{card}]")
        print(json.dumps({"ok": True, "phase": "multirank", "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    K.reset_launch_counts()
    worst = phase("kernels", check_kernels, torch, K, circuits, unitary_ready)
    kernel_phase = dict(K.launches)
    # the impl race's table of this run under build/chip_smoke/autotune/
    from qdml_tpu_torch.quantum import autotune

    shutil.rmtree(EVAL_WORK, ignore_errors=True)
    autotune.set_table_path(str(TUNE_DIR / "qsc_impl.json"))
    from qdml_tpu_torch.serve import batching_autotune

    batching_autotune.set_table_path(str(TUNE_DIR / "serve_batching.json"))
    phase("lint", lint_phase, card)
    race_launches = phase("autotune", autotune_phase, torch, K, cfg_mod, card)
    launches, engines, requests = phase("serve", serve, torch, K, cfg_mod, engine_mod, hdce_mod, qsc_mod)
    dispatch_launches = phase(
        "serve dispatch", serve_dispatch, torch, K, cfg_mod, engine_mod, hdce_mod, qsc_mod, engines, card
    )
    micro_launches = phase("microbench", microbench, torch, K, card)
    tier_launches = phase("serve_tier", serve_tier_phase, torch, K, mods, card)
    phase("lockdep", lockdep_phase, card)
    mesh_launches = phase("mesh_serve", mesh_serve_phase, torch, K, mods, card, False)
    control_launches = phase("control", control_phase, torch, K, mods, card)
    phase("fleet", fleet_phase, torch, K, mods, card)
    train_launches, adjoint_per_step, train_data = phase("train", train, torch, K, mods, card)
    dce_launches = phase("dce", dce_phase, torch, K, mods, card, train_data)
    del train_data
    eval_launches = phase("eval", evaluate, torch, K, mods, card)
    phase("interop", interop_phase, torch, mods, card)
    nat_launches, ens = phase("nat_sweep", nat_sweep_phase, torch, K, mods, card)
    traj_call = phase("trajectories", trajectories_phase, torch, card)
    scan_launches = phase("scan", scan_phase, torch, K, mods, card)
    phase("routing", routing_phase, torch, mods, card)
    lowp_launches = phase("lowp", lowp_phase, torch, K, mods, card)
    phase("mps", mps_phase, torch, K, mods, card)
    scaling_launches = phase("scaling", scaling_phase, torch, K, card)
    phase("bench", bench_phase, card)
    multirank_launches = phase("multirank", multirank_phase, torch, K, mods, card)
    tele_launches = phase("telemetry", telemetry_phase, torch, K, mods, card)
    t_times = time.perf_counter()
    launches = {
        k: race_launches[k] + launches[k] + dispatch_launches[k] + micro_launches[k] + train_launches[k]
        + dce_launches[k] + eval_launches[k] + nat_launches[k] + scan_launches[k] + lowp_launches[k]
        + scaling_launches[k] + tier_launches[k] + multirank_launches[k] + mesh_launches[k] + control_launches[k]
        + tele_launches[k]
        for k in launches
    }
    # B.3's one entry point is the sharded statevector's local wires: its
    # launches are the sharded_16q training world's (every rank's)
    log(f"rotation_layer launches in the kernel phase's checks (not counted): {kernel_phase['rotation_layer']}")
    log(f"launches on each kernel's path: {json.dumps(launches)}")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched on its path")

    # times at the serving shapes, plain version beside each kernel
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    a6 = torch.tensor(rng.uniform(-1, 1, (SERVE_BATCH, 6)), dtype=torch.float32, device=dev)
    w6 = torch.tensor(rng.uniform(0, 2 * np.pi, (3, 6, 2)), dtype=torch.float32, device=dev)
    u6 = circuits.ansatz_unitary(w6, 6, 3)
    ur, ui = u6.re.contiguous(), u6.im.contiguous()
    a8 = torch.tensor(rng.uniform(-1, 1, (SERVE_BATCH, 8)), dtype=torch.float32, device=dev)
    w8 = torch.tensor(rng.uniform(0, 2 * np.pi, (3, 8, 2)), dtype=torch.float32, device=dev)
    saved = dict(K.launches)
    with torch.inference_mode():
        qsc_ms = event_ms(torch, lambda: K.fused_qsc_expvals(a6, ur, ui, 6))
        qsc_plain_ms = event_ms(torch, lambda: K.qsc_expvals_plain(a6, ur, ui, 6))
        circ_ms = event_ms(torch, lambda: K.fused_circuit_expvals(a8, w8, 8, 3))
        # the plain gate chain takes about 15 ms a call: fewer reps
        circ_plain_ms = event_ms(torch, lambda: K.circuit_expvals_plain(a8, w8, 8, 3), reps=5, inner=2)
        # the adjoint at the training shape (n=8, L=3, 2304 rows a step) and at
        # B=64; every event timing runs before the first profiler session
        adj = {}
        for b in (TRAIN_BATCH * 9, SERVE_BATCH):
            a = torch.tensor(rng.uniform(-1, 1, (b, 8)), dtype=torch.float32, device=dev)
            g = torch.tensor(rng.standard_normal((b, 8)), dtype=torch.float32, device=dev)
            _, fre, fim = K.fused_circuit_expvals(a, w8, 8, 3, return_state=True)
            args = (fre, fim, g, a, w8, 8, 3)
            adj[b] = {
                "args": args,
                "ms": event_ms(torch, lambda: K.circuit_adjoint(*args)),
                "plain_ms": event_ms(torch, lambda: K.circuit_adjoint_plain(*args), reps=5, inner=2),
                "bound": bound(*adjoint_work(b, 8, 3)),
            }

        # the rotation layer at its main-path shape (n=14, B=144) and the unitary kernel at the
        # microbench's n=6, B=2304, with the complex product alone beside it
        from qdml_tpu_torch.utils.complexops import CArr

        r_re = torch.tensor(rng.standard_normal((ROT_BATCH, 1 << ROT_N)), dtype=torch.float32, device=dev)
        r_im = torch.tensor(rng.standard_normal((ROT_BATCH, 1 << ROT_N)), dtype=torch.float32, device=dev)
        w_l = torch.tensor(rng.uniform(-3, 3, (ROT_N, 2)), dtype=torch.float32, device=dev)
        rot_args = (CArr(r_re, r_im), w_l, ROT_N)
        rot = {
            "ms": event_ms(torch, lambda: K.apply_rotation_layer(*rot_args)),
            "plain_ms": event_ms(torch, lambda: K.rotation_layer_plain(r_re, r_im, w_l, ROT_N), reps=10, inner=5),
            "bound": bound(*rotation_work(ROT_BATCH, ROT_N)),
        }
        p_re = torch.tensor(rng.standard_normal((WIDE_BATCH, 1 << UNI_N)), dtype=torch.float32, device=dev)
        p_im = torch.tensor(rng.standard_normal((WIDE_BATCH, 1 << UNI_N)), dtype=torch.float32, device=dev)
        uni_psi, uni_u = CArr(p_re, p_im), CArr(u6.re.contiguous(), u6.im.contiguous())
        psi_c, ut_c = torch.complex(p_re, p_im), torch.complex(u6.re, u6.im).T.contiguous()
        uni = {
            "ms": event_ms(torch, lambda: K.fused_unitary_expvals(uni_psi, uni_u, UNI_N)),
            "plain_ms": event_ms(torch, lambda: K.unitary_expvals_plain(p_re, p_im, uni_u.re, uni_u.im, UNI_N)),
            "matmul_ms": event_ms(torch, lambda: torch.matmul(psi_c, ut_c)),
            "bound": bound(*unitary_work(WIDE_BATCH, UNI_N)),
        }
        # the member-axis circuit kernels at the ensemble's shape, beside E
        # one-member launches of the same work
        ens_t = ensemble_event_times(torch, K, ens)
    # the BatchNorm + ReLU pair at a trunk site (its backward needs autograd)
    bn_t = bn_relu_times(torch, K, card)
    # the quantum classifier's front end at the QSC cell's shape
    front_t = qsc_front_times(torch, K, card)

    for name, (gpu, _) in engines.items():
        for b in BUCKETS:
            x = requests[64][:b]
            med, low = host_ms(torch, lambda: gpu.infer(x))
            log(f"time infer {name} bucket {b}: median {med:.4f} ms, min {low:.4f} ms over 20 [{card}]")
        # where one bucket-64 forward goes: the classifier (with its circuit),
        # then all trunks and the head
        xt = torch.from_numpy(requests[64]).to(dev).permute(0, 3, 1, 2).contiguous()
        xs = xt.expand(gpu.cfg.data.n_scenarios, *xt.shape)
        with torch.inference_mode():
            clf_ms, _ = host_ms(torch, lambda: gpu.clf(xt))
            hdce_ms, _ = host_ms(torch, lambda: gpu.hdce(xs))
        log(f"time forward parts {name} bucket 64: classifier {clf_ms:.4f} ms, trunks+head {hdce_ms:.4f} ms (medians) [{card}]")
    with torch.inference_mode():
        u_ms, _ = host_ms(torch, lambda: circuits.ansatz_unitary(w6, 6, 3))
    log(f"time ansatz_unitary n=6 L=3 (rebuilt by impl pallas on every call): median {u_ms:.4f} ms [{card}]")

    # device times last: a profiler session can slow the host's launches after it
    with torch.inference_mode():
        # the launch floor on this card: a one-element in-place add, on no path
        one = torch.zeros(1, device=dev)
        floor_us = profiled_device_us(torch, lambda: one.add_(1.0), "elementwise_kernel")
        qsc_dev_us = profiled_device_us(torch, lambda: K.fused_qsc_expvals(a6, ur, ui, 6), "qsc_expvals_kernel")
        circ_dev_us = profiled_device_us(torch, lambda: K.fused_circuit_expvals(a8, w8, 8, 3), "circuit_expvals_kernel")
        for t in adj.values():
            t["device_us"] = profiled_device_us(
                torch, lambda: K.circuit_adjoint(*t["args"]), "circuit_adjoint_"
            )
        rot["device_us"] = profiled_device_us(torch, lambda: K.apply_rotation_layer(*rot_args), "rotation_layer_kernel")
        # the kernel beside its yardstick, the complex product alone (one
        # PyTorch call the port never makes), both as CUDA graph replays
        uni["device_us"] = graph_device_us(torch, K, lambda: K.fused_unitary_expvals(uni_psi, uni_u, UNI_N))
        uni["matmul_device_us"] = graph_device_us(torch, K, lambda: torch.matmul(psi_c, ut_c))
        for key, kname in (("fwd", "circuit_expvals_kernel"), ("fwd_single", "circuit_expvals_kernel"),
                           ("adj", "circuit_adjoint_"), ("adj_single", "circuit_adjoint_")):
            ens_t[f"{key}_device_us"] = profiled_device_us(torch, ens_t["calls"][key], kname)
        traj_us = profiled_device_us(torch, traj_call, None, calls=5)
        device_sweep(torch, K, circuits, card, floor_us)
        after = event_ms(torch, lambda: K.circuit_adjoint(*adj[SERVE_BATCH]["args"]))
    K.launches.update(saved)  # timing launches are not main-path launches
    log(f"launch floor: one-element in-place add_ {floor_us} us of device time (profiler) [{card}]")
    for name, us in (("qsc_expvals_kernel", qsc_dev_us), ("circuit_expvals_kernel", circ_dev_us)):
        shown = f"{us:.3f} us per launch" if us is not None else "not measured (no device time in the trace)"
        log(f"profiler device time {name}: {shown} [{card}]")
    log(f"time qsc_expvals n=6 B={SERVE_BATCH}: kernel {qsc_ms:.5f} ms, plain {qsc_plain_ms:.5f} ms [{card}]")
    log(f"time circuit_expvals n=8 L=3 B={SERVE_BATCH}: kernel {circ_ms:.5f} ms, plain {circ_plain_ms:.5f} ms [{card}]")
    for b, t in adj.items():
        us = t["device_us"]
        shown = f"{us:.3f} us" if us is not None else "not measured (no device time in the trace)"
        log(f"time circuit_adjoint n=8 L=3 B={b}: wrapper {t['ms']:.5f} ms, device {shown} per launch, "
            f"plain {t['plain_ms']:.5f} ms, bound {t['bound'][0]:.3e} ms ({t['bound'][1]}); "
            f"{adjoint_per_step} launches per training step [{card}]")
    log(f"time circuit_adjoint n=8 L=3 B={SERVE_BATCH} wrapper again after the profiler sessions: "
        f"{after:.5f} ms (before them: {adj[SERVE_BATCH]['ms']:.5f} ms) [{card}]")

    def shown_us(us):
        return f"{us:.3f} us" if us is not None else "not measured (no device time in the trace)"

    log(f"time rotation_layer n={ROT_N} B={ROT_BATCH}: wrapper {rot['ms']:.5f} ms, device "
        f"{shown_us(rot['device_us'])} per launch, plain {rot['plain_ms']:.5f} ms, bound "
        f"{rot['bound'][0]:.3e} ms ({rot['bound'][1]}) [{card}]")
    log(f"time unitary_expvals n={UNI_N} B={WIDE_BATCH}: wrapper {uni['ms']:.5f} ms, device "
        f"{shown_us(uni['device_us'])} per launch, plain {uni['plain_ms']:.5f} ms, the complex product "
        f"alone (torch.matmul, complex64) {uni['matmul_ms']:.5f} ms event-timed, device "
        f"{shown_us(uni['matmul_device_us'])} (both device times by CUDA graph replays), bound "
        f"{uni['bound'][0]:.3e} ms ({uni['bound'][1]}) [{card}]")

    e, eb = ens["members"], ens["rows"]
    for key, what in (("fwd", "circuit_expvals"), ("adj", "circuit_adjoint")):
        log(f"time {what} member axis E={e} n={ens['n']} L={ens['layers']} B={eb}: one launch wrapper "
            f"{ens_t[key + '_ms']:.5f} ms, device {shown_us(ens_t[key + '_device_us'])}; {e} one-member launches "
            f"wrapper {ens_t[key + '_single_ms']:.5f} ms, device {shown_us(ens_t[key + '_single_device_us'])}; "
            f"plain {ens_t[key + '_plain_ms']:.5f} ms; bound {ens_t[key + '_bound'][0]:.3e} ms "
            f"({ens_t[key + '_bound'][1]}) [{card}]")
    log(f"time trajectories n=6 L=3 B=2304 32 trajectories: device {shown_us(traj_us)} per call "
        f"(every kernel of the call, profiler) [{card}]")

    train_adj = adj[TRAIN_BATCH * 9]  # the adjoint's main-path shape is the training step's
    qsc_bound, qsc_by = bound(*qsc_work(SERVE_BATCH, 6))
    circ_bound, circ_by = bound(*circuit_work(SERVE_BATCH, 8, 3))
    kernels = [
        {
            "name": "qsc_expvals",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/qsc_expvals.cu",
            "replaces": "qdml_tpu/quantum/pallas_kernels.py:205",
            "launches": launches["qsc_expvals"],
            "max_abs_err": worst["qsc_expvals"],
            "ms": qsc_ms,
            "device_ms": None if qsc_dev_us is None else qsc_dev_us / 1e3,
            "plain_ms": qsc_plain_ms,
            "bound_ms": qsc_bound,
            "bound_by": qsc_by,
            "library_ms": None,
        },
        {
            "name": "circuit_expvals",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/circuit_expvals.cu",
            "replaces": "qdml_tpu/quantum/pallas_kernels.py:354",
            "launches": launches["circuit_expvals"],
            "max_abs_err": worst["circuit_expvals"],
            "ms": circ_ms,
            "device_ms": None if circ_dev_us is None else circ_dev_us / 1e3,
            "plain_ms": circ_plain_ms,
            "bound_ms": circ_bound,
            "bound_by": circ_by,
            "library_ms": None,
        },
        {
            "name": "circuit_adjoint",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/circuit_adjoint.cu",
            "replaces": "qdml_tpu/quantum/pallas_kernels.py:521",
            "launches": launches["circuit_adjoint"],
            "max_abs_err": worst["circuit_adjoint"],
            "ms": train_adj["ms"],
            "device_ms": None if train_adj["device_us"] is None else train_adj["device_us"] / 1e3,
            "plain_ms": train_adj["plain_ms"],
            "bound_ms": train_adj["bound"][0],
            "bound_by": train_adj["bound"][1],
            "library_ms": None,
        },
    ]
    for name, t, replaces, library_us in (
        # no one PyTorch call computes a rotation layer
        ("rotation_layer", rot, "qdml_tpu/quantum/pallas_kernels.py:587", None),
        # the unitary kernel's yardstick: the profiled device time of the
        # complex product alone (complex64 torch.matmul), which the kernel
        # does along with |c|^2 and the sign contraction
        ("unitary_expvals", uni, "qdml_tpu/quantum/pallas_kernels.py:75", uni["matmul_device_us"]),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"qdml_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": worst[name],
            "ms": t["ms"],
            "device_ms": None if t["device_us"] is None else t["device_us"] / 1e3,
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": None if library_us is None else library_us / 1e3,
        })
    # the member-axis entry points (the noise-sweep ensemble's path); their
    # TPU counterpart is the same Pallas kernel batched by vmap
    for name, key, source, replaces, err in (
        ("circuit_expvals_ensemble", "fwd", "circuit_expvals", "qdml_tpu/quantum/pallas_kernels.py:354", "fwd"),
        ("circuit_adjoint_ensemble", "adj", "circuit_adjoint", "qdml_tpu/quantum/pallas_kernels.py:521", "adj"),
    ):
        dev_us, single_us = ens_t[f"{key}_device_us"], ens_t[f"{key}_single_device_us"]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"qdml_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": ens["worst"][err],
            "ms": ens_t[f"{key}_ms"],
            "device_ms": None if dev_us is None else dev_us / 1e3,
            "plain_ms": ens_t[f"{key}_plain_ms"],
            "bound_ms": ens_t[f"{key}_bound"][0],
            "bound_by": ens_t[f"{key}_bound"][1],
            "library_ms": None,
            "one_member_launches_ms": ens_t[f"{key}_single_ms"],
            "one_member_launches_device_ms": None if single_us is None else single_us / 1e3,
        })
    # the trunks' BatchNorm + ReLU, which replaces no TPU kernel (the JAX
    # package leaves it to XLA); its yardstick is the cuDNN chain it replaced
    for key, t in bn_t.items():
        kernels.append({
            "name": f"bn_relu_{key}",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/bn_relu.cu",
            "replaces": None,
            "launches": launches[f"bn_relu_{key}"],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "device_ms": t["device_us"] / 1e3,
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_us"] / 1e3,
        })
    # the quantum classifier's front end, which replaces no TPU kernel
    # either; its yardstick is the cuDNN and max-pool path it replaced
    for key, t in front_t.items():
        kernels.append({
            "name": f"qsc_front_{key}",
            "route": "cuda",
            "source": "qdml_tpu_torch/csrc/qsc_front.cu",
            "replaces": None,
            "launches": launches[f"qsc_front_{key}"],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "device_ms": t["device_us"] / 1e3,
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "library_ms": t["library_us"] / 1e3,
        })
    for rec in kernels:  # the card's launch floor beside every bound
        rec["floor_ms"] = None if floor_us is None else floor_us / 1e3
    phase_s["times"] = round(time.perf_counter() - t_times, 2)
    # last: its profiler session would slow the host's launches of any timing after it
    phase("profile", profile_phase, torch, mods, card)
    log(f"phase wall seconds: {json.dumps(phase_s)} [{card}]")
    log(f"smoke wall: {time.perf_counter() - t_main:.2f} s from the start of main, the kernels' build included "
        f"[{card}]")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
