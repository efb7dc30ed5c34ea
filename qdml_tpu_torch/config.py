"""The port's own copy of the configuration it needs (``qdml_tpu/config.py``).

Field names and defaults are the JAX package's, so a JAX config and the
port's describe the same model. Only the fields the ported paths read are
carried: the channel geometry and dataset fields of ``DataConfig``,
``ModelConfig``, ``QuantumConfig`` with its training knobs, ``TrainConfig``,
``EvalConfig``, ``ServeConfig`` (buckets, dispatch, the micro-batcher, the
replica pool, supervision, the breaker, the socket server and loadgen's
traffic knobs), ``MeshConfig`` (the ``(fed, data, model)`` layout of a
``torch.distributed`` world, :mod:`qdml_tpu_torch.parallel`), and the
geometry-derived widths of ``ExperimentConfig``. Fleet and control
configuration are not ported yet (ROADMAP A.11, parts 2-3). ``model.kernel_size``,
``model.n_conv_layers``, ``model.conv_impl`` and ``eval.indicator`` are
accepted with the JAX package's validation and recorded, so that a JAX
command line runs unchanged; the port's convs are 3x3, three deep, and
``torch.nn.functional.conv2d`` whatever they say.
``model.dtype`` (bfloat16 activations), ``train.moments_dtype`` (bfloat16
Adam first moments), ``data.trig_impl``, ``data.rng_impl`` and
``quantum.mps_chi`` are the JAX package's low-precision and scaling knobs,
with its defaults and its rejection messages. :func:`override` and
:func:`from_args` take the JAX package's dotted CLI flags
(``--train.lr=3e-4``) and ``--preset=NAME`` (:func:`presets`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class DataConfig:
    """Channel geometry and dataset (``qdml_tpu/config.py:24-83``)."""

    n_ant: int = 64          # BS ULA antennas; H is (n_ant, n_sub) complex
    n_sub: int = 16          # OFDM subcarriers
    n_beam: int = 8          # sounded DFT beams -> pilot_num = n_beam * n_sub
    n_scenarios: int = 3     # propagation scenario families (reference: 3)
    # Channel-family drift (data/channels.family_table): step 0 is the frozen
    # table; > 0 perturbs delay spread, K-factor, angular spread and mobility
    # of drift_scenario (-1 = every family) as a function of the step
    # (qdml_tpu/config.py:41-48).
    drift_step: int = 0
    drift_scenario: int = -1
    n_users: int = 3         # users per scenario (reference: 3)
    data_len: int = 20000    # training samples per (scenario, user) cell
    snr_db: float = 10.0     # training SNR (reference SNRdb=10)
    train_split: float = 0.9  # reference train_test_ratio=0.9
    seed: int = 2026         # base seed of the sample generator
    # Per-entry variance of the full-pilot LS label is
    # label_noise_factor * 10**(-SNR/10) (data/channels.label_noise_var).
    label_noise_factor: float = 1.9
    # Optional per-batch training-SNR jitter (lo, hi) dB; None = fixed SNR.
    snr_jitter: tuple[float, float] | None = None
    # Sample-generator PRNG: "threefry" | "rbg" (qdml_tpu/config.py:70).
    # Validated and recorded only: the port draws from torch.Generator's
    # Philox whichever is named (data/channels.py).
    rng_impl: str = "threefry"
    # Steering/delay phase ramps: "direct" (one sin/cos per element) or
    # "split" (angle-addition factorization, the same values to f32
    # rounding; utils/complexops.cexp_i_ramp) (qdml_tpu/config.py:75).
    trig_impl: str = "direct"

    @property
    def pilot_num(self) -> int:
        return self.n_beam * self.n_sub  # 128 for the default geometry

    @property
    def h_dim(self) -> int:
        return self.n_ant * self.n_sub  # 1024 for the default geometry


@dataclass(frozen=True)
class ModelConfig:
    """CNN estimator family (``qdml_tpu/config.py:91-103``)."""

    features: int = 32       # conv channels (reference self.features=32)
    # Recorded only, as in the JAX package, whose convs are 3x3 and three
    # deep whatever these say (qdml_tpu/models/cnn.py).
    kernel_size: int = 3
    n_conv_layers: int = 3
    # Activation dtype of the HDCE and DCE trainers' convs and head:
    # "float32" | "bfloat16" (parameters stay float32; qdml_tpu/config.py:98).
    dtype: str = "float32"
    # The JAX package's conv lowering ("auto" | "conv" | "shift_matmul",
    # qdml_tpu/models/cnn.py:resolve_conv_impl): validated and recorded; the
    # port has one lowering, torch's conv2d.
    conv_impl: str = "auto"

    def __post_init__(self):
        activation_dtype(self.dtype)
        if self.conv_impl not in ("auto", "conv", "shift_matmul"):
            raise ValueError(f"conv_impl must be auto|conv|shift_matmul, got {self.conv_impl!r}")


def activation_dtype(name: str):
    """``model.dtype`` as a torch dtype (``qdml_tpu/models/cnn.py:
    activation_dtype``); anything but ``float32`` / ``bfloat16`` raises
    ``KeyError``, as the JAX package's lookup does."""
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


@dataclass(frozen=True)
class QuantumConfig:
    """Quantum scenario-classifier circuit (``qdml_tpu/config.py:106-153``)."""

    n_qubits: int = 6        # reference default n_qubits=6; published 4/6/8
    n_layers: int = 3        # reference default n_layers=3
    n_classes: int = 3
    # Legacy simulator-backend knob and the dispatcher override; see
    # qdml_tpu_torch.quantum.circuits.resolve_impl for the precedence.
    backend: str = "auto"
    impl: str = "auto"
    input_norm: bool = False
    use_quantumnat: bool = False      # reference ships with this OFF
    noise_level: float = 0.01         # QuantumNAT sigma
    use_gradient_pruning: bool = False
    gradient_threshold: float = 0.1   # absolute cutoff, or quantile fraction
    gradient_prune_mode: str = "absolute"  # "absolute" | "quantile"
    # QuantumNAT sigma of each member of the nat-sweep ensemble
    noise_sweep: tuple[float, ...] = (0.0, 0.01, 0.05, 0.1)
    # Bond dimension of the "mps" impl (quantum/mps.py): chi >= 2^(n/2) is
    # exact for this circuit, a smaller chi a controlled approximation
    # (qdml_tpu/config.py:135).
    mps_chi: int = 8
    # When the impl race may run (trainer start, serve warmup; never on the
    # request path): "auto" = on the card only, "on"/"off" force it
    # (qdml_tpu_torch.quantum.autotune).
    autotune: str = "auto"
    # Table location; "" = results_torch/autotune/qsc_impl.json
    # (QDML_TORCH_QSC_AUTOTUNE_TABLE overrides the default).
    autotune_table: str = ""


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (``qdml_tpu/config.py:161-224``)."""

    batch_size: int = 256        # per (scenario, user) cell
    lr: float = 1e-3
    lr_decay_epochs: int = 30    # halve every 30 epochs
    lr_floor: float = 1e-6
    n_epochs: int = 100
    optimizer: str = "adam"      # 'adam' | 'adamw' | 'sgd'
    weight_decay: float = 0.01   # AdamW weight decay (the QSC trainer's)
    momentum: float = 0.9        # SGD momentum
    print_freq: int = 50         # batch-loss log period, in steps
    # Steps a dispatch (qdml_tpu_torch.train.scan): K >= 1 runs K steps as
    # one CUDA-graph replay on the card (the eager chunk of K steps on the
    # CPU), K = 1 included; 0 selects the per-step path. Negative raises.
    scan_steps: int = 1
    # Adam moment storage: "float32", or "bfloat16" (the first moment stored
    # in bfloat16, the second in float32, all arithmetic in float32;
    # train/optim.py). Only Adam takes it: adamw and sgd warn and keep f32.
    moments_dtype: str = "float32"
    seed: int = 0
    workdir: str = "workspace"   # checkpoint root
    resume: bool = False

    def __post_init__(self):
        if self.scan_steps < 0:
            raise ValueError(f"train.scan_steps must be >= 0 (0 = per-step dispatch), got {self.scan_steps}")


@dataclass(frozen=True)
class ServeConfig:
    """The serving engine and its tier (``qdml_tpu/config.py:243-379``), with
    the JAX package's defaults."""

    max_batch: int = 64        # largest (and last) bucket
    max_wait_ms: float = 2.0   # coalescing window before a partial batch flushes
    max_queue: int = 256       # bounded request queue; beyond it, shed Overloaded
    # Mesh sharding of the request path: "auto" | "off", validated as in JAX
    # (parallel.mesh.serve_mesh). One visible device and one rank serve
    # unsharded; a world of several ranks or several visible cards raises
    # (mesh serving is a ROADMAP queue item of its own).
    shard: str = "auto"
    # Shard the trunks over the mesh's "fed" axis (validated; mesh serving
    # is not ported, so one device serves every expert).
    expert_sharding: bool = False
    # Expert routing: "dense" runs every trunk and gathers, "sparse" runs each
    # row's trunk on capacity buckets. "auto" races them per bucket at warmup
    # (qdml_tpu_torch.ops.dispatch_autotune; sparse enters the race from
    # S = 6, so at S = 3 dense is chosen without timing anything).
    dispatch: str = "auto"
    # Sparse per-expert bucket headroom: capacity = ceil(B * f / S); overflow
    # rows are served by the dense path, never dropped.
    capacity_factor: float = 1.25
    # Pad handling and admission per tier: "bucket" pads to the bucket and
    # relies on row independence, the batcher coalescing to bucket edges;
    # "ragged" masks the pad rows inside the forward and the batcher admits
    # continuously (dispatch whenever a worker is free). "auto" races the two
    # per tier at warmup (qdml_tpu_torch.serve.batching_autotune, table-cached).
    batching: str = "auto"
    # ServeLoops sharing one warmup and one MicroBatcher feed (ReplicaPool).
    replicas: int = 1
    # Default per-request deadline in ms; 0 disables. Past it a request is
    # shed (typed Overloaded) at admission or dequeue, never served late.
    deadline_ms: float = 0.0
    buckets: tuple[int, ...] = ()  # () = powers of two up to max_batch
    # Worker threads per ServeLoop pumping batcher -> engine, each with its
    # own ServeMetrics (merged exactly on read).
    workers: int = 1
    # The numerics sanitizer of the serving forward: not ported (ROADMAP
    # A.12); True raises.
    checkify: bool = False
    # loadgen's arrival process: "poisson" | "bursty" (two-state MMPP, mean
    # rate kept) | "diurnal" (sinusoidal rate by thinning); burstiness is the
    # burst/lull ratio and sets the diurnal peak-to-trough ratio.
    arrival: str = "poisson"
    burstiness: float = 4.0
    # loadgen --drift-at=K: requests from K on come from the drifted family
    # table at this step, half of them from drift_scenario. 0 disables.
    drift_step: int = 0
    drift_scenario: int = 0
    # Supervision: restart a replica whose workers died (or, with
    # stall_timeout_s > 0, whose heartbeat is stale while work is queued)
    # after restart_backoff_s * 2^k with jitter, up to restart_budget
    # restarts a slot; past it the slot is quarantined.
    supervise: bool = True
    supervise_interval_s: float = 0.05
    restart_backoff_s: float = 0.05
    restart_budget: int = 3
    stall_timeout_s: float = 0.0
    # Circuit breaker: open at breaker_high_frac * max_queue (new submits
    # fast-fail typed breaker_open), half-open after breaker_open_s with
    # breaker_probes probes, closed again under breaker_low_frac * max_queue.
    breaker: bool = False
    breaker_high_frac: float = 0.8
    breaker_low_frac: float = 0.3
    breaker_open_s: float = 0.25
    breaker_probes: int = 4
    # Socket hardening: an idle connection is reaped after conn_timeout_s
    # (0 disables); a line over max_line_bytes gets bad_request and closes.
    conn_timeout_s: float = 30.0
    max_line_bytes: int = 8_388_608
    # A retried request id re-attaches to its first dispatch for this long;
    # 0 disables dedup.
    dedup_ttl_s: float = 30.0
    # Fraction of requests carrying a phase trace (sampled on the id hash);
    # 0 builds no trace and reads no clock for it.
    trace_sample: float = 0.0
    # Local socket endpoint of `serve`.
    host: str = "127.0.0.1"
    port: int = 8377

    def __post_init__(self):
        if self.checkify:
            raise NotImplementedError(
                "serve.checkify (the numerics sanitizer of the serving forward) is not "
                "ported yet (ROADMAP A.12)"
            )


@dataclass(frozen=True)
class MeshConfig:
    """The ``(fed, data, model)`` layout of the ranks of a world
    (``qdml_tpu/config.py:228-240``, its fields and defaults). JAX lays
    devices out on this mesh; the port lays out the ranks of a
    ``torch.distributed`` world, one rank a process
    (:mod:`qdml_tpu_torch.parallel.mesh`)."""

    data_axis: int = -1      # -1: all ranks left after model and fed on the data axis
    model_axis: int = 1      # tensor/statevector-parallel axis size
    fed_axis: int = 1        # federated (scenario-grid) axis size
    # axis names used throughout qdml_tpu_torch.parallel
    data_axis_name: str = "data"
    model_axis_name: str = "model"
    fed_axis_name: str = "fed"


@dataclass(frozen=True)
class EvalConfig:
    """The SNR sweep (``qdml_tpu/config.py:530-537``, reference ``Test.py:11-21,
    66``). ``results_dir`` is the port's own: the JAX package's default,
    ``results/``, holds that package's committed figures and tables."""

    snr_grid: tuple[float, ...] = (5.0, 7.0, 9.0, 11.0, 13.0, 15.0)
    test_len: int = 10000     # reference data_len_for_test
    batch_size: int = 200     # reference batch_size=200
    # -1 = all scenarios mixed (reference Test.py:18); recorded only, as in
    # the JAX package, whose sweep reads no such field.
    indicator: int = -1
    results_dir: str = "results_torch"


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    quantum: QuantumConfig = field(default_factory=QuantumConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @property
    def image_hw(self) -> tuple[int, int]:
        """CNN input spatial dims: (n_sub, n_beam) with 2 (re/im) channels."""
        return (self.data.n_sub, self.data.n_beam)

    @property
    def h_out_dim(self) -> int:
        """Estimation-head width: n_ant * n_sub * 2 real outputs."""
        return self.data.h_dim * 2


def override(cfg: Any, dotted: str, value: Any) -> Any:
    """A copy of a (nested, frozen) dataclass with ``dotted`` replaced:
    ``override(cfg, "train.lr", 3e-4)`` (``qdml_tpu/config.py:633-647``)."""
    head, _, rest = dotted.partition(".")
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"cannot override {dotted!r} on non-dataclass {type(cfg)}")
    names = {f.name: f for f in dataclasses.fields(cfg)}
    if head not in names:
        raise KeyError(f"unknown config field {head!r} (have {sorted(names)})")
    if rest:
        return dataclasses.replace(cfg, **{head: override(getattr(cfg, head), rest, value)})
    return dataclasses.replace(cfg, **{head: _coerce(value, names[head])})


def _coerce(value: Any, fld: dataclasses.Field) -> Any:
    if not isinstance(value, str):
        return value
    t = fld.type
    if t in ("int", int):
        return int(value)
    if t in ("float", float):
        return float(value)
    if t in ("bool", bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(t, str) and t.startswith("tuple"):
        if value.strip().lower() == "none":
            return None
        items = [v for v in value.replace("(", "").replace(")", "").split(",") if v.strip()]
        return tuple(float(v) if "." in v else int(v) for v in items)
    return value


# The JAX package's presets the port cannot run: none since the mesh presets
# landed (qdml_tpu_torch.parallel).
UNPORTED_PRESETS: tuple[str, ...] = ()


def _preset(name: str, **overrides: Any) -> ExperimentConfig:
    cfg = ExperimentConfig(name=name)
    for dotted, value in overrides.items():
        cfg = override(cfg, dotted, value)
    return cfg


def presets() -> dict[str, ExperimentConfig]:
    """The JAX package's six presets, with its values
    (``qdml_tpu/config.py:587-626``). The mesh presets run on a world of
    several ranks (:mod:`qdml_tpu_torch.parallel`) and, like JAX's on one
    device, on one rank without a mesh."""
    return {
        # Runner_P128 single-worker, 4-qubit QuantumNAT classifier
        "single_4q": _preset(
            "single_4q",
            **{"quantum.n_qubits": 4, "quantum.use_quantumnat": True, "mesh.data_axis": 1},
        ),
        # 8-qubit QNN + CNN estimator, data-parallel over the mesh
        "dp_8q": _preset("dp_8q", **{"quantum.n_qubits": 8, "mesh.data_axis": -1}),
        # 16-qubit QNN, the statevector sharded over the model axis
        "sharded_16q": _preset(
            "sharded_16q",
            **{
                "quantum.n_qubits": 16,
                "quantum.backend": "sharded",
                "mesh.model_axis": 4,
                "mesh.data_axis": 1,
            },
        ),
        # federated RIS: one scenario's trunk a rank, the shared head reduced
        "federated": _preset("federated", **{"mesh.fed_axis": 3, "mesh.data_axis": 1}),
        # noise-aware training (pruning off: at the reference's 0.1 it
        # freezes training)
        "nat_sweep": _preset("nat_sweep", **{"quantum.use_quantumnat": True}),
        # scale-invariant angle encoding + SNR-jittered training
        "robust_qsc": _preset(
            "robust_qsc",
            **{"quantum.input_norm": True, "data.snr_jitter": (5.0, 15.0)},
        ),
    }


def preset(name: str) -> ExperimentConfig:
    """The preset ``name``; an unknown name raises ``KeyError``."""
    table = presets()
    if name not in table:
        raise KeyError(f"unknown preset {name!r}; want one of {sorted(table)}")
    return table[name]


def from_args(argv: Sequence[str], base: ExperimentConfig | None = None) -> ExperimentConfig:
    """``--preset=NAME`` (applied first, wherever it stands) plus
    ``--a.b.c=value`` dotted overrides onto ``base`` (default config), as
    ``qdml_tpu/config.py:666-680`` parses them."""
    cfg = base or ExperimentConfig()
    rest = []
    for arg in argv:
        if arg.startswith("--preset="):
            cfg = preset(arg.split("=", 1)[1])
        else:
            rest.append(arg)
    for arg in rest:
        if not arg.startswith("--") or "=" not in arg:
            raise SystemExit(f"unrecognised argument {arg!r}; expected --path.to.field=value")
        dotted, value = arg[2:].split("=", 1)
        cfg = override(cfg, dotted, value)
    return cfg
