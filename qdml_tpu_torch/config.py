"""The port's own copy of the configuration it needs (``qdml_tpu/config.py``).

Field names and defaults are the JAX package's, so a JAX config and the
port's describe the same model. Only the fields the ported paths read are
carried: the channel geometry and dataset fields of ``DataConfig``,
``ModelConfig``, ``QuantumConfig`` with its training knobs, ``TrainConfig``,
``EvalConfig``, the ``ServeConfig`` bucket and dispatch fields, and the
geometry-derived widths of ``ExperimentConfig``. Mesh, fleet and control
configuration are not ported yet (ROADMAP A.10, multi-rank half; A.11).
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
    # Activation dtype of the HDCE and DCE trainers' convs and head:
    # "float32" | "bfloat16" (parameters stay float32; qdml_tpu/config.py:98).
    dtype: str = "float32"

    def __post_init__(self):
        activation_dtype(self.dtype)


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
    """Bucket and dispatch fields of the serving engine (``qdml_tpu/config.py:243-298``)."""

    max_batch: int = 64        # largest (and last) bucket
    buckets: tuple[int, ...] = ()  # () = powers of two up to max_batch
    # Expert routing: "dense" runs every trunk and gathers, "sparse" runs each
    # row's trunk on capacity buckets. "auto" races them per bucket at warmup
    # (qdml_tpu_torch.ops.dispatch_autotune; sparse enters the race from
    # S = 6, so at S = 3 dense is chosen without timing anything).
    dispatch: str = "auto"
    # Sparse per-expert bucket headroom: capacity = ceil(B * f / S); overflow
    # rows are served by the dense path, never dropped.
    capacity_factor: float = 1.25
    # Pad handling per tier: "bucket" relies on row independence, "ragged"
    # masks the pad rows inside the forward. "auto" races them in JAX; the
    # port has no such race yet (it comes with continuous admission, ROADMAP
    # A.11) and takes JAX's no-table fallback, bucket.
    batching: str = "auto"


@dataclass(frozen=True)
class EvalConfig:
    """The SNR sweep (``qdml_tpu/config.py:530-537``, reference ``Test.py:11-21,
    66``). ``results_dir`` is the port's own: the JAX package's default,
    ``results/``, holds that package's committed figures and tables."""

    snr_grid: tuple[float, ...] = (5.0, 7.0, 9.0, 11.0, 13.0, 15.0)
    test_len: int = 10000     # reference data_len_for_test
    batch_size: int = 200     # reference batch_size=200
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


# The JAX package's presets (qdml_tpu/config.py:587-626) that need a mesh;
# the port runs on one device until ROADMAP A.10's multi-rank half.
UNPORTED_PRESETS = ("dp_8q", "sharded_16q", "federated")


def _preset(name: str, **overrides: Any) -> ExperimentConfig:
    cfg = ExperimentConfig(name=name)
    for dotted, value in overrides.items():
        cfg = override(cfg, dotted, value)
    return cfg


def presets() -> dict[str, ExperimentConfig]:
    """The JAX package's presets that run on one device, with its values
    (``qdml_tpu/config.py:587-626``). ``single_4q``'s ``mesh.data_axis=1`` is
    the port's single-device layout; the mesh presets are
    :data:`UNPORTED_PRESETS`."""
    return {
        # Runner_P128 single-worker, 4-qubit QuantumNAT classifier
        "single_4q": _preset(
            "single_4q", **{"quantum.n_qubits": 4, "quantum.use_quantumnat": True}
        ),
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
    """The preset ``name``; the mesh presets raise ``NotImplementedError``."""
    if name in UNPORTED_PRESETS:
        raise NotImplementedError(
            f"preset {name!r} needs a device mesh, not ported yet (ROADMAP A.10, multi-rank half)"
        )
    table = presets()
    if name not in table:
        raise KeyError(f"unknown preset {name!r}; want one of {sorted(table) + list(UNPORTED_PRESETS)}")
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
