"""The port's own copy of the configuration it needs (``qdml_tpu/config.py``).

Field names and defaults are the JAX package's, so a JAX config and the
port's describe the same model. Only the fields the ported paths read are
carried: the channel geometry and dataset fields of ``DataConfig``,
``ModelConfig``, ``QuantumConfig`` with its training knobs, ``TrainConfig``,
the ``ServeConfig`` bucket fields, and the geometry-derived widths of
``ExperimentConfig``. Mesh, eval, fleet and control configuration arrive with
the slices that use them. :func:`override` and :func:`from_args` take the
JAX package's dotted CLI flags (``--train.lr=3e-4``).
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
    # Adam moment storage: only "float32" is ported; the JAX package's
    # "bfloat16" (a documented non-default deviation) raises.
    moments_dtype: str = "float32"
    seed: int = 0
    workdir: str = "workspace"   # checkpoint root
    resume: bool = False


@dataclass(frozen=True)
class ServeConfig:
    """Bucket fields of the serving engine (``qdml_tpu/config.py:243-298``)."""

    max_batch: int = 64        # largest (and last) bucket
    buckets: tuple[int, ...] = ()  # () = powers of two up to max_batch


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    quantum: QuantumConfig = field(default_factory=QuantumConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
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


def from_args(argv: Sequence[str], base: ExperimentConfig | None = None) -> ExperimentConfig:
    """``--a.b.c=value`` dotted overrides onto ``base`` (default config)
    (``qdml_tpu/config.py:666-680``; the JAX package's presets are not
    carried)."""
    cfg = base or ExperimentConfig()
    for arg in argv:
        if not arg.startswith("--") or "=" not in arg:
            raise SystemExit(f"unrecognised argument {arg!r}; expected --path.to.field=value")
        dotted, value = arg[2:].split("=", 1)
        cfg = override(cfg, dotted, value)
    return cfg
