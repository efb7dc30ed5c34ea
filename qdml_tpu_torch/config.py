"""The port's own copy of the configuration it needs (``qdml_tpu/config.py``).

Field names and defaults are the JAX package's, so a JAX config and the
port's describe the same model. Only the fields this slice reads are carried:
the channel geometry of ``DataConfig``, ``ModelConfig``, ``QuantumConfig``, the
``ServeConfig`` bucket fields, and the two geometry-derived widths of
``ExperimentConfig``. Training, mesh, eval, fleet and control configuration
arrive with the slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DataConfig:
    """Channel geometry (``qdml_tpu/config.py:24-83``)."""

    n_ant: int = 64          # BS ULA antennas; H is (n_ant, n_sub) complex
    n_sub: int = 16          # OFDM subcarriers
    n_beam: int = 8          # sounded DFT beams -> pilot_num = n_beam * n_sub
    n_scenarios: int = 3     # propagation scenario families (reference: 3)
    n_users: int = 3         # users per scenario (reference: 3)

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
    serve: ServeConfig = field(default_factory=ServeConfig)

    @property
    def image_hw(self) -> tuple[int, int]:
        """CNN input spatial dims: (n_sub, n_beam) with 2 (re/im) channels."""
        return (self.data.n_sub, self.data.n_beam)

    @property
    def h_out_dim(self) -> int:
        """Estimation-head width: n_ant * n_sub * 2 real outputs."""
        return self.data.h_dim * 2
