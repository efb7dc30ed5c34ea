"""Synthetic DeepMIMO-style geometric channels (``qdml_tpu/data/channels.py``).

The JAX package draws each sample from a key derived from ``(seed, scenario,
user, index)`` and shapes the draws into a channel inside one jitted
function. The port splits that into two steps:

- :func:`draw_channels` takes the random numbers from a ``torch.Generator``
  on the device: a truncated normal on [-2, 2] (by the inverse CDF through
  ``erfinv``, as ``jax.random.truncated_normal`` does), an exponential and a
  normal ``(MAX_PATHS, 2)`` per path, and the mobility normal only where a
  family is mobile. ``jax.random``'s bits cannot be reproduced, so these are
  held by distribution;
- :func:`channels_from_draws` is the deterministic transform of the draws
  into ``H (n_ant, n_sub)`` and is held exactly against JAX's
  ``sample_channel`` fed the same draws. :func:`sound_pilots` and
  :func:`ls_label` do the same for the pilots ``Yp = F_beam H + noise`` and
  the full-pilot LS label ``H + noise``;
- :func:`generate_samples` chains the two over flat ``(N,)`` scenario and
  user vectors, the counterpart of the JAX ``generate_samples``.

The constant tables (family parameters, DFT matrices) are copied to a device
once and cached there: a host-to-device copy from pageable memory waits for
the device, so a per-call copy would put a host sync into every batch.

Complex values are :class:`~qdml_tpu_torch.utils.complexops.CArr` real pairs;
the family table and constants are verbatim copies (host numpy).

``ChannelGeometry.trig_impl`` picks how the steering and delay phase ramps
are evaluated, ``direct`` or ``split`` (:func:`~qdml_tpu_torch.utils.
complexops.cexp_i_ramp`), as in JAX. ``rng_impl`` (``threefry`` | ``rbg``)
is validated and carried so that JAX configs and presets load, but changes
no draw: the port's draws come from ``torch.Generator`` (Philox on the
card), and neither JAX stream can be reproduced anyway.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from qdml_tpu_torch.config import DataConfig
from qdml_tpu_torch.utils.complexops import CArr, ceinsum, cexp_i, cexp_i_ramp

# Maximum paths across scenarios; per-scenario counts are masked.
MAX_PATHS = 20

# The three frozen reference presets [LOS-dominant, moderate NLOS, rich
# scattering] (qdml_tpu/data/channels.py:60-71).
FAMILY_PRESET_NAMES = ("inh_los", "umi_street", "uma_nlos")
SCENARIO_N_PATHS = np.array([3, 8, 20], dtype=np.int32)
SCENARIO_ANGLE_SPREAD = np.array([0.3 / 64, 0.8 / 64, 1.6 / 64], dtype=np.float32)
SCENARIO_DELAY_SPREAD = np.array([0.6, 1.8, 3.5], dtype=np.float32)  # in samples
SCENARIO_K_FACTOR = np.array([8.0, 2.0, 0.5], dtype=np.float32)  # LOS power boost
SCENARIO_MOBILITY = np.array([0.0, 0.0, 0.0], dtype=np.float32)


def family_table(
    n_scenarios: int, drift_step: int = 0, drift_scenario: int = -1
) -> dict[str, np.ndarray]:
    """Per-scenario propagation parameters of an S-family grid, a verbatim
    copy of the JAX ``family_table`` (``qdml_tpu/data/channels.py:74-158``):
    rows 0..2 are the frozen presets, row ``s >= 3`` derives from preset
    ``s % 3`` at tier ``s // 3``; ``drift_step > 0`` perturbs the table as a
    deterministic function of the step, and 0 returns it untouched."""
    if n_scenarios < 1:
        raise ValueError(f"n_scenarios must be >= 1, got {n_scenarios}")
    if drift_step < 0:
        raise ValueError(f"drift_step must be >= 0, got {drift_step}")
    idx = np.arange(n_scenarios)
    base = idx % 3
    tier = (idx // 3).astype(np.float32)
    table = {
        "n_paths": np.clip(
            SCENARIO_N_PATHS[base] + 2 * (idx // 3), 1, MAX_PATHS
        ).astype(np.int32),
        "angle_spread": (
            SCENARIO_ANGLE_SPREAD[base] * (1.0 + 0.25 * tier)
        ).astype(np.float32),
        "delay_spread": np.clip(
            SCENARIO_DELAY_SPREAD[base] * (1.0 + 0.3 * tier), 0.1, None
        ).astype(np.float32),
        "k_factor": (SCENARIO_K_FACTOR[base] / (1.0 + 0.5 * tier)).astype(
            np.float32
        ),
        "mobility": (
            SCENARIO_MOBILITY[base]
            + np.where(tier > 0, 0.15 * np.sqrt(tier), 0.0)
        ).astype(np.float32),
        "preset": [
            FAMILY_PRESET_NAMES[b] + (f"+t{t:.0f}" if t else "")
            for b, t in zip(base, tier)
        ],
    }
    if drift_step == 0:
        return table
    d = np.float32(drift_step)
    hit = np.ones(n_scenarios, bool) if drift_scenario < 0 else (idx == drift_scenario)
    table["delay_spread"] = np.where(
        hit, np.clip(table["delay_spread"] * (1.0 + 0.12 * d), 0.1, None),
        table["delay_spread"],
    ).astype(np.float32)
    table["k_factor"] = np.where(
        hit, table["k_factor"] / (1.0 + 0.25 * d), table["k_factor"]
    ).astype(np.float32)
    table["angle_spread"] = np.where(
        hit, table["angle_spread"] * (1.0 + 0.08 * d), table["angle_spread"]
    ).astype(np.float32)
    table["mobility"] = np.where(
        hit, table["mobility"] + 0.08 * d, table["mobility"]
    ).astype(np.float32)
    table["preset"] = [
        p + (f"~d{drift_step}" if h else "") for p, h in zip(table["preset"], hit)
    ]
    return table


# Per-user angular sector centres, in spatial-frequency units.
USER_CENTER_F = np.array([0.8 / 64, 2.5 / 64, 4.2 / 64], dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class ChannelGeometry:
    """Constants of a dataset geometry (``qdml_tpu/data/channels.py:170-281``)."""

    n_ant: int = 64
    n_sub: int = 16
    n_beam: int = 8
    n_scenarios: int = 3
    drift_step: int = 0
    drift_scenario: int = -1
    # Per-entry variance of the full-pilot LS label is
    # label_noise_factor * 10**(-SNR/10).
    label_noise_factor: float = 1.9
    # "threefry" | "rbg": validated and recorded; the port's draws are
    # torch.Generator's whichever is named (module docstring)
    rng_impl: str = "threefry"
    # phase ramps: "direct" (one sin/cos per element) | "split" (cexp_i_ramp)
    trig_impl: str = "direct"

    def __post_init__(self):
        # the JAX package's rejection contract (qdml_tpu/data/channels.py:209-217):
        # a typo must not silently select the default
        if self.rng_impl not in ("threefry", "rbg"):
            raise ValueError(
                f"rng_impl must be 'threefry' or 'rbg', got {self.rng_impl!r}"
            )
        if self.trig_impl not in ("direct", "split"):
            raise ValueError(
                f"trig_impl must be 'direct' or 'split', got {self.trig_impl!r}"
            )
        if self.drift_step < 0:
            raise ValueError(f"drift_step must be >= 0, got {self.drift_step}")
        if not (-1 <= self.drift_scenario < self.n_scenarios):
            raise ValueError(
                f"drift_scenario must be -1 (all) or a scenario id < "
                f"{self.n_scenarios}, got {self.drift_scenario}"
            )

    @classmethod
    def from_config(cls, cfg: DataConfig) -> "ChannelGeometry":
        return cls(
            n_ant=cfg.n_ant,
            n_sub=cfg.n_sub,
            n_beam=cfg.n_beam,
            n_scenarios=cfg.n_scenarios,
            label_noise_factor=cfg.label_noise_factor,
            rng_impl=cfg.rng_impl,
            trig_impl=cfg.trig_impl,
        )

    @property
    def pilot_num(self) -> int:
        return self.n_beam * self.n_sub

    @property
    def h_dim(self) -> int:
        return self.n_ant * self.n_sub

    @property
    def noise_ref_power(self) -> float:
        """Nominal per-pilot signal power that sets the noise floor:
        h_dim / pilot_num with unit average channel-entry power."""
        return self.h_dim / self.pilot_num

    def family(self) -> dict[str, np.ndarray]:
        return family_table(self.n_scenarios, self.drift_step, self.drift_scenario)

    def beam_matrix(self, device: str | torch.device = "cpu") -> CArr:
        """First ``n_beam`` rows of the unitary ``n_ant``-point DFT: (n_beam, n_ant)."""
        return _dft(self.n_beam, self.n_ant, str(torch.device(device)))

    def ant_dft(self, device: str | torch.device = "cpu") -> CArr:
        """Full unitary antenna DFT (n_ant, n_ant): the beam-domain transform."""
        return _dft(self.n_ant, self.n_ant, str(torch.device(device)))

    def sub_dft(self, device: str | torch.device = "cpu") -> CArr:
        """Full unitary subcarrier DFT (n_sub, n_sub): the delay-domain transform."""
        return _dft(self.n_sub, self.n_sub, str(torch.device(device)))


@lru_cache(maxsize=None)
def _dft(rows: int, n: int, device: str) -> CArr:
    """The first ``rows`` rows of the unitary ``n``-point DFT on ``device``
    (``qdml_tpu/data/channels.py:249-257``), cached per device. Callers must
    not write into it."""
    m = np.arange(rows)[:, None]
    a = np.arange(n)[None, :]
    ang = -2.0 * np.pi * m * a / n
    scale = 1.0 / np.sqrt(n)
    return CArr(
        torch.tensor((np.cos(ang) * scale).astype(np.float32), device=device),
        torch.tensor((np.sin(ang) * scale).astype(np.float32), device=device),
    )


@lru_cache(maxsize=None)
def _family_tensors(geom: "ChannelGeometry", device: str) -> dict[str, torch.Tensor]:
    """The geometry's family table and user sector centres on ``device``,
    cached per device."""
    fam = geom.family()
    out = {k: _f32(fam[k], device) for k in ("angle_spread", "delay_spread", "k_factor", "mobility")}
    out["n_paths"] = torch.as_tensor(fam["n_paths"], device=device)
    out["center"] = _f32(USER_CENTER_F, device)
    return out


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def noise_var(geom: ChannelGeometry, snr_db) -> torch.Tensor:
    """Per-pilot-entry complex noise variance at ``snr_db`` (dB)."""
    return geom.noise_ref_power * 10.0 ** (-_f32(snr_db) / 10.0)


def label_noise_var(geom: ChannelGeometry, snr_db) -> torch.Tensor:
    """Per-entry complex noise variance of the full-pilot LS label."""
    return geom.label_noise_factor * 10.0 ** (-_f32(snr_db) / 10.0)


def _steering(f: torch.Tensor, n_ant: int, trig_impl: str = "direct") -> CArr:
    """ULA steering vectors for spatial frequencies f: (..., L) -> (..., L, n_ant)."""
    if trig_impl == "split":
        return cexp_i_ramp(2.0 * math.pi * f, n_ant)
    n = torch.arange(n_ant, dtype=torch.float32, device=f.device)
    return cexp_i(2.0 * math.pi * f[..., None] * n)


def _delay_response(tau: torch.Tensor, n_sub: int, trig_impl: str = "direct") -> CArr:
    """Subcarrier responses for delays tau (samples): (..., L) -> (..., L, n_sub)."""
    if trig_impl == "split":
        return cexp_i_ramp(-2.0 * math.pi * tau / n_sub, n_sub)
    k = torch.arange(n_sub, dtype=torch.float32, device=tau.device)
    return cexp_i(-2.0 * math.pi * tau[..., None] * k / n_sub)


def truncated_normal(
    generator: torch.Generator, shape: tuple[int, ...], lower: float = -2.0, upper: float = 2.0
) -> torch.Tensor:
    """Standard normal truncated to (lower, upper) by the inverse CDF, as
    ``jax.random.truncated_normal``: ``sqrt(2) erfinv(U(erf(lo/sqrt2),
    erf(hi/sqrt2)))``, clipped to the open interval."""
    sqrt2 = math.sqrt(2.0)
    a, b = math.erf(lower / sqrt2), math.erf(upper / sqrt2)
    u = torch.rand(shape, generator=generator, device=generator.device)
    out = sqrt2 * torch.erfinv(a + (b - a) * u)
    lo = torch.nextafter(_f32(lower), _f32(math.inf))
    hi = torch.nextafter(_f32(upper), _f32(-math.inf))
    return torch.clamp(out, lo.item(), hi.item())


def draw_channels(
    generator: torch.Generator, scenario: torch.Tensor, geom: ChannelGeometry
) -> dict[str, torch.Tensor]:
    """The random numbers of ``len(scenario)`` channel realisations, on the
    generator's device: ``trunc`` (N, MAX_PATHS) truncated normal on [-2, 2]
    (path angles), ``expo`` (N, MAX_PATHS) unit exponential (path delays),
    ``gain`` (N, MAX_PATHS, 2) standard normal (complex path gains) and, only
    when some family of the geometry is mobile, ``phi`` (N, MAX_PATHS)
    standard normal (Doppler phases)."""
    n = scenario.shape[0]
    dev = generator.device
    draws = {
        "trunc": truncated_normal(generator, (n, MAX_PATHS)),
        "expo": torch.empty((n, MAX_PATHS), device=dev).exponential_(generator=generator),
        "gain": torch.randn((n, MAX_PATHS, 2), generator=generator, device=dev),
    }
    if np.any(geom.family()["mobility"] > 0.0):
        draws["phi"] = torch.randn((n, MAX_PATHS), generator=generator, device=dev)
    return draws


def channels_from_draws(
    draws: dict[str, torch.Tensor],
    scenario: torch.Tensor,
    user: torch.Tensor,
    geom: ChannelGeometry,
) -> CArr:
    """The deterministic transform of :func:`draw_channels`'s numbers into
    channels H, (N, n_ant, n_sub), as ``sample_channel``
    (``qdml_tpu/data/channels.py:323-388``) shapes its draws."""
    dev = draws["trunc"].device
    fam = _family_tensors(geom, str(dev))
    s, u = scenario.long().to(dev), user.long().to(dev)
    n_paths = fam["n_paths"][s][:, None]
    spread = fam["angle_spread"][s][:, None]
    dly = fam["delay_spread"][s][:, None]
    kfac = fam["k_factor"][s][:, None]
    center = fam["center"][u][:, None]
    path = torch.arange(MAX_PATHS, device=dev)
    mask = (path < n_paths).float()

    # path spatial frequencies around the user's sector centre
    f = torch.clamp(center + spread * draws["trunc"], min=0.05 / geom.n_ant)
    # path delays: LOS path at tau=0, NLOS exponential with the scenario spread
    tau_raw = dly * draws["expo"]
    tau = torch.where(path == 0, 0.0, torch.clamp(tau_raw, 0.0, geom.n_sub / 2.0))
    # path powers: exponential decay in delay, K-factor boost on path 0
    p = torch.exp(-tau / torch.clamp(dly, min=0.3))
    p = p * torch.where(path == 0, kfac, 1.0) * mask
    p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-12)

    amp = torch.sqrt(p / 2.0)
    g = draws["gain"]
    alpha = CArr(amp * g[..., 0], amp * g[..., 1])  # (N, L)
    if "phi" in draws:
        phi = fam["mobility"][s][:, None] * draws["phi"]
        rot = cexp_i(phi)
        alpha = CArr(
            alpha.re * rot.re - alpha.im * rot.im, alpha.re * rot.im + alpha.im * rot.re
        )

    a = _steering(f, geom.n_ant, geom.trig_impl)  # (N, L, n_ant)
    b = _delay_response(tau, geom.n_sub, geom.trig_impl)  # (N, L, n_sub)
    w = CArr(
        alpha.re[..., None] * a.re - alpha.im[..., None] * a.im,
        alpha.re[..., None] * a.im + alpha.im[..., None] * a.re,
    )
    return ceinsum("nla,nlk->nak", w, b)


def clean_pilots(h: CArr, geom: ChannelGeometry) -> CArr:
    """``F_beam H`` flattened beam-major: (N, n_ant, n_sub) -> (N, pilot_num)."""
    x = ceinsum("ba,nak->nbk", geom.beam_matrix(h.re.device), h)
    return x.reshape(h.re.shape[0], geom.pilot_num)


def sound_pilots(
    h: CArr, noise: torch.Tensor, snr_db, geom: ChannelGeometry
) -> CArr:
    """``Yp = F_beam H + noise`` (``qdml_tpu/data/channels.py:391-400``) from
    unit normal ``noise`` (N, 2, pilot_num): (N, pilot_num) complex."""
    x = clean_pilots(h, geom)
    scale = float(torch.sqrt(noise_var(geom, snr_db) / 2.0))  # a float32 scalar, no copy to the device
    return CArr(x.re + scale * noise[:, 0], x.im + scale * noise[:, 1])


def ls_label(h: CArr, noise: torch.Tensor, snr_db, geom: ChannelGeometry) -> CArr:
    """The full-pilot LS label ``H + CN(0, label_noise_var)`` from unit normal
    ``noise`` (N, 2, h_dim) (``qdml_tpu/data/channels.py:455-459``)."""
    hf = h.reshape(h.re.shape[0], geom.h_dim)
    scale = float(torch.sqrt(label_noise_var(geom, snr_db) / 2.0))
    return CArr(hf.re + scale * noise[:, 0], hf.im + scale * noise[:, 1])


def generate_samples(
    generator: torch.Generator,
    scenarios: torch.Tensor,
    users: torch.Tensor,
    snr_db: float,
    geom: ChannelGeometry,
) -> dict:
    """Flat sample synthesis over ``(N,)`` scenario and user vectors on the
    generator's device, the counterpart of ``generate_samples``
    (``qdml_tpu/data/channels.py:434-468``): ``yp (N, pilot_num)``,
    ``h_perf (N, h_dim)`` and ``h_ls (N, h_dim)`` as CArr, the LS label's
    noise independent of the pilots', and ``indicator (N,)``. The draws come
    from ``generator`` in a fixed order (the channels', then the pilot noise,
    then the label noise), so a generator seeded alike gives the same samples."""
    dev = generator.device
    scenarios, users = scenarios.to(dev), users.to(dev)
    n = scenarios.shape[0]
    h = channels_from_draws(draw_channels(generator, scenarios, geom), scenarios, users, geom)
    pilot_noise = torch.randn((n, 2, geom.pilot_num), generator=generator, device=dev)
    label_noise = torch.randn((n, 2, geom.h_dim), generator=generator, device=dev)
    return {
        "yp": sound_pilots(h, pilot_noise, snr_db, geom),
        "h_perf": h.reshape(n, geom.h_dim),
        "h_ls": ls_label(h, label_noise, snr_db, geom),
        "indicator": scenarios.long(),
    }
