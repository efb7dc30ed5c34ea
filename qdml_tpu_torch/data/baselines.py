"""Classical channel-estimation baselines, LS and LMMSE (``qdml_tpu/data/baselines.py``).

The LS baseline IS the full-pilot observation ``h_ls`` the generator makes
(the reference's ``HLS``); :func:`mmse_estimate` refines it with a diagonal
Wiener gain in the beam-delay domain under an empirical prior profile, and
:func:`mmse_generic_estimate` is the site-agnostic LMMSE the reference's
``generate_MMSE_estimate`` stands for (``Test.py:145``). :func:`ls_estimate`
back-projects the compressed ``Yp`` pilots. Complex values are
:class:`~qdml_tpu_torch.utils.complexops.CArr` real pairs.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from qdml_tpu_torch.data.channels import (
    ChannelGeometry,
    channels_from_draws,
    draw_channels,
    noise_var,
)
from qdml_tpu_torch.utils.complexops import CArr, ceinsum
from qdml_tpu_torch.utils.device import resolve_device


def _conj(x: CArr) -> CArr:
    return CArr(x.re, -x.im)


def _transpose(x: CArr) -> CArr:
    return CArr(x.re.T, x.im.T)


def ls_estimate(yp: CArr, geom: ChannelGeometry) -> CArr:
    """LS (back-projection) estimate, (..., pilot_num) -> (..., h_dim): with the
    unitary-row beam codebook ``B``, the minimum-norm solution of ``Yp = B H``
    is ``B^H Yp`` (observed beams restored, unsounded beams zero)."""
    x = yp.reshape(yp.shape[:-1] + (geom.n_beam, geom.n_sub))
    h = ceinsum("ba,...bk->...ak", _conj(geom.beam_matrix(yp.re.device)), x)
    return h.reshape(yp.shape[:-1] + (geom.h_dim,))


def _to_beam_delay(h: CArr, geom: ChannelGeometry) -> CArr:
    """(..., n_ant, n_sub) antenna-frequency -> beam-delay domain."""
    dev = h.re.device
    g = ceinsum("ma,...ak->...mk", geom.ant_dft(dev), h)
    return ceinsum("...mk,kd->...md", g, _transpose(_conj(geom.sub_dft(dev))))


def _from_beam_delay(g: CArr, geom: ChannelGeometry) -> CArr:
    dev = g.re.device
    h = ceinsum("am,...md->...ad", _transpose(_conj(geom.ant_dft(dev))), g)
    return ceinsum("...ad,dk->...ak", h, geom.sub_dft(dev))


def beam_delay_profile(
    geom: ChannelGeometry,
    seed: int = 7,
    n_samples: int = 768,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Empirical prior variance profile E|G[m, d]|^2 in the beam-delay domain,
    averaged over the 3 x 3 scenario/user grid: (n_ant, n_sub) float32. It
    plays the role of the channel covariance; drawn from noiseless channels
    of a generator seeded with ``seed`` (the JAX package's keys cannot be
    reproduced, so the profile agrees with JAX's in distribution). On the
    card unless ``device="cpu"``."""
    device = resolve_device(device)
    per_cell = max(n_samples // 9, 1)
    scen = torch.arange(3, device=device).repeat_interleave(3 * per_cell)
    user = torch.arange(3, device=device).repeat_interleave(per_cell).repeat(3)
    gen = torch.Generator(device=device).manual_seed(seed)
    h = channels_from_draws(draw_channels(gen, scen, geom), scen, user, geom)
    return _to_beam_delay(h, geom).abs2().mean(dim=0)


def mmse_estimate(h_ls: CArr, sigma2, profile: torch.Tensor, geom: ChannelGeometry) -> CArr:
    """LMMSE refinement of the full-pilot LS estimate: to the beam-delay
    domain, the diagonal Wiener gain ``P / (P + sigma2)``, and back. ``sigma2``
    is the label noise variance; white noise stays white under the unitary
    transforms."""
    hh = h_ls.reshape(h_ls.shape[:-1] + (geom.n_ant, geom.n_sub))
    g = _to_beam_delay(hh, geom)
    gain = profile / (profile + sigma2)
    h = _from_beam_delay(CArr(g.re * gain, g.im * gain), geom)
    return h.reshape(h_ls.shape)


def sigma2_for_snr(geom: ChannelGeometry, snr_db) -> torch.Tensor:
    """Noise variance matching the generator's pilot noise."""
    return noise_var(geom, snr_db)


@lru_cache(maxsize=64)
def _generic_wiener(n_sub: int, sigma2: float, rho: float, device: str) -> torch.Tensor:
    """``W = R (R + sigma2 I)^-1`` with ``R[k, k'] = rho**|k - k'|``, in float32
    as the JAX package forms it, then cached on ``device``: one host-to-device
    copy per (SNR, device), not one per batch."""
    k = torch.arange(n_sub)
    corr = rho ** (k[:, None] - k[None, :]).abs().to(torch.float32)
    w = corr @ torch.linalg.inv(corr + sigma2 * torch.eye(n_sub))
    return w.to(device)


def mmse_generic_estimate(
    h_ls: CArr, sigma2, geom: ChannelGeometry, rho: float = 0.85
) -> CArr:
    """Reference-faithful generic LMMSE (``generate_MMSE_estimate``,
    ``Test.py:145``): a per-antenna frequency-domain Wiener filter under an
    ASSUMED exponential subcarrier correlation ``rho**|k - k'|``, with no
    knowledge of the generator's prior. ``rho = 0.85`` calibrates the curve
    to the reference's published MMSE (-13.5 dB at 15 dB SNR)."""
    w = _generic_wiener(geom.n_sub, float(sigma2), float(rho), str(h_ls.re.device))
    hh = h_ls.reshape(h_ls.shape[:-1] + (geom.n_ant, geom.n_sub))
    out = CArr(hh.re @ w.T, hh.im @ w.T)
    return out.reshape(h_ls.shape)
