"""The DML grid loader (``qdml_tpu/data/datasets.py``), on the device.

The JAX package's data are a function of ``(seed, scenario, user, index)``:
every epoch reshuffles the same ``data_len`` realisations of each (scenario,
user) cell, and each step synthesizes its batch on the device. The port keeps
that meaning by materialising the grid ONCE on the device (:class:`GridData`)
and gathering each step's batch from it. Per cell and index it stores the
channel ``H``, the clean pilots ``F_beam H``, and the unit normal pilot and
label noises; each batch scales both noises by the step's SNR as it is
gathered, so ``snr_jitter`` keeps working. At the reference's data_len=20000
that is about 3.3 GB.

:meth:`GridData.from_npy_cache` instead holds the finished ``Yp``, ``Hlabel``
and ``Hperf`` of a reference-format ``.npy`` cache (the files the JAX
package's ``save_npy_cache`` writes). Those were written at the cache's
fixed SNR, so over a cache ``snr_jitter`` is refused, as the JAX
``NpyGridLoader`` refuses it. Over such a cache :class:`DMLGridLoader` yields
the batches of JAX's ``DMLGridLoader`` at ``snr_jitter=None``: the same
indices (:func:`_epoch_perms` is a verbatim copy) and the same samples.

Batches carry the JAX package's fields and layouts: ``yp_img (S, U, B,
n_sub, n_beam, 2)`` (NHWC), ``h_label`` and ``h_perf`` ``(S, U, B,
2*h_dim)``, ``indicator (S, U, B)``, the complex ``yp``, ``h_ls`` and
``h_perf_c``, and ``index``, the (S, U, B) sample indices of the step.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from qdml_tpu_torch.config import DataConfig
from qdml_tpu_torch.data.channels import (
    ChannelGeometry,
    channels_from_draws,
    clean_pilots,
    draw_channels,
    label_noise_var,
    noise_var,
)
from qdml_tpu_torch.utils.complexops import CArr, unpack_h
from qdml_tpu_torch.utils.device import resolve_device


def _resolve_split(cfg: DataConfig, split: str) -> tuple[int, int]:
    """(index_base, n) for a split — the reference's 90/10 train/val cut of
    each (scenario, user) cell (``qdml_tpu/data/datasets.py:74-82``)."""
    n_train = int(cfg.data_len * cfg.train_split)
    if split == "train":
        return 0, n_train
    if split == "val":
        return n_train, cfg.data_len - n_train
    raise ValueError(f"unknown split {split!r}")


def _epoch_perms(
    cfg: DataConfig, n: int, index_base: int, epoch: int, shuffle: bool
) -> np.ndarray:
    """(S, U, n) per-cell sample indices for one epoch, deterministic in
    ``(cfg.seed, epoch)`` (verbatim, ``qdml_tpu/data/datasets.py:85-99``)."""
    s, u = cfg.n_scenarios, cfg.n_users
    if shuffle:
        rng = np.random.default_rng((cfg.seed, epoch))
        perms = rng.permuted(
            np.broadcast_to(np.arange(n), (s, u, n)).copy(), axis=-1
        )
    else:
        perms = np.broadcast_to(np.arange(n), (s, u, n))
    return perms + index_base


def _npy_names(dirpath: str, cfg: DataConfig, scenario: int, user: int) -> dict[str, str]:
    """The reference's ``available_data/`` file names (verbatim,
    ``qdml_tpu/data/datasets.py:266-282``)."""
    tpl = "{name}{ind}_{pn}_{hd}_{snr}dB_{uid}_datalen_{dl}.npy"
    return {
        name: os.path.join(
            dirpath,
            tpl.format(
                name=name,
                ind=scenario,
                pn=cfg.pilot_num,
                hd=cfg.h_dim,
                snr=int(cfg.snr_db),
                uid=user,
                dl=cfg.data_len,
            ),
        )
        for name in ("Yp", "Hlabel", "Hperf")
    }


# samples synthesized per draw: bounds the transform's temporaries
_SYNTH_CHUNK = 4096


def _packed(c: CArr) -> torch.Tensor:
    return torch.cat([c.re, c.im], dim=-1)


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(S, U, N, D) rows at the (S, U, B) indices -> (S, U, B, D)."""
    return torch.gather(t, 2, idx[..., None].expand(-1, -1, -1, t.shape[-1]))


class GridData:
    """The whole (S, U, data_len) grid on one device, packed as real
    ``[re | im]`` rows. Build it with :meth:`synthesize` or
    :meth:`from_npy_cache`; :class:`DMLGridLoader` walks its splits."""

    def __init__(self, cfg: DataConfig, rows: dict[str, torch.Tensor], cached: bool):
        self.cfg = cfg
        self.geom = ChannelGeometry.from_config(cfg)
        self.rows = rows
        self.cached = cached
        self.device = rows["h_perf"].device

    @classmethod
    def synthesize(
        cls,
        cfg: DataConfig,
        device: str | torch.device | None = None,
    ) -> "GridData":
        """Draw the grid on ``device`` from a generator seeded with
        ``cfg.seed``: the same (seed, data_len) gives the same data."""
        dev = resolve_device(device)
        geom = ChannelGeometry.from_config(cfg)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        s_n, u_n, n = cfg.n_scenarios, cfg.n_users, cfg.data_len
        p2, h2 = 2 * geom.pilot_num, 2 * geom.h_dim
        rows = {
            "h_perf": torch.empty((s_n, u_n, n, h2), device=dev),
            "pilots": torch.empty((s_n, u_n, n, p2), device=dev),
            "pilot_noise": torch.empty((s_n, u_n, n, p2), device=dev),
            "label_noise": torch.empty((s_n, u_n, n, h2), device=dev),
        }
        for s in range(s_n):
            for u in range(u_n):
                for lo in range(0, n, _SYNTH_CHUNK):
                    m = min(_SYNTH_CHUNK, n - lo)
                    scen = torch.full((m,), s, device=dev)
                    user = torch.full((m,), u, device=dev)
                    h = channels_from_draws(draw_channels(gen, scen, geom), scen, user, geom)
                    rows["h_perf"][s, u, lo : lo + m] = _packed(h.reshape(m, geom.h_dim))
                    rows["pilots"][s, u, lo : lo + m] = _packed(clean_pilots(h, geom))
                    rows["pilot_noise"][s, u, lo : lo + m] = torch.randn(
                        (m, p2), generator=gen, device=dev
                    )
                    rows["label_noise"][s, u, lo : lo + m] = torch.randn(
                        (m, h2), generator=gen, device=dev
                    )
        return cls(cfg, rows, cached=False)

    @classmethod
    def from_npy_cache(
        cls, dirpath: str, cfg: DataConfig, device: str | torch.device | None = None
    ) -> "GridData":
        """Hold a reference-format ``.npy`` cache on ``device``. Its samples
        were drawn at the fixed ``cfg.snr_db``, so ``snr_jitter`` is refused
        (``qdml_tpu/data/datasets.py:339-344``)."""
        if cfg.snr_jitter is not None:
            raise ValueError(
                "snr_jitter is impossible on a materialised npy cache (files "
                "were generated at the fixed cfg.snr_db); synthesize the grid "
                "for the jittered protocol"
            )
        dev = resolve_device(device)
        cells: dict[str, list[list[np.ndarray]]] = {"Yp": [], "Hlabel": [], "Hperf": []}
        for s in range(cfg.n_scenarios):
            for name in cells:
                cells[name].append([])
            for u in range(cfg.n_users):
                for name, path in _npy_names(dirpath, cfg, s, u).items():
                    arr = np.load(path)
                    cells[name][s].append(np.concatenate([arr.real, arr.imag], axis=-1))
        rows = {
            key: torch.tensor(np.asarray(cells[name], dtype=np.float32), device=dev)
            for key, name in (("yp", "Yp"), ("h_label", "Hlabel"), ("h_perf", "Hperf"))
        }
        return cls(cfg, rows, cached=True)

    def batch(self, idx: torch.Tensor, snr_db: float) -> dict[str, torch.Tensor]:
        """The network batch of the (S, U, B) sample indices ``idx`` at
        ``snr_db`` (the fields of ``make_network_batch``)."""
        geom = self.geom
        if self.cached:
            if snr_db != self.cfg.snr_db:
                raise ValueError(f"the npy cache holds SNR {self.cfg.snr_db} dB, not {snr_db}")
            yp = _gather(self.rows["yp"], idx)
            h_label = _gather(self.rows["h_label"], idx)
            h_perf = _gather(self.rows["h_perf"], idx)
        else:
            h_perf = _gather(self.rows["h_perf"], idx)
            # float32 scales, as Python numbers: no host-to-device copy
            yp_scale = float(torch.sqrt(noise_var(geom, snr_db) / 2.0))
            yp = _gather(self.rows["pilots"], idx) + yp_scale * _gather(self.rows["pilot_noise"], idx)
            h_scale = float(torch.sqrt(label_noise_var(geom, snr_db) / 2.0))
            h_label = h_perf + h_scale * _gather(self.rows["label_noise"], idx)
        s_n, u_n, b = idx.shape
        img = yp.reshape(s_n, u_n, b, 2, geom.n_beam, geom.n_sub).permute(0, 1, 2, 5, 4, 3)
        indicator = torch.arange(s_n, device=self.device)[:, None, None].expand(s_n, u_n, b)
        return {
            "yp": unpack_h(yp),
            "h_ls": unpack_h(h_label),
            "h_perf_c": unpack_h(h_perf),
            "yp_img": img.contiguous(),
            "h_label": h_label,
            "h_perf": h_perf,
            "indicator": indicator,
            "index": idx,
        }


class DMLGridLoader:
    """Iterates (shuffled) minibatches of one split of a :class:`GridData`
    grid (``qdml_tpu/data/datasets.py:102-227``). Each step yields arrays with
    leading shape ``(n_scenarios, n_users, bs)``; per-epoch shuffling is
    deterministic in ``(data seed, epoch)``."""

    def __init__(self, data: GridData, batch_size: int, split: str = "train"):
        self.data = data
        self.cfg = data.cfg
        self.index_base, self.n = _resolve_split(self.cfg, split)
        self.batch_size = min(batch_size, self.n)
        self.steps_per_epoch = self.n // self.batch_size

    def _step_snr(self, epoch: int, step: int) -> float:
        """Per-step training SNR: fixed ``cfg.snr_db`` or, with
        ``cfg.snr_jitter=(lo, hi)``, uniform per batch and deterministic in
        ``(seed, epoch, step)`` (``qdml_tpu/data/datasets.py:169-179``)."""
        lo_hi = self.cfg.snr_jitter
        if lo_hi is None:
            return float(self.cfg.snr_db)
        rng = np.random.default_rng((self.cfg.seed, 7, epoch, step))
        return float(rng.uniform(lo_hi[0], lo_hi[1]))

    def _snr_for(self, epoch: int, step: int, shuffle: bool) -> float:
        # jitter applies to shuffled (training) epochs only
        return self._step_snr(epoch, step) if shuffle else float(self.cfg.snr_db)

    def epoch(self, epoch: int, shuffle: bool = True) -> Iterator[dict[str, torch.Tensor]]:
        perms = _epoch_perms(self.cfg, self.n, self.index_base, epoch, shuffle)
        # one host-to-device copy of the epoch's indices
        idx = torch.as_tensor(np.ascontiguousarray(perms), dtype=torch.long, device=self.data.device)
        bs = self.batch_size
        for step in range(self.steps_per_epoch):
            yield self.data.batch(
                idx[:, :, step * bs : (step + 1) * bs], self._snr_for(epoch, step, shuffle)
            )
