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

:class:`NpyGridLoader` reads such a cache from its files instead, through
the native IO runtime (:mod:`qdml_tpu_torch.runtime`): mmapped files, the
C++ row gather and a producer thread a few steps ahead, each batch copied
to the device as it is assembled.

Test data (:func:`generate_datapair`, :func:`sweep_batch`) is drawn anew on
the device: flat ``(N,)`` scenario and user vectors assigned as the JAX
package assigns them, through :func:`make_network_batch`. ``jax.random``'s
bits cannot be reproduced, so where JAX offsets the sample index past the
training data (``qdml_tpu/eval/sweep.py:260``), the port draws test samples
from generators of their own: each is seeded with a SeedSequence of
``(data seed, a test-stream tag, start, ...)``, while the training grid's
generator is seeded with the bare data seed. The seeds differ, so the test
streams never hand out the training draws. :func:`save_npy_cache` writes the
training grid itself in the reference's ``.npy`` format.
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
    generate_samples,
    label_noise_var,
    noise_var,
)
from qdml_tpu_torch.utils.complexops import CArr, pack_h, unpack_h, yp_to_image
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
# SeedSequence tag of the test-data streams (eval sweep, generate_datapair)
_TEST_STREAM = 0x7E57


def _synth_chunks(cfg: DataConfig, dev: torch.device):
    """The training grid's draws, chunk by chunk, from ONE generator seeded
    with ``cfg.seed`` in a fixed (scenario, user, index) order: yields
    ``((s, u, lo), rows)`` with the packed channel, clean pilots and unit
    pilot and label noises of samples ``lo ..`` of cell (s, u)."""
    geom = ChannelGeometry.from_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    p2, h2 = 2 * geom.pilot_num, 2 * geom.h_dim
    for s in range(cfg.n_scenarios):
        for u in range(cfg.n_users):
            for lo in range(0, cfg.data_len, _SYNTH_CHUNK):
                m = min(_SYNTH_CHUNK, cfg.data_len - lo)
                scen = torch.full((m,), s, device=dev)
                user = torch.full((m,), u, device=dev)
                h = channels_from_draws(draw_channels(gen, scen, geom), scen, user, geom)
                yield (s, u, lo), {
                    "h_perf": _packed(h.reshape(m, geom.h_dim)),
                    "pilots": _packed(clean_pilots(h, geom)),
                    "pilot_noise": torch.randn((m, p2), generator=gen, device=dev),
                    "label_noise": torch.randn((m, h2), generator=gen, device=dev),
                }


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
        s_n, u_n, n = cfg.n_scenarios, cfg.n_users, cfg.data_len
        p2, h2 = 2 * geom.pilot_num, 2 * geom.h_dim
        rows = {
            "h_perf": torch.empty((s_n, u_n, n, h2), device=dev),
            "pilots": torch.empty((s_n, u_n, n, p2), device=dev),
            "pilot_noise": torch.empty((s_n, u_n, n, p2), device=dev),
            "label_noise": torch.empty((s_n, u_n, n, h2), device=dev),
        }
        for (s, u, lo), chunk in _synth_chunks(cfg, dev):
            for key, value in chunk.items():
                rows[key][s, u, lo : lo + value.shape[0]] = value
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

    def batch(
        self, idx: torch.Tensor, snr_db: float | torch.Tensor, scen_start: int = 0
    ) -> dict[str, torch.Tensor]:
        """The network batch of the (S, U, B) sample indices ``idx`` of
        scenarios ``scen_start ... scen_start + S - 1`` (a rank's rectangle
        under a mesh, :meth:`DMLGridLoader.set_process_slice`) at ``snr_db``
        (the fields of ``make_network_batch``): a Python number,
        or a 0-d float32 tensor on the grid's device, which a captured CUDA
        graph reads at every replay (a number would be frozen into it). The
        noise scales are computed on the SNR's device in float32 either way.
        Over an npy cache a number is checked against the cache's SNR; a
        tensor is not read on the host, and the loaders only hand it
        ``cfg.snr_db`` (a cache refuses ``snr_jitter``)."""
        geom = self.geom
        s_n = idx.shape[0]
        rows = {k: v[scen_start : scen_start + s_n] for k, v in self.rows.items()}
        if self.cached:
            if not isinstance(snr_db, torch.Tensor) and snr_db != self.cfg.snr_db:
                raise ValueError(f"the npy cache holds SNR {self.cfg.snr_db} dB, not {snr_db}")
            yp = _gather(rows["yp"], idx)
            h_label = _gather(rows["h_label"], idx)
            h_perf = _gather(rows["h_perf"], idx)
        else:
            h_perf = _gather(rows["h_perf"], idx)
            yp_scale = torch.sqrt(noise_var(geom, snr_db) / 2.0)
            h_scale = torch.sqrt(label_noise_var(geom, snr_db) / 2.0)
            if not isinstance(snr_db, torch.Tensor):
                # float32 scales, as Python numbers: no host-to-device copy
                yp_scale, h_scale = float(yp_scale), float(h_scale)
            yp = _gather(rows["pilots"], idx) + yp_scale * _gather(rows["pilot_noise"], idx)
            h_label = h_perf + h_scale * _gather(rows["label_noise"], idx)
        s_n, u_n, b = idx.shape
        img = yp.reshape(s_n, u_n, b, 2, geom.n_beam, geom.n_sub).permute(0, 1, 2, 5, 4, 3)
        scen = torch.arange(scen_start, scen_start + s_n, device=self.device)
        indicator = scen[:, None, None].expand(s_n, u_n, b)
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
        self._pslice: tuple[int, int] | None = None
        self._sslice: tuple[int, int] = (0, self.cfg.n_scenarios)

    def set_process_slice(
        self, start: int, length: int, scen_start: int = 0, scen_count: int | None = None
    ) -> None:
        """Yield only ``[start, start + length)`` of each batch window and,
        under a federated layout, only scenarios ``[scen_start, scen_start +
        scen_count)``: a rank's rectangle of every global batch
        (``qdml_tpu/data/datasets.py:129-159``, its checks and messages).
        The rows are those the one-rank loader yields in that rectangle."""
        if not (0 <= start and start + length <= self.batch_size):
            raise ValueError(
                f"process slice [{start}, {start + length}) outside batch "
                f"window of {self.batch_size}"
            )
        s = self.cfg.n_scenarios
        scen_count = s if scen_count is None else scen_count
        if not (0 <= scen_start and scen_start + scen_count <= s):
            raise ValueError(
                f"scenario slice [{scen_start}, {scen_start + scen_count}) "
                f"outside the {s}-scenario grid"
            )
        self._pslice = (start, length)
        self._sslice = (scen_start, scen_count)

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

    def _step_window(self, perms: np.ndarray, step: int) -> np.ndarray:
        """This step's (S, U, bs) index window: one source for both
        iterators below, as ``qdml_tpu/data/datasets.py:181-192``."""
        bs = self.batch_size
        window = perms[:, :, step * bs : (step + 1) * bs]
        if self._pslice is not None:
            p0, plen = self._pslice
            s0, scount = self._sslice
            window = window[s0 : s0 + scount, :, p0 : p0 + plen]
        return window

    def epoch(self, epoch: int, shuffle: bool = True) -> Iterator[dict[str, torch.Tensor]]:
        """The epoch's batches, one a step. The SNRs reach the device as a
        tensor, the same float32 arithmetic as :meth:`epoch_chunks`'s
        graph, so the per-step and the K-step paths take the same steps."""
        perms = _epoch_perms(self.cfg, self.n, self.index_base, epoch, shuffle)
        # one host-to-device copy of the epoch's indices and one of its SNRs
        dev = self.data.device
        idx = torch.as_tensor(np.ascontiguousarray(perms), dtype=torch.long, device=dev)
        snrs = torch.tensor(
            [self._snr_for(epoch, step, shuffle) for step in range(self.steps_per_epoch)],
            dtype=torch.float32, device=dev,
        )
        for step in range(self.steps_per_epoch):
            window = self._step_window(idx, step)
            yield self.data.batch(window, snrs[step], self._sslice[0])

    def epoch_chunks(
        self, epoch: int, k: int, shuffle: bool = True
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """The K-step view of :meth:`epoch` (``qdml_tpu/data/datasets.py:
        211-227``): ``(idx (k', S, U, B) int64, snr (k',) float32)`` host
        arrays covering the same per-step index windows and SNRs, ``k``
        steps at a time; the last chunk may be shorter, so an epoch has at
        most two chunk lengths. :mod:`qdml_tpu_torch.train.scan` copies each
        chunk to the device once."""
        if k < 1:
            raise ValueError(f"epoch_chunks needs k >= 1, got {k}")
        perms = _epoch_perms(self.cfg, self.n, self.index_base, epoch, shuffle)
        for c0 in range(0, self.steps_per_epoch, k):
            steps = range(c0, min(c0 + k, self.steps_per_epoch))
            windows = np.stack([self._step_window(perms, step) for step in steps]).astype(np.int64)
            snrs = np.asarray([self._snr_for(epoch, step, shuffle) for step in steps], np.float32)
            yield windows, snrs


# ---------------------------------------------------------------------------
# Test data: flat batches drawn on the device
# ---------------------------------------------------------------------------


def make_network_batch(
    generator: torch.Generator,
    scenarios: torch.Tensor,
    users: torch.Tensor,
    snr_db: float,
    geom: ChannelGeometry,
) -> dict:
    """Flat ``(N,)`` samples as network-ready arrays, the flat form of
    ``make_network_batch`` (``qdml_tpu/data/datasets.py:37-71``): complex
    ``yp``, ``h_ls``, ``h_perf_c``; ``yp_img (N, n_sub, n_beam, 2)`` NHWC;
    packed ``h_label`` and ``h_perf (N, 2*h_dim)``; ``indicator (N,)``."""
    flat = generate_samples(generator, scenarios, users, snr_db, geom)
    return {
        "yp": flat["yp"],
        "h_ls": flat["h_ls"],
        "h_perf_c": flat["h_perf"],
        "yp_img": yp_to_image(flat["yp"], geom.n_sub, geom.n_beam).contiguous(),
        "h_label": pack_h(flat["h_ls"]),
        "h_perf": pack_h(flat["h_perf"]),
        "indicator": flat["indicator"],
    }


def _eval_generator(cfg: DataConfig, device: torch.device, *key: int) -> torch.Generator:
    """A test-data generator on ``device`` seeded from ``(cfg.seed, the
    test-stream tag, *key)``; never the training grid's stream (seeded with
    ``cfg.seed`` alone)."""
    words = (int(cfg.seed), _TEST_STREAM, *(int(k) for k in key))
    seed = int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)



def sweep_batch(
    cfg: DataConfig,
    start: int,
    count_base: int,
    batch_size: int,
    snr_db: float,
    device: str | torch.device | None = None,
    geom: ChannelGeometry | None = None,
) -> dict:
    """One eval-sweep batch (``qdml_tpu/eval/sweep.py:112-118``): rows
    ``i = count_base .. count_base + batch_size - 1``, scenario ``i % S``, user
    ``(i // S) % U``, drawn from the test generator of ``(start,
    count_base)``. The draws do not depend on ``snr_db``, so every SNR point
    sees the same channels and unit noises, as in JAX."""
    dev = resolve_device(device)
    geom = geom or ChannelGeometry.from_config(cfg)
    i = count_base + torch.arange(batch_size, device=dev)
    scen = i % cfg.n_scenarios
    user = (i // cfg.n_scenarios) % cfg.n_users
    gen = _eval_generator(cfg, dev, start, count_base)
    return make_network_batch(gen, scen, user, snr_db, geom)


def generate_datapair(
    ns: int,
    pilot_num: int,
    index: int,
    snr_db: float,
    start: int,
    cfg: DataConfig | None = None,
    geom: ChannelGeometry | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Test-set synthesis for the reference call ``generate_datapair(Ns,
    Pilot_num, index, SNRdb, start, training_data_len)`` (``Test.py:127-129``,
    ``qdml_tpu/data/datasets.py:230-258``): ``index=-1`` mixes all scenarios
    round-robin over the grid, ``index=k`` takes scenario ``k % S`` with users
    round-robin. The samples come from the test generator of ``(start,
    index)``, never from the training stream."""
    cfg = cfg or DataConfig()
    geom = geom or ChannelGeometry.from_config(cfg)
    if pilot_num != geom.pilot_num:
        raise ValueError(f"pilot_num {pilot_num} != geometry pilot_num {geom.pilot_num}")
    dev = resolve_device(device)
    i = torch.arange(ns, device=dev)
    if index == -1:
        scen = i % cfg.n_scenarios
        user = (i // cfg.n_scenarios) % cfg.n_users
    else:
        scen = torch.full((ns,), index % cfg.n_scenarios, device=dev)
        user = i % cfg.n_users
    gen = _eval_generator(cfg, dev, start, index + 1, ns)
    return make_network_batch(gen, scen, user, snr_db, geom)


# ---------------------------------------------------------------------------
# Reference-format .npy cache (``available_data/`` naming, Runner...py:49-55)
# ---------------------------------------------------------------------------


def _complex(rows: torch.Tensor) -> np.ndarray:
    """Packed ``[re | im]`` rows -> a complex64 numpy array, as JAX's
    ``CArr.to_numpy`` writes them."""
    c = unpack_h(rows.cpu())
    return c.re.numpy() + 1j * c.im.numpy()


def save_npy_cache(
    dirpath: str, cfg: DataConfig, device: str | torch.device | None = None
) -> None:
    """Write the training grid that :meth:`GridData.synthesize` draws, at the
    fixed ``cfg.snr_db``, as the reference's ``.npy`` cache
    (``qdml_tpu/data/datasets.py:285-307``): per (scenario, user) cell the
    complex ``Yp (data_len, pilot_num)``, ``Hlabel`` and ``Hperf (data_len,
    h_dim)``, under the reference's file names. One cell is held at a time."""
    dev = resolve_device(device)
    os.makedirs(dirpath, exist_ok=True)
    geom = ChannelGeometry.from_config(cfg)
    yp_scale = float(torch.sqrt(noise_var(geom, cfg.snr_db) / 2.0))
    h_scale = float(torch.sqrt(label_noise_var(geom, cfg.snr_db) / 2.0))
    parts: dict[str, list[np.ndarray]] = {"Yp": [], "Hlabel": [], "Hperf": []}
    for (s, u, lo), chunk in _synth_chunks(cfg, dev):
        parts["Yp"].append(_complex(chunk["pilots"] + yp_scale * chunk["pilot_noise"]))
        parts["Hlabel"].append(_complex(chunk["h_perf"] + h_scale * chunk["label_noise"]))
        parts["Hperf"].append(_complex(chunk["h_perf"]))
        if lo + chunk["h_perf"].shape[0] == cfg.data_len:  # the cell is complete
            for name, path in _npy_names(dirpath, cfg, s, u).items():
                np.save(path, np.concatenate(parts[name], axis=0))
            parts = {name: [] for name in parts}


def load_npy_cache(dirpath: str, cfg: DataConfig, scenario: int, user: int) -> dict[str, np.ndarray]:
    """One (scenario, user) cell of a reference-format ``.npy`` cache
    (``qdml_tpu/data/datasets.py:310-312``)."""
    return {n: np.load(p) for n, p in _npy_names(dirpath, cfg, scenario, user).items()}


class NpyGridLoader:
    """The DML grid loader over a reference-format ``.npy`` cache through the
    native IO runtime (``qdml_tpu/data/datasets.py:315-420``): the files are
    mmapped zero-copy (:class:`~qdml_tpu_torch.runtime.NativeNpyFile`), each
    step's shuffled rows are gathered by the C++ threads
    (:func:`~qdml_tpu_torch.runtime.gather_rows`), and a producer thread
    keeps ``prefetch_depth`` steps assembled and on ``device`` ahead of the
    consumer. The file-based twin of :class:`DMLGridLoader` over
    :meth:`GridData.from_npy_cache`, which holds the whole cache on the
    device instead.

    Yields the same ``(S, U, bs, ...)`` ``yp_img``, ``h_label``, ``h_perf``
    and ``indicator`` as :class:`DMLGridLoader` over the same cache, the
    same indices (:func:`_epoch_perms`) in the same order, as tensors on
    ``device`` (the card unless the caller asks for the CPU). The cache was
    written at the fixed ``cfg.snr_db``, so ``snr_jitter`` is refused.
    ``is_native`` says whether every file is read through the C++ library
    (else numpy's mmap, the same values)."""

    def __init__(
        self,
        dirpath: str,
        cfg: DataConfig,
        batch_size: int,
        split: str = "train",
        n_threads: int = 4,
        prefetch_depth: int = 2,
        device: str | torch.device | None = None,
    ):
        from qdml_tpu_torch.runtime import NativeNpyFile

        if cfg.snr_jitter is not None:
            raise ValueError(
                "snr_jitter is impossible on a materialised npy cache (files "
                "were generated at the fixed cfg.snr_db); use DMLGridLoader "
                "for the jittered protocol"
            )
        self.cfg = cfg
        self.geom = ChannelGeometry.from_config(cfg)
        self.device = resolve_device(device)
        self.n_threads = n_threads
        self.prefetch_depth = max(prefetch_depth, 1)
        self._files = {
            (s, u, name): NativeNpyFile(path)
            for s in range(cfg.n_scenarios)
            for u in range(cfg.n_users)
            for name, path in _npy_names(dirpath, cfg, s, u).items()
        }
        self.index_base, self.n = _resolve_split(cfg, split)
        self.batch_size = min(batch_size, self.n)
        self.steps_per_epoch = self.n // self.batch_size

    @property
    def is_native(self) -> bool:
        return all(f.is_native for f in self._files.values())

    def _assemble(self, idx_grid: np.ndarray) -> dict[str, torch.Tensor]:
        """One (S, U, bs) step's rows from the mmaps (C++ threads), packed
        ``[re | im]`` in float32 on the host, then copied to the device."""
        from qdml_tpu_torch.runtime import gather_rows

        s_n, u_n, bs = idx_grid.shape
        packed = {}
        for name in ("Yp", "Hlabel", "Hperf"):
            dim = self._files[(0, 0, name)].array.shape[-1]
            rows = np.empty((s_n, u_n, bs, 2 * dim), np.float32)
            for s in range(s_n):
                for u in range(u_n):
                    c = gather_rows(self._files[(s, u, name)].array, idx_grid[s, u], self.n_threads)
                    rows[s, u, :, :dim] = c.real
                    rows[s, u, :, dim:] = c.imag
            packed[name] = torch.from_numpy(rows).to(self.device)
        geom = self.geom
        scen = torch.arange(s_n, device=self.device)
        return {
            "yp_img": yp_to_image(unpack_h(packed["Yp"]), geom.n_sub, geom.n_beam).contiguous(),
            "h_label": packed["Hlabel"],
            "h_perf": packed["Hperf"],
            "indicator": scen[:, None, None].expand(s_n, u_n, bs),
        }

    def epoch(self, epoch: int, shuffle: bool = True) -> Iterator[dict[str, torch.Tensor]]:
        import queue
        import threading

        bs = self.batch_size
        perms = _epoch_perms(self.cfg, self.n, self.index_base, epoch, shuffle)
        # a depth-limited producer: the C++ gather releases the GIL, so step
        # k+1's assembly overlaps the consumer's step k. It always ends with
        # a sentinel: an assembly error is forwarded to the consumer, and an
        # abandoned epoch (the consumer's early break) sets ``stop`` so the
        # producer is never left blocked on a full queue
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        done, failed = object(), object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for step in range(self.steps_per_epoch):
                    if not put(self._assemble(perms[:, :, step * bs : (step + 1) * bs])):
                        return
                put((done, None))
            except BaseException as e:  # lint: disable=broad-except(producer-thread failures (incl. KeyboardInterrupt) are forwarded through the queue and re-raised on the consumer)
                put((failed, e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, tuple) and item[0] in (done, failed):
                    if item[0] is failed:
                        raise item[1]
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()
