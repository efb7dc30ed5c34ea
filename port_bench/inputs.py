"""What the benchmark makes from ``--seed``: weights, the training grid and
the order of its rows. Both the program and the reference are handed what
these functions make; neither makes its own.

Weights and the grid are drawn on the device with a ``torch.Generator`` in
a few large calls (one normal draw for all the weights, one draw a row
kind for the grid); the rows' order is drawn on the host.
"""

from __future__ import annotations

import numpy as np
import torch

# distinct streams drawn from one --seed
STREAMS = {"weights": 1, "grid": 2, "order": 3}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def host_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def device_generator(seed: int, stream: str, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def make_weights(specs: list[tuple], seed: int, stream: str, device: torch.device) -> dict[str, torch.Tensor]:
    """Every tensor of ``specs`` ((name, shape, init) as
    :mod:`port_bench.reference.models` writes them), float32 on ``device``
    (``num_batches_tracked`` int64), from one normal draw."""
    gen = device_generator(seed, stream, device)
    sizes = [int(np.prod(shape)) for _, shape, _ in specs]
    n_normal = sum(n for n, (_, _, init) in zip(sizes, specs) if init[0] == "normal")
    normal = torch.randn(max(n_normal, 1), generator=gen, device=device)
    out, i_n = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        if init[0] == "normal":
            t = normal[i_n : i_n + n].view(shape) * init[1]
            i_n += n
        elif name.endswith("num_batches_tracked"):
            t = torch.full(shape, int(init[1]), dtype=torch.long, device=device)
        else:
            t = torch.full(shape, float(init[1]), dtype=torch.float32, device=device)
        out[name] = t.contiguous()
    return out


def grid_widths(geom: dict) -> dict[str, int]:
    """Each row kind's width: packed [re | im] pilots and channels."""
    p2, h2 = 2 * geom["pilot_num"], 2 * geom["h_dim"]
    return {"h_perf": h2, "pilots": p2, "pilot_noise": p2, "label_noise": h2}


def make_grid(geom: dict, n_scenarios: int, n_users: int, rows: int, seed: int,
              device: torch.device) -> dict[str, torch.Tensor]:
    """The (S, U, rows) training grid: channels of unit complex power an
    entry, pilots at the per-pilot power h_dim / pilot_num that sets the
    noise floor, and unit normal noise, which the SNR scales."""
    gen = device_generator(seed, "grid", device)
    pilot_std = (geom["h_dim"] / geom["pilot_num"] / 2.0) ** 0.5
    scale = {"h_perf": 0.5 ** 0.5, "pilots": pilot_std, "pilot_noise": 1.0, "label_noise": 1.0}
    out = {}
    for key, width in grid_widths(geom).items():
        t = torch.randn((n_scenarios, n_users, rows, width), generator=gen, device=device)
        out[key] = t.mul_(scale[key]) if scale[key] != 1.0 else t
    return out


def step_indices(n_steps: int, n_scenarios: int, n_users: int, batch: int, rows: int,
                 seed: int) -> np.ndarray:
    """(n_steps, S, U, B) sample indices: each (scenario, user) cell walks a
    seeded permutation of its rows, so steps within one pass take rows that
    all differ."""
    rng = host_rng(seed, "order")
    out = np.empty((n_steps, n_scenarios, n_users, batch), np.int64)
    per_pass = rows // batch
    for s in range(n_scenarios):
        for u in range(n_users):
            perm = None
            for t in range(n_steps):
                if t % per_pass == 0:
                    perm = rng.permutation(rows)
                j = t % per_pass
                out[t, s, u] = perm[j * batch : (j + 1) * batch]
    return out
