"""The unitary <Z> kernel's design, checked on the CPU.

``csrc/unitary_expvals.cu`` cannot run here, so its partition is emulated in
float64 numpy and held against the port's plain version and the JAX
package's ``fused_unitary_expvals`` (Pallas in interpret mode, as the JAX
package's own tests run it): the launcher's tile plan by (n, batch), the
column tiles, K-chunks and depth groups (each (row, column, k) term taken
exactly once), and the fixed-order sum of the column tiles' partial sums.

Inputs come from a numpy seed; tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax.numpy as jnp  # noqa: E402

from qdml_tpu.quantum import pallas_kernels as jpk  # noqa: E402
from qdml_tpu.utils.complexops import CArr as JCArr  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.quantum import statevector as sv  # noqa: E402

# the tile plan, mirrored from csrc/unitary_expvals.cu

# (RT, CT, TY, TX, KS, KC): outputs a thread, threads over rows and columns,
# depth groups, the largest K-chunk
PLANS = {
    "small": (1, 1, 4, 8, 8, 256),
    "mid": (2, 2, 8, 16, 1, 32),
    "low16": (2, 2, 8, 32, 1, 64),
    "low32": (2, 4, 16, 16, 1, 64),
    "wide": (4, 4, 16, 16, 1, 32),
}


def plan_for(n, batch):
    if batch <= 4:
        return "small"
    if n <= 7:
        return "low32" if batch >= 2048 else "low16" if batch >= 512 else "mid"
    return "wide" if batch >= 1024 else "mid"


def emulate_unitary(psi_re, psi_im, u_re, u_im, n):
    """The kernel's partition in float64 numpy: row tiles x column tiles
    (zero-filled past the batch and past 2^n), K-chunks split over depth
    groups (each k taken by exactly one group), each tile's per-row signed
    sums of |c|^2, then the column tiles summed in order. Returns (<Z>, the
    number of tiles that took each (row, column), the number of depth
    groups that took each k in one tile's walk)."""
    psi = np.asarray(psi_re, np.float64) + 1j * np.asarray(psi_im, np.float64)
    u = np.asarray(u_re, np.float64) + 1j * np.asarray(u_im, np.float64)
    batch, dim = psi.shape
    rt, ct, ty, tx, ks, kc = PLANS[plan_for(n, batch)]
    rows, cols = rt * ty, ct * tx
    chunk = min(dim, kc)
    vec = min(chunk, 4)
    groups = min(ks, chunk // vec)
    sub = chunk // groups
    tiles = max(1, dim // cols)
    row_tiles = -(-batch // rows)
    z = sv.z_signs(n).astype(np.float64)
    partial = np.zeros((tiles, batch, n))
    taken_rc = np.zeros((batch, dim), dtype=np.int64)
    taken_k = np.zeros(dim, dtype=np.int64)
    for bx in range(row_tiles):
        r_idx = bx * rows + np.arange(rows)
        r_ok = r_idx < batch
        for by in range(tiles):
            j_idx = by * cols + np.arange(cols)
            j_ok = j_idx < dim
            a = np.where(r_ok[:, None], psi[np.minimum(r_idx, batch - 1)], 0)
            b = np.where(j_ok[:, None], u[np.minimum(j_idx, dim - 1)], 0)
            c = np.zeros((rows, cols), complex)
            for k0 in range(0, dim, chunk):
                for g in range(ks):
                    if g >= groups:
                        continue  # depth groups without work add zeros
                    ks_ = k0 + g * sub + np.arange(sub)
                    c += a[:, ks_] @ b[:, ks_].T
                    if bx == by == 0:  # every tile walks the same k
                        taken_k[ks_] += 1
            taken_rc[np.ix_(r_idx[r_ok], j_idx[j_ok])] += 1
            p = np.abs(c) ** 2  # (rows, cols); zero past 2^n
            signs = z[np.minimum(j_idx, dim - 1)] * j_ok[:, None]
            part = p @ signs
            partial[by, r_idx[r_ok]] = part[r_ok]
    out = np.zeros((batch, n))
    for t in range(tiles):  # the second pass, in column-tile order
        out += partial[t]
    return out, (taken_rc, taken_k)


def _unitary_inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    dim = 1 << n
    re, im = rng.standard_normal((2, batch, dim))
    norm = np.sqrt((re**2 + im**2).sum(-1, keepdims=True))
    u = rng.standard_normal((2, dim, dim)) / np.sqrt(2 * dim)  # about norm-preserving
    return [x.astype(np.float32) for x in (re / norm, im / norm, u[0], u[1])]


@pytest.mark.parametrize("batch", [3, 9])
@pytest.mark.parametrize("n", range(1, 13))
def test_unitary_emulation_matches_plain_and_jax(n, batch):
    """The emulated partition (the small-batch plan at B = 3, the moderate
    one at B = 9) against the plain version and the JAX package: 1e-5 of the
    largest |<Z>| (2^n-term sums in another order). Every (row, column, k)
    term is taken once."""
    ins = _unitary_inputs(n, batch, seed=200 + 2 * n + batch)
    got, taken = emulate_unitary(*ins, n)
    assert all((t == 1).all() for t in taken)
    plain = tk.unitary_expvals_plain(*(torch.tensor(x) for x in ins), n).numpy()
    jax_ref = np.asarray(jpk.fused_unitary_expvals(JCArr(*map(jnp.asarray, ins[:2])), JCArr(*map(jnp.asarray, ins[2:])), n))
    scale = np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, jax_ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize(
    "n,batch,plan",
    [(1, 600, "low16"), (6, 600, "low16"), (7, 513, "low16"), (6, 2304, "low32"), (7, 2050, "low32"),
     (2, 2048, "low32"), (8, 1024, "wide"), (8, 1030, "wide"), (9, 1024, "wide")],
)
def test_unitary_wide_plans_partition_matches_plain(n, batch, plan):
    """The large-batch plans (16 x 64 and 32 x 64 tiles at n <= 7, 64 x 64
    from n = 8, ragged last row tiles) take every term once and agree with
    the plain version within 1e-5 of the largest |<Z>|."""
    assert plan_for(n, batch) == plan
    ins = _unitary_inputs(n, batch, seed=300 + n)
    got, taken = emulate_unitary(*ins, n)
    assert all((t == 1).all() for t in taken)
    plain = tk.unitary_expvals_plain(*(torch.tensor(x) for x in ins), n).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * np.abs(plain).max())
