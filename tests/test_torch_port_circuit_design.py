"""The circuit forward kernel's design, checked on the CPU.

``csrc/circuit_expvals.cu`` cannot run here, so its addressing is emulated
in float64 numpy and held against the port's plain version and the JAX
package's ``fused_circuit_expvals`` and ``_circuit_forward`` (the Pallas
kernel in interpret mode for 7 <= n <= 12, its XLA twin below, as the JAX
package's own tests run them): the pass plan (wires applied ``span`` at a
time, the last pass padded with first-pass wires it leaves alone), the
embedded state built in the first pass's registers, the ring as an XOR index
map (the table of g^j(e_q), g the ring's source map, against powers of
``ring_cnot_perm``), the swizzled shared-memory index, and the epilogue's
logical-order read that writes the state and sums <Z>.

Inputs come from a numpy seed; tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax.numpy as jnp  # noqa: E402

from qdml_tpu.quantum import pallas_kernels as jpk  # noqa: E402
from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.quantum import statevector as sv  # noqa: E402

# --- the forward's pass plan, mirrored from csrc/circuit_expvals.cu ---------


def _span(n):
    return 2 if n < 7 else 3


def _passes(n):
    return -(-n // _span(n))


def _active(n, p):
    return min(_span(n), n - p * _span(n))


def _slot_wire(n, p, s):
    a = _active(n, p)
    return n - 1 - p * _span(n) - s if s < a else n - 1 - (s - a)


def _other_wires(n, p):
    slots = {_slot_wire(n, p, s) for s in range(_span(n))}
    return [q for q in range(n - 1, -1, -1) if q not in slots]


def _groups(n):
    return 1 << (n - _span(n))


def _samples_per_block(n):
    return max(32, _groups(n)) // _groups(n)


def _swz(t):
    return t ^ ((t >> 5) & 31)


def ring_source_masks(n: int, layers: int) -> np.ndarray:
    """(layers + 1, n): entry [j, q] is g^j(e_q), g the ring's source map
    (``ring_cnot_perm``: psi'[y] = psi[g(y)]), e_q wire q's basis bit."""
    g = sv.ring_cnot_perm(n)
    v = 1 << (n - 1 - np.arange(n))
    out = np.empty((layers + 1, n), dtype=np.int64)
    for j in range(layers + 1):
        out[j] = v
        v = g[v]
    return out


def _members(base, masks, w_):
    """(..., 2^w) addresses: base XOR the masks of r's set bits (slot s is bit
    w-1-s of r)."""
    off = np.zeros(1 << w_, dtype=np.int64)
    for r in range(1 << w_):
        for s in range(w_):
            if (r >> (w_ - 1 - s)) & 1:
                off[r] ^= masks[s]
    return base[..., None] ^ off


def emulate_forward(angles, weights, n, layers):
    """The kernel's walk in float64 numpy, one block's shared memory at a
    time: SPB samples at swizzled physical indices, the first pass building
    the embedded state in registers, passes of ``span`` wires addressed
    through the swizzled ring masks, no data moved by the ring, then the
    logical-order epilogue. Returns (<Z>, re, im) with the state in logical
    order."""
    angles, weights = np.asarray(angles, np.float64), np.asarray(weights, np.float64)
    batch, dim = angles.shape[0], 1 << n
    w_, amps, gps, spb = _span(n), 1 << _span(n), _groups(n), _samples_per_block(n)
    raw = ring_source_masks(n, layers)
    masks = _swz(raw)
    half = 0.5 * weights
    cy, sy, cz, sz = np.cos(half[..., 0]), np.sin(half[..., 0]), np.cos(half[..., 1]), np.sin(half[..., 1])
    gi = np.arange(gps)
    ev = np.zeros((batch, n))
    re_out, im_out = np.zeros((batch, dim)), np.zeros((batch, dim))
    g_perm = sv.ring_cnot_perm(n)
    for s0 in range(0, batch, spb):
        valid = min(spb, batch - s0)
        a = np.zeros((spb, n))
        a[:valid] = angles[s0:s0 + valid]  # padding samples embed angle 0
        h = np.stack([np.cos(0.5 * a), np.sin(0.5 * a)], axis=-1)  # (spb, n, 2)
        base = _swz(np.arange(spb) * dim)[:, None]  # (spb, 1)
        pre = np.full(spb * dim, np.nan)
        pim = np.full(spb * dim, np.nan)
        for l in range(layers):
            col = masks[l]
            applied = []
            for p in range(_passes(n)):
                slots = [_slot_wire(n, p, s) for s in range(w_)]
                yb = np.broadcast_to(base, (spb, gps)).copy()
                for i, q in enumerate(_other_wires(n, p)):
                    yb ^= np.where((gi >> i) & 1, col[q], 0)
                idx = _members(yb, col[slots], w_)  # (spb, gps, amps)
                assert np.array_equal(np.sort(idx.ravel()), np.arange(spb * dim))  # groups tile the block
                if l == 0 and p == 0:
                    amp = np.ones((spb, gps, amps))
                    for i, q in enumerate(_other_wires(n, 0)):
                        amp *= h[:, q, :][:, (gi >> i) & 1][:, :, None]
                    r = np.arange(amps)
                    for s in range(w_):
                        amp *= h[:, slots[s], :][:, (r >> (w_ - 1 - s)) & 1][:, None, :]
                    ar, ai = amp, np.zeros_like(amp)
                else:
                    ar, ai = pre[idx], pim[idx]
                    assert not np.isnan(ar).any()
                for s in range(_active(n, p)):
                    q = slots[s]
                    applied.append(q)
                    bit = 1 << (w_ - 1 - s)
                    a0 = np.array([r for r in range(amps) if not r & bit])
                    a1 = a0 | bit
                    r0, i0, r1, i1 = ar[..., a0], ai[..., a0], ar[..., a1], ai[..., a1]
                    c, t = cy[l, q], sy[l, q]
                    br0, bi0, br1, bi1 = c * r0 - t * r1, c * i0 - t * i1, t * r0 + c * r1, t * i0 + c * i1
                    c, t = cz[l, q], sz[l, q]
                    ar, ai = ar.copy(), ai.copy()
                    ar[..., a0], ai[..., a0] = c * br0 + t * bi0, c * bi0 - t * br0
                    ar[..., a1], ai[..., a1] = c * br1 - t * bi1, c * bi1 + t * br1
                pre[idx], pim[idx] = ar, ai
            assert sorted(applied) == list(range(n))  # every wire once a layer
        # epilogue: logical x = (gi << W) | r at physical g^L(x), swizzled
        col = masks[layers]
        yb = np.broadcast_to(base, (spb, gps)).copy()
        for i in range(n - w_):
            yb ^= np.where((gi >> i) & 1, col[n - w_ - 1 - i], 0)
        idx = _members(yb, col[n - w_:], w_).reshape(spb, dim)
        x = np.arange(dim)
        gx = x.copy()
        for _ in range(layers):
            gx = g_perm[gx]
        assert np.array_equal(idx, _swz(np.arange(spb)[:, None] * dim + gx[None, :]))
        re, im = pre[idx][:valid], pim[idx][:valid]
        re_out[s0:s0 + valid], im_out[s0:s0 + valid] = re, im
        ev[s0:s0 + valid] = (re * re + im * im) @ sv.z_signs(n).astype(np.float64)
    return ev, re_out, im_out


@pytest.mark.parametrize("n", range(2, 13))
def test_ring_source_masks_are_powers_of_the_ring(n):
    """XOR of g^j(e_q) over the set bits of x is ``ring_cnot_perm`` applied j
    times to x, and the kernel's ring source map is that table: exact."""
    g = sv.ring_cnot_perm(n)
    masks = ring_source_masks(n, 4)
    x = np.arange(1 << n)
    gj = x.copy()
    for j in range(5):
        got = np.zeros_like(x)
        for q in range(n):
            got ^= np.where((x >> (n - 1 - q)) & 1, masks[j, q], 0)
        assert np.array_equal(got, gj)
        gj = g[gj]


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("n", range(2, 13))
def test_forward_emulation_matches_plain_and_jax(n, layers):
    """The emulated kernel against the plain version and the JAX package:
    <Z> and the final state (unit-norm amplitudes) within 1e-5 absolute and
    relative (fp32 rounding over 2nL gate updates in another wire order)."""
    rng = np.random.default_rng(100 + 10 * n + layers)
    batch = 5  # a ragged block at every n up to 8 (spb 2..32 samples)
    angles = rng.uniform(-1, 1, (batch, n)).astype(np.float32)
    weights = rng.uniform(-3, 3, (layers, n, 2)).astype(np.float32)
    ev, re, im = emulate_forward(angles, weights, n, layers)
    pev, pre, pim = tk.circuit_expvals_plain(torch.tensor(angles), torch.tensor(weights), n, layers)
    jev, jre, jim = jpk._circuit_forward(jnp.asarray(angles), jnp.asarray(weights), n, layers, False)
    jfused = jpk.fused_circuit_expvals(jnp.asarray(angles), jnp.asarray(weights), n, layers)
    for got, plain, jax_ref in ((ev, pev, jev), (re, pre, jre), (im, pim, jim)):
        np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jax_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ev, np.asarray(jfused), rtol=1e-5, atol=1e-5)
