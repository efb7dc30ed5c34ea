"""The designs of the port's CUDA kernels, checked on the CPU.

``csrc/circuit_adjoint.cu`` rests on two facts and one addressing scheme,
each checked here without a card:

- within a layer the gates on different wires commute, so the wires of a
  layer may be undone in any order (:func:`adjoint_in_wire_order`) and two
  or three at a time;
- the ring of CNOTs is XOR-linear on the index bits, so after j rings are
  undone logical index x lives at the XOR of f^j(e_q) over its set bits
  (the table :func:`ring_index_masks` builds, as the kernel does);
- a numpy emulation of the kernel's passes (its slot wires, group
  enumeration, offsets and swizzled shared-memory index) reproduces
  ``circuit_adjoint_plain``.

Inputs come from a numpy seed; tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu_torch.quantum import kernels as tk  # noqa: E402
from qdml_tpu_torch.quantum import statevector as sv  # noqa: E402


def ring_index_masks(n: int, layers: int) -> np.ndarray:
    """(layers + 1, n): entry [j, q] is f^j(e_q), with f the ring's index map
    (psi'[f(x)] = psi[x], the inverse of ``ring_cnot_perm``'s source table)
    and e_q wire q's basis bit (qubit 0 the MSB)."""
    f = np.argsort(sv.ring_cnot_perm(n))
    v = 1 << (n - 1 - np.arange(n))
    out = np.empty((layers + 1, n), dtype=np.int64)
    for j in range(layers + 1):
        out[j] = v
        v = f[v]
    return out


def _xor_of_masks(masks: np.ndarray, n: int) -> np.ndarray:
    """For every x in 0..2^n-1, the XOR of masks[q] over the set bits of x."""
    x = np.arange(1 << n)
    out = np.zeros_like(x)
    for q in range(n):
        out ^= np.where((x >> (n - 1 - q)) & 1, masks[q], 0)
    return out


# --- the kernel's pass plan, mirrored from csrc/circuit_adjoint.cu ----------


def _span(n):
    return min(2, n) if n < 7 else 3


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


def _swz(t):
    return t ^ ((t >> 5) & 31)


def emulate_adjoint(fre, fim, g, angles, weights, n, layers):
    """The kernel's walk in float64 numpy, one sample's shared memory at a
    time: psi and lambda at swizzled physical indices, passes of two or three
    wires addressed through the swizzled ring masks, RZ's cotangent summed
    elementwise from each pass's starting state, the embedding cotangent read
    through f^L."""
    fre, fim, g, angles, weights = (np.asarray(t, dtype=np.float64) for t in (fre, fim, g, angles, weights))
    batch, dim = fre.shape
    w_ = _span(n)
    amps = 1 << w_
    masks = _swz(ring_index_masks(n, layers))
    half = 0.5 * weights
    cy, sy, cz, sz = np.cos(half[..., 0]), np.sin(half[..., 0]), np.cos(half[..., 1]), np.sin(half[..., 1])
    dprobs = g @ sv.z_signs(n).astype(np.float64).T
    dweights = np.zeros((layers, n, 2))
    lam_logical = np.zeros((batch, dim))
    phys = _swz(np.arange(dim))
    for b in range(batch):
        psi = [np.empty(dim), np.empty(dim)]
        lam = [np.empty(dim), np.empty(dim)]
        psi[0][phys], psi[1][phys] = fre[b], fim[b]
        lam[0][phys], lam[1][phys] = 2 * fre[b] * dprobs[b], 2 * fim[b] * dprobs[b]
        for l in reversed(range(layers)):
            col = masks[layers - l]
            seen = []
            for p in range(_passes(n)):
                off = np.zeros(amps, dtype=np.int64)
                for r in range(amps):
                    for s in range(w_):
                        if (r >> (w_ - 1 - s)) & 1:
                            off[r] ^= col[_slot_wire(n, p, s)]
                gi = np.arange(1 << (n - w_))
                yb = np.zeros_like(gi)
                for i, q in enumerate(_other_wires(n, p)):
                    yb ^= np.where((gi >> i) & 1, col[q], 0)
                idx = yb[:, None] ^ off[None, :]  # (groups, amps)
                assert len(np.unique(idx)) == dim  # the groups tile the state
                ar, ai = psi[0][idx], psi[1][idx]
                br, bi = lam[0][idx], lam[1][idx]
                # RZ's cotangent from the pass's starting state, elementwise
                m = (br * ai - bi * ar).sum(0)  # (amps,)
                for s in range(_active(n, p)):
                    sign = 1 - 2 * ((np.arange(amps) >> (w_ - 1 - s)) & 1)
                    dweights[l, _slot_wire(n, p, s), 1] += 0.5 * (sign * m).sum()
                for s in range(_active(n, p)):
                    q = _slot_wire(n, p, s)
                    seen.append(q)
                    bit = 1 << (w_ - 1 - s)
                    a0 = np.array([r for r in range(amps) if not r & bit])
                    a1 = a0 | bit
                    r0, i0, r1, i1 = ar[:, a0], ai[:, a0], ar[:, a1], ai[:, a1]
                    x0, y0, x1, y1 = br[:, a0], bi[:, a0], br[:, a1], bi[:, a1]
                    c, t = cz[l, q], sz[l, q]
                    r0, i0 = c * r0 - t * i0, c * i0 + t * r0
                    r1, i1 = c * r1 + t * i1, c * i1 - t * r1
                    x0, y0 = c * x0 - t * y0, c * y0 + t * x0
                    x1, y1 = c * x1 + t * y1, c * y1 - t * x1
                    dweights[l, q, 0] += 0.5 * ((x1 * r0 - x0 * r1) + (y1 * i0 - y0 * i1)).sum()
                    c, t = cy[l, q], sy[l, q]
                    ar[:, a0], ar[:, a1] = c * r0 + t * r1, c * r1 - t * r0
                    ai[:, a0], ai[:, a1] = c * i0 + t * i1, c * i1 - t * i0
                    br[:, a0], br[:, a1] = c * x0 + t * x1, c * x1 - t * x0
                    bi[:, a0], bi[:, a1] = c * y0 + t * y1, c * y1 - t * y0
                psi[0][idx], psi[1][idx] = ar, ai
                lam[0][idx], lam[1][idx] = br, bi
            assert sorted(seen) == list(range(n))  # every wire undone once a layer
        lam_logical[b] = lam[0][_xor_of_masks(masks[layers], n)]
    factors = np.stack([np.cos(0.5 * angles), np.sin(0.5 * angles)], axis=-1)  # (B, n, 2)
    bits = (np.arange(dim)[:, None] >> (n - 1 - np.arange(n))[None, :]) & 1  # (dim, n)
    dangles = np.zeros((batch, n))
    for q in range(n):
        dq = factors.copy()
        dq[:, q] = np.stack([-0.5 * factors[:, q, 1], 0.5 * factors[:, q, 0]], axis=-1)
        amp = np.prod(np.take_along_axis(dq[:, None, :, :], bits[None, :, :, None], axis=-1)[..., 0], axis=-1)
        dangles[:, q] = (lam_logical * amp).sum(-1)
    return dangles, dweights


def adjoint_in_wire_order(fre, fim, g, angles, weights, n, layers, order):
    """``circuit_adjoint_plain`` with each layer's wires undone in ``order``
    (the reference undoes them n-1 .. 0, as the kernel's passes do)."""
    psi = sv.CArr(fre, fim)
    dprobs = g @ torch.as_tensor(sv.z_signs(n)).T
    lam = sv.CArr(2.0 * fre * dprobs, 2.0 * fim * dprobs)
    inv_ring = np.argsort(sv.ring_cnot_perm(n))
    cs = tk.circuit_gate_table(weights)
    dweights = torch.zeros((layers, n, 2))
    for l in reversed(range(layers)):
        psi, lam = sv.apply_perm(psi, inv_ring), sv.apply_perm(lam, inv_ring)
        for q in order:
            cy, sy, cz, sz = cs[l, q]
            (r0, r1), (i0, i1) = tk._halves(psi.re, n, q), tk._halves(psi.im, n, q)
            (x0, x1), (y0, y1) = tk._halves(lam.re, n, q), tk._halves(lam.im, n, q)
            dweights[l, q, 1] = 0.5 * ((x0 * i0 - y0 * r0) + (y1 * r1 - x1 * i1)).sum()
            psi, lam = sv.apply_rz_cs(psi, n, q, cz, -sz), sv.apply_rz_cs(lam, n, q, cz, -sz)
            (r0, r1), (i0, i1) = tk._halves(psi.re, n, q), tk._halves(psi.im, n, q)
            (x0, x1), (y0, y1) = tk._halves(lam.re, n, q), tk._halves(lam.im, n, q)
            dweights[l, q, 0] = 0.5 * ((x1 * r0 - x0 * r1) + (y1 * i0 - y0 * i1)).sum()
            psi, lam = sv.apply_ry_cs(psi, n, q, cy, -sy), sv.apply_ry_cs(lam, n, q, cy, -sy)
    # the embedding cotangent reads lambda's real part after the last layer
    half = 0.5 * angles
    factors = torch.stack([torch.cos(half), torch.sin(half)], dim=-1)
    dangles = []
    for q in range(n):
        dq = factors.clone()
        dq[:, q] = torch.stack([-0.5 * factors[:, q, 1], 0.5 * factors[:, q, 0]], dim=-1)
        dangles.append((lam.re * tk._product_state(dq)).sum(-1))
    return torch.stack(dangles, dim=-1), dweights


def _inputs(n, layers, batch, seed):
    rng = np.random.default_rng(seed)
    angles = torch.tensor(rng.uniform(-1, 1, (batch, n)), dtype=torch.float32)
    weights = torch.tensor(rng.uniform(-3, 3, (layers, n, 2)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((batch, n)), dtype=torch.float32)
    _, fre, fim = tk.circuit_expvals_plain(angles, weights, n, layers)
    return fre, fim, g, angles, weights


@pytest.mark.parametrize("n", range(2, 13))
def test_ring_index_masks_agree_with_ring_perm_and_its_inverse(n):
    """XOR of f^j(e_q) over the set bits of x is the ring applied j times to
    x; ``ring_cnot_perm`` (the source table, f^-1) applied j times takes it
    back to x. Exact integer equality."""
    src = sv.ring_cnot_perm(n)
    f = np.argsort(src)
    masks = ring_index_masks(n, 4)
    x = np.arange(1 << n)
    fj = x.copy()
    for j in range(5):
        assert np.array_equal(_xor_of_masks(masks[j], n), fj)
        back = _xor_of_masks(masks[j], n)
        for _ in range(j):
            back = src[back]
        assert np.array_equal(back, x)
        fj = f[fj]
    # the swizzle the kernel stores masks in is XOR-linear and a bijection
    assert np.array_equal(_swz(x ^ 77), _swz(x) ^ _swz(np.full_like(x, 77)))
    assert len(np.unique(_swz(x))) == len(x)


@pytest.mark.parametrize(
    "n,layers,order",
    [(3, 2, [0, 1, 2]), (5, 3, [2, 4, 0, 3, 1]), (8, 2, [5, 6, 7, 2, 3, 4, 0, 1]), (8, 3, list(range(8)))],
)
def test_adjoint_plain_wire_order_gives_the_same_gradient(n, layers, order):
    """Undoing a layer's wires in another order changes only fp32 rounding:
    atol 1e-5 of the largest entry. The default order n-1 .. 0 reproduces the
    reference exactly."""
    args = _inputs(n, layers, batch=6, seed=40 + n)
    da, dw = tk.circuit_adjoint_plain(*args, n, layers)
    da2, dw2 = adjoint_in_wire_order(*args, n, layers, order)
    torch.testing.assert_close(dw2, dw, rtol=0, atol=1e-5 * dw.abs().max().item())
    torch.testing.assert_close(da2, da, rtol=0, atol=1e-5 * da.abs().max().item())
    da3, dw3 = adjoint_in_wire_order(*args, n, layers, list(reversed(range(n))))
    assert torch.equal(dw3, dw) and torch.equal(da3, da)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("n", range(2, 8))
def test_kernel_addressing_emulation_matches_plain_adjoint(n, layers):
    """The kernel's passes emulated in float64 against the float32 plain
    version: atol 2e-5 of the largest cotangent plus 1e-6, the kernel's own
    tolerance on the card."""
    fre, fim, g, angles, weights = _inputs(n, layers, batch=5, seed=50 + 10 * n + layers)
    da, dw = emulate_adjoint(fre, fim, g, angles, weights, n, layers)
    pa, pw = tk.circuit_adjoint_plain(fre, fim, g, angles, weights, n, layers)
    for got, want in ((da, pa), (dw, pw)):
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=2e-5 * want.abs().max().item() + 1e-6)


@pytest.mark.parametrize("n,offset", [(1, 1), (2, 2), (6, 1), (8, 3)])
def test_qsc_launch_rejects_misaligned_u_before_loading(monkeypatch, n, offset):
    """The QSC kernel copies U with 16-byte ``cp.async`` (8-byte at n = 1): a
    contiguous view of U that starts ``offset`` floats into its storage is
    refused before the library is touched; at n = 1 two floats in is enough."""
    monkeypatch.setattr(tk, "_load", lambda name: pytest.fail("reached the loader"))
    dim = 1 << n
    a = torch.zeros(3, n)
    u = torch.zeros(dim * dim)
    shifted = torch.zeros(dim * dim + offset)[offset:].view(dim, dim)
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="byte boundary"):
        tk._qsc_launch(a, shifted, u.view(dim, dim), n)
    with pytest.raises(ValueError, match="byte boundary"):
        tk._qsc_launch(a, u.view(dim, dim), shifted, n)
    if n == 1:  # 8 bytes in passes the check and reaches the loader
        ok = torch.zeros(dim * dim + 2)[2:].view(dim, dim)
        with pytest.raises(pytest.fail.Exception, match="reached the loader"):
            tk._qsc_launch(a, ok, ok, n)


def test_occupancy_query_validates_before_loading(monkeypatch):
    monkeypatch.setattr(tk, "_load", lambda name: pytest.fail("reached the loader"))
    for n, layers in ((1, 3), (13, 3), (8, 0)):
        with pytest.raises(ValueError, match="circuit kernels take"):
            tk.circuit_adjoint_occupancy(n, layers)



def _bank_degree(n, layers, swizzle):
    """Mean over passes and members of the worst bank's distinct addresses in
    one warp's load at n <= 8, where a warp holds 32 / 2^(n - span) samples
    (``csrc/circuit_adjoint.cu``'s layout, sample s at s * 2^n)."""
    w_ = _span(n)
    groups = 1 << (n - w_)
    masks = ring_index_masks(n, layers)
    if swizzle:
        masks = _swz(masks)
    lanes = np.arange(32)
    sample, gi = lanes // groups, lanes % groups
    degrees = []
    for j in range(1, layers + 1):
        col = masks[j]
        for p in range(_passes(n)):
            yb = _swz(sample << n) if swizzle else sample << n
            for i, q in enumerate(_other_wires(n, p)):
                yb = yb ^ np.where((gi >> i) & 1, col[q], 0)
            for r in range(1 << w_):
                a = yb.copy()
                for s in range(w_):
                    if (r >> (w_ - 1 - s)) & 1:
                        a ^= col[_slot_wire(n, p, s)]
                degrees.append(max(len(set(a[a % 32 == b])) for b in range(32)))
    return float(np.mean(degrees))


def test_swizzle_spreads_a_warps_loads_over_the_banks():
    """At the trained width (n = 8, L = 3) the XOR swizzle leaves about one
    address a bank per warp load (the note in csrc/circuit_adjoint.cu), where
    the plain index puts several on one bank; it is never worse at n = 5..8."""
    assert _bank_degree(8, 3, swizzle=True) <= 1.3
    assert _bank_degree(8, 3, swizzle=False) >= 3.0
    for n in range(5, 9):
        assert _bank_degree(n, 3, swizzle=True) <= _bank_degree(n, 3, swizzle=False)
