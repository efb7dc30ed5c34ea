"""The rotation-layer kernel's design, checked on the CPU.

``csrc/rotation_layer.cu`` cannot run here, so its plan and addressing are
mirrored in Python and its walk is emulated in float32 numpy, then held
against the port's plain version and the JAX package's
``apply_rotation_layer`` (the Pallas kernel in interpret mode from n = 7,
its XLA twin below, as ``tests/test_pallas.py`` runs it): the tile bits by
n and batch, the passes through device memory and the bit map of each, the
sub-passes (tile bits 0 and 1 plus two high bits at the load and the store,
four bits between), the tile partition (each amplitude in exactly one tile a
pass), each wire applied exactly once with RY before RZ, the XOR swizzle of
the shared-memory index, and the 64-bit flat offsets.

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

# --- the plan, mirrored from csrc/rotation_layer.cu -------------------------

LOW_RUN = 4  # low bits a later pass carries
FILL_BLOCKS = 132  # SMs of an H100 SXM
MAX_MID = 5


def passes_at(n, tb):
    return 1 if n <= tb else 1 + -(-(n - tb) // (tb - LOW_RUN))


def tile_bits(batch, n):
    if n <= 10:
        return 10
    if n <= 12:
        return 12
    if n <= 14 and ((batch << n) >> 14) >= FILL_BLOCKS:
        return 14
    return 10 if passes_at(n, 10) <= passes_at(n, 12) else 12


def reg_bits(batch, n):
    """K: amplitudes a thread holds are 2^K; 2 below one tile an SM."""
    tb = tile_bits(batch, n)
    return 2 if -(-(batch << n) >> tb) < FILL_BLOCKS else 4


def cluster_bits(tb):
    return 2 if tb == 14 else 0


def local_bits(tb):
    return tb - cluster_bits(tb)


def _make_sub(bits, todo, wire_of_bit):
    """(bits, wires, todo after): the wire applied at each slot, or -1."""
    wires = []
    for b in bits:
        now = (todo >> b) & 1
        wires.append(wire_of_bit[b] if now else -1)
        if now:
            todo &= ~(1 << b)
    return list(bits), wires, todo


def _take_high(frm, used, top):
    for pool in (frm, ((1 << top) - 1) & ~3):
        for b in range(top - 1, 1, -1):
            if (pool >> b) & 1 and not (used >> b) & 1:
                return b, used | (1 << b)
    raise AssertionError("no bit left")


def bank_group_bit(b):
    return -1 if b < 2 else b if b < 5 else b - 3 if b < 8 else b - 6 if b < 11 else -1


def phase_free(u, v, lim):
    """An 8-lane phase of the store sub-pass over {0, 1, u, v} varies the
    three lowest other bits; free of bank conflicts when they land on
    distinct bank-group bits."""
    groups = [bank_group_bit(b) for b in range(2, lim) if b not in (u, v)][:3]
    return -1 not in groups and len(set(groups)) == len(groups)


def _store_bits(todo, lim):
    order = [b for b in range(lim - 1, 1, -1) if (todo >> b) & 1]
    order += [b for b in range(lim - 1, 1, -1) if not (todo >> b) & 1]
    for i in range(len(order)):
        for j in range(i + 1, len(order)):
            if phase_free(order[i], order[j], lim):
                return [order[i], order[j]]
    return order[:2]


def _plan_subs(todo, wire_of_bit, tb, lim, k_bits):
    """The sub-passes in the kernel's order: load, the middles, store."""
    used, first = 3, [0, 1]
    for _ in range(k_bits - 2):
        b, used = _take_high(todo, used, tb)
        first.append(b)
    first = _make_sub(first, todo, wire_of_bit)
    todo = first[2]
    if todo == 0:
        return [first]
    last_bits = [0, 1] + (_store_bits(todo, lim) if k_bits == 4 else [])

    def without_last(t):
        for b in last_bits[2:]:
            if (t >> b) & 1:
                t &= ~(1 << b)
        return t

    mids = []
    after = without_last(todo)
    while after:
        u, bits = 0, []
        for _ in range(k_bits):
            pick = next((x for x in range(lim - 1, -1, -1) if (after >> x) & 1 and not (u >> x) & 1), None)
            if pick is None:
                pick = next(x for x in range(lim - 1, -1, -1) if not (u >> x) & 1 and not (after >> x) & 1)
            bits.append(pick)
            u |= 1 << pick
        sub = _make_sub(bits, todo, wire_of_bit)
        todo = sub[2]
        mids.append(sub)
        after = without_last(todo)
    last = _make_sub(last_bits, todo, wire_of_bit)
    assert last[2] == 0
    assert len(mids) <= MAX_MID
    return [first, *mids, last]


def plan_pass(n, tb, k_bits, k):
    """(c, p, sub-passes): tile bits below c are flat bits 0..c-1, tile bits
    from c are flat bits p, p+1, ...; each sub-pass is (bits, wires, _)."""
    todo, wire_of_bit = 0, [-1] * tb
    if k == 0:
        c = p = tb
        for b in range(min(n, tb)):
            wire_of_bit[b] = n - 1 - b
            todo |= 1 << b
    else:
        span = tb - LOW_RUN
        done = tb + (k - 1) * span
        c, p = LOW_RUN, min(done, n - span)
        for b in range(tb):
            pos = b if b < LOW_RUN else p + b - LOW_RUN
            wire_of_bit[b] = n - 1 - pos
            if pos >= done:
                todo |= 1 << b
    return c, p, _plan_subs(todo, wire_of_bit, tb, local_bits(tb), k_bits)


def plan(batch, n):
    """(tile bits, register bits, [passes])."""
    tb, kb = tile_bits(batch, n), reg_bits(batch, n)
    return tb, kb, [plan_pass(n, tb, kb, k) for k in range(passes_at(n, tb))]


def swz(t):
    return t ^ ((((t >> 5) ^ (t >> 8)) & 7) << 2)


def spread(tid, bits):
    """Thread indices spread over the tile bits outside ``bits`` (a zero
    inserted at each, lowest first)."""
    x = np.asarray(tid, dtype=np.int64)
    for b in sorted(bits):
        x = ((x >> b) << (b + 1)) | (x & ((1 << b) - 1))
    return x


def members(base, bits):
    """(threads, 2^K) tile indices: member m's bit k at tile bit bits[k]."""
    m = np.arange(1 << len(bits))
    off = np.zeros_like(m)
    for k, b in enumerate(bits):
        off |= ((m >> k) & 1) << b
    return base[:, None] | off[None, :]


def flat_in_tile(t, c, p):
    t = np.asarray(t, dtype=np.int64)
    return (t & ((1 << c) - 1)) | ((t >> c) << p)


def tile_bases(tiles, c, p, tb):
    tile = np.asarray(tiles, dtype=np.int64)
    return ((tile & ((1 << (p - c)) - 1)) << c) | ((tile >> (p - c)) << (p + tb - c))


def sub_threads(tb, k_bits, j):
    """Tile indices' thread bases of sub-pass j: the load spans the whole
    tile (a cluster's threads, rank-major); every later sub-pass one block's
    2^local_bits, with the rank in the bits above."""
    lb = local_bits(tb)
    if j == 0:
        return [np.arange(1 << (tb - k_bits))]
    return [np.arange(1 << (lb - k_bits)) + (r << (lb - k_bits)) for r in range(1 << cluster_bits(tb))]


# --- the walk, emulated ------------------------------------------------------


def _apply(ar, ai, wires, cs, log, rz_first=False):
    """The kernel's ``apply``: per slot k with a wire, RY then RZ on each
    member pair across bit k, in float32."""
    for k, w in enumerate(wires):
        if w < 0:
            continue
        log.append(w)
        cy, sy, cz, sz = (np.float32(x) for x in cs[w])
        a0 = np.array([m for m in range(ar.shape[-1]) if not m & (1 << k)])
        a1 = a0 | (1 << k)
        r0, i0, r1, i1 = ar[..., a0], ai[..., a0], ar[..., a1], ai[..., a1]
        if rz_first:  # the wrong order, kept to show the check can fail
            r0, i0, r1, i1 = cz * r0 + sz * i0, cz * i0 - sz * r0, cz * r1 - sz * i1, cz * i1 + sz * r1
            ar[..., a0], ai[..., a0] = cy * r0 - sy * r1, cy * i0 - sy * i1
            ar[..., a1], ai[..., a1] = sy * r0 + cy * r1, sy * i0 + cy * i1
            continue
        br0, bi0 = cy * r0 - sy * r1, cy * i0 - sy * i1
        br1, bi1 = sy * r0 + cy * r1, sy * i0 + cy * i1
        ar[..., a0], ai[..., a0] = cz * br0 + sz * bi0, cz * bi0 - sz * br0
        ar[..., a1], ai[..., a1] = cz * br1 - sz * bi1, cz * bi1 + sz * br1


def emulate(re, im, weights_l, n, rz_first=False):
    """The kernel's passes over the flat state in float32 numpy: per pass the
    tiles' flat offsets, sub-pass 0 from device memory into registers, each
    group written to the shared memory of the block (cluster rank) that
    holds it at its swizzled index, the middle sub-passes and the store
    sub-pass per block (later passes update ``out`` in place). Returns (re,
    im, the wires applied in order)."""
    batch = re.shape[0]
    total = batch << n
    half = 0.5 * np.asarray(weights_l, np.float32)
    cs = np.stack([np.cos(half[:, 0]), np.sin(half[:, 0]), np.cos(half[:, 1]), np.sin(half[:, 1])], -1)
    cs = cs.astype(np.float32)
    tb, kb, passes = plan(batch, n)
    lb, ranks = local_bits(tb), 1 << cluster_bits(tb)
    src_re, src_im = re.reshape(-1).astype(np.float32), im.reshape(-1).astype(np.float32)
    out_re, out_im = np.full(total, np.nan, np.float32), np.full(total, np.nan, np.float32)
    log = []
    for c, p, subs in passes:
        tiles = np.arange(-(-total >> tb))
        tbase = tile_bases(tiles, c, p, tb)[:, None, None]  # (tiles, 1, 1)
        bits, wires, _ = subs[0]
        idx = members(spread(sub_threads(tb, kb, 0)[0], bits), bits)  # (threads, 2^K)
        g = tbase + flat_in_tile(idx, c, p)[None]
        ok = g < total
        gs = np.where(ok, g, 0)
        ar = np.where(ok, src_re[gs], np.float32(0))
        ai = np.where(ok, src_im[gs], np.float32(0))
        _apply(ar, ai, wires, cs, log, rz_first)
        if len(subs) == 1:
            out_re[g[ok]], out_im[g[ok]] = ar[ok], ai[ok]
        else:
            sre = np.full((tiles.size, ranks, 1 << lb), np.nan, np.float32)
            sim = np.full((tiles.size, ranks, 1 << lb), np.nan, np.float32)
            rank, local = idx >> lb, swz(idx & ((1 << lb) - 1))
            sre[:, rank, local], sim[:, rank, local] = ar, ai
            for j in range(1, len(subs) + 1):
                if j == len(subs):
                    bits, wires, _ = subs[-1]  # the store sub-pass
                elif j < len(subs) - 1:
                    bits, wires, _ = subs[j]
                else:
                    continue
                for r, threads in enumerate(sub_threads(tb, kb, 1)):
                    idx = members(spread(threads - (r << (lb - kb)), bits), bits)
                    assert (idx >> lb == 0).all()  # every access local to the block
                    ar, ai = sre[:, r, swz(idx)], sim[:, r, swz(idx)]
                    assert not np.isnan(ar).any()
                    _apply(ar, ai, wires, cs, log if r == 0 else [], rz_first)  # each block the same wires
                    if j < len(subs):
                        sre[:, r, swz(idx)], sim[:, r, swz(idx)] = ar, ai
                    else:
                        g = tbase + flat_in_tile(idx | (r << lb), c, p)[None]
                        ok = g < total
                        out_re[g[ok]], out_im[g[ok]] = ar[ok], ai[ok]
        src_re, src_im = out_re, out_im  # later passes: `out` in place
    assert not np.isnan(out_re).any()
    return out_re.reshape(batch, -1), out_im.reshape(batch, -1), log


def _states(rng, batch, n):
    re = rng.standard_normal((batch, 1 << n)).astype(np.float32)
    im = rng.standard_normal((batch, 1 << n)).astype(np.float32)
    return re, im


# shapes that reach every (tile bits, register bits) the launcher has, and
# one to three passes
PLAN_SHAPES = [(1, 5), (3, 7), (8, 1), (8, 9), (8, 2304), (10, 3), (12, 2), (12, 64), (13, 1), (13, 264),
               (14, 2), (14, 64), (14, 132), (16, 3), (17, 1), (20, 1), (21, 1)]


# --- the tests -----------------------------------------------------------------


def test_plan_follows_the_kernel_choices():
    """The plan the kernel header states: one pass through n = 12, and at
    n = 13, 14 once every SM gets a 2^14 tile (a cluster of four 2^12
    blocks); tiles of 2^10 wherever they need no more passes than 2^12 (two
    passes at n = 13..16), two passes of 2^12 at n = 17..20; register bits
    2 below one tile an SM, else 4."""
    assert [tile_bits(2304, n) for n in (1, 8, 10, 11, 12)] == [10, 10, 10, 12, 12]
    assert (tile_bits(2304, 14), passes_at(14, 14), cluster_bits(14)) == (14, 1, 2)
    assert (tile_bits(264, 13), tile_bits(263, 13), tile_bits(64, 13)) == (14, 10, 10)
    assert (tile_bits(1, 14), passes_at(14, 10), tile_bits(64, 14)) == (10, 2, 10)
    assert (tile_bits(1, 16), tile_bits(64, 16), tile_bits(1, 20), tile_bits(1, 21)) == (10, 10, 12, 10)
    assert (passes_at(20, 12), passes_at(21, 10), passes_at(21, 12)) == (2, 3, 3)
    assert [reg_bits(b, 8) for b in (1, 64, 524, 525, 2304)] == [2, 2, 2, 4, 4]
    assert (reg_bits(1, 14), reg_bits(64, 14), reg_bits(1, 20), reg_bits(2304, 14)) == (2, 4, 4, 4)


@pytest.mark.parametrize("n", range(1, 25))
def test_each_wire_once_and_load_store_bits(n):
    """Over all passes every wire is applied exactly once; each sub-pass
    holds K distinct tile bits, the load and store ones tile bits 0 and 1,
    and only the load bits at or above a block's own (a cluster's rank
    bits); a later pass's window ends at or below n."""
    for batch in (1, 3, 64, 2304):
        tb, kb, passes = plan(batch, n)
        applied = []
        for k, (c, p, subs) in enumerate(passes):
            assert 1 <= len(subs) <= 2 + MAX_MID
            if k:
                assert c == LOW_RUN and LOW_RUN <= p and p + tb - c <= n
            for j, (bits, wires, _) in enumerate(subs):
                assert len(set(bits)) == kb and all(0 <= b < tb for b in bits)
                if j:
                    assert all(b < local_bits(tb) for b in bits)
                if j in (0, len(subs) - 1):
                    assert bits[:2] == [0, 1]
                applied += [w for w in wires if w >= 0]
        assert sorted(applied) == list(range(n))


@pytest.mark.parametrize("n,batch", PLAN_SHAPES)
def test_tile_partition(n, batch):
    """Each pass's tiles cover every flat amplitude exactly once (the ragged
    last tile of pass 0 only past the end); the load sub-pass's threads
    cover every index of a tile once, each later sub-pass's threads every
    index of their block's part once."""
    total = batch << n
    tb, kb, passes = plan(batch, n)
    lb = local_bits(tb)
    for c, p, subs in passes:
        tiles = np.arange(-(-total >> tb))
        flats = (tile_bases(tiles, c, p, tb)[:, None] + flat_in_tile(np.arange(1 << tb), c, p)[None]).ravel()
        inside = np.sort(flats[flats < total])
        assert np.array_equal(inside, np.arange(total))
        assert (flats >= total).sum() == tiles.size * (1 << tb) - total
        for j, (bits, _, _) in enumerate(subs):
            if j == 0:
                idx = members(spread(sub_threads(tb, kb, 0)[0], bits), bits)
                assert np.array_equal(np.sort(idx.ravel()), np.arange(1 << tb))
            else:
                idx = members(spread(np.arange(1 << (lb - kb)), bits), bits)
                assert np.array_equal(np.sort(idx.ravel()), np.arange(1 << lb))


@pytest.mark.parametrize("n,batch", PLAN_SHAPES)
def test_swizzle_keeps_groups_and_spreads_banks(n, batch):
    """The swizzle is a bijection of a block's part that keeps bits 0 and 1
    (16-byte groups stay whole and aligned); the store sub-pass's 16-byte
    reads, and the load sub-pass's writes where the block keeps its tile,
    are free of bank conflicts (each 8-lane phase covers 32 banks); the
    middle sub-passes' 4-byte accesses meet at most 2 a bank."""
    tb, kb, passes = plan(batch, n)
    lb = local_bits(tb)
    t = np.arange(1 << lb)
    assert np.array_equal(np.sort(swz(t)), t) and np.array_equal(swz(t) & 3, t & 3)
    for _, _, subs in passes:
        for j, (bits, _, _) in enumerate(subs):
            if j == 0 and cluster_bits(tb):
                continue  # written into four blocks' shared memory
            base = spread(np.arange(1 << (lb - kb)), bits)
            if j in (0, len(subs) - 1):
                for g in range(1 << (kb - 2)):  # the 16-byte groups a thread moves
                    groups = base.copy()
                    for k in range(2, kb):
                        groups |= ((g >> (k - 2)) & 1) << bits[k]
                    for phase in range(0, base.size, 8):
                        banks = (swz(groups[phase:phase + 8])[:, None] + np.arange(4)) % 32
                        assert len(set(banks.ravel())) == 32
            else:
                idx = swz(members(base, bits))
                for warp in range(0, base.size, 32):
                    for m in range(idx.shape[1]):
                        assert np.bincount(idx[warp:warp + 32, m] % 32, minlength=32).max() <= 2


@pytest.mark.parametrize("n,batch", [(8, 2304), (8, 1), (14, 2304), (14, 1), (16, 64), (21, 1)])
def test_precomputed_masks_give_every_address(n, batch):
    """The swizzle and the tile-to-flat map are XOR-linear, so the kernel
    addresses a member as its thread's swizzled (or flat) base XOR the
    per-slot masks the host precomputes, swz(1 << bit) and flat(1 << bit):
    the same addresses as swizzling or mapping each member index, exactly."""
    tb, kb, passes = plan(batch, n)
    lb = local_bits(tb)
    rng = np.random.default_rng(n)
    a, b = rng.integers(0, 1 << tb, 1000), rng.integers(0, 1 << tb, 1000)
    assert np.array_equal(swz(a ^ b), swz(a) ^ swz(b))
    for c, p, subs in passes:
        assert np.array_equal(flat_in_tile(a ^ b, c, p), flat_in_tile(a, c, p) ^ flat_in_tile(b, c, p))
        for j, (bits, _, _) in enumerate(subs):
            base = spread(sub_threads(tb, kb, 0)[0] if j == 0 else np.arange(1 << (lb - kb)), bits)
            idx = members(base, bits)
            gstep = [int(flat_in_tile(1 << x, c, p)) for x in bits]
            via_g = np.repeat(flat_in_tile(base, c, p)[:, None], 1 << kb, 1)
            for m in range(1 << kb):
                for slot in range(kb):
                    if (m >> slot) & 1:
                        via_g[:, m] += gstep[slot]  # disjoint bits: + is XOR
            assert np.array_equal(via_g, flat_in_tile(idx, c, p))
            if j:  # local to a block: the swizzled masks
                via_s = np.repeat(swz(base)[:, None], 1 << kb, 1)
                for m in range(1 << kb):
                    for slot in range(kb):
                        if (m >> slot) & 1:
                            via_s[:, m] ^= swz(1 << bits[slot])
                assert np.array_equal(via_s, swz(idx))


def test_offsets_need_64_bits():
    """At n = 20, B = 2048 the state holds 2^31 amplitudes, a count an int32
    cannot hold; at B = 4096 the last tiles' flat offsets pass 2^31 - 1 in
    every pass, so an int32 offset would wrap before the array; int64 keeps
    them, and B * 2^n stays below 2^63 for every int32 batch up to n = 32
    (the wrapper's window)."""
    n = 20
    assert (2048 << n) == 2**31
    batch = 4096
    total = batch << n
    tb, _, passes = plan(batch, n)
    for c, p, _ in passes:
        last = tile_bases(np.array([(total >> tb) - 1]), c, p, tb)[0] + flat_in_tile((1 << tb) - 1, c, p)
        assert last == total - 1 > 2**31 - 1
        wrapped = (last + 2**31) % 2**32 - 2**31
        assert wrapped < 0  # an int32 offset would point before the array
    assert ((2**31 - 1) << tk.ROTATION_MAX_QUBITS) < 2**63
    assert tk.ROTATION_MAX_QUBITS == 32


def _tol(n, amax):
    """2e-6 of the largest amplitude through n = 14 (the kernel's check
    since it was ported); from n = 15, 8 n unit roundoffs (2^-24) of it: 2n
    rotations, each rounding a two-term sum twice, in two implementations."""
    return (2e-6 if n <= 14 else 8 * n * 2.0**-24) * amax


def _check_emulation(n, batch, seed):
    rng = np.random.default_rng(seed)
    re, im = _states(rng, batch, n)
    w = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    got_re, got_im, log = emulate(re, im, w, n)
    assert sorted(log) == list(range(n))
    want = tk.rotation_layer_plain(torch.tensor(re), torch.tensor(im), torch.tensor(w), n)
    tol = _tol(n, max(want.re.abs().max().item(), want.im.abs().max().item()))
    np.testing.assert_allclose(got_re, want.re.numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got_im, want.im.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("n", range(1, 21))
def test_emulation_matches_plain(n):
    """The emulated kernel against the plain version, every n to 20, with a
    ragged batch at small n; the wires applied each exactly once."""
    _check_emulation(n, 3 if n <= 12 else 2 if n <= 16 else 1, 200 + n)


@pytest.mark.parametrize("n,batch", [(8, 600), (12, 200), (13, 264), (14, 132), (14, 64)])
def test_emulation_matches_plain_on_wide_plans(n, batch):
    """The plans of many tiles: four register bits, the 2^12 tile, and the
    2^14 tile over a cluster of four blocks (n = 13, 14 at batches that
    fill every SM)."""
    assert reg_bits(batch, n) == 4
    _check_emulation(n, batch, 300 + n)


@pytest.mark.parametrize("n", [3, 8, 15])
def test_rz_before_ry_is_caught(n):
    """The same emulation with RZ applied before RY on each wire misses the
    plain version by far more than the tolerance: the check has teeth."""
    rng = np.random.default_rng(400 + n)
    re, im = _states(rng, 2, n)
    w = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    bad_re, _, _ = emulate(re, im, w, n, rz_first=True)
    want = tk.rotation_layer_plain(torch.tensor(re), torch.tensor(im), torch.tensor(w), n)
    assert np.abs(bad_re - want.re.numpy()).max() > 1e3 * _tol(n, want.re.abs().max().item())


@pytest.mark.parametrize("n", [7, 8, 15, 16])
def test_emulation_matches_jax(n):
    """The emulated kernel against JAX's ``apply_rotation_layer`` (its Pallas
    kernel in interpret mode, which has no upper cap) on unit-norm states:
    the tolerance of the plain comparison."""
    rng = np.random.default_rng(500 + n)
    re, im = _states(rng, 2, n)
    norm = np.sqrt((re**2 + im**2).sum(-1, keepdims=True))
    re, im = re / norm, im / norm
    w = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    got_re, got_im, _ = emulate(re, im, w, n)
    out = jpk.apply_rotation_layer(JCArr(jnp.asarray(re), jnp.asarray(im)), jnp.asarray(w), n)
    j_re, j_im = np.asarray(out.re), np.asarray(out.im)
    tol = _tol(n, max(np.abs(j_re).max(), np.abs(j_im).max()))
    np.testing.assert_allclose(got_re, j_re, rtol=0, atol=tol)
    np.testing.assert_allclose(got_im, j_im, rtol=0, atol=tol)
