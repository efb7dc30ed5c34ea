// One rotation layer of the ansatz on a batch of states: RY(w[q,0]) then
// RZ(w[q,1]) on every wire q = 0 .. n-1.
//
// Replaces the TPU kernel `_layer_kernel_body` (qdml_tpu/quantum/pallas_kernels.py),
// reached through `apply_rotation_layer` -> `_rotation_layer_pallas`. Per
// sample, with qubit 0 the most significant bit, wire q sits at index bit
// position n-1-q, and for each pair (a0 with that bit 0, a1 with it 1):
//   RY(t) = [c, -s; s, c] on (a0, a1), c = cos(t/2), s = sin(t/2) (real);
//   RZ(p) multiplies a0 by e^{-ip/2} and a1 by e^{+ip/2}.
// Gates on different wires commute, so the wires may be taken in any order
// and grouping; on each wire RY comes before RZ.
//
// What bounds it on an H100: each amplitude is read once and written once
// (16 bytes of re+im per amplitude, in and out) and takes about 12 flops per
// wire, so the memory rate bounds it: 2.8 us at n = 8, B = 2304 (9.4 MB),
// 180 us at n = 14, B = 2304 (604 MB), at 3.35 TB/s.
//
// What the first design lost: one shared-memory pass per wire, each ended by
// a block barrier (n barriers a sample), 4-byte loads with nothing in flight
// while a block computed, one block an SM at n = 13, 14 (one sample of 64-128
// KB in shared memory), B blocks at small B (B = 1 at n = 14 ran on one SM),
// and 32-bit indices that capped n at 14. This design:
//   - the flat (B * 2^n) amplitude array is cut into tiles of 2^TB amplitudes
//     (TB = 10, 12 or 14); a tile's bits are TB bits of the flat index;
//   - a thread holds 2^K amplitudes spanning K of the tile's bits in
//     registers and applies the wires of those bits there, RY then RZ each
//     (K = 4, or K = 2 when the call has fewer tiles than SMs: four times
//     the threads, a quarter of the serial work each, for latency). A tile
//     takes a few such sub-passes, with an XOR-swizzled shared-memory
//     exchange and one barrier between them, in place of one barrier a wire;
//   - the first sub-pass holds tile bits 0 and 1 and K - 2 high bits, so it
//     loads straight from device memory into registers by 16-byte loads (a
//     warp reads 512 contiguous bytes, or 64-byte runs in a later pass), and
//     applies its wires before the first barrier; the last sub-pass holds
//     bits 0 and 1 again and stores from registers by 16-byte stores. When
//     the first sub-pass applies every wire of the tile (n <= 4) the tile
//     never touches shared memory;
//   - the swizzle and the tile-to-flat map are XOR-linear, so the host
//     precomputes each sub-pass's per-slot masks and a thread addresses a
//     member as its base XOR the masks of its set slots;
//   - one pass when a sample fits a tile: n <= 12, and n = 13, 14 at batches
//     that give every SM a tile of 2^14, which a cluster of four blocks
//     holds, 2^12 each (32 KB, so several tiles share an SM where one 128 KB
//     block would sit alone); the load sub-pass holds the two rank bits and
//     writes each group into the shared memory of the block that holds it
//     (distributed shared memory), and one cluster barrier after it is the
//     only exchange across blocks. Otherwise passes through device memory:
//     pass 0 applies the low TB wires to contiguous tiles, each later pass
//     applies up to TB - 4 higher wires to tiles that take a 16-amplitude
//     run of the low bits (64 bytes, whole sectors) and every value of a run
//     of high bits. Pass 0 writes `out`, the later passes update `out` in
//     place (a tile reads and writes only its own amplitudes);
//   - tiles of 2^10 wherever they need no more passes than 2^12 (more
//     blocks, the same traffic): n = 13..16 take two passes of 2^10, n =
//     17..20 two of 2^12;
//   - flat offsets are 64-bit, so n is bounded by memory, not the index: B
//     * 2^n < 2^63 for every int batch up to n = 32;
//   - the gate table (n, 4) of cos/sin half-angles is computed by the caller
//     and read through the read-only cache (16 bytes a wire); the pass plan
//     is a __grid_constant__ parameter, read in place.
// The TPU kernel's lane rolls with an iota-mask select, and its XLA fallback
// below 128 lanes (dim < 128), were TPU artifacts: the partner is index
// arithmetic here. Padding amplitudes of a ragged last tile (n < TB) load as
// zero and are never stored.
// Measured (device time per call, every pass summed, torch profiler; NVIDIA
// H100 80GB HBM3, 700.00 W; the first design in brackets, same call): n = 8:
// 2.94 us at B = 1 [3.80], 2.96 at B = 64 [3.99], 6.05 at B = 2304 [9.61];
// n = 14: 5.88 at B = 1 [36.2], 14.3 at B = 64 [37.0], 295 at B = 2304
// [826]; n = 16: 6.5 at B = 1, 60 at B = 64; n = 20: 18.7 at B = 1, 933 at
// B = 64. ptxas: 64 registers and 16-32 bytes of spills at K = 4 (72
// registers without spills measured no faster), 32 at K = 2. Rejected in the
// same calls: one 128 KB block a 2^14 tile (355 us at n = 14, B = 2304),
// two passes of 2^10 or 2^12 tiles there (475, 510 us), K = 4 at small
// batches (4.46 us at n = 8, B = 1), tiles of 2^12 at n <= 10 (7.4 us at
// n = 8, B = 2304). What is left at n = 8, B = 2304 (2.1x the bound): one
// wave of 576 two-warp blocks, whose loads, sub-passes and stores run in
// step instead of overlapping.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 32;
constexpr int kMaxRegBits = 4;  // tile bits a thread holds in a sub-pass, at most
constexpr int kMaxMid = 5;      // middle sub-passes a tile takes at most (K = 2, TB = 12)
constexpr int kLowRun = 4;      // low bits a later pass carries: 64-byte runs
constexpr int kFillBlocks = 132;  // SMs of an H100 SXM

// A sub-pass: the tile bits of a thread's amplitudes (member m's bit s is
// tile bit `bit[s]`), the same bits ascending (for the thread-index spread),
// the wire applied at each slot, or -1 where the bit is carried, and each
// slot's bit as a swizzled shared-memory mask and as a flat stride.
struct Sub {
  int bit[kMaxRegBits];
  int asc[kMaxRegBits];
  int wire[kMaxRegBits];
  int smask[kMaxRegBits];
  long long gstep[kMaxRegBits];
};

// A pass over every tile: tile bits below `c` are flat bits 0..c-1, tile bits
// from c up are flat bits p, p+1, ...; sub[0] loads, sub[1] stores (when
// nsub > 1), sub[2 ..] are the middle sub-passes between them.
struct Pass {
  int c, p, nsub;
  Sub sub[2 + kMaxMid];
};

// XOR swizzle of a shared-memory index: flat bits 5..7 and 8..10 fold into
// bits 2..4 (bank bits), bits 0 and 1 stay, so 16-byte groups stay whole.
__host__ __device__ __forceinline__ int swz(int t) { return t ^ ((((t >> 5) ^ (t >> 8)) & 7) << 2); }

// A tile index's flat offset within its tile (the tile's own base added by
// the caller).
__host__ __device__ __forceinline__ long long flat(int t, int c, int p) {
  return static_cast<long long>(t & ((1 << c) - 1)) | (static_cast<long long>(t >> c) << p);
}

// Tile bits held across a cluster: a 2^14 tile is split over a cluster of
// four blocks of 2^12.
__host__ __device__ constexpr int cluster_bits(int tb) { return tb == 14 ? 2 : 0; }
// Tile bits a block holds in its own shared memory.
__host__ __device__ constexpr int local_bits(int tb) { return tb - cluster_bits(tb); }

// The thread index spread over the tile bits outside the sub-pass's K (a
// zero inserted at each, lowest first).
template <int K>
__device__ __forceinline__ int spread(int tid, const Sub& s) {
  int x = tid;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int b = s.asc[k];
    x = ((x >> b) << (b + 1)) | (x & ((1 << b) - 1));
  }
  return x;
}

// Member m's swizzled shared-memory index from its thread's swizzled base.
template <int K>
__device__ __forceinline__ int member(int sbase, int m, const Sub& s) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((m >> k) & 1) sbase ^= s.smask[k];
  return sbase;
}

// A load/store sub-pass's 16-byte group j (members 4j..4j+3: tile bits 0, 1
// inside the group, slots 2.. from j): its tile-index offset, flat offset and
// swizzled shared-memory offset.
template <int K>
__device__ __forceinline__ int group_bits(int j, const Sub& s) {
  int t = 0;
#pragma unroll
  for (int k = 2; k < K; ++k)
    if ((j >> (k - 2)) & 1) t |= 1 << s.bit[k];
  return t;
}
template <int K>
__device__ __forceinline__ long long group_flat(long long gbase, int j, const Sub& s) {
#pragma unroll
  for (int k = 2; k < K; ++k)
    if ((j >> (k - 2)) & 1) gbase += s.gstep[k];
  return gbase;
}
template <int K>
__device__ __forceinline__ int group_smem(int sbase, int j, const Sub& s) {
#pragma unroll
  for (int k = 2; k < K; ++k)
    if ((j >> (k - 2)) & 1) sbase ^= s.smask[k];
  return sbase;
}

template <int K>
__device__ __forceinline__ void apply(float (&ar)[1 << K], float (&ai)[1 << K], const Sub& s,
                                      const float4* __restrict__ gates) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int w = s.wire[k];
    if (w < 0) continue;
    const float4 g = __ldg(gates + w);
    const float cy = g.x, sy = g.y, cz = g.z, sz = g.w;
#pragma unroll
    for (int a0 = 0; a0 < (1 << K); ++a0) {
      if (a0 & (1 << k)) continue;
      const int a1 = a0 | (1 << k);
      const float r0 = ar[a0], i0 = ai[a0], r1 = ar[a1], i1 = ai[a1];
      // RY(t) = [c, -s; s, c], real: the same on re and im
      const float br0 = cy * r0 - sy * r1, bi0 = cy * i0 - sy * i1;
      const float br1 = sy * r0 + cy * r1, bi1 = sy * i0 + cy * i1;
      // RZ(p): the 0-branch times e^{-ip/2}, the 1-branch times e^{+ip/2}
      ar[a0] = cz * br0 + sz * bi0;
      ai[a0] = cz * bi0 - sz * br0;
      ar[a1] = cz * br1 - sz * bi1;
      ai[a1] = cz * bi1 + sz * br1;
    }
  }
}

__device__ __forceinline__ void load4(const float* src, long long g, long long total, float* v) {
  if (g + 4 <= total) {
    const float4 x = *reinterpret_cast<const float4*>(src + g);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = g + i < total ? src[g + i] : 0.f;
  }
}

__device__ __forceinline__ void store4(float* dst, long long g, long long total, const float* v) {
  if (g + 4 <= total) {
    *reinterpret_cast<float4*>(dst + g) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (g + i < total) dst[g + i] = v[i];
  }
}

template <int TB, int K>
constexpr int threads_of() { return 1 << (local_bits(TB) - K); }
// blocks an SM the launch bounds ask for: 1024 resident threads, so at most
// 64 registers a thread
template <int TB, int K>
constexpr int min_blocks() { return 1024 / threads_of<TB, K>(); }

template <int TB, int K>
__global__ void __launch_bounds__(threads_of<TB, K>(), min_blocks<TB, K>())
rotation_layer_kernel(const float* in_re, const float* in_im, const float* __restrict__ cs,
                      float* out_re, float* out_im, long long total,
                      const __grid_constant__ Pass pass) {
  // no __restrict__ on the state: the later passes read and write `out`
  constexpr int CB = cluster_bits(TB), LB = local_bits(TB);
  constexpr int kAmps = 1 << K, kGroups = kAmps / 4;
  extern __shared__ __align__(16) float smem[];
  float* sre = smem;
  float* sim = smem + (1 << LB);
  const float4* gates = reinterpret_cast<const float4*>(cs);
  const int c = pass.c, p = pass.p;
  // a cluster's blocks hold the tile's 2^CB parts: tile bits LB.. are the rank
  int rank = 0;
  if constexpr (CB > 0) rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long tile = blockIdx.x >> CB;
  const long long high = tile >> (p - c);
  const long long tile_base = ((tile & ((1LL << (p - c)) - 1)) << c) | (high << (p + TB - c));
  const int tid = threadIdx.x;

  float ar[kAmps], ai[kAmps];
  // sub-pass 0: device memory -> registers, 16-byte loads; apply its wires
  {
    const Sub& s = pass.sub[0];
    // the load spans the whole tile: the cluster's threads, rank-major
    const int base = spread<K>((rank << (LB - K)) | tid, s);
    const long long gbase = tile_base + flat(base, c, p);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const long long g = group_flat<K>(gbase, j, s);
      load4(in_re, g, total, ar + 4 * j);
      load4(in_im, g, total, ai + 4 * j);
    }
    apply<K>(ar, ai, s, gates);
    if (pass.nsub == 1) {  // every wire of the tile applied: straight back out
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const long long g = group_flat<K>(gbase, j, s);
        store4(out_re, g, total, ar + 4 * j);
        store4(out_im, g, total, ai + 4 * j);
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      // into the shared memory of the block that holds the group's part
      const int idx = base | group_bits<K>(j, s);
      const int a = swz(idx & ((1 << LB) - 1));
      float* dre = sre + a;
      float* dim = sim + a;
      if constexpr (CB > 0) {
        const cg::cluster_group cluster = cg::this_cluster();
        dre = cluster.map_shared_rank(dre, idx >> LB);
        dim = cluster.map_shared_rank(dim, idx >> LB);
      }
      *reinterpret_cast<float4*>(dre) = make_float4(ar[4 * j], ar[4 * j + 1], ar[4 * j + 2], ar[4 * j + 3]);
      *reinterpret_cast<float4*>(dim) = make_float4(ai[4 * j], ai[4 * j + 1], ai[4 * j + 2], ai[4 * j + 3]);
    }
  }
  // the only exchange across the cluster: after it every access is local,
  // so no block touches another's shared memory once it may have exited
  if constexpr (CB > 0) cg::this_cluster().sync(); else __syncthreads();
  // middle sub-passes: shared memory -> registers -> the same places
#pragma unroll
  for (int k = 0; k < kMaxMid; ++k) {
    if (2 + k >= pass.nsub) break;
    const Sub& s = pass.sub[2 + k];
    const int sbase = swz(spread<K>(tid, s));
#pragma unroll
    for (int m = 0; m < kAmps; ++m) {
      const int a = member<K>(sbase, m, s);
      ar[m] = sre[a];
      ai[m] = sim[a];
    }
    apply<K>(ar, ai, s, gates);
#pragma unroll
    for (int m = 0; m < kAmps; ++m) {
      const int a = member<K>(sbase, m, s);
      sre[a] = ar[m];
      sim[a] = ai[m];
    }
    __syncthreads();
  }
  // last sub-pass: shared memory -> registers; apply; 16-byte stores out
  {
    const Sub& s = pass.sub[1];
    const int base = spread<K>(tid, s) | (rank << LB);
    const int sbase = swz(base & ((1 << LB) - 1));
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int a = group_smem<K>(sbase, j, s);
      const float4 r = *reinterpret_cast<const float4*>(sre + a);
      const float4 i = *reinterpret_cast<const float4*>(sim + a);
      ar[4 * j] = r.x; ar[4 * j + 1] = r.y; ar[4 * j + 2] = r.z; ar[4 * j + 3] = r.w;
      ai[4 * j] = i.x; ai[4 * j + 1] = i.y; ai[4 * j + 2] = i.z; ai[4 * j + 3] = i.w;
    }
    apply<K>(ar, ai, s, gates);
    const long long gbase = tile_base + flat(base, c, p);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const long long g = group_flat<K>(gbase, j, s);
      store4(out_re, g, total, ar + 4 * j);
      store4(out_im, g, total, ai + 4 * j);
    }
  }
}

// ---------------------------------------------------------------------------
// The plan (host): tile bits and register bits by n and batch, the passes,
// their sub-passes. tests/test_torch_port_rotation_design.py mirrors it line
// for line.
// ---------------------------------------------------------------------------

int passes_at(int n, int tb) {
  return n <= tb ? 1 : 1 + (n - tb + (tb - kLowRun) - 1) / (tb - kLowRun);
}

int tile_bits(int batch, int n) {
  if (n <= 10) return 10;
  if (n <= 12) return 12;
  const long long amps = static_cast<long long>(batch) << n;
  if (n <= 14 && (amps >> 14) >= kFillBlocks) return 14;  // one pass, every SM a tile
  return passes_at(n, 10) <= passes_at(n, 12) ? 10 : 12;
}

// K = 2 (latency) when the call has fewer tiles than the card has SMs, else
// K = 4 (bytes in flight).
int reg_bits(int batch, int n) {
  const int tb = tile_bits(batch, n);
  const long long tiles = ((static_cast<long long>(batch) << n) + (1LL << tb) - 1) >> tb;
  return tiles < kFillBlocks ? 2 : 4;
}

// One sub-pass over the K tile bits `bits` (slot order), applying the tile
// bits still in `todo` (a mask over the tile's bits) and clearing them.
Sub make_sub(const int* bits, int k_bits, unsigned& todo, const int* wire_of_bit) {
  Sub s{};
  for (int k = 0; k < k_bits; ++k) {
    s.bit[k] = s.asc[k] = bits[k];
    const bool now = (todo >> bits[k]) & 1u;
    s.wire[k] = now ? wire_of_bit[bits[k]] : -1;
    if (now) todo &= ~(1u << bits[k]);
  }
  for (int a = 1; a < k_bits; ++a)  // ascending copy (insertion sort)
    for (int b = a; b > 0 && s.asc[b - 1] > s.asc[b]; --b) {
      const int t = s.asc[b];
      s.asc[b] = s.asc[b - 1];
      s.asc[b - 1] = t;
    }
  return s;
}

// The highest bit below `top` of `from` (a mask) not in `used`, or of bits
// 2..top-1 when `from` has none left; marks it used.
int take_high(unsigned from, unsigned& used, int top) {
  for (int pass = 0; pass < 2; ++pass) {
    const unsigned pool = pass == 0 ? from : ((1u << top) - 1u) & ~3u;
    for (int b = top - 1; b >= 2; --b)
      if (((pool >> b) & 1u) && !((used >> b) & 1u)) {
        used |= 1u << b;
        return b;
      }
  }
  return -1;
}

// The bank-group bit (2..4) a tile bit lands on under the swizzle, or -1.
int bank_group_bit(int b) { return b < 2 ? -1 : b < 5 ? b : b < 8 ? b - 3 : b < 11 ? b - 6 : -1; }

// Whether a store sub-pass over tile bits {0, 1, u, v} reads its 16-byte
// groups free of bank conflicts: an 8-lane phase varies the three lowest
// other bits, which must land on distinct bank-group bits.
bool phase_free(int u, int v, int lim) {
  int seen = 0, got = 0;
  for (int b = 2; b < lim && got < 3; ++b) {
    if (b == u || b == v) continue;
    const int g = bank_group_bit(b);
    if (g < 0 || ((seen >> g) & 1)) return false;
    seen |= 1 << g;
    ++got;
  }
  return true;
}

// The store sub-pass's two high bits at K = 4: the first pair, in the order
// of the bits to do (highest first) then the carried ones, whose reads are
// free of bank conflicts; else the first two.
void store_bits(unsigned todo, int lim, int* u, int* v) {
  int order[32], count = 0;
  for (int pass = 0; pass < 2; ++pass)
    for (int b = lim - 1; b >= 2; --b)
      if (((todo >> b) & 1u) == (pass == 0 ? 1u : 0u)) order[count++] = b;
  for (int i = 0; i < count; ++i)
    for (int j = i + 1; j < count; ++j)
      if (phase_free(order[i], order[j], lim)) {
        *u = order[i];
        *v = order[j];
        return;
      }
  *u = order[0];
  *v = order[1];
}

// The sub-passes of one pass that applies the tile bits in `todo`: load
// {0, 1, the K-2 highest to do}, store {0, 1, K-2 more, chosen for
// conflict-free reads}, the rest K at a time in between (highest first),
// padded with bits it carries. Only the load may hold bits at or above
// `lim` (a cluster's rank bits).
void plan_subs(Pass& ps, unsigned todo, const int* wire_of_bit, int tb, int lim, int k_bits) {
  unsigned used = 3u;
  int first[kMaxRegBits] = {0, 1};
  for (int k = 2; k < k_bits; ++k) first[k] = take_high(todo, used, tb);
  ps.sub[0] = make_sub(first, k_bits, todo, wire_of_bit);
  ps.nsub = 1;
  if (todo == 0) return;
  int last[kMaxRegBits] = {0, 1};
  if (k_bits == 4) store_bits(todo, lim, &last[2], &last[3]);
  unsigned after = todo;  // what the store sub-pass will apply, taken out of the middles
  for (int k = 2; k < k_bits; ++k)
    if ((todo >> last[k]) & 1u) after &= ~(1u << last[k]);
  int mids = 0;
  while (after != 0) {
    unsigned u = 0;
    int bits[kMaxRegBits];
    for (int k = 0; k < k_bits; ++k) {
      bits[k] = -1;
      for (int b = lim - 1; b >= 0 && bits[k] < 0; --b)
        if (((after >> b) & 1u) && !((u >> b) & 1u)) bits[k] = b;
      if (bits[k] < 0)  // pad with the highest carried bit not yet in the group
        for (int b = lim - 1; b >= 0 && bits[k] < 0; --b)
          if (!((u >> b) & 1u) && !((after >> b) & 1u)) bits[k] = b;
      u |= 1u << bits[k];
    }
    ps.sub[2 + mids] = make_sub(bits, k_bits, todo, wire_of_bit);
    after = todo;
    for (int k = 2; k < k_bits; ++k)
      if ((todo >> last[k]) & 1u) after &= ~(1u << last[k]);
    ++mids;
  }
  ps.sub[1] = make_sub(last, k_bits, todo, wire_of_bit);
  ps.nsub = 2 + mids;
}

// Pass k of the plan for n at tile bits tb and register bits k_bits: its bit
// map, sub-passes and their address masks.
Pass plan_pass(int n, int tb, int k_bits, int k) {
  Pass ps{};
  int wire_of_bit[32];
  unsigned todo = 0;
  if (k == 0) {
    ps.c = ps.p = tb;  // contiguous tiles: tile bit b is flat bit b
    for (int b = 0; b < tb; ++b) {
      wire_of_bit[b] = b < n ? n - 1 - b : -1;
      if (b < n) todo |= 1u << b;
    }
  } else {
    const int span = tb - kLowRun;
    const int done = tb + (k - 1) * span;  // flat bits 0 .. done-1 are applied
    ps.c = kLowRun;
    ps.p = done < n - span ? done : n - span;
    for (int b = 0; b < tb; ++b) {
      const int pos = b < kLowRun ? b : ps.p + b - kLowRun;
      wire_of_bit[b] = n - 1 - pos;
      if (pos >= done) todo |= 1u << b;
    }
  }
  plan_subs(ps, todo, wire_of_bit, tb, local_bits(tb), k_bits);
  for (int j = 0; j < ps.nsub; ++j)
    for (int s = 0; s < k_bits; ++s) {
      ps.sub[j].smask[s] = swz(1 << ps.sub[j].bit[s]);
      ps.sub[j].gstep[s] = flat(1 << ps.sub[j].bit[s], ps.c, ps.p);
    }
  return ps;
}

template <int TB, int K>
cudaError_t run(const float* in_re, const float* in_im, const float* cs, float* out_re,
                float* out_im, int batch, int n, cudaStream_t stream) {
  const auto kern = rotation_layer_kernel<TB, K>;
  constexpr int CB = cluster_bits(TB);
  // at most 32 KB a block (2^12 amplitudes of re+im): under the static 48 KB
  const size_t smem = sizeof(float) * 2 * (size_t{1} << local_bits(TB));
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(batch) << n;
  const long long tiles = (total + (1LL << TB) - 1) >> TB;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1u << CB;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles << CB));
  cfg.blockDim = dim3(threads_of<TB, K>());
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = CB > 0 ? 1 : 0;
  for (int k = 0; k < passes_at(n, TB); ++k) {
    const Pass ps = plan_pass(n, TB, K, k);
    // pass 0 reads the input; the later passes update `out` in place
    const float* src_re = k == 0 ? in_re : out_re;
    const float* src_im = k == 0 ? in_im : out_im;
    err = cudaLaunchKernelEx(&cfg, kern, src_re, src_im, cs, out_re, out_im, total, ps);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

bool in_window(int batch, int n) { return n >= 1 && n <= kMaxN && batch >= 1; }

}  // namespace

// The plan of a launch at this batch and n: tile bits (10, 12 or 14),
// register bits (2 or 4) and passes through device memory; 0 outside the
// window.
extern "C" int rotation_layer_tile_bits(int batch, int n) {
  return in_window(batch, n) ? tile_bits(batch, n) : 0;
}
extern "C" int rotation_layer_reg_bits(int batch, int n) {
  return in_window(batch, n) ? reg_bits(batch, n) : 0;
}
extern "C" int rotation_layer_passes(int batch, int n) {
  return in_window(batch, n) ? passes_at(n, tile_bits(batch, n)) : 0;
}

// in_re, in_im (batch, 2^n): the states; cs (n, 4): cos, sin of the RY
// half-angle then of the RZ half-angle, per wire; out_re, out_im (batch, 2^n).
// All float32 on the device, 16-byte aligned, out apart from in.
// 1 <= n <= 32, batch >= 1. One kernel launch per pass. Returns the first
// CUDA error, or 0.
extern "C" int rotation_layer_launch(const float* in_re, const float* in_im, const float* cs,
                                     float* out_re, float* out_im, int batch, int n,
                                     void* stream) {
  if (!in_window(batch, n)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int tb = tile_bits(batch, n);
  const bool wide = reg_bits(batch, n) == 4;
  cudaError_t err;
  if (tb == 10) {
    err = wide ? run<10, 4>(in_re, in_im, cs, out_re, out_im, batch, n, s)
               : run<10, 2>(in_re, in_im, cs, out_re, out_im, batch, n, s);
  } else if (tb == 12) {
    err = wide ? run<12, 4>(in_re, in_im, cs, out_re, out_im, batch, n, s)
               : run<12, 2>(in_re, in_im, cs, out_re, out_im, batch, n, s);
  } else {
    err = run<14, 4>(in_re, in_im, cs, out_re, out_im, batch, n, s);  // tiles >= SMs: K = 4
  }
  return static_cast<int>(err);
}
