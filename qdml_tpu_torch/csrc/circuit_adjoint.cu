// Adjoint backward of the whole-circuit gate chain: from the final state and
// the <Z> cotangent to the cotangents of the angles and of the gate weights.
//
// Replaces the TPU kernel's backward: `_circuit_bwd` with its helpers
// `_undo_layer` and `_apply_layer_fwd` (qdml_tpu/quantum/pallas_kernels.py),
// the backward of the `_circuit_expvals` custom_vjp behind
// `fused_circuit_expvals`. Per sample, with psi the final state the forward
// kernel wrote and g the cotangent of <Z>:
//   lambda = 2 psi * dprobs,  dprobs[x] = sum_q g[q] * (1 - 2 * bit_q(x));
//   for each layer l from the last:
//     the inverse ring permutation on psi and lambda;
//     for every wire q:
//       dw[l,q,1] += <lambda, dRZ/dt psi>;  undo RZ on psi, push lambda
//       through RZ^T (the same rotation: the gate is unitary);
//       dw[l,q,0] += <lambda, dRY/dt psi>;  the same for RY;
//   dangles[q] = sum_x lambda_re[x] * d amp[x] / d angle_q, with amp the
//   real RY product state (its factors, never a division by cos or sin).
// dweights is summed over the batch.
//
// What bounds it on an H100: the work is 2nL rotations undone on psi and
// lambda, about 64 flops per amplitude pair per wire; at the training shape
// (n = 8, L = 3, B = 2304) that is about 0.47 GFLOP against 4.7 MB of final
// state, so the fp32 rate sets the bound (6.95 us). What kept the first
// design from it was on-chip: one pass per wire through shared memory, the
// ring a gather through registers, n a runtime value: 185 registers, one
// block an SM, 33 block barriers and ~220 KB of shared-memory traffic per
// sample, 157 us at that shape. This design:
//   - n is a template parameter (one instantiation per n in 2..12): every
//     per-thread array is sized for its own n and every index is a constant
//     or an XOR of a few masks; __launch_bounds__ keeps 32 warps resident per
//     SM (64 registers a thread; a little spills at span 3);
//   - several wires per pass: within a layer the RY/RZ gates of different
//     wires commute, and Re<lambda, dG_q psi> does not change when gates on
//     other wires are applied to both psi and lambda, so a thread holds the
//     2^span amplitudes of psi and lambda that span `span` wires (3 from
//     n = 7, 2 below) in registers, undoes those wires' RZ and RY, sums their
//     weight cotangents, and writes back once: ceil(n / span) passes a layer
//     instead of n (~72 KB of shared-memory traffic per sample at n = 8);
//     RZ's cotangent is elementwise (RZ is diagonal), 0.5 sum_x z_q(x)
//     Im(conj(lambda_x) psi_x), so it is summed once per amplitude for all
//     the pass's wires instead of per pair and wire;
//   - the ring is an index map, not a gather: each CNOT of the ring is
//     XOR-linear on the index bits, so after j rings are undone logical x
//     lives at physical f^j(x) = XOR of f^j(e_q) over its set bits. The block
//     builds the (L + 1, n) table of f^j(e_q) once and a pass addresses its
//     amplitudes by XORing entries (tests/test_torch_port_kernel_design.py
//     builds the same table from `ring_cnot_perm` and emulates the walk);
//   - the shared-memory index is swizzled (t ^ ((t >> 5) & 31)), XOR-linear
//     too, so the table holds swizzled masks; it spreads a warp's strided
//     loads over the banks (1.22 addresses a bank on average at n = 8 over
//     the passes, against 3.44 unswizzled, as the design test counts them);
//   - 64-thread blocks up to n = 9 (the blocks spread evenly over the SMs),
//     one sample's groups per block above; a sample lives in one warp up to
//     n = 8, so passes are separated by __syncwarp, from n = 9 by
//     __syncthreads; each layer ends with one block barrier, after which the
//     per-warp weight sums (double-buffered by layer) are folded in warp
//     order into the block's partial;
//   - the batch sum of dweights is a cross-block reduction: each block
//     writes its partial (L, n, 2) and a second kernel of the same launch
//     call sums the partials in a fixed order; no atomics, so the gradient
//     is the same on every run;
//   - a member axis (the noise-sweep ensemble) is the grid's y dimension,
//     as the JAX package's vmap batches its custom_vjp: each member's blocks
//     are a one-member launch's, offset to its slices, and the fold sums
//     each member's own partials;
//   - the embedding cotangent: each thread takes the amplitudes of one
//     logical group, forms the leave-one-out products of the per-wire
//     factors by prefix and suffix products, and the threads of a sample
//     reduce all n sums at once by shuffles.
// The padding samples of the last block hold psi = lambda = 0 and add 0.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): 27.4 us of device
// time at n = 8, L = 3, B = 2304 (the first design: 157.1 us), 12.5 us at
// B = 64, 439 us at n = 12, B = 2304;
// ptxas: 64 registers, 168 bytes of spill stores at n = 8, none below n = 7;
// 32 warps resident per SM up to n = 11. What is left: instruction issue
// (about 40 arithmetic instructions per amplitude pair per wire), the
// spills, and the shuffle sums of each pass.

#include <cuda_runtime.h>

namespace {

constexpr int kResidentThreads = 1024;  // 32 warps an SM: at most 64 registers a thread
constexpr int kMinN = 2;
constexpr int kMaxN = 12;
constexpr int kStaticSmem = 48 * 1024;

// Wires whose 2^span amplitudes one thread holds in a pass: 3 from n = 7
// (fewer passes and shuffles), 2 below, where more threads per sample pay
// more than the extra pass costs (both measured on an H100 at n = 6 and 8).
__host__ __device__ constexpr int span(int n) { return n < 7 ? (n < 2 ? n : 2) : 3; }
__host__ __device__ constexpr int passes(int n) { return (n + span(n) - 1) / span(n); }
// Groups of 2^span amplitudes per sample; threads per block (64 up to n = 9,
// so that the blocks spread evenly over the SMs, then one sample's groups up
// to 256); samples per block; groups per thread.
__host__ __device__ constexpr int groups(int n) { return 1 << (n - span(n)); }
__host__ __device__ constexpr int threads(int n) {
  return groups(n) < 64 ? 64 : (groups(n) > 256 ? 256 : groups(n));
}
__host__ __device__ constexpr int samples_per_block(int n) {
  return groups(n) >= threads(n) ? 1 : threads(n) / groups(n);
}
__host__ __device__ constexpr int iters(int n) {
  return groups(n) > threads(n) ? groups(n) / threads(n) : 1;
}

// Pass p undoes wires n-1-p*span .. in its first `active` slots; the last
// pass, when span does not divide n, fills its spare slots with wires of the
// first pass, which it holds but leaves alone.
__host__ __device__ constexpr int active(int n, int p) {
  return n - p * span(n) < span(n) ? n - p * span(n) : span(n);
}
__host__ __device__ constexpr int slot_wire(int n, int p, int s) {
  return s < active(n, p) ? n - 1 - p * span(n) - s : n - 1 - (s - active(n, p));
}
__host__ __device__ constexpr bool in_pass(int n, int p, int q) {
  for (int s = 0; s < span(n); ++s)
    if (slot_wire(n, p, s) == q) return true;
  return false;
}
// Bit i of a thread's group index is the i-th wire outside pass p's slots,
// counting down from wire n-1.
__host__ __device__ constexpr int other_wire(int n, int p, int i) {
  for (int q = n - 1; q >= 0; --q) {
    if (in_pass(n, p, q)) continue;
    if (i == 0) return q;
    --i;
  }
  return -1;
}

size_t smem_bytes(int n, int layers) {
  const size_t spb = samples_per_block(n);
  const size_t floats = 4 * spb * (size_t{1} << n) + 3 * spb * n + 4 * (threads(n) / 32) * n;
  return sizeof(float) * floats + sizeof(int) * (static_cast<size_t>(layers) + 1) * n;
}

// XOR-linear swizzle of a shared-memory index: the bank bits take the next
// five bits in.
__device__ __forceinline__ int swz(int t) { return t ^ ((t >> 5) & 31); }

// The forward ring's index map f: psi'[f(x)] = psi[x], the gates CNOT(0,1),
// CNOT(1,2), ..., CNOT(n-2,n-1), CNOT(n-1,0) applied in that order to the
// bits of x (qubit 0 is the MSB). f is linear over GF(2).
template <int N>
__device__ __forceinline__ int ring_dst(int x) {
#pragma unroll
  for (int c = 0; c < N - 1; ++c) x ^= ((x >> (N - 1 - c)) & 1) << (N - 2 - c);
  return x ^ ((x & 1) << (N - 1));
}

// Member r of a group: its base XOR the masks of r's set bits (slot s is
// bit W-1-s of r).
template <int W>
__device__ __forceinline__ int member(int base, int r, const int (&c)[W]) {
#pragma unroll
  for (int s = 0; s < W; ++s)
    if ((r >> (W - 1 - s)) & 1) base ^= c[s];
  return base;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int N>
__global__ void __launch_bounds__(threads(N), kResidentThreads / threads(N))
circuit_adjoint_kernel(const float* __restrict__ fre, const float* __restrict__ fim,
                       const float* __restrict__ g, const float* __restrict__ cs,
                       const float* __restrict__ angles, float* __restrict__ dangles,
                       float* __restrict__ partials, int batch, int layers) {
  constexpr int kDim = 1 << N;
  constexpr int kThreads = threads(N);
  constexpr int kWarps = kThreads / 32;
  constexpr int W = span(N);
  constexpr int kAmps = 1 << W;
  constexpr int kOther = N - W;
  constexpr int P = passes(N);
  constexpr int GPS = groups(N);
  constexpr int SPB = samples_per_block(N);
  constexpr int IT = iters(N);
  constexpr int kTotal = SPB * kDim;
  constexpr bool kWarpLocal = GPS <= 32;  // a sample's groups lie in one warp

  // Member m = blockIdx.y of a member-axis launch reads and writes its own
  // slices; the blocks along x cut its batch exactly as a one-member launch
  // does, so its dangles and block partials are those of a launch on its
  // slices, bit for bit.
  {
    const size_t m = blockIdx.y;
    fre += m * batch * kDim;
    fim += m * batch * kDim;
    g += m * batch * N;
    cs += m * layers * N * 4;
    angles += m * batch * N;
    dangles += m * batch * N;
    partials += m * gridDim.x * layers * N * 2;
  }

  extern __shared__ float smem[];
  float* pre = smem;                     // psi, re and im (swizzled index)
  float* pim = pre + kTotal;
  float* lre = pim + kTotal;             // lambda, re and im
  float* lim = lre + kTotal;
  float* half_cs = lim + kTotal;         // (SPB, N, 2): cos, sin of angle / 2
  float* gs = half_cs + 2 * SPB * N;     // (SPB, N): the <Z> cotangent
  float* red = gs + SPB * N;             // (2, kWarps, N, 2): per-warp sums, by layer parity
  int* cols = reinterpret_cast<int*>(red + 4 * kWarps * N);  // (layers + 1, N): swz(f^j(e_q))

  const int s0 = blockIdx.x * SPB;
  const int valid = min(SPB, batch - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int t = threadIdx.x; t < SPB * N; t += kThreads) {
    const bool ok = t / N < valid;
    const float a = ok ? angles[s0 * N + t] : 0.f;
    float s, c;
    sincosf(0.5f * a, &s, &c);
    half_cs[2 * t] = c;
    half_cs[2 * t + 1] = s;
    gs[t] = ok ? g[s0 * N + t] : 0.f;
  }
  if (threadIdx.x < N) {
    int v = 1 << (N - 1 - threadIdx.x);
    cols[threadIdx.x] = swz(v);
    for (int j = 1; j <= layers; ++j) {
      v = ring_dst<N>(v);
      cols[j * N + threadIdx.x] = swz(v);
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kTotal; t += kThreads) {
    const int s = t >> N;
    const int x = t & (kDim - 1);
    float r = 0.f, i = 0.f, dp = 0.f;
    if (s < valid) {
      r = fre[s0 * kDim + t];
      i = fim[s0 * kDim + t];
      const float* gq = gs + s * N;
#pragma unroll
      for (int q = 0; q < N; ++q) dp += ((x >> (N - 1 - q)) & 1) ? -gq[q] : gq[q];
    }
    const int a = swz(t);
    pre[a] = r;
    pim[a] = i;
    lre[a] = 2.f * r * dp;
    lim[a] = 2.f * i * dp;
  }
  __syncthreads();

  for (int l = layers - 1; l >= 0; --l) {
    const int* col = cols + (layers - l) * N;  // l + 1 .. L rings undone: f^(L-l)
    float* slot = red + ((l & 1) * kWarps + warp) * N * 2;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int c[W];  // the slot wires' swizzled masks: member r of a group sits at
                 // its base XOR the masks of r's set bits
#pragma unroll
      for (int s = 0; s < W; ++s) c[s] = col[slot_wire(N, p, s)];
      float dy[W], dz[W];
#pragma unroll
      for (int s = 0; s < W; ++s) dy[s] = dz[s] = 0.f;
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int gt = threadIdx.x + it * kThreads;
        const int gi = gt & (GPS - 1);
        int yb = swz((gt / GPS) * kDim);
#pragma unroll
        for (int i = 0; i < kOther; ++i)
          if ((gi >> i) & 1) yb ^= col[other_wire(N, p, i)];
        float ar[kAmps], ai[kAmps], br[kAmps], bi[kAmps];
#pragma unroll
        for (int r = 0; r < kAmps; ++r) {
          const int a = member<W>(yb, r, c);
          ar[r] = pre[a];
          ai[r] = pim[a];
          br[r] = lre[a];
          bi[r] = lim[a];
        }
        // RZ's cotangent pairs no amplitudes: 0.5 * sum_x (1 - 2 bit_q(x))
        // Im(conj(lambda_x) psi_x), the same at any point of the pass (the
        // other wires' gates cancel), so it is taken before any is undone
#pragma unroll
        for (int r = 0; r < kAmps; ++r) {
          const float m = br[r] * ai[r] - bi[r] * ar[r];
#pragma unroll
          for (int s = 0; s < active(N, p); ++s) dz[s] += ((r >> (W - 1 - s)) & 1) ? -m : m;
        }
#pragma unroll
        for (int s = 0; s < active(N, p); ++s) {
          const float4 k = __ldg(reinterpret_cast<const float4*>(cs) + l * N + slot_wire(N, p, s));
          const float cy = k.x, sy = k.y, cz = k.z, sz = k.w;
          const int bit = 1 << (W - 1 - s);
#pragma unroll
          for (int a0 = 0; a0 < kAmps; ++a0) {
            if (a0 & bit) continue;
            const int a1 = a0 | bit;
            float r0 = ar[a0], i0 = ai[a0], r1 = ar[a1], i1 = ai[a1];
            float x0 = br[a0], y0 = bi[a0], x1 = br[a1], y1 = bi[a1];
            // undo RZ: e^{+it/2} on the 0-branch, e^{-it/2} on the 1-branch
            float t0 = cz * r0 - sz * i0, t1 = cz * i0 + sz * r0;
            r0 = t0; i0 = t1;
            t0 = cz * r1 + sz * i1; t1 = cz * i1 - sz * r1;
            r1 = t0; i1 = t1;
            t0 = cz * x0 - sz * y0; t1 = cz * y0 + sz * x0;
            x0 = t0; y0 = t1;
            t0 = cz * x1 + sz * y1; t1 = cz * y1 - sz * x1;
            x1 = t0; y1 = t1;
            // RY(t) = [c, -s; s, c]: d/dt (b0, b1) = (-b1, b0) / 2
            dy[s] += 0.5f * ((x1 * r0 - x0 * r1) + (y1 * i0 - y0 * i1));
            // undo RY: [c, s; -s, c]
            ar[a0] = cy * r0 + sy * r1;
            ar[a1] = cy * r1 - sy * r0;
            ai[a0] = cy * i0 + sy * i1;
            ai[a1] = cy * i1 - sy * i0;
            br[a0] = cy * x0 + sy * x1;
            br[a1] = cy * x1 - sy * x0;
            bi[a0] = cy * y0 + sy * y1;
            bi[a1] = cy * y1 - sy * y0;
          }
        }
#pragma unroll
        for (int r = 0; r < kAmps; ++r) {
          const int a = member<W>(yb, r, c);
          pre[a] = ar[r];
          pim[a] = ai[r];
          lre[a] = br[r];
          lim[a] = bi[r];
        }
      }
#pragma unroll
      for (int s = 0; s < active(N, p); ++s) {
        const float sy = warp_sum(dy[s]);
        const float sz = 0.5f * warp_sum(dz[s]);
        if (lane == 0) {
          slot[2 * slot_wire(N, p, s)] = sy;
          slot[2 * slot_wire(N, p, s) + 1] = sz;
        }
      }
      if (p + 1 < P) {
        if (kWarpLocal) __syncwarp(); else __syncthreads();
      }
    }
    __syncthreads();
    // This layer's block partial, summed over warps in a fixed order. The
    // next layer writes the other parity's slots; this parity's are
    // rewritten two layers on, after the barrier that ends the next layer.
    if (threadIdx.x < 2 * N) {
      const float* lay = red + (l & 1) * kWarps * N * 2;
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += lay[w * N * 2 + threadIdx.x];
      partials[(blockIdx.x * layers + l) * N * 2 + threadIdx.x] = sum;
    }
  }

  // The embedding cotangent. Logical x = (gi << W) | r: wires 0 .. N-W-1
  // from the group index, the last W wires from r; after all L rings x lives
  // at f^L(x).
  const int* colL = cols + layers * N;
  int cL[W];
#pragma unroll
  for (int s = 0; s < W; ++s) cL[s] = colL[kOther + s];
  float acc[N];
#pragma unroll
  for (int q = 0; q < N; ++q) acc[q] = 0.f;
  const int my_s = threadIdx.x / GPS;  // IT > 1 only when SPB == 1
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int gt = threadIdx.x + it * kThreads;
    const int gi = gt & (GPS - 1);
    int yb = swz((gt / GPS) * kDim);
#pragma unroll
    for (int i = 0; i < kOther; ++i)
      if ((gi >> i) & 1) yb ^= colL[kOther - 1 - i];
    const float* h = half_cs + 2 * N * my_s;
    // leave-one-out products of the group wires' factors (prefix x suffix)
    float v[kOther + 1], d[kOther + 1], prefix[kOther + 1], suffix[kOther + 1];
#pragma unroll
    for (int q = 0; q < kOther; ++q) {
      const int bit = (gi >> (kOther - 1 - q)) & 1;
      v[q] = h[2 * q + bit];
      // d cos(a/2) / da = -sin(a/2) / 2, d sin(a/2) / da = cos(a/2) / 2
      d[q] = bit ? 0.5f * h[2 * q] : -0.5f * h[2 * q + 1];
    }
    prefix[0] = 1.f;
#pragma unroll
    for (int q = 0; q < kOther; ++q) prefix[q + 1] = prefix[q] * v[q];
    suffix[kOther] = 1.f;
#pragma unroll
    for (int q = kOther - 1; q >= 0; --q) suffix[q] = suffix[q + 1] * v[q];
    float lam[kAmps];
#pragma unroll
    for (int r = 0; r < kAmps; ++r) lam[r] = lre[member<W>(yb, r, cL)];
    // the last W wires: the group's sum with each wire's factor, and with
    // each one in turn replaced by its derivative
    float whole = 0.f, part[W];
#pragma unroll
    for (int s = 0; s < W; ++s) part[s] = 0.f;
#pragma unroll
    for (int r = 0; r < kAmps; ++r) {
#pragma unroll
      for (int s = -1; s < W; ++s) {
        float prod = lam[r];
#pragma unroll
        for (int u = 0; u < W; ++u) {
          const int q = kOther + u;
          const int bit = (r >> (W - 1 - u)) & 1;
          prod *= u == s ? (bit ? 0.5f * h[2 * q] : -0.5f * h[2 * q + 1]) : h[2 * q + bit];
        }
        if (s < 0) whole += prod; else part[s] += prod;
      }
    }
#pragma unroll
    for (int q = 0; q < kOther; ++q) acc[q] += whole * (prefix[q] * suffix[q + 1]) * d[q];
#pragma unroll
    for (int s = 0; s < W; ++s) acc[kOther + s] += prefix[kOther] * part[s];
  }
  if constexpr (GPS <= 32) {
    // the sample's GPS threads are an aligned run of lanes
#pragma unroll
    for (int off = GPS / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < N; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
    }
    if ((threadIdx.x & (GPS - 1)) == 0 && my_s < valid) {
#pragma unroll
      for (int q = 0; q < N; ++q) dangles[(s0 + my_s) * N + q] = acc[q];
    }
  } else {
    // a sample spans kWarps / SPB warps: per-warp sums, then a fixed-order
    // fold; the parity-1 slots are free (their last reader ended before the
    // final layer's barrier)
    float* wsum = red + kWarps * N * 2;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float v = warp_sum(acc[q]);
      if (lane == 0) wsum[warp * N + q] = v;
    }
    __syncthreads();
    constexpr int kWps = kWarps / SPB;
    for (int t = threadIdx.x; t < SPB * N; t += kThreads) {
      const int s = t / N, q = t % N;
      if (s >= valid) break;
      float sum = 0.f;
      for (int w = 0; w < kWps; ++w) sum += wsum[(s * kWps + w) * N + q];
      dangles[(s0 + s) * N + q] = sum;
    }
  }
}

// dweights of each member: the sum of its blocks' partials (blocks, per),
// per = layers * n * 2, in a fixed order with no atomics: block (k, m) of
// one warp sums entry k of member m, lane j taking blocks j, j + 32, ... in
// turn, then a fixed shuffle tree. A one-member launch sums the same way,
// so a member's dweights equal a one-member launch's on its slices.
__global__ void circuit_adjoint_fold_kernel(const float* __restrict__ partials,
                                            float* __restrict__ dweights, int blocks, int per) {
  const int k = blockIdx.x;
  const size_t m = blockIdx.y;
  const float* p = partials + m * blocks * per + k;
  float sum = 0.f;
  for (int b = threadIdx.x; b < blocks; b += 32) sum += p[static_cast<size_t>(b) * per];
  sum = warp_sum(sum);
  if (threadIdx.x == 0) dweights[m * per + k] = sum;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                        float*, float*, int, int);

Kernel kernel_for(int n) {
  switch (n) {
    case 2: return circuit_adjoint_kernel<2>;
    case 3: return circuit_adjoint_kernel<3>;
    case 4: return circuit_adjoint_kernel<4>;
    case 5: return circuit_adjoint_kernel<5>;
    case 6: return circuit_adjoint_kernel<6>;
    case 7: return circuit_adjoint_kernel<7>;
    case 8: return circuit_adjoint_kernel<8>;
    case 9: return circuit_adjoint_kernel<9>;
    case 10: return circuit_adjoint_kernel<10>;
    case 11: return circuit_adjoint_kernel<11>;
    case kMaxN: return circuit_adjoint_kernel<kMaxN>;
    default: return nullptr;
  }
}

int threads_for(int n) { return threads(n); }

// Shared memory for this launch, opted in above the static 48 KB, and the
// carveout that lets four blocks' shared memory sit beside each other.
cudaError_t configure(Kernel kern, size_t smem) {
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Blocks of one launch: the leading size of the `partials` buffer (0 outside
// the window).
extern "C" int circuit_adjoint_blocks(int batch, int n) {
  if (n < kMinN || n > kMaxN) return 0;
  const int spb = samples_per_block(n);
  return (batch + spb - 1) / spb;
}

// Resident blocks per SM for this n and layer count, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current device, or
// minus the CUDA error. A block has circuit_adjoint_threads(n) threads.
extern "C" int circuit_adjoint_occupancy(int n, int layers) {
  const Kernel kern = kernel_for(n);
  if (kern == nullptr || layers < 1) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, layers);
  cudaError_t err = configure(kern, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads_for(n), smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Threads per block for this n (0 outside the window).
extern "C" int circuit_adjoint_threads(int n) {
  return n < kMinN || n > kMaxN ? 0 : threads(n);
}

// members independent circuits of one shape, each its own slice of every
// array: fre, fim (members, batch, 2^n): the forward's final states; g
// (members, batch, n): the cotangent of <Z>; cs (members, layers, n, 4):
// cos, sin of the RY half-angle then of the RZ half-angle; angles (members,
// batch, n). Writes dangles (members, batch, n) and dweights (members,
// layers, n, 2), through partials (members, circuit_adjoint_blocks(batch,
// n), layers, n, 2), scratch that the second kernel sums over its blocks
// axis. All float32 on the device. 2 <= n <= 12, layers >= 1, batch >= 1,
// 1 <= members <= 65535 (the grid's y extent). Returns the first CUDA
// error, or 0.
extern "C" int circuit_adjoint_launch(const float* fre, const float* fim, const float* g,
                                      const float* cs, const float* angles, float* dangles,
                                      float* partials, float* dweights, int batch, int n,
                                      int layers, int members, void* stream) {
  const Kernel kern = kernel_for(n);
  if (kern == nullptr || layers < 1 || batch < 1 || members < 1 || members > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, layers);
  cudaError_t err = configure(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = circuit_adjoint_blocks(batch, n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kern<<<dim3(blocks, members), threads_for(n), smem, s>>>(fre, fim, g, cs, angles, dangles,
                                                           partials, batch, layers);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = layers * n * 2;
  circuit_adjoint_fold_kernel<<<dim3(per, members), 32, 0, s>>>(partials, dweights, blocks, per);
  return static_cast<int>(cudaGetLastError());
}
