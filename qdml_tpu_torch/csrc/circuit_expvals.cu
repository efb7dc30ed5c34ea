// Whole-circuit gate chain: angles -> L x (RY, RZ on every wire + ring CNOTs) -> <Z>.
//
// Replaces the TPU kernel `_circuit_kernel` (qdml_tpu/quantum/pallas_kernels.py,
// reached through `fused_circuit_expvals` -> `_circuit_forward`). Per sample:
//   embed the real RY product state of the angles,
//   for each layer l: for each wire q: RY(w[l,q,0]) then RZ(w[l,q,1]);
//                     then CNOT(i, i+1) for i < n-1 and CNOT(n-1, 0),
//   out[q] = sum_x |psi_x|^2 * (1 - 2 * bit_q(x))   (qubit 0 = MSB),
// and, when asked, the final state (re, im) in logical index order, which
// the adjoint backward (circuit_adjoint.cu) reads.
//
// What bounds it on an H100: 24 flops per amplitude pair per wire per layer;
// at the training shape (n = 8, L = 3, B = 2304) that is 0.17 GFLOP and 4.7
// MB of final state written, 2.6 us at the fp32 rate; at the serving shape
// (B = 64) under 5 MFLOP, far under the launch floor. What the first design
// lost was on-chip: n a runtime value, 256-thread blocks of 512 amplitudes
// (2 samples a block at n = 8, so B = 64 filled 32 SMs), one in-place pass
// per wire, each ended by __syncthreads(), the ring a gather through
// registers sized for n = 12 behind two more barriers (about 32 block
// barriers per sample at n = 8, L = 3), and <Z> one warp per (sample, wire)
// rereading the state n times. This design carries over what the adjoint
// proved:
//   - n is a template parameter (one instantiation per n in 2..12);
//   - several wires per pass: the RY/RZ gates of different wires commute, so
//     a thread holds the 2^span amplitudes that span `span` wires (3 from
//     n = 7, 2 below) in registers and applies those wires' RY then RZ in
//     one pass: ceil(n / span) passes a layer instead of n;
//   - the ring is an index map, not a data movement: each CNOT of the ring
//     is XOR-linear on the index bits, so after j rings logical x lives at
//     physical g^j(x) = XOR of g^j(e_q) over its set bits, g the ring's
//     source map (psi'[y] = psi[g(y)]). The block builds the (L + 1, n)
//     table of g^j(e_q) once, and a pass addresses its amplitudes by XORing
//     entries: no gather pass and no barrier for the ring;
//   - the embedded state is built in the registers of the first pass, so it
//     never makes a round trip through shared memory;
//   - the shared-memory index is swizzled (t ^ ((t >> 5) & 31)), as in the
//     adjoint: XOR-linear, so the table holds swizzled masks;
//   - a sample lives in one warp up to n = 8 (blocks of one warp: 64 blocks
//     at B = 64), so passes are separated by __syncwarp; from n = 9 a block
//     is one sample's groups (64 to 512 threads) and passes end in
//     __syncthreads;
//   - the epilogue reads the state once, in logical order through the table
//     of g^L: each thread takes the 2^span consecutive logical amplitudes of
//     one group, writes them with 16-byte stores when the state is asked
//     for, and sums |psi|^2 with signs for all n wires at once (the group's
//     top wires share one sum, the span wires' signs are constants); the
//     sample's threads then reduce the n sums by shuffles, across warps in
//     a fixed order from n = 9.
// The TPU's lower bound n >= 7 came from its 128-lane roll and does not
// apply here; the ring itself needs n >= 2.
// Measured (device time, torch profiler; NVIDIA H100 80GB HBM3, 700.00 W;
// the first design in brackets, same call): n = 8, L = 3: 4.19 us at B = 1
// [10.91], 4.22 at B = 64 [11.49], 11.75 at B = 2304 with the state
// [55.44], 11.27 without [54.47], 16.8 at B = 4096 [92.2]; n = 12: 14.5 at
// B = 64 [46.8], 234.8 at B = 2304 with the state [555.9]. ptxas: 32 to 64
// registers, no spills (a 32-byte stack frame from n = 3); the launch
// bounds keep 32 warps resident an SM. Rejected in the same calls: two-sample (64-thread) blocks
// at n = 8 (equal within 1%), two wires a pass at n = 8 (3.65 us at B = 64,
// but 13.58 at B = 2304 with the state). What is left at B = 2304: the
// shared-memory round trip of each of the 9 passes and the epilogue's
// shuffles, 4.2x the fp32 bound.

#include <cuda_runtime.h>

namespace {

constexpr int kResidentThreads = 1024;  // 32 warps an SM: at most 64 registers a thread
constexpr int kMaxN = 12;
constexpr int kStaticSmem = 48 * 1024;

// Wires whose 2^span amplitudes one thread holds in a pass (the adjoint's
// choice): 3 from n = 7, 2 below.
__host__ __device__ constexpr int span(int n) { return n < 7 ? 2 : 3; }
__host__ __device__ constexpr int passes(int n) { return (n + span(n) - 1) / span(n); }
// Groups of 2^span amplitudes per sample (one a thread); threads per block,
// one warp up to n = 8, then one sample's groups; samples per block.
__host__ __device__ constexpr int groups(int n) { return 1 << (n - span(n)); }
__host__ __device__ constexpr int threads(int n) { return groups(n) < 32 ? 32 : groups(n); }
__host__ __device__ constexpr int samples_per_block(int n) { return threads(n) / groups(n); }

// Pass p applies wires n-1-p*span .. in its first `active` slots; the last
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
  const size_t floats = 2 * spb * (size_t{1} << n) + 2 * spb * n + (threads(n) / 32) * n;
  return sizeof(float) * floats + sizeof(int) * (static_cast<size_t>(layers) + 1) * n;
}

// XOR-linear swizzle of a shared-memory index: the bank bits take the next
// five bits in.
__device__ __forceinline__ int swz(int t) { return t ^ ((t >> 5) & 31); }

// The ring's source map g: psi'[y] = psi[g(y)] after CNOT(0,1), CNOT(1,2),
// ..., CNOT(n-2,n-1), CNOT(n-1,0) (qubit 0 is the MSB). Each CNOT is its own
// inverse, so g applies them in reverse order. g is linear over GF(2).
template <int N>
__device__ __forceinline__ int ring_src(int y) {
  int x = y ^ ((y & 1) << (N - 1));  // CNOT(n-1, 0): control is the LSB
#pragma unroll
  for (int c = N - 2; c >= 0; --c) x ^= ((x >> (N - 1 - c)) & 1) << (N - 2 - c);
  return x;
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
circuit_expvals_kernel(const float* __restrict__ angles, const float* __restrict__ cs,
                       float* __restrict__ ev, float* __restrict__ fre,
                       float* __restrict__ fim, int batch, int layers, int write_state) {
  constexpr int kDim = 1 << N;
  constexpr int kThreads = threads(N);
  constexpr int kWarps = kThreads / 32;
  constexpr int W = span(N);
  constexpr int kAmps = 1 << W;
  constexpr int kOther = N - W;
  constexpr int P = passes(N);
  constexpr int GPS = groups(N);
  constexpr int SPB = samples_per_block(N);
  constexpr int kTotal = SPB * kDim;

  extern __shared__ float smem[];
  float* pre = smem;                     // psi, re and im (swizzled index)
  float* pim = pre + kTotal;
  float* half_cs = pim + kTotal;         // (SPB, N, 2): cos, sin of angle / 2
  float* red = half_cs + 2 * SPB * N;    // (kWarps, N): per-warp <Z> sums from n = 9
  int* cols = reinterpret_cast<int*>(red + kWarps * N);  // (layers + 1, N): swz(g^j(e_q))

  const int s0 = blockIdx.x * SPB;
  const int valid = min(SPB, batch - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int my_s = threadIdx.x / GPS;
  const int gi = threadIdx.x & (GPS - 1);

  for (int t = threadIdx.x; t < SPB * N; t += kThreads) {
    const float a = t / N < valid ? angles[s0 * N + t] : 0.f;
    float s, c;
    sincosf(0.5f * a, &s, &c);
    half_cs[2 * t] = c;
    half_cs[2 * t + 1] = s;
  }
  if (threadIdx.x < N) {
    int v = 1 << (N - 1 - threadIdx.x);
    cols[threadIdx.x] = swz(v);
    for (int j = 1; j <= layers; ++j) {
      v = ring_src<N>(v);
      cols[j * N + threadIdx.x] = swz(v);
    }
  }
  __syncthreads();

  const int base = swz(my_s * kDim);
  const float* h = half_cs + 2 * N * my_s;
  const float4* gates = reinterpret_cast<const float4*>(cs);
  for (int l = 0; l < layers; ++l) {
    const int* col = cols + l * N;  // l rings applied: g^l
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int c[W];
#pragma unroll
      for (int s = 0; s < W; ++s) c[s] = col[slot_wire(N, p, s)];
      int yb = base;
#pragma unroll
      for (int i = 0; i < kOther; ++i)
        if ((gi >> i) & 1) yb ^= col[other_wire(N, p, i)];
      float ar[kAmps], ai[kAmps];
      if (p == 0 && l == 0) {
        // the embedded product state, built here: no round trip through
        // shared memory (g^0 is the identity, so the slots are the logical
        // wires of the group's members)
        float g = 1.f;
#pragma unroll
        for (int i = 0; i < kOther; ++i) g *= h[2 * other_wire(N, 0, i) + ((gi >> i) & 1)];
#pragma unroll
        for (int r = 0; r < kAmps; ++r) {
          float v = g;
#pragma unroll
          for (int s = 0; s < W; ++s) v *= h[2 * slot_wire(N, 0, s) + ((r >> (W - 1 - s)) & 1)];
          ar[r] = v;
          ai[r] = 0.f;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kAmps; ++r) {
          const int a = member<W>(yb, r, c);
          ar[r] = pre[a];
          ai[r] = pim[a];
        }
      }
#pragma unroll
      for (int s = 0; s < active(N, p); ++s) {
        const float4 k = __ldg(gates + l * N + slot_wire(N, p, s));
        const float cy = k.x, sy = k.y, cz = k.z, sz = k.w;
        const int bit = 1 << (W - 1 - s);
#pragma unroll
        for (int a0 = 0; a0 < kAmps; ++a0) {
          if (a0 & bit) continue;
          const int a1 = a0 | bit;
          const float r0 = ar[a0], i0 = ai[a0], r1 = ar[a1], i1 = ai[a1];
          // RY: [c, -s; s, c]
          const float br0 = cy * r0 - sy * r1, bi0 = cy * i0 - sy * i1;
          const float br1 = sy * r0 + cy * r1, bi1 = sy * i0 + cy * i1;
          // RZ: e^{-i t/2} on the 0-branch, e^{+i t/2} on the 1-branch
          ar[a0] = cz * br0 + sz * bi0;
          ai[a0] = cz * bi0 - sz * br0;
          ar[a1] = cz * br1 - sz * bi1;
          ai[a1] = cz * bi1 + sz * br1;
        }
      }
#pragma unroll
      for (int r = 0; r < kAmps; ++r) {
        const int a = member<W>(yb, r, c);
        pre[a] = ar[r];
        pim[a] = ai[r];
      }
      if constexpr (GPS <= 32) __syncwarp(); else __syncthreads();
    }
  }

  // Epilogue, in logical order: x = (gi << W) | r, wires 0 .. N-W-1 from the
  // group index, the last W wires from r; after all L rings x lives at g^L(x).
  const int* colL = cols + layers * N;
  int cL[W];
#pragma unroll
  for (int s = 0; s < W; ++s) cL[s] = colL[kOther + s];
  int yb = base;
#pragma unroll
  for (int i = 0; i < kOther; ++i)
    if ((gi >> i) & 1) yb ^= colL[kOther - 1 - i];
  float vr[kAmps], vi[kAmps];
  float total = 0.f, low[W];
#pragma unroll
  for (int s = 0; s < W; ++s) low[s] = 0.f;
#pragma unroll
  for (int r = 0; r < kAmps; ++r) {
    const int a = member<W>(yb, r, cL);
    vr[r] = pre[a];
    vi[r] = pim[a];
    const float pr = vr[r] * vr[r] + vi[r] * vi[r];
    total += pr;
#pragma unroll
    for (int s = 0; s < W; ++s) low[s] += ((r >> (W - 1 - s)) & 1) ? -pr : pr;
  }
  if (write_state && my_s < valid) {
    // 2^W >= 4 consecutive floats at a multiple of 2^W: 16-byte stores
    const size_t at = static_cast<size_t>(s0 + my_s) * kDim + (gi << W);
    float4* dr = reinterpret_cast<float4*>(fre + at);
    float4* di = reinterpret_cast<float4*>(fim + at);
#pragma unroll
    for (int v = 0; v < kAmps / 4; ++v) {
      dr[v] = make_float4(vr[4 * v], vr[4 * v + 1], vr[4 * v + 2], vr[4 * v + 3]);
      di[v] = make_float4(vi[4 * v], vi[4 * v + 1], vi[4 * v + 2], vi[4 * v + 3]);
    }
  }
  float acc[N];
#pragma unroll
  for (int q = 0; q < kOther; ++q) acc[q] = ((gi >> (kOther - 1 - q)) & 1) ? -total : total;
#pragma unroll
  for (int s = 0; s < W; ++s) acc[kOther + s] = low[s];
  if constexpr (GPS <= 32) {
    // the sample's GPS threads are an aligned run of lanes
#pragma unroll
    for (int off = GPS / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < N; ++q) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], off);
    }
    if (gi == 0 && my_s < valid) {
#pragma unroll
      for (int q = 0; q < N; ++q) ev[(s0 + my_s) * N + q] = acc[q];
    }
  } else {
    // one sample a block, over kWarps warps: per-warp sums, then a
    // fixed-order fold
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float v = warp_sum(acc[q]);
      if (lane == 0) red[warp * N + q] = v;
    }
    __syncthreads();
    if (threadIdx.x < N) {
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[w * N + threadIdx.x];
      ev[s0 * N + threadIdx.x] = sum;
    }
  }
}

using Kernel = void (*)(const float*, const float*, float*, float*, float*, int, int, int);

Kernel kernel_for(int n) {
  switch (n) {
    case 2: return circuit_expvals_kernel<2>;
    case 3: return circuit_expvals_kernel<3>;
    case 4: return circuit_expvals_kernel<4>;
    case 5: return circuit_expvals_kernel<5>;
    case 6: return circuit_expvals_kernel<6>;
    case 7: return circuit_expvals_kernel<7>;
    case 8: return circuit_expvals_kernel<8>;
    case 9: return circuit_expvals_kernel<9>;
    case 10: return circuit_expvals_kernel<10>;
    case 11: return circuit_expvals_kernel<11>;
    case kMaxN: return circuit_expvals_kernel<kMaxN>;
    default: return nullptr;
  }
}

// Shared memory for this launch, opted in above the static 48 KB (many
// layers at n = 12), and the carveout that lets 32 one-warp blocks' shared
// memory sit beside each other.
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

// angles (batch, n); cs (layers, n, 4) = cos, sin of the RY half-angle then of
// the RZ half-angle; ev (batch, n); fre/fim (batch, 2^n), written in logical
// index order only when write_state != 0 (may be null otherwise; 16-byte
// aligned). All float32 on the device. 2 <= n <= 12, layers >= 1, batch >= 1.
// Returns the first CUDA error, or 0.
extern "C" int circuit_expvals_launch(const float* angles, const float* cs, float* ev,
                                      float* fre, float* fim, int batch, int n, int layers,
                                      int write_state, void* stream) {
  const Kernel kern = kernel_for(n);
  if (kern == nullptr || layers < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, layers);
  const cudaError_t err = configure(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int spb = samples_per_block(n);
  kern<<<(batch + spb - 1) / spb, threads(n), smem, static_cast<cudaStream_t>(stream)>>>(
      angles, cs, ev, fre, fim, batch, layers, write_state);
  return static_cast<int>(cudaGetLastError());
}
