// Whole-circuit gate chain: angles -> L x (RY, RZ on every wire + ring CNOTs) -> <Z>.
//
// Replaces the TPU kernel `_circuit_kernel` (qdml_tpu/quantum/pallas_kernels.py,
// reached through `fused_circuit_expvals` -> `_circuit_forward`). Per sample:
//   embed the real RY product state of the angles,
//   for each layer l: for each wire q: RY(w[l,q,0]) then RZ(w[l,q,1]);
//                     then CNOT(i, i+1) for i < n-1 and CNOT(n-1, 0),
//   out[q] = sum_x |psi_x|^2 * (1 - 2 * bit_q(x))   (qubit 0 = MSB),
// and, when asked, the final state (re, im).
//
// What bounds it on an H100: the work is 2nL passes over 2^n amplitudes per
// sample, about 10 flops per amplitude pair per gate; at the serving shapes
// (n = 8, L = 3, B = 64) that is under 1 MFLOP and about 0.13 MB of output
// state, so launch latency and the __syncthreads() between gates bound it,
// not the card's memory or arithmetic rates. The design therefore keeps the
// whole chain in one launch with the state resident in shared memory:
//   - one block of 256 threads holds `spb` samples (spb * 2^n = max(2^n, 512)
//     amplitudes, re and im: 4 KB to 32 KB at n = 12, under the 48 KB static
//     limit, so no opt-in to larger shared memory is needed);
//   - the embedding is built in shared memory from cos/sin and bit tests; the
//     embedded state never exists in device memory;
//   - each RY+RZ pair is ONE in-place pass over the 2^(n-1) amplitude pairs
//     of wire q (partner index by bit insertion, not the TPU's lane rolls),
//     with a barrier between wires; the per-gate cos/sin come from the
//     (L, n, 4) table the wrapper computes on the device;
//   - the ring's composed permutation is a gather through registers: every
//     thread reads its at most 16 source amplitudes, a barrier, then writes;
//   - <Z> is one warp per (sample, wire), a shuffle reduction over the
//     state with signs from the index.
// The TPU's lower bound n >= 7 came from its 128-lane roll and does not apply
// here; the ring itself needs n >= 2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 12;
constexpr int kBlockAmps = 512;  // amplitudes per block below n = 9 (spb * 2^n)
constexpr int kMaxItems = (1 << kMaxN) / kThreads;  // ring gather slots per thread

// Source index of the composed ring permutation: psi'[y] = psi[src(y)].
// The ring applies CNOT(0,1), CNOT(1,2), ..., CNOT(n-2,n-1), CNOT(n-1,0) in
// that order; each CNOT is its own inverse, so the inverse applies them in
// reverse order.
__device__ __forceinline__ int ring_src(int y, int n) {
  int x = y ^ ((y & 1) << (n - 1));  // CNOT(n-1, 0): control is the LSB
  for (int c = n - 2; c >= 0; --c) x ^= ((x >> (n - 1 - c)) & 1) << (n - 2 - c);
  return x;
}

__global__ void __launch_bounds__(kThreads)
circuit_expvals_kernel(const float* __restrict__ angles, const float* __restrict__ cs,
                       float* __restrict__ ev, float* __restrict__ fre,
                       float* __restrict__ fim, int batch, int n, int layers, int spb,
                       int write_state) {
  extern __shared__ float smem[];
  const int dim = 1 << n;
  const int total = spb * dim;
  float* sre = smem;
  float* sim = smem + total;
  float* half_cs = smem + 2 * total;  // (spb, n, 2): cos, sin of a / 2
  const int s0 = blockIdx.x * spb;

  for (int t = threadIdx.x; t < spb * n; t += kThreads) {
    const int row = s0 + t / n;
    const float a = row < batch ? angles[row * n + t % n] : 0.f;
    float s, c;
    sincosf(0.5f * a, &s, &c);
    half_cs[2 * t] = c;
    half_cs[2 * t + 1] = s;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < total; t += kThreads) {
    const float* h = half_cs + 2 * n * (t >> n);
    const int x = t & (dim - 1);
    float p = 1.f;
    for (int q = 0; q < n; ++q) p *= h[2 * q + ((x >> (n - 1 - q)) & 1)];
    sre[t] = p;
    sim[t] = 0.f;
  }
  __syncthreads();

  const int pairs = total >> 1;
  const int pair_mask = (dim >> 1) - 1;
  for (int l = 0; l < layers; ++l) {
    for (int q = 0; q < n; ++q) {
      const float* gq = cs + 4 * (l * n + q);
      const float cy = __ldg(gq), sy = __ldg(gq + 1), cz = __ldg(gq + 2), sz = __ldg(gq + 3);
      const int pos = n - 1 - q;
      const int m = 1 << pos;
      for (int p = threadIdx.x; p < pairs; p += kThreads) {
        const int pl = p & pair_mask;
        const int a0 = (p >> (n - 1)) * dim + (((pl >> pos) << (pos + 1)) | (pl & (m - 1)));
        const int a1 = a0 + m;
        const float r0 = sre[a0], i0 = sim[a0], r1 = sre[a1], i1 = sim[a1];
        // RY: [c, -s; s, c]
        const float br0 = cy * r0 - sy * r1, bi0 = cy * i0 - sy * i1;
        const float br1 = sy * r0 + cy * r1, bi1 = sy * i0 + cy * i1;
        // RZ: e^{-i t/2} on the 0-branch, e^{+i t/2} on the 1-branch
        sre[a0] = cz * br0 + sz * bi0;
        sim[a0] = cz * bi0 - sz * br0;
        sre[a1] = cz * br1 - sz * bi1;
        sim[a1] = cz * bi1 + sz * br1;
      }
      __syncthreads();
    }
    float vr[kMaxItems], vi[kMaxItems];
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t < total) {
        const int src = (t & ~(dim - 1)) | ring_src(t & (dim - 1), n);
        vr[k] = sre[src];
        vi[k] = sim[src];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) {
      const int t = threadIdx.x + k * kThreads;
      if (t < total) {
        sre[t] = vr[k];
        sim[t] = vi[k];
      }
    }
    __syncthreads();
  }

  if (write_state) {
    const int valid = min(total, (batch - s0) * dim);
    for (int t = threadIdx.x; t < valid; t += kThreads) {
      fre[s0 * dim + t] = sre[t];
      fim[s0 * dim + t] = sim[t];
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = warp; o < spb * n; o += kThreads / 32) {
    const int s = o / n, q = o % n;
    if (s0 + s >= batch) break;  // o grows with s: every later o is padding too
    float sum = 0.f;
    for (int x = lane; x < dim; x += 32) {
      const float re = sre[s * dim + x], im = sim[s * dim + x];
      const float p = re * re + im * im;
      sum += ((x >> (n - 1 - q)) & 1) ? -p : p;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) ev[(s0 + s) * n + q] = sum;
  }
}

}  // namespace

// angles (batch, n); cs (layers, n, 4) = cos, sin of the RY half-angle then of
// the RZ half-angle; ev (batch, n); fre/fim (batch, 2^n), written only when
// write_state != 0 (may be null otherwise). All float32 on the device.
// 2 <= n <= 12, layers >= 1, batch >= 1. Returns cudaGetLastError().
extern "C" int circuit_expvals_launch(const float* angles, const float* cs, float* ev,
                                      float* fre, float* fim, int batch, int n, int layers,
                                      int write_state, void* stream) {
  if (n < 2 || n > kMaxN || layers < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dim = 1 << n;
  const int spb = dim >= kBlockAmps ? 1 : kBlockAmps / dim;
  const int blocks = (batch + spb - 1) / spb;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(spb) * dim + 2 * spb * n);
  circuit_expvals_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      angles, cs, ev, fre, fim, batch, n, layers, spb, write_state);
  return static_cast<int>(cudaGetLastError());
}
