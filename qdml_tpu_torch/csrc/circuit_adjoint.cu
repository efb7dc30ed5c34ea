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
//     for wires q = n-1 .. 0:
//       dw[l,q,1] += <lambda, dRZ/dt psi>;  undo RZ on psi, push lambda
//       through RZ^T (the same rotation: the gate is unitary);
//       dw[l,q,0] += <lambda, dRY/dt psi>;  the same for RY;
//   dangles[q] = sum_x lambda_re[x] * d amp[x] / d angle_q, with amp the
//   real RY product state (its factors, never a division by cos or sin).
// dweights is summed over the batch.
//
// What bounds it on an H100: like the forward, the work is 2nL in-place
// passes over 2^n amplitude pairs per sample (now four arrays, psi and
// lambda, about 40 flops per pair per wire), and at the training shapes
// (n = 8, L = 3, B = 2304) it moves some 4.7 MB of final state and does
// about 0.5 GFLOP: the chain of barriers between wires inside a block, not
// the card's memory or arithmetic rate. The design follows the forward:
//   - one block of 256 threads holds `spb` samples (spb * 2^n =
//     max(2^n, 512)); psi and lambda stay resident in shared memory for the
//     whole reverse walk, 4 * spb * 2^n floats: 8 KB below n = 10, 64 KB at
//     n = 12, which is over the 48 KB static limit, so the launcher opts in
//     to large dynamic shared memory;
//   - each wire's RZ and RY are undone in ONE pass over its amplitude pairs
//     (partner by bit insertion), which also accumulates both weight
//     cotangents in registers; a warp shuffle then one slot per warp in
//     shared memory, folded in warp order at the end of the layer;
//   - the inverse ring is one gather through registers of psi and lambda;
//   - the batch sum of dweights is a cross-block reduction: each block
//     writes its partial (L, n, 2) and the caller sums the partials in a
//     fixed order; no atomics, so the gradient is the same on every run;
//   - dangles is one warp per (sample, wire), like the forward's <Z>.
// The padding samples of the last block hold psi = lambda = 0 and add 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 12;
constexpr int kBlockAmps = 512;  // amplitudes per block below n = 9 (spb * 2^n)
constexpr int kMaxItems = (1 << kMaxN) / kThreads;  // ring gather slots per thread
constexpr int kStaticSmem = 48 * 1024;

// The forward ring's index map f: psi'[f(x)] = psi[x], the gates CNOT(0,1),
// CNOT(1,2), ..., CNOT(n-2,n-1), CNOT(n-1,0) applied in that order to the
// bits of x (qubit 0 is the MSB). Undoing the ring gathers psi[x] = psi'[f(x)].
__device__ __forceinline__ int ring_dst(int x, int n) {
  for (int c = 0; c < n - 1; ++c) x ^= ((x >> (n - 1 - c)) & 1) << (n - 2 - c);
  return x ^ ((x & 1) << (n - 1));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
circuit_adjoint_kernel(const float* __restrict__ fre, const float* __restrict__ fim,
                       const float* __restrict__ g, const float* __restrict__ cs,
                       const float* __restrict__ angles, float* __restrict__ dangles,
                       float* __restrict__ partials, int batch, int n, int layers, int spb) {
  extern __shared__ float smem[];
  const int dim = 1 << n;
  const int total = spb * dim;
  float* pre = smem;                    // psi, re and im
  float* pim = pre + total;
  float* lre = pim + total;             // lambda, re and im
  float* lim = lre + total;
  float* half_cs = lim + total;         // (spb, n, 2): cos, sin of angle / 2
  float* gs = half_cs + 2 * spb * n;    // (spb, n): the <Z> cotangent
  float* red = gs + spb * n;            // (n, kWarps, 2): one layer's per-warp sums
  const int s0 = blockIdx.x * spb;
  const int valid = min(spb, batch - s0);

  for (int t = threadIdx.x; t < spb * n; t += kThreads) {
    const bool ok = t / n < valid;
    const float a = ok ? angles[s0 * n + t] : 0.f;
    float s, c;
    sincosf(0.5f * a, &s, &c);
    half_cs[2 * t] = c;
    half_cs[2 * t + 1] = s;
    gs[t] = ok ? g[s0 * n + t] : 0.f;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < total; t += kThreads) {
    const int s = t >> n;
    const int x = t & (dim - 1);
    float r = 0.f, i = 0.f, dp = 0.f;
    if (s < valid) {
      r = fre[s0 * dim + t];
      i = fim[s0 * dim + t];
      const float* gq = gs + s * n;
      for (int q = 0; q < n; ++q) dp += ((x >> (n - 1 - q)) & 1) ? -gq[q] : gq[q];
    }
    pre[t] = r;
    pim[t] = i;
    lre[t] = 2.f * r * dp;
    lim[t] = 2.f * i * dp;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = total >> 1;
  const int pair_mask = (dim >> 1) - 1;
  for (int l = layers - 1; l >= 0; --l) {
    {
      float v0[kMaxItems], v1[kMaxItems], v2[kMaxItems], v3[kMaxItems];
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        const int t = threadIdx.x + k * kThreads;
        if (t < total) {
          const int src = (t & ~(dim - 1)) | ring_dst(t & (dim - 1), n);
          v0[k] = pre[src];
          v1[k] = pim[src];
          v2[k] = lre[src];
          v3[k] = lim[src];
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMaxItems; ++k) {
        const int t = threadIdx.x + k * kThreads;
        if (t < total) {
          pre[t] = v0[k];
          pim[t] = v1[k];
          lre[t] = v2[k];
          lim[t] = v3[k];
        }
      }
      __syncthreads();
    }
    for (int q = n - 1; q >= 0; --q) {
      const float* gq = cs + 4 * (l * n + q);
      const float cy = __ldg(gq), sy = __ldg(gq + 1), cz = __ldg(gq + 2), sz = __ldg(gq + 3);
      const int pos = n - 1 - q;
      const int m = 1 << pos;
      float dy = 0.f, dz = 0.f;
      for (int p = threadIdx.x; p < pairs; p += kThreads) {
        const int pl = p & pair_mask;
        const int a0 = (p >> (n - 1)) * dim + (((pl >> pos) << (pos + 1)) | (pl & (m - 1)));
        const int a1 = a0 + m;
        float r0 = pre[a0], i0 = pim[a0], r1 = pre[a1], i1 = pim[a1];
        float x0 = lre[a0], y0 = lim[a0], x1 = lre[a1], y1 = lim[a1];
        // RZ(t) multiplies the 0-branch by e^{-it/2}, the 1-branch by
        // e^{+it/2}: d/dt is -i/2 resp. +i/2 times the amplitude.
        dz += 0.5f * ((x0 * i0 - y0 * r0) + (y1 * r1 - x1 * i1));
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
        dy += 0.5f * ((x1 * r0 - x0 * r1) + (y1 * i0 - y0 * i1));
        // undo RY: [c, s; -s, c]
        pre[a0] = cy * r0 + sy * r1;
        pre[a1] = cy * r1 - sy * r0;
        pim[a0] = cy * i0 + sy * i1;
        pim[a1] = cy * i1 - sy * i0;
        lre[a0] = cy * x0 + sy * x1;
        lre[a1] = cy * x1 - sy * x0;
        lim[a0] = cy * y0 + sy * y1;
        lim[a1] = cy * y1 - sy * y0;
      }
      dy = warp_sum(dy);
      dz = warp_sum(dz);
      if (lane == 0) {
        red[2 * (q * kWarps + warp)] = dy;
        red[2 * (q * kWarps + warp) + 1] = dz;
      }
      __syncthreads();
    }
    // This layer's block partial, summed over warps in a fixed order. The
    // slots are rewritten only after the next layer's ring, two barriers on.
    if (threadIdx.x < 2 * n) {
      const int q = threadIdx.x / 2, k = threadIdx.x % 2;
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) sum += red[2 * (q * kWarps + w) + k];
      partials[((blockIdx.x * layers + l) * n + q) * 2 + k] = sum;
    }
  }

  for (int o = warp; o < spb * n; o += kWarps) {
    const int s = o / n, q = o % n;
    if (s >= valid) break;  // o grows with s: every later o is padding too
    const float* h = half_cs + 2 * n * s;
    float sum = 0.f;
    for (int x = lane; x < dim; x += 32) {
      float prod = 0.5f * lre[s * dim + x];
      for (int p = 0; p < n; ++p) {
        const int bit = (x >> (n - 1 - p)) & 1;
        // d cos(a/2) / da = -sin(a/2) / 2, d sin(a/2) / da = cos(a/2) / 2
        prod *= p == q ? (bit ? h[2 * p] : -h[2 * p + 1]) : h[2 * p + bit];
      }
      sum += prod;
    }
    sum = warp_sum(sum);
    if (lane == 0) dangles[(s0 + s) * n + q] = sum;
  }
}

int samples_per_block(int n) {
  const int dim = 1 << n;
  return dim >= kBlockAmps ? 1 : kBlockAmps / dim;
}

}  // namespace

// Blocks of one launch: the leading size of the `partials` buffer.
extern "C" int circuit_adjoint_blocks(int batch, int n) {
  const int spb = samples_per_block(n);
  return (batch + spb - 1) / spb;
}

// fre, fim (batch, 2^n): the forward's final state; g (batch, n): the
// cotangent of <Z>; cs (layers, n, 4): cos, sin of the RY half-angle then of
// the RZ half-angle; angles (batch, n). Writes dangles (batch, n) and
// partials (circuit_adjoint_blocks(batch, n), layers, n, 2), whose sum over
// the first axis is dweights. All float32 on the device. 2 <= n <= 12,
// layers >= 1, batch >= 1. Returns the first CUDA error, or 0.
extern "C" int circuit_adjoint_launch(const float* fre, const float* fim, const float* g,
                                      const float* cs, const float* angles, float* dangles,
                                      float* partials, int batch, int n, int layers,
                                      void* stream) {
  if (n < 2 || n > kMaxN || layers < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int spb = samples_per_block(n);
  const int blocks = circuit_adjoint_blocks(batch, n);
  const size_t smem =
      sizeof(float) * (4 * static_cast<size_t>(spb) * (1 << n) + 3 * spb * n + 2 * n * kWarps);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        circuit_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  circuit_adjoint_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fre, fim, g, cs, angles, dangles, partials, batch, n, layers, spb);
  return static_cast<int>(cudaGetLastError());
}
