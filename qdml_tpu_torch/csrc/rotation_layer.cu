// One rotation layer of the ansatz on a batch of states: RY(w[q,0]) then
// RZ(w[q,1]) on every wire q = 0 .. n-1, in that order.
//
// Replaces the TPU kernel `_layer_kernel_body` (qdml_tpu/quantum/pallas_kernels.py),
// reached through `apply_rotation_layer` -> `_rotation_layer_pallas`. Per
// sample, with qubit 0 the most significant bit, the partner of amplitude i on
// wire q is i ^ (1 << (n-1-q)), and for each pair (a0 with bit 0, a1 with bit 1):
//   RY(t) = [c, -s; s, c] on (a0, a1), c = cos(t/2), s = sin(t/2) (real);
//   RZ(p) multiplies a0 by e^{-ip/2} and a1 by e^{+ip/2}.
//
// What bounds it on an H100: each amplitude is read once and written once
// (16 bytes of re+im per amplitude, in and out) and takes about 12 flops per
// wire, so at n = 8, B = 2304 the call moves 9.4 MB for 57 MFLOP: the memory
// rate bounds it (2.8 us at 3.35 TB/s). The design keeps every intermediate
// out of device memory:
//   - one block of 256 threads holds `spb` samples (spb * 2^n = max(2^n,
//     1024) amplitudes) in shared memory: loaded once, coalesced, then one
//     in-place pass per wire over its amplitude pairs (partner by bit
//     insertion), RY and RZ fused in that pass, a barrier between wires, and
//     one coalesced store;
//   - the TPU kernel's lane rolls with an iota-mask select, and its XLA
//     fallback below 128 lanes (dim < 128), were TPU artifacts: the partner is
//     index arithmetic here, so the kernel covers 1 <= n <= 14;
//   - at n = 14 one sample is 128 KB of re+im, over the 48 KB static limit, so
//     the launcher opts in to large dynamic shared memory (one block per SM);
//   - the gate table (n, 4) of cos/sin half-angles is computed by the caller
//     and staged in shared memory.
// The padding samples of the last block are zero and are never stored.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 14;
constexpr int kBlockAmps = 1024;  // amplitudes per block below n = 10 (spb * 2^n)
constexpr int kStaticSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
rotation_layer_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                      const float* __restrict__ cs, float* __restrict__ out_re,
                      float* __restrict__ out_im, int batch, int n, int spb) {
  extern __shared__ float smem[];
  const int dim = 1 << n;
  const int total = spb * dim;
  float* sre = smem;
  float* sim = sre + total;
  float* table = sim + total;  // (n, 4): cos, sin of the RY half-angle, then of RZ's
  const long long base = static_cast<long long>(blockIdx.x) * total;
  const int valid = min(spb, batch - static_cast<int>(blockIdx.x) * spb) * dim;

  for (int t = threadIdx.x; t < 4 * n; t += kThreads) table[t] = cs[t];
  for (int t = threadIdx.x; t < total; t += kThreads) {
    const bool ok = t < valid;
    sre[t] = ok ? in_re[base + t] : 0.f;
    sim[t] = ok ? in_im[base + t] : 0.f;
  }
  __syncthreads();

  const int pairs = total >> 1;
  const int pair_mask = (dim >> 1) - 1;
  for (int q = 0; q < n; ++q) {
    const float cy = table[4 * q], sy = table[4 * q + 1];
    const float cz = table[4 * q + 2], sz = table[4 * q + 3];
    const int pos = n - 1 - q;
    const int m = 1 << pos;
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int pl = p & pair_mask;
      const int a0 = (p >> (n - 1)) * dim + (((pl >> pos) << (pos + 1)) | (pl & (m - 1)));
      const int a1 = a0 + m;
      const float r0 = sre[a0], i0 = sim[a0], r1 = sre[a1], i1 = sim[a1];
      // RY(t) = [c, -s; s, c], real: the same on re and im
      const float br0 = cy * r0 - sy * r1, bi0 = cy * i0 - sy * i1;
      const float br1 = sy * r0 + cy * r1, bi1 = sy * i0 + cy * i1;
      // RZ(p): the 0-branch times e^{-ip/2}, the 1-branch times e^{+ip/2}
      sre[a0] = cz * br0 + sz * bi0;
      sim[a0] = cz * bi0 - sz * br0;
      sre[a1] = cz * br1 - sz * bi1;
      sim[a1] = cz * bi1 + sz * br1;
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < valid; t += kThreads) {
    out_re[base + t] = sre[t];
    out_im[base + t] = sim[t];
  }
}

int samples_per_block(int n) {
  const int dim = 1 << n;
  return dim >= kBlockAmps ? 1 : kBlockAmps / dim;
}

}  // namespace

// in_re, in_im (batch, 2^n): the states; cs (n, 4): cos, sin of the RY
// half-angle then of the RZ half-angle, per wire; out_re, out_im (batch, 2^n).
// All float32 on the device, out apart from in. 1 <= n <= 14, batch >= 1.
// Returns the first CUDA error, or 0.
extern "C" int rotation_layer_launch(const float* in_re, const float* in_im, const float* cs,
                                     float* out_re, float* out_im, int batch, int n,
                                     void* stream) {
  if (n < 1 || n > kMaxN || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int spb = samples_per_block(n);
  const int blocks = (batch + spb - 1) / spb;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(spb) * (1 << n) + 4 * n);
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        rotation_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rotation_layer_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in_re, in_im, cs, out_re, out_im, batch, n, spb);
  return static_cast<int>(cudaGetLastError());
}
