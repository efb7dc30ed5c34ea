// Train-mode BatchNorm followed by ReLU, forward and backward, for the HDCE
// and DCE trunks (Conv -> BatchNorm2d -> ReLU, qdml_tpu_torch/models/cnn.py).
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm and ReLU to XLA,
// which fuses them into its convolutions' neighbours. On the H100 the port
// ran them as cuDNN's training BatchNorm, a second `torch.var_mean` over the
// same input for the running statistics, two `lerp_`, the ReLU and its
// `threshold_backward`: at the trunk's shape (768, 32, 16, 8) cuDNN's
// forward moved its 25.2 MB at 0.44 TB/s and its backward its 37.7 MB at
// 0.43 TB/s, 7-13% of the card's 3.35 TB/s.
//
// Forward, with M = N*H*W values a channel:
//   mean, var = the batch statistics over (N, H, W), var biased;
//   y = relu((x - mean) * (invstd * gamma) + beta), invstd = 1/sqrt(var + eps);
//   running = lerp(running, batch statistic, momentum) for the mean and the
//   biased variance (Flax's BatchNorm; torch's lerp, both of its branches);
//   saves mean and invstd for the backward.
// Backward, from x, dy and the saved statistics:
//   z = the pre-ReLU value recomputed with the forward's own float
//   operations (pre_relu below), so the ReLU mask is the forward's bit for
//   bit; dz = z <= 0 ? 0 : dy (torch's threshold_backward on y);
//   dbeta = sum dz, dgamma = sum dz * xhat, xhat = (x - mean) * invstd;
//   dx = gamma * invstd * (dz - dbeta / M - xhat * dgamma / M).
//
// What bounds it on an H100: bytes. A few flops a value against 8 bytes
// (forward: x in, y out) or 12 (backward: x and dy in, dx out), so the
// floor is the bytes over 3.35 TB/s: 7.5 us forward and 11.3 us backward
// at (768, 32, 16, 8), less where the conv just left x in the 50 MB L2.
// The design:
//   - every pass is spread over the whole card: a channel's M values are
//     cut into chunks of kTile, one 256-thread block a (chunk, channel),
//     grid (chunks, C); 12 chunks x 32 channels = 384 blocks at the trunk's
//     shape, resident at once on the 132 SMs. Each thread holds its 32
//     values of the chunk in registers, loaded as 8 16-byte loads issued
//     together (one plane of 16 x 8 floats is one warp's 512 bytes);
//     where H*W is not a multiple of 4 or a pointer is not 16-byte aligned,
//     the same plan with 4-byte loads;
//   - the statistics: each block takes its chunk's mean and M2 by two
//     passes over the values it holds (sum, then the sum of squared
//     deviations from that mean), not E[x^2] - E[x]^2; the normalising
//     kernel's first warp merges the channel's chunks by Chan's formula in
//     a fixed order, while the block's own loads of x are in flight. Every
//     block of a channel merges the same partials in the same order and so
//     gets the same statistics; the channel's first block writes the saved
//     statistics and the running ones. The backward's two sums are plain
//     per-chunk sums merged the same way;
//   - no atomics and no sum whose order depends on scheduling: an eager
//     call, a CUDA-graph replay and any two runs agree bit for bit, and
//     nothing is left in device memory between calls for a replay to find;
//   - two kernels a direction (the chunk statistics, then the normalising
//     or dx pass, which re-reads x, and dy, mostly from L2: one site's x is
//     12.6 MB). No grid-wide barrier: the blocks need not be resident
//     together.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// values of one channel a block takes: 32 a thread
constexpr int kTile = 8192;

// the value before the ReLU; both directions compute it with these rounded
// operations (no contraction left to the compiler), so the backward's mask
// is the forward's
__device__ __forceinline__ float pre_relu(float x, float mean, float scale, float shift) {
  return __fmaf_rn(__fsub_rn(x, mean), scale, shift);
}

// torch's relu: NaN passes, -0 and below become +0
__device__ __forceinline__ float relu(float z) { return z <= 0.f ? 0.f : z; }

// torch's lerp (its two branches, weight below 0.5 or not)
__device__ __forceinline__ float lerp(float self, float end, float w) {
  return fabsf(w) < 0.5f ? self + w * (end - self) : end - (end - self) * (1.f - w);
}

// a butterfly of commutative adds: every lane ends with the same sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum of v and of u, the warps' sums added in warp order: every
// thread gets the same two sums. buf holds 2 * kWarps floats.
__device__ __forceinline__ float2 block_sum2(float v, float u, float* buf) {
  v = warp_sum(v);
  u = warp_sum(u);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    buf[w] = v;
    buf[kWarps + w] = u;
  }
  __syncthreads();
  float2 s = make_float2(buf[0], buf[kWarps]);
#pragma unroll
  for (int i = 1; i < kWarps; ++i) {
    s.x += buf[i];
    s.y += buf[kWarps + i];
  }
  __syncthreads();  // buf may be written again
  return s;
}

// count, mean and M2 of a set of values
struct Moments {
  float n, mean, m2;
};

// Chan's merge of two sets' moments
__device__ __forceinline__ Moments chan(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

__device__ __forceinline__ int chunk_count(int chunk, int m) { return min(kTile, m - chunk * kTile); }

// The V-wide slot r of this thread in chunk `chunk` of channel c: its index
// into the (N, C, HW) array, or -1 past the channel's M values. V divides
// HW, so a slot never crosses a plane.
template <int V>
__device__ __forceinline__ long long slot(int chunk, int r, int c, int C, int HW, int m) {
  const int e = chunk * kTile + (r * kThreads + static_cast<int>(threadIdx.x)) * V;
  if (e >= m) return -1;
  const int n = e / HW;
  return (static_cast<long long>(n) * C + c) * HW + (e - n * HW);
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  float v[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec<1> {
  float v[1];
  __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
  __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};

// The channel's statistics from its chunks' (mean, M2) partials, merged by
// the calling warp in a fixed order: lane l takes chunks l, l + 32, ... in
// turn, then the lanes fold down to lane 0, whose result is returned (in
// lane 0 only).
__device__ __forceinline__ Moments merge_moments(const float2* part, int chunks, int m) {
  const int lane = threadIdx.x & 31;
  Moments acc = {0.f, 0.f, 0.f};
  for (int p = lane; p < chunks; p += 32) {
    const float2 q = part[p];
    acc = chan(acc, Moments{static_cast<float>(chunk_count(p, m)), q.x, q.y});
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Moments other;
    other.n = __shfl_down_sync(0xffffffffu, acc.n, o);
    other.mean = __shfl_down_sync(0xffffffffu, acc.mean, o);
    other.m2 = __shfl_down_sync(0xffffffffu, acc.m2, o);
    if (lane + o < 32) acc = chan(acc, other);
  }
  return acc;
}

// The channel's two sums from its chunks' partials, in the same fixed order.
__device__ __forceinline__ float2 merge_sums(const float2* part, int chunks) {
  const int lane = threadIdx.x & 31;
  float2 acc = make_float2(0.f, 0.f);
  for (int p = lane; p < chunks; p += 32) {
    const float2 q = part[p];
    acc.x += q.x;
    acc.y += q.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float x = __shfl_down_sync(0xffffffffu, acc.x, o);
    const float y = __shfl_down_sync(0xffffffffu, acc.y, o);
    if (lane + o < 32) {
      acc.x += x;
      acc.y += y;
    }
  }
  return acc;
}

// Forward, first kernel: each (chunk, channel) block's mean and M2.
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const float* __restrict__ x, float2* __restrict__ partials, int C, int HW, int m) {
  constexpr int R = kTile / (kThreads * V);
  const int chunk = blockIdx.x, c = blockIdx.y;
  __shared__ float buf[2 * kWarps];
  Vec<V> v[R];
  bool ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = slot<V>(chunk, r, c, C, HW, m);
    ok[r] = i >= 0;
    if (ok[r]) v[r].load(x + i);
  }
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ok[r])
#pragma unroll
      for (int k = 0; k < V; ++k) s += v[r].v[k];
  const float count = static_cast<float>(chunk_count(chunk, m));
  const float mean = block_sum2(s, 0.f, buf).x / count;
  float q = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ok[r])
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = v[r].v[k] - mean;
        q += d * d;
      }
  const float m2 = block_sum2(q, 0.f, buf).x;
  if (threadIdx.x == 0) partials[static_cast<long long>(c) * gridDim.x + chunk] = make_float2(mean, m2);
}

// Forward, second kernel: merge the channel's statistics, normalise, scale,
// shift and ReLU; the channel's first block saves the statistics and updates
// the running ones.
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_relu_apply_kernel(const float* __restrict__ x, const float2* __restrict__ partials,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         float* __restrict__ running_mean, float* __restrict__ running_var,
                         float* __restrict__ y, float* __restrict__ save_mean,
                         float* __restrict__ save_invstd, int C, int HW, int m, float momentum,
                         float eps) {
  constexpr int R = kTile / (kThreads * V);
  const int chunk = blockIdx.x, c = blockIdx.y;
  __shared__ float stats[2];
  Vec<V> v[R];
  long long idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    idx[r] = slot<V>(chunk, r, c, C, HW, m);
    if (idx[r] >= 0) v[r].load(x + idx[r]);
  }
  if (threadIdx.x < 32) {
    const Moments s = merge_moments(partials + static_cast<long long>(c) * gridDim.x, gridDim.x, m);
    if (threadIdx.x == 0) {
      const float var = s.m2 / static_cast<float>(m);
      const float invstd = 1.f / sqrtf(var + eps);
      stats[0] = s.mean;
      stats[1] = invstd;
      if (chunk == 0) {
        save_mean[c] = s.mean;
        save_invstd[c] = invstd;
        running_mean[c] = lerp(running_mean[c], s.mean, momentum);
        running_var[c] = lerp(running_var[c], var, momentum);
      }
    }
  }
  __syncthreads();
  const float mean = stats[0];
  const float scale = __fmul_rn(stats[1], gamma[c]);
  const float shift = beta[c];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (idx[r] < 0) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) v[r].v[k] = relu(pre_relu(v[r].v[k], mean, scale, shift));
    v[r].store(y + idx[r]);
  }
}

// Backward, first kernel: each (chunk, channel) block's sum of dz and of
// dz * xhat.
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_relu_bwd_reduce_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                              const float* __restrict__ gamma, const float* __restrict__ beta,
                              const float* __restrict__ save_mean,
                              const float* __restrict__ save_invstd, float2* __restrict__ partials,
                              int C, int HW, int m) {
  constexpr int R = kTile / (kThreads * V);
  const int chunk = blockIdx.x, c = blockIdx.y;
  __shared__ float buf[2 * kWarps];
  const float mean = save_mean[c];
  const float invstd = save_invstd[c];
  const float scale = __fmul_rn(invstd, gamma[c]);
  const float shift = beta[c];
  Vec<V> xv[R], gv[R];
  bool ok[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = slot<V>(chunk, r, c, C, HW, m);
    ok[r] = i >= 0;
    if (ok[r]) {
      xv[r].load(x + i);
      gv[r].load(dy + i);
    }
  }
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ok[r])
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xk = xv[r].v[k];
        const float dz = pre_relu(xk, mean, scale, shift) <= 0.f ? 0.f : gv[r].v[k];
        s1 += dz;
        s2 += dz * ((xk - mean) * invstd);
      }
  const float2 s = block_sum2(s1, s2, buf);
  if (threadIdx.x == 0) partials[static_cast<long long>(c) * gridDim.x + chunk] = s;
}

// Backward, second kernel: merge the channel's sums, write dx; the channel's
// first block writes dgamma and dbeta.
template <int V>
__global__ void __launch_bounds__(kThreads)
    bn_relu_bwd_dx_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          const float* __restrict__ save_mean,
                          const float* __restrict__ save_invstd,
                          const float2* __restrict__ partials, float* __restrict__ dx,
                          float* __restrict__ dgamma, float* __restrict__ dbeta, int C, int HW,
                          int m) {
  constexpr int R = kTile / (kThreads * V);
  const int chunk = blockIdx.x, c = blockIdx.y;
  __shared__ float sums[2];
  Vec<V> xv[R], gv[R];
  long long idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    idx[r] = slot<V>(chunk, r, c, C, HW, m);
    if (idx[r] >= 0) {
      xv[r].load(x + idx[r]);
      gv[r].load(dy + idx[r]);
    }
  }
  if (threadIdx.x < 32) {
    const float2 s = merge_sums(partials + static_cast<long long>(c) * gridDim.x, gridDim.x);
    if (threadIdx.x == 0) {
      sums[0] = s.x;
      sums[1] = s.y;
      if (chunk == 0) {
        dbeta[c] = s.x;
        dgamma[c] = s.y;
      }
    }
  }
  __syncthreads();
  const float mean = save_mean[c];
  const float invstd = save_invstd[c];
  const float g = gamma[c];
  const float scale = __fmul_rn(invstd, g);
  const float shift = beta[c];
  const float k_dx = g * invstd;
  const float a = sums[0] / static_cast<float>(m);
  const float b = sums[1] / static_cast<float>(m);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (idx[r] < 0) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xk = xv[r].v[k];
      const float dz = pre_relu(xk, mean, scale, shift) <= 0.f ? 0.f : gv[r].v[k];
      const float xhat = (xk - mean) * invstd;
      xv[r].v[k] = k_dx * (dz - a - xhat * b);
    }
    xv[r].store(dx + idx[r]);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool valid_shape(int n, int c, int hw) {
  // M = n * hw values a channel, at least 2 and with room for a whole
  // tile past it in int arithmetic; C is the grid's y extent
  const long long m = static_cast<long long>(n) * hw;
  return n >= 1 && hw >= 1 && c >= 1 && c <= 65535 && m >= 2 && m <= (1LL << 30);
}

// Chunks of one channel (blocks along the grid's x): ceil(n * hw / kTile).
// The (C, chunks, 2) float32 scratch each launch takes has this many rows
// a channel.
int chunks(int n, int hw) {
  const long long m = static_cast<long long>(n) * hw;
  return static_cast<int>((m + kTile - 1) / kTile);
}

}  // namespace

// kTile, which the caller's scratch size depends on: the wrapper holds the
// same number and compares it with this once, when the library is loaded.
extern "C" int bn_relu_tile() { return kTile; }

// Forward. x (n, c, hw) contiguous; gamma, beta, running_mean, running_var,
// save_mean, save_invstd (c); partials (c, ceil(n * hw / kTile), 2)
// scratch; y (n, c, hw). All float32 on the device. Updates running_mean
// and running_var in place. Returns the first CUDA error, or 0.
extern "C" int bn_relu_fwd_launch(const float* x, const float* gamma, const float* beta,
                                  float* running_mean, float* running_var, float* partials,
                                  float* y, float* save_mean, float* save_invstd, int n, int c,
                                  int hw, float momentum, float eps, void* stream) {
  if (!valid_shape(n, c, hw)) return static_cast<int>(cudaErrorInvalidValue);
  const int m = n * hw;
  const dim3 grid(chunks(n, hw), c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(partials);
  if (hw % 4 == 0 && aligned16(x) && aligned16(y)) {
    bn_stats_kernel<4><<<grid, kThreads, 0, s>>>(x, part, c, hw, m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bn_relu_apply_kernel<4><<<grid, kThreads, 0, s>>>(x, part, gamma, beta, running_mean, running_var, y,
                                                      save_mean, save_invstd, c, hw, m, momentum, eps);
  } else {
    bn_stats_kernel<1><<<grid, kThreads, 0, s>>>(x, part, c, hw, m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bn_relu_apply_kernel<1><<<grid, kThreads, 0, s>>>(x, part, gamma, beta, running_mean, running_var, y,
                                                      save_mean, save_invstd, c, hw, m, momentum, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward. x, dy, dx (n, c, hw) contiguous; gamma, beta, save_mean,
// save_invstd (the forward's), dgamma, dbeta (c); partials (c,
// ceil(n * hw / kTile), 2) scratch. All float32 on the device. Returns the
// first CUDA error, or 0.
extern "C" int bn_relu_bwd_launch(const float* x, const float* dy, const float* gamma,
                                  const float* beta, const float* save_mean,
                                  const float* save_invstd, float* partials, float* dx,
                                  float* dgamma, float* dbeta, int n, int c, int hw,
                                  void* stream) {
  if (!valid_shape(n, c, hw)) return static_cast<int>(cudaErrorInvalidValue);
  const int m = n * hw;
  const dim3 grid(chunks(n, hw), c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part = reinterpret_cast<float2*>(partials);
  if (hw % 4 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx)) {
    bn_relu_bwd_reduce_kernel<4><<<grid, kThreads, 0, s>>>(x, dy, gamma, beta, save_mean, save_invstd, part,
                                                           c, hw, m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bn_relu_bwd_dx_kernel<4><<<grid, kThreads, 0, s>>>(x, dy, gamma, beta, save_mean, save_invstd, part, dx,
                                                       dgamma, dbeta, c, hw, m);
  } else {
    bn_relu_bwd_reduce_kernel<1><<<grid, kThreads, 0, s>>>(x, dy, gamma, beta, save_mean, save_invstd, part,
                                                           c, hw, m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bn_relu_bwd_dx_kernel<1><<<grid, kThreads, 0, s>>>(x, dy, gamma, beta, save_mean, save_invstd, part, dx,
                                                       dgamma, dbeta, c, hw, m);
  }
  return static_cast<int>(cudaGetLastError());
}
