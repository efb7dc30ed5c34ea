// Whole-circuit QSC measurement: angles -> <Z> through a precompiled unitary.
//
// Replaces the TPU kernel `_qsc_kernel` (qdml_tpu/quantum/pallas_kernels.py,
// reached through `fused_qsc_expvals` -> `_qsc_forward`). Per row b:
//   amp[b, i] = prod_q (bit_q(i) ? sin(a_bq / 2) : cos(a_bq / 2))   (real RY product state)
//   c[b, j]   = sum_i amp[b, i] * U[j, i]                            (re and im)
//   out[b, q] = sum_j |c[b, j]|^2 * (1 - 2 * bit_q(j))               (qubit 0 = MSB)
//
// What bounds it on an H100: at the serving and eval shapes (n = 6, B = 64
// and 200) the call moves about 35 KB and does about 1-3 MFLOP, which the
// card clears in well under a microsecond: what is left is the launch and
// the chain of dependent steps inside one block. At the microbench and
// training shape (B = 2304) and at n = 8 the product is the work (0.6 GFLOP
// at n = 8, B = 2304: 9 us at the fp32 rate), and the first design restaged
// all of U (512 KB at n = 8) from L2 for every 4 rows: 576 blocks, ~300 MB
// of L2 reads. The design:
//   - n and the tile, R rows and C columns per thread, are template
//     parameters; the launcher takes one row and one column at small batch
//     (the shortest chain per block: 16 blocks at n = 6, B = 64) and a wide
//     tile at large batch (32 rows a block at n = 6 and 8, B = 2304: U read
//     once per 32 rows, each loaded amplitude feeding 2C FMAs);
//   - the embedded state is built in shared memory from cos/sin and bit
//     tests (input traffic is B * n angles, not B * 2^n amplitudes);
//   - U goes straight from device memory into shared memory with cp.async
//     (no register hop), row-major with a pitch of K + 4 floats, so that a
//     thread reads 4 k of its row in one 16-byte load and a warp's 32 rows
//     fall on distinct bank groups; all of U in one copy at n <= 6, in
//     double-buffered chunks of 32 and 16 columns at n = 7 and 8 (two
//     blocks fit an SM), the next chunk in flight during this one's FMAs;
//     the first copy starts before the angles load;
//   - the sign contraction is a shuffle reduction over the lanes that share
//     a row, all n wires' sums interleaved as independent chains, then,
//     where a row spans warps, a fixed-order sum over warps: no serial
//     2^n-long loop and no atomics.
// The TPU's duplicated [amp | amp] layout and 128-lane padding existed to
// fill its matrix unit and are not carried over. Plain fp32 FMAs: no TF32.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; the first design
// on the same card in brackets): n = 6 at B = 64, 200 and 2304 2.52, 2.56
// and 4.70 us of device time (4.30, 4.28, 5.99); n = 8 at B = 64 and 2304
// 12.2 and 40.3 us (29.3, 102.9); a one-element add takes
// 1.14 us on the same card. At n = 8, B = 2304 the wide tile (210
// registers, one block an SM, 72 blocks) is held by the shared-memory
// loads of the embedded amplitudes and the chunk barriers, 4.4x its bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 8;  // D <= 256 = kThreads: one thread per output column
constexpr int kStaticSmem = 48 * 1024;

// A block's tile for n qubits, R rows and C columns per thread: the threads
// of a row group cover the 2^n columns, C each (columns jt + c * 2^n / C).
template <int N, int R, int C>
struct Shape {
  static constexpr int kDim = 1 << N;
  static constexpr int kColThreads = kDim / C;                   // threads per row group
  static constexpr int kGroups = kThreads / kColThreads;         // row groups
  static constexpr int kRows = kGroups * R;                      // rows per block
  // columns of U per copy: all of it up to n = 6, else 4096 / 2^n (32 at
  // n = 7, 16 at n = 8), so that two stages leave room for two blocks an SM
  static constexpr int kChunk = kDim * kDim <= 4096 ? kDim : 4096 / kDim;
  static constexpr int kChunks = kDim / kChunk;
  static constexpr int kStages = kChunks > 1 ? 2 : 1;
  static constexpr int kVec = kChunk < 4 ? kChunk : 4;           // floats per shared load
  static constexpr int kPitch = kChunk < 4 ? kChunk : kChunk + 4;
  static constexpr int kLanes = kColThreads < 32 ? kColThreads : 32;  // lanes sharing a row
  static constexpr int kRowWarps = kColThreads / kLanes;         // warps sharing a row
  static constexpr size_t kSmemFloats = 2 * kStages * kDim * kPitch + kRows * kDim +
                                        kRows * N * 2 + kRows * kRowWarps * N;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(Bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int N, int R, int C>
__global__ void __launch_bounds__(kThreads)
qsc_expvals_kernel(const float* __restrict__ angles, const float* __restrict__ u_re,
                   const float* __restrict__ u_im, float* __restrict__ out, int batch) {
  using S = Shape<N, R, C>;
  constexpr int kDim = S::kDim, kG = S::kGroups, kChunk = S::kChunk, kPitch = S::kPitch;
  constexpr int kVec = S::kVec, kCT = S::kColThreads;
  constexpr int kRows = S::kRows;
  constexpr int kStage = kDim * kPitch;               // floats per stage per re/im
  constexpr int kCopies = kDim * (kChunk / kVec);     // vectors per chunk per re/im
  extern __shared__ __align__(16) float smem[];
  float* st_re = smem;                                // (stages, kDim, kPitch): U[j, k0 + kk]
  float* st_im = st_re + S::kStages * kStage;
  float* amp = st_im + S::kStages * kStage;           // (kRows, kDim): embedded states
  float* half_cs = amp + kRows * kDim;                // (kRows, N, 2): cos, sin of a / 2
  float* red = half_cs + kRows * N * 2;               // (kRows, kRowWarps, N)

  auto copy_chunk = [&](int c) {
    const int k0 = c * kChunk;
    float* dre = st_re + (c % S::kStages) * kStage;
    float* dim_ = st_im + (c % S::kStages) * kStage;
    for (int e = threadIdx.x; e < kCopies; e += kThreads) {
      const int row = e / (kChunk / kVec), kk = (e % (kChunk / kVec)) * kVec;
      cp_async<4 * kVec>(dre + row * kPitch + kk, u_re + row * kDim + k0 + kk);
      cp_async<4 * kVec>(dim_ + row * kPitch + kk, u_im + row * kDim + k0 + kk);
    }
    cp_async_commit();
  };
  copy_chunk(0);  // in flight while the embedding is built
  if (S::kChunks > 1) copy_chunk(1);

  const int row0 = blockIdx.x * kRows;
  for (int t = threadIdx.x; t < kRows * N; t += kThreads) {
    const int row = row0 + t / N;
    const float a = row < batch ? angles[row * N + t % N] : 0.f;
    float s, c;
    sincosf(0.5f * a, &s, &c);
    half_cs[2 * t] = c;
    half_cs[2 * t + 1] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R * C; ++k) {  // kRows * kDim = kThreads * R * C
    const int t = threadIdx.x + k * kThreads;
    const int b = t / kDim, x = t % kDim;
    const float* h = half_cs + 2 * N * b;
    float p = 1.f;
#pragma unroll
    for (int q = 0; q < N; ++q) p *= h[2 * q + ((x >> (N - 1 - q)) & 1)];
    amp[t] = p;
  }

  const int jt = threadIdx.x % kCT;  // columns jt, jt + kCT, ...
  const int g = threadIdx.x / kCT;   // rows g, g + kG, ...
  float cr[R][C], ci[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) cr[r][c] = ci[r][c] = 0.f;

#pragma unroll 1
  for (int c = 0; c < S::kChunks; ++c) {
    if (S::kChunks > 1 && c + 1 < S::kChunks) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();  // chunk c (and, at c = 0, the embedding) visible to all
    const float* ur_row = st_re + (c % S::kStages) * kStage + jt * kPitch;
    const float* ui_row = st_im + (c % S::kStages) * kStage + jt * kPitch;
    const float* a_col = amp + c * kChunk;
#pragma unroll 4
    for (int kk = 0; kk < kChunk; kk += kVec) {
      float ur[C][kVec], ui[C][kVec];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) {
        load_vec<kVec>(ur_row + cc * kCT * kPitch + kk, ur[cc]);
        load_vec<kVec>(ui_row + cc * kCT * kPitch + kk, ui[cc]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a[kVec];
        load_vec<kVec>(a_col + (g + r * kG) * kDim + kk, a);
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            cr[r][cc] = fmaf(a[v], ur[cc][v], cr[r][cc]);
            ci[r][cc] = fmaf(a[v], ui[cc][v], ci[r][cc]);
          }
      }
    }
    if (c + 2 < S::kChunks) {
      __syncthreads();  // every thread is done with this stage
      copy_chunk(c + 2);
    }
  }

  // <Z>: each thread's |c|^2 times the sign of its column for every wire,
  // reduced over the lanes that share the row (n chains interleaved)
  constexpr int kLanes = S::kLanes;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float z[N];
#pragma unroll
    for (int q = 0; q < N; ++q) z[q] = 0.f;
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      const int j = jt + cc * kCT;
      const float p = cr[r][cc] * cr[r][cc] + ci[r][cc] * ci[r][cc];
#pragma unroll
      for (int q = 0; q < N; ++q) z[q] += ((j >> (N - 1 - q)) & 1) ? -p : p;
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < N; ++q) z[q] += __shfl_xor_sync(0xffffffffu, z[q], off);
    }
    const int b = g + r * kG;
    if constexpr (S::kRowWarps == 1) {
      if ((lane & (kLanes - 1)) == 0 && row0 + b < batch) {
#pragma unroll
        for (int q = 0; q < N; ++q) out[(row0 + b) * N + q] = z[q];
      }
    } else if (lane == 0) {
#pragma unroll
      for (int q = 0; q < N; ++q) red[(b * S::kRowWarps + jt / 32) * N + q] = z[q];
    }
  }
  if constexpr (S::kRowWarps > 1) {
    __syncthreads();
    for (int o = threadIdx.x; o < kRows * N; o += kThreads) {
      const int b = o / N, q = o % N;
      if (row0 + b >= batch) break;  // o grows with b: every later o is padding too
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < S::kRowWarps; ++w) sum += red[(b * S::kRowWarps + w) * N + q];
      out[(row0 + b) * N + q] = sum;
    }
  }
}

int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 1;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int count = 1;
  if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) count = 1;
  if (dev < 64) cached[dev] = count;
  return count;
}

template <int N, int R, int C>
cudaError_t launch_rows(const float* angles, const float* u_re, const float* u_im, float* out,
                        int batch, cudaStream_t stream) {
  constexpr int kRows = Shape<N, R, C>::kRows;
  constexpr size_t smem = sizeof(float) * Shape<N, R, C>::kSmemFloats;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(qsc_expvals_kernel<N, R, C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  qsc_expvals_kernel<N, R, C><<<(batch + kRows - 1) / kRows, kThreads, smem, stream>>>(
      angles, u_re, u_im, out, batch);
  return cudaGetLastError();
}

// The tile for a large batch: R rows and C columns per thread, so that each
// embedded amplitude loaded from shared memory feeds 2C FMAs and each U
// vector 8R (on an H100 at B = 2304 these beat one column a thread with up
// to 32 rows, at n = 6 and 8).
constexpr int large_rows(int n) { return n == 8 ? 8 : 4; }
constexpr int large_cols(int n) { return n <= 5 ? 1 : (n == 6 ? 2 : 4); }

// The large tile once it still gives a block to every other SM, else one row
// and one column per thread: the shortest chain per block at small batch.
template <int N>
cudaError_t launch(const float* angles, const float* u_re, const float* u_im, float* out, int batch,
                   cudaStream_t stream) {
  constexpr int R = large_rows(N), C = large_cols(N);
  if (2L * batch >= static_cast<long>(sm_count()) * Shape<N, R, C>::kRows)
    return launch_rows<N, R, C>(angles, u_re, u_im, out, batch, stream);
  return launch_rows<N, 1, 1>(angles, u_re, u_im, out, batch, stream);
}

}  // namespace

// angles (batch, n), u_re/u_im (2^n, 2^n) row-major U, out (batch, n); all
// float32 on the device. 1 <= n <= 8, batch >= 1. Returns the first CUDA
// error, or 0.
extern "C" int qsc_expvals_launch(const float* angles, const float* u_re, const float* u_im,
                                  float* out, int batch, int n, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 1: err = launch<1>(angles, u_re, u_im, out, batch, s); break;
    case 2: err = launch<2>(angles, u_re, u_im, out, batch, s); break;
    case 3: err = launch<3>(angles, u_re, u_im, out, batch, s); break;
    case 4: err = launch<4>(angles, u_re, u_im, out, batch, s); break;
    case 5: err = launch<5>(angles, u_re, u_im, out, batch, s); break;
    case 6: err = launch<6>(angles, u_re, u_im, out, batch, s); break;
    case 7: err = launch<7>(angles, u_re, u_im, out, batch, s); break;
    case kMaxN: err = launch<kMaxN>(angles, u_re, u_im, out, batch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
