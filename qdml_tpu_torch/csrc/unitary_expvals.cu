// Per-wire <Z> of complex states after a unitary: psi (B, 2^n) -> <Z> (B, n),
// <Z>[b, q] = sum_j |c[b, j]|^2 * (1 - 2 * bit_q(j)),  c = psi @ U^T.
//
// Replaces the TPU kernel `_fused_kernel` (qdml_tpu/quantum/pallas_kernels.py),
// reached through `fused_unitary_expvals` -> `_fused_forward`: the complex
// product (there three real products on the MXU, Gauss's trick), |c|^2 and
// the sign contraction in one pass, so c never exists in device memory.
//
// What bounds it on an H100: the complex product is 2^n x 2^n multiply-adds
// per row. At the microbench's shape (n = 6, B = 2304) the call reads 1.2 MB
// and does about 58 MFLOP (three real products' worth), so the fp32 rate
// bounds it (0.87 us at 67 TFLOP/s); at n = 12 it is some 2^24 complex
// multiply-adds per row, far above the memory line. The design is a plain
// tiled product with the epilogue fused:
//   - one block of 256 threads (16 x 16) owns a tile of 32 rows of psi and
//     ALL 2^n columns of c, walking the columns in tiles of 64; so every
//     <Z> sum is made inside one block, in a fixed order, without atomics;
//   - per column tile, K-chunks of 32 of psi (32 x 32) and of U^T (32 x 64)
//     are staged through shared memory, loaded along U's and psi's rows
//     (coalesced) and stored transposed with a pitch of one extra float, so
//     neither the stores nor the reads conflict on banks;
//   - each thread accumulates a 2 x 4 micro-tile of c_re and c_im in fp32
//     registers, four fused multiply-adds per complex term (Gauss's three
//     products save a multiply on the MXU, not on the FMA units);
//   - the epilogue squares the micro-tile, contracts each row's four |c|^2
//     with the signs 1 - 2 * bit_q(j) taken from the column index (the sign
//     matrix is never loaded), sums across the 16 threads of a row by warp
//     shuffles, and one thread per row adds the tile's n sums into shared
//     memory;
//   - n is a template parameter, so the n sums sit in registers. Edges
//     (n < 6, a ragged last batch tile) are zero-filled: a zero amplitude
//     adds nothing.
// The TPU kernel's 128-lane padding and its whole-U residency in VMEM were
// TPU artifacts; here U streams through shared memory, so n reaches 12.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 2;
constexpr int kColsPerThread = 4;
constexpr int kTileRows = 16 * kRowsPerThread;  // rows of psi per block
constexpr int kTileCols = 16 * kColsPerThread;  // columns of c per pass
constexpr int kChunk = 32;                      // K-depth staged at a time
constexpr int kMaxN = 12;

template <int N>
__global__ void __launch_bounds__(kThreads)
unitary_expvals_kernel(const float* __restrict__ psi_re, const float* __restrict__ psi_im,
                       const float* __restrict__ u_re, const float* __restrict__ u_im,
                       float* __restrict__ out, int batch) {
  constexpr int kDim = 1 << N;
  __shared__ float a_re[kChunk][kTileRows + 1];  // a[kk][r] = psi[row0 + r, k0 + kk]
  __shared__ float a_im[kChunk][kTileRows + 1];
  __shared__ float b_re[kChunk][kTileCols + 1];  // b[kk][j] = U[j0 + j, k0 + kk]
  __shared__ float b_im[kChunk][kTileCols + 1];
  __shared__ float acc[kTileRows][N];

  const int tx = threadIdx.x % 16;  // columns tx + 16 c
  const int ty = threadIdx.x / 16;  // rows ty + 16 r
  const int row0 = blockIdx.x * kTileRows;
  for (int t = threadIdx.x; t < kTileRows * N; t += kThreads) acc[t / N][t % N] = 0.f;

  for (int j0 = 0; j0 < kDim; j0 += kTileCols) {
    float cr[kRowsPerThread][kColsPerThread], ci[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) cr[r][c] = ci[r][c] = 0.f;
    }
    for (int k0 = 0; k0 < kDim; k0 += kChunk) {
      for (int e = threadIdx.x; e < kTileRows * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        const bool ok = row0 + r < batch && k0 + kk < kDim;
        const size_t src = static_cast<size_t>(row0 + r) * kDim + k0 + kk;
        a_re[kk][r] = ok ? psi_re[src] : 0.f;
        a_im[kk][r] = ok ? psi_im[src] : 0.f;
      }
      for (int e = threadIdx.x; e < kTileCols * kChunk; e += kThreads) {
        const int j = e / kChunk, kk = e % kChunk;
        const bool ok = j0 + j < kDim && k0 + kk < kDim;
        const size_t src = static_cast<size_t>(j0 + j) * kDim + k0 + kk;
        b_re[kk][j] = ok ? __ldg(u_re + src) : 0.f;
        b_im[kk][j] = ok ? __ldg(u_im + src) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        float ar[kRowsPerThread], ai[kRowsPerThread], br[kColsPerThread], bi[kColsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          ar[r] = a_re[kk][ty + 16 * r];
          ai[r] = a_im[kk][ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c) {
          br[c] = b_re[kk][tx + 16 * c];
          bi[c] = b_im[kk][tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
#pragma unroll
          for (int c = 0; c < kColsPerThread; ++c) {
            cr[r][c] = fmaf(ar[r], br[c], cr[r][c]);
            cr[r][c] = fmaf(-ai[r], bi[c], cr[r][c]);
            ci[r][c] = fmaf(ar[r], bi[c], ci[r][c]);
            ci[r][c] = fmaf(ai[r], br[c], ci[r][c]);
          }
        }
      }
      __syncthreads();  // the stage is read; the next one may overwrite it
    }

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float part[N];
#pragma unroll
      for (int q = 0; q < N; ++q) part[q] = 0.f;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        const int j = j0 + tx + 16 * c;
        const float p = cr[r][c] * cr[r][c] + ci[r][c] * ci[r][c];
#pragma unroll
        for (int q = 0; q < N; ++q) part[q] += ((j >> (N - 1 - q)) & 1) ? -p : p;
      }
      // the 16 threads of a row are one half of a warp
#pragma unroll
      for (int q = 0; q < N; ++q) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) part[q] += __shfl_xor_sync(0xffffffffu, part[q], off);
      }
      if (tx == 0) {
#pragma unroll
        for (int q = 0; q < N; ++q) acc[ty + 16 * r][q] += part[q];
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTileRows * N; t += kThreads) {
    const int r = t / N;
    if (row0 + r < batch) out[static_cast<size_t>(row0 + r) * N + t % N] = acc[r][t % N];
  }
}

template <int N>
void launch(const float* psi_re, const float* psi_im, const float* u_re, const float* u_im,
            float* out, int batch, cudaStream_t stream) {
  unitary_expvals_kernel<N><<<(batch + kTileRows - 1) / kTileRows, kThreads, 0, stream>>>(
      psi_re, psi_im, u_re, u_im, out, batch);
}

}  // namespace

// psi_re, psi_im (batch, 2^n): the states; u_re, u_im (2^n, 2^n): U row-major;
// out (batch, n). All float32 on the device. 1 <= n <= 12, batch >= 1.
// Returns cudaGetLastError().
extern "C" int unitary_expvals_launch(const float* psi_re, const float* psi_im,
                                      const float* u_re, const float* u_im, float* out,
                                      int batch, int n, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch<1>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 2: launch<2>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 3: launch<3>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 4: launch<4>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 5: launch<5>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 6: launch<6>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 7: launch<7>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 8: launch<8>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 9: launch<9>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 10: launch<10>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case 11: launch<11>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    case kMaxN: launch<kMaxN>(psi_re, psi_im, u_re, u_im, out, batch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
