// Whole-circuit QSC measurement: angles -> <Z> through a precompiled unitary.
//
// Replaces the TPU kernel `_qsc_kernel` (qdml_tpu/quantum/pallas_kernels.py,
// reached through `fused_qsc_expvals` -> `_qsc_forward`). Per row b:
//   amp[b, i] = prod_q (bit_q(i) ? sin(a_bq / 2) : cos(a_bq / 2))   (real RY product state)
//   c[b, j]   = sum_i amp[b, i] * U[j, i]                            (re and im)
//   out[b, q] = sum_j |c[b, j]|^2 * (1 - 2 * bit_q(j))               (qubit 0 = MSB)
//
// What bounds it on an H100: at the serving shapes (n = 6, D = 64, B = 64) the
// call moves about 35 KB and does about 1 MFLOP, which the card's memory and
// fp32 rates clear in well under a microsecond. What is left is latency: the
// launch, and the chain of dependent steps inside a block. The design keeps
// that chain short and everything but U and the angles out of device memory:
//   - the qubit count is a template parameter, so every loop bound, the rows
//     per block and the thread -> (row, column) map are compile-time
//     constants: loops unroll and no thread issues work for rows it does not
//     own;
//   - one block of 256 threads per tile of (256 / D) * kRowsPerThread rows;
//     the embedded state is built in shared memory from cos/sin and bit
//     tests and never exists in device memory (input traffic is B * n angles,
//     not B * 2^n amplitudes);
//   - U is staged into shared memory transposed, a chunk of columns at a
//     time (all of it at n <= 6, 32 columns at n = 7, 16 at n = 8, whose
//     512 KB would not fit the 227 KB of a block): the loads run along the
//     rows of U, so a warp reads neighbouring floats, and each thread issues
//     all its loads of a chunk at once, the next chunk's while it computes on
//     this one;
//   - each thread owns one output column j and kRowsPerThread rows, reads
//     column j of the staged U^T (neighbouring threads, neighbouring banks)
//     and accumulates c_re, c_im in fp32 registers;
//   - |c|^2 goes to shared memory and one thread per (row, qubit) sums it
//     against the sign 1 - 2 * bit_q(j), computed from the index, so the
//     sign matrix is never loaded (a warp-shuffle reduction per output cost
//     more in dependent shuffles than it saved).
// The TPU's duplicated [amp | amp] layout and 128-lane padding existed to
// fill its matrix unit and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kMaxN = 8;           // D <= 256 = kThreads: one thread per output column
constexpr int kStage = 64 * 65;    // staging floats per re/im: all of U at n = 6

// Widest power-of-two chunk of U's columns whose transposed (chunk, D + 1)
// tile fits the staging buffer.
__host__ __device__ constexpr int chunk_cols(int dim) {
  int c = dim;
  while (c * (dim + 1) > kStage) c >>= 1;
  return c;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
qsc_expvals_kernel(const float* __restrict__ angles, const float* __restrict__ u_re,
                   const float* __restrict__ u_im, float* __restrict__ out, int batch) {
  constexpr int kDim = 1 << N;
  constexpr int kGroups = kThreads / kDim;             // rows sharing one column j
  constexpr int kRows = kGroups * kRowsPerThread;      // rows per block
  constexpr int kChunk = chunk_cols(kDim);             // columns of U per stage
  constexpr int kPitch = kDim + 1;                     // +1: transposing stores spread over banks
  constexpr int kLoads = (kDim * kChunk + kThreads - 1) / kThreads;  // per thread per stage
  constexpr int kVec = kChunk >= 4 ? 4 : 1;            // k steps per float4 read of amp
  __shared__ float half_cs[kRows][N][2];               // cos, sin of a / 2
  __shared__ __align__(16) float amp[kRows][kDim];     // embedded states, then |c|^2
  __shared__ float st_re[kChunk * kPitch];             // st[kk * kPitch + j] = U[j, k0 + kk]
  __shared__ float st_im[kChunk * kPitch];

  const int row0 = blockIdx.x * kRows;
  for (int t = threadIdx.x; t < kRows * N; t += kThreads) {
    const int row = row0 + t / N;
    const float a = row < batch ? angles[row * N + t % N] : 0.f;
    float s, c;
    sincosf(0.5f * a, &s, &c);
    half_cs[t / N][t % N][0] = c;
    half_cs[t / N][t % N][1] = s;
  }

  // element e of a stage: row e / kChunk of U, column k0 + e % kChunk
  float vr[kLoads], vi[kLoads];
  auto load_stage = [&](int k0) {
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int e = threadIdx.x + s * kThreads;
      if (e < kDim * kChunk) {
        const int src = (e / kChunk) * kDim + k0 + e % kChunk;
        vr[s] = __ldg(u_re + src);
        vi[s] = __ldg(u_im + src);
      }
    }
  };
  load_stage(0);  // in flight while the embedding is built

  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {  // kRows * kDim = kThreads * kRowsPerThread
    const int t = threadIdx.x + k * kThreads;
    const int b = t / kDim, x = t % kDim;
    float p = 1.f;
#pragma unroll
    for (int q = 0; q < N; ++q) p *= half_cs[b][q][(x >> (N - 1 - q)) & 1];
    amp[b][x] = p;
  }

  const int j = threadIdx.x % kDim;
  const int g = threadIdx.x / kDim;  // rows g, g + kGroups, ...
  float cr[kRowsPerThread], ci[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) cr[r] = ci[r] = 0.f;

  for (int k0 = 0; k0 < kDim; k0 += kChunk) {
#pragma unroll
    for (int s = 0; s < kLoads; ++s) {
      const int e = threadIdx.x + s * kThreads;
      if (e < kDim * kChunk) {
        st_re[(e % kChunk) * kPitch + e / kChunk] = vr[s];
        st_im[(e % kChunk) * kPitch + e / kChunk] = vi[s];
      }
    }
    __syncthreads();
    if (k0 + kChunk < kDim) load_stage(k0 + kChunk);  // in flight during the FMAs
#pragma unroll 4
    for (int kk = 0; kk < kChunk; kk += kVec) {
      float a[kRowsPerThread][kVec];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if constexpr (kVec == 4) {
          const float4 v = *reinterpret_cast<const float4*>(&amp[g + r * kGroups][k0 + kk]);
          a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
        } else {
          a[r][0] = amp[g + r * kGroups][k0 + kk];
        }
      }
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const float ur = st_re[(kk + v) * kPitch + j];
        const float ui = st_im[(kk + v) * kPitch + j];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          cr[r] = fmaf(a[r][v], ur, cr[r]);
          ci[r] = fmaf(a[r][v], ui, ci[r]);
        }
      }
    }
    __syncthreads();  // the stage and amp are read; both may be overwritten
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) amp[g + r * kGroups][j] = cr[r] * cr[r] + ci[r] * ci[r];
  __syncthreads();

  // one thread per (row, qubit): a serial sum over the row, four partial
  // sums for overlap, each thread starting at its own offset so that the
  // threads of a warp read distinct banks
  for (int o = threadIdx.x; o < kRows * N; o += kThreads) {
    const int b = o / N, q = o % N;
    if (row0 + b >= batch) break;  // o grows with b: every later o is padding too
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int i = 0; i < kDim; ++i) {
      const int x = (i + o) & (kDim - 1);
      const float p = amp[b][x];
      sum[i & 3] += ((x >> (N - 1 - q)) & 1) ? -p : p;
    }
    out[(row0 + b) * N + q] = (sum[0] + sum[1]) + (sum[2] + sum[3]);
  }
}

template <int N>
void launch(const float* angles, const float* u_re, const float* u_im, float* out, int batch,
            cudaStream_t stream) {
  constexpr int kRows = (kThreads >> N) * kRowsPerThread;
  qsc_expvals_kernel<N><<<(batch + kRows - 1) / kRows, kThreads, 0, stream>>>(
      angles, u_re, u_im, out, batch);
}

}  // namespace

// angles (batch, n), u_re/u_im (2^n, 2^n) row-major U, out (batch, n); all
// float32 on the device. 1 <= n <= 8, batch >= 1. Returns cudaGetLastError().
extern "C" int qsc_expvals_launch(const float* angles, const float* u_re, const float* u_im,
                                  float* out, int batch, int n, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch<1>(angles, u_re, u_im, out, batch, s); break;
    case 2: launch<2>(angles, u_re, u_im, out, batch, s); break;
    case 3: launch<3>(angles, u_re, u_im, out, batch, s); break;
    case 4: launch<4>(angles, u_re, u_im, out, batch, s); break;
    case 5: launch<5>(angles, u_re, u_im, out, batch, s); break;
    case 6: launch<6>(angles, u_re, u_im, out, batch, s); break;
    case 7: launch<7>(angles, u_re, u_im, out, batch, s); break;
    case kMaxN: launch<kMaxN>(angles, u_re, u_im, out, batch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
