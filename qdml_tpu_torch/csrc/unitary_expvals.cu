// Per-wire <Z> of complex states after a unitary: psi (B, 2^n) -> <Z> (B, n),
// <Z>[b, q] = sum_j |c[b, j]|^2 * (1 - 2 * bit_q(j)),  c = psi @ U^T.
//
// Replaces the TPU kernel `_fused_kernel` (qdml_tpu/quantum/pallas_kernels.py),
// reached through `fused_unitary_expvals` -> `_fused_forward`: the complex
// product (there three real products on the MXU, Gauss's trick), |c|^2 and
// the sign contraction in one pass, so c never exists in device memory.
//
// What bounds it on an H100: the complex product, 2^n x 2^n complex
// multiply-adds per row. At the microbench's shape (n = 6, B = 2304) the
// call reads 1.2 MB and does about 58 MFLOP (three real products' worth), so
// the fp32 rate bounds it (0.87 us at 67 TFLOP/s); at n = 10 and B = 1 it is
// the 8 MB of U (2.5 us at 3.35 TB/s), at B = 2304 14.5 GFLOP (0.22 ms).
// What the first design lost: a block owned 32 rows and walked all 2^n
// columns alone, so the grid was ceil(B / 32) blocks whatever n was (one SM
// at B = 1: 2.48 ms at n = 10; 72 blocks at B = 2304), with plain loads into
// shared memory and no copy in flight during the products. This design:
//   - the columns are split across blocks: the grid is (row tiles, column
//     tiles); each block makes its tile's n signed sums per row and, when
//     there are several column tiles, writes them to a scratch tensor the
//     wrapper allocates; a second, tiny kernel sums the column tiles in a
//     fixed order. No atomics: the result is the same on every run;
//   - the tile follows the batch and n (the launcher's plan): 4 rows x 8
//     columns with the depth split over 8 groups of threads and K-chunks of
//     256 at B <= 4 (128 blocks streaming U at n = 10, each with 48 KB in
//     flight), 16 x 32 at moderate batch, 16 x 64 at n <= 7 and B >= 512 and
//     32 x 64 from B = 2048 (U's 64 columns staged once a block at n = 6),
//     and 64 x 64 with a 4 x 4 register tile from n = 8 and B >= 1024;
//   - psi and U reach shared memory by cp.async, row-major with a pitch of
//     K + 4 floats (a thread reads 4 k of a row in one 16-byte load; a
//     warp's rows fall on distinct bank groups), double-buffered over
//     K-chunks so the next chunk is in flight during this one's FMAs; ragged
//     rows and columns are zero-filled by the copy;
//   - each thread keeps an RT x CT micro-tile of c_re and c_im in fp32
//     registers, four fused multiply-adds per complex term; the depth
//     groups' partial tiles are added in a fixed order through shared
//     memory;
//   - the epilogue squares the micro-tile, contracts each row's |c|^2 with
//     the signs 1 - 2 * bit_q(j) taken from the column index, and sums across
//     the threads of a row by shuffles.
// The TPU kernel's 128-lane padding and whole-U residency in VMEM were TPU
// artifacts; here U streams through shared memory, so n reaches 14 (U is
// 0.5 GB of re+im at n = 13, 2 GB at n = 14; n = 13, 14 instantiate only the
// plans n >= 8 can select: the small-batch, moderate and 64 x 64 tiles).
// Past 14, U alone (8 GB at n = 15) outgrows any practical use, as the JAX
// kernel's whole-U VMEM residency does. Plain fp32 FMAs: no TF32.
// Measured (device time of both passes, torch profiler; NVIDIA H100 80GB
// HBM3, 700.00 W; the first design in brackets, same call; the complex64
// torch.matmul alone in braces): n = 6: 2.96 us at B = 1 [9.38] {4.54},
// 4.74 at B = 64 [10.01] {5.41}, 5.96 at B = 2304 [10.06] {5.83}; n = 10:
// 8.69 at B = 1 [2499] {3.87}, 37.2 at B = 64 [2722] {17.2}, 606 at B =
// 2304 [2753] {387}. ptxas: 28 to 128 registers (128 on the 64 x 64 tile),
// no spills. Rejected in the same calls: at n = 6, B = 2304 16 x 64 tiles
// 6.84 us, 32 x 64 as 4 x 2 a thread 6.15, 8 x 64 7.60 (taken: 32 x 64 as
// 2 x 4, 5.92); at n = 10, B = 1 4 x 16 tiles with chunks of 64 12.9 us, of
// 128 9.36 (taken: 4 x 8 with chunks of 256, 8.62); a 16 x 32 tile with the
// depth over two groups, 32.6 us at n = 10, B = 64 but 15% slower at B =
// 600 and at n = 12; chunks of 16 on the 64 x 64 tile, 627 against 606 us.
// What is left at n >= 8: the FMA loop shares the SM with its shared-memory
// loads (16 16-byte loads per 256 FMAs a thread), 2.8x the fp32 bound at
// n = 10, B = 2304; 3xTF32 tensor-core products are the next lever.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 14;
constexpr int kStaticSmem = 48 * 1024;

// A tile plan: RT x CT outputs a thread, TY x TX threads over the tile's rows
// and columns, KS groups of threads over the depth of each K-chunk of at
// most KC, at least MinBlocks blocks an SM (the register budget).
template <int RT_, int CT_, int TY_, int TX_, int KS_, int KC_, int MinBlocks_>
struct Plan {
  static constexpr int RT = RT_, CT = CT_, TY = TY_, TX = TX_, KS = KS_, KC = KC_;
  static constexpr int MinBlocks = MinBlocks_;
};
using Small = Plan<1, 1, 4, 8, 8, 256, 2>;    // B <= 4: 4 x 8 tiles, depth over 8 groups
using Mid = Plan<2, 2, 8, 16, 1, 32, 4>;       // 16 x 32 tiles, 128 threads
using Low16 = Plan<2, 2, 8, 32, 1, 64, 2>;     // n <= 7, 512 <= B < 2048: 16 x 64 tiles
using Low32 = Plan<2, 4, 16, 16, 1, 64, 2>;    // n <= 7, B >= 2048: 32 x 64 tiles
using Wide = Plan<4, 4, 16, 16, 1, 32, 2>;     // n >= 8, B >= 1024: 64 x 64 tiles
enum PlanId { kSmall, kMid, kLow16, kLow32, kWide };

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int N, class C>
struct Shape {
  static constexpr int kDim = 1 << N;
  static constexpr int kThreads = C::TY * C::TX * C::KS;
  static constexpr int kRows = C::RT * C::TY;                   // rows of psi a block
  static constexpr int kCols = C::CT * C::TX;                   // columns of c a block
  static constexpr int kColTiles = cmax(1, kDim / kCols);
  static constexpr int kChunk = cmin(kDim, C::KC);              // K-depth staged at a time
  static constexpr int kChunks = kDim / kChunk;
  static constexpr int kStages = kChunks > 1 ? 2 : 1;
  static constexpr int kVec = cmin(kChunk, 4);                  // floats per copy and shared load
  static constexpr int kPitch = kChunk < 4 ? kChunk : kChunk + 4;
  static constexpr int kGroups = cmin(C::KS, kChunk / kVec);    // depth groups with work
  static constexpr int kSub = kChunk / kGroups;                 // depth a group takes per chunk
  // a stage: psi re, psi im (kRows lines each), U re, U im (kCols lines each)
  static constexpr int kLines = 2 * kRows + 2 * kCols;
  static constexpr int kStageFloats = kLines * kPitch;
  static constexpr int kReduceFloats = (C::KS - 1) * C::TY * C::TX * 2 * C::RT * C::CT;
  static constexpr size_t kSmemBytes =
      sizeof(float) * static_cast<size_t>(cmax(kStages * kStageFloats, kReduceFloats));
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Bytes from global to shared memory, or zeros when !ok (src-size 0).
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(Bytes), "r"(ok ? Bytes : 0));
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

template <int N, class C>
__global__ void __launch_bounds__(C::TY * C::TX * C::KS, C::MinBlocks)
unitary_expvals_kernel(const float* __restrict__ psi_re, const float* __restrict__ psi_im,
                       const float* __restrict__ u_re, const float* __restrict__ u_im,
                       float* __restrict__ dst, int batch) {
  using S = Shape<N, C>;
  constexpr int RT = C::RT, CT = C::CT, TY = C::TY, TX = C::TX;
  constexpr int kDim = S::kDim, kChunk = S::kChunk, kVec = S::kVec, kPitch = S::kPitch;
  constexpr int kRows = S::kRows, kCols = S::kCols;
  constexpr int kPieces = kChunk / kVec;  // copies per line per chunk
  extern __shared__ __align__(16) float smem[];

  const int row0 = blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tx = threadIdx.x % TX;
  const int ty = (threadIdx.x / TX) % TY;
  const int kg = threadIdx.x / (TX * TY);

  // lines 0..kRows-1: psi re of rows row0..; then psi im; then U re of rows
  // (columns of c) col0..; then U im
  auto issue = [&](int chunk) {
    const int k0 = chunk * kChunk;
    float* st = smem + (chunk % S::kStages) * S::kStageFloats;
    for (int e = threadIdx.x; e < S::kLines * kPieces; e += S::kThreads) {
      const int line = e / kPieces, piece = e % kPieces;
      const bool is_psi = line < 2 * kRows;
      const int idx = is_psi ? line % kRows : (line - 2 * kRows) % kCols;
      const float* base = is_psi ? (line < kRows ? psi_re : psi_im)
                                 : (line < 2 * kRows + kCols ? u_re : u_im);
      const bool ok = is_psi ? row0 + idx < batch : col0 + idx < kDim;
      const size_t off = ok ? static_cast<size_t>(is_psi ? row0 + idx : col0 + idx) * kDim + k0 +
                                  piece * kVec
                            : 0;
      cp_async<4 * kVec>(st + line * kPitch + piece * kVec, base + off, ok);
    }
    cp_async_commit();
  };

  float cr[RT][CT], ci[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < CT; ++c) cr[r][c] = ci[r][c] = 0.f;
  }

  issue(0);
  for (int chunk = 0; chunk < S::kChunks; ++chunk) {
    if (chunk + 1 < S::kChunks) {
      issue(chunk + 1);  // in flight during this chunk's products
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = smem + (chunk % S::kStages) * S::kStageFloats;
    const float* are = st;
    const float* aim = st + kRows * kPitch;
    const float* bre = st + 2 * kRows * kPitch;
    const float* bim = bre + kCols * kPitch;
    if (kg < S::kGroups) {
#pragma unroll
      for (int i = 0; i < S::kSub / kVec; ++i) {
        const int kk = kg * S::kSub + i * kVec;
        float ar[RT][kVec], ai[RT][kVec], br[CT][kVec], bi[CT][kVec];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          load_vec(are + (ty + TY * r) * kPitch + kk, ar[r]);
          load_vec(aim + (ty + TY * r) * kPitch + kk, ai[r]);
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          load_vec(bre + (tx + TX * c) * kPitch + kk, br[c]);
          load_vec(bim + (tx + TX * c) * kPitch + kk, bi[c]);
        }
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
#pragma unroll
            for (int c = 0; c < CT; ++c) {
              cr[r][c] = fmaf(ar[r][v], br[c][v], cr[r][c]);
              cr[r][c] = fmaf(-ai[r][v], bi[c][v], cr[r][c]);
              ci[r][c] = fmaf(ar[r][v], bi[c][v], ci[r][c]);
              ci[r][c] = fmaf(ai[r][v], br[c][v], ci[r][c]);
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is read; the copy after next may overwrite it
  }

  if constexpr (C::KS > 1) {
    // the depth groups' partial tiles, added to group 0's in group order
    constexpr int kTile = 2 * RT * CT;
    const int t = threadIdx.x % (TX * TY);
    if (kg > 0) {
      float* mine = smem + ((kg - 1) * TX * TY + t) * kTile;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          mine[2 * (r * CT + c)] = cr[r][c];
          mine[2 * (r * CT + c) + 1] = ci[r][c];
        }
      }
    }
    __syncthreads();
    if (kg > 0) return;  // whole warps: a group is a multiple of 32 threads
    for (int g = 1; g < C::KS; ++g) {
      const float* theirs = smem + ((g - 1) * TX * TY + t) * kTile;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          cr[r][c] += theirs[2 * (r * CT + c)];
          ci[r][c] += theirs[2 * (r * CT + c) + 1];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float part[N];
#pragma unroll
    for (int q = 0; q < N; ++q) part[q] = 0.f;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int j = col0 + tx + TX * c;  // past 2^n (small n) the copy zero-filled U: p = 0
      const float p = cr[r][c] * cr[r][c] + ci[r][c] * ci[r][c];
#pragma unroll
      for (int q = 0; q < N; ++q) part[q] += ((j >> (N - 1 - q)) & 1) ? -p : p;
    }
    // the TX threads of a row are an aligned run of lanes
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < N; ++q) part[q] += __shfl_xor_sync(0xffffffffu, part[q], off);
    }
    const int row = row0 + ty + TY * r;
    if (tx == 0 && row < batch) {
      float* o = dst + (static_cast<size_t>(blockIdx.y) * batch + row) * N;
#pragma unroll
      for (int q = 0; q < N; ++q) o[q] = part[q];
    }
  }
}

// out[i] = sum over the column tiles of partial[t, i], t = 0, 1, ... in order.
__global__ void unitary_expvals_reduce_kernel(const float* __restrict__ partial,
                                              float* __restrict__ out, int count, int tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += partial[static_cast<size_t>(t) * count + i];
  out[i] = s;
}

PlanId plan_for(int n, int batch) {
  if (batch <= 4) return kSmall;
  if (n <= 7) return batch >= 2048 ? kLow32 : batch >= 512 ? kLow16 : kMid;
  return batch >= 1024 ? kWide : kMid;
}

int col_tiles(int n, PlanId plan) {
  const int cols = plan == kSmall ? Small::CT * Small::TX
                 : plan == kMid   ? Mid::CT * Mid::TX
                 : plan == kLow16 ? Low16::CT * Low16::TX
                 : plan == kLow32 ? Low32::CT * Low32::TX
                                  : Wide::CT * Wide::TX;
  return (1 << n) > cols ? (1 << n) / cols : 1;
}

template <int N, class C>
cudaError_t run(const float* psi_re, const float* psi_im, const float* u_re, const float* u_im,
                float* out, float* partial, int batch, cudaStream_t stream) {
  using S = Shape<N, C>;
  const auto kern = unitary_expvals_kernel<N, C>;
  cudaError_t err;
  if (S::kSmemBytes > kStaticSmem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(S::kSmemBytes));
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + S::kRows - 1) / S::kRows, S::kColTiles);
  kern<<<grid, S::kThreads, S::kSmemBytes, stream>>>(psi_re, psi_im, u_re, u_im,
                                                    S::kColTiles > 1 ? partial : out, batch);
  if (S::kColTiles > 1) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int count = batch * N;
    unitary_expvals_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(partial, out, count,
                                                                          S::kColTiles);
  }
  return cudaGetLastError();
}

template <int N>
cudaError_t run_n(PlanId plan, const float* psi_re, const float* psi_im, const float* u_re,
                  const float* u_im, float* out, float* partial, int batch, cudaStream_t s) {
  switch (plan) {
    case kSmall: return run<N, Small>(psi_re, psi_im, u_re, u_im, out, partial, batch, s);
    case kMid: return run<N, Mid>(psi_re, psi_im, u_re, u_im, out, partial, batch, s);
    case kLow16:
      if constexpr (N <= 7) return run<N, Low16>(psi_re, psi_im, u_re, u_im, out, partial, batch, s);
      break;
    case kLow32:
      if constexpr (N <= 7) return run<N, Low32>(psi_re, psi_im, u_re, u_im, out, partial, batch, s);
      break;
    case kWide:
      if constexpr (N >= 8) return run<N, Wide>(psi_re, psi_im, u_re, u_im, out, partial, batch, s);
      break;
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Column tiles of a launch at this batch and n: the leading size of the
// `partial` scratch (tiles, batch, n) when above 1, else no scratch is read
// (0 outside the window).
extern "C" int unitary_expvals_tiles(int batch, int n) {
  if (n < 1 || n > kMaxN || batch < 1) return 0;
  return col_tiles(n, plan_for(n, batch));
}

// psi_re, psi_im (batch, 2^n): the states; u_re, u_im (2^n, 2^n): U row-major;
// out (batch, n); partial (tiles, batch, n) scratch when
// unitary_expvals_tiles(batch, n) > 1, else may be null. All float32 on the
// device, psi and U on a 4 * min(2^n, 4)-byte boundary. 1 <= n <= 14,
// batch >= 1. One or two kernel launches (the second sums the column tiles).
// Returns the first CUDA error, or 0.
extern "C" int unitary_expvals_launch(const float* psi_re, const float* psi_im,
                                      const float* u_re, const float* u_im, float* out,
                                      float* partial, int batch, int n, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const PlanId plan = plan_for(n, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 1: err = run_n<1>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 2: err = run_n<2>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 3: err = run_n<3>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 4: err = run_n<4>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 5: err = run_n<5>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 6: err = run_n<6>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 7: err = run_n<7>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 8: err = run_n<8>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 9: err = run_n<9>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 10: err = run_n<10>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 11: err = run_n<11>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 12: err = run_n<12>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case 13: err = run_n<13>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    case kMaxN: err = run_n<kMaxN>(plan, psi_re, psi_im, u_re, u_im, out, partial, batch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
