// The quantum classifier's CNN front end, forward and backward, each as one
// launch: QSCPreprocess (qdml_tpu_torch/models/cnn.py), the reference
// QSC_P128's `preprocess`:
//   conv1 (2 -> 16, 3x3, pad 1, bias) -> ReLU -> max-pool 2 ->
//   conv2 (16 -> 32, 3x3, pad 1, bias) -> ReLU -> max-pool 2 ->
//   flatten (torch's C-major order) -> Linear (32 * H/4 * W/4 -> n) -> tanh,
// an (B, 2, H, W) image batch to the circuit's (B, n) angles.
//
// Replaces no TPU kernel: the JAX package leaves these convolutions, pools
// and the Linear to XLA. On the H100 the port ran them as cuDNN's FFT
// convolutions (fft2d_r2c/c2r and a complex GEMM for each 3x3 layer on an
// 8x4 or 16x8 image), its alg0 weight-gradient engine, torch's max-pool and
// its backward, and a dozen elementwise passes: about 0.94 ms of the 1.62 ms
// QSC training step at B = 2304, n = 8, some 5% of the front end's bound.
//
// What bounds it on an H100: FFMA operations. A sample's forward is 186,368
// multiply-adds (conv1 36,864, conv2 147,456, the Linear 2,048 at n = 8); its
// backward recomputes the forward and adds the Linear's gradients, conv2's
// weight and input gradients and conv1's weight gradient, 522,240
// multiply-adds counted dense. At B = 2304 that is 0.86 and 2.41 GFLOP:
// 12.8 us forward and 36 us backward at 67 TFLOP/s of float32 FFMA, against
// 2.4 MB of input and 30 KB of weights, so the bytes never bound it.
//
// The design:
//   - one 256-thread block takes two rows at a time (a chunk), each row a
//     128-thread group, and keeps every weight in shared memory, rearranged
//     so that the threads' tiles read 2 or 4 output channels as one 8- or
//     16-byte load; the row's intermediates (padded input, pooled conv1
//     output, pooled conv2 output, pool indices) never leave shared memory;
//   - each thread computes a register tile that reuses every loaded value
//     over several FMAs: conv1 2 channels x 2 x 4 positions (a pool window
//     pair), conv2 4 channels x a 2x2 pool window over half the input
//     channels, the halves summed by a shuffle; conv2's input gradient 4
//     input channels x 2x2 positions over a quarter of the output channels,
//     summed by two shuffles; conv2's weight gradient 2 output channels x 9
//     taps of one input channel over 2x2 positions; plane strides are odd so
//     the 16 input channels of a warp fall in 16 banks;
//   - the blocks are persistent: as many as fit on the card at once
//     (occupancy x SMs, or fewer for a small batch), block b taking chunks b,
//     b + grid, ...; with two blocks an SM at B = 2304 the 1152 chunks give
//     an SM 8 or 9 chunks. A block loads its weights with every load in
//     flight before the first store, and each chunk's input one chunk ahead
//     into registers, so the loads overlap the compute;
//   - the published 16 x 8 image has its own instantiation, in which every
//     shared-memory offset is a constant (other sizes read theirs at run
//     time): on an H100 6% faster in both directions than the run-time
//     offsets, and bit for bit the same sums;
//   - the backward recomputes the forward in the block rather than reading
//     saved activations (saving them would cost 19 MB of traffic a step).
//     Pool masks follow torch's max_pool2d (the first maximum in scan order,
//     a NaN taken), ReLU's backward torch's threshold_backward on the
//     output (the gradient where the output is not <= 0). dz at conv1 is
//     nonzero only at each pool window's argmax, so conv1's weight gradient
//     reads one input patch a pooled value (a quarter of the dense work);
//   - weight gradients are summed in each block's registers and shared
//     memory over its rows, written as the block's partial, and a second
//     kernel of the same launch sums the partials in a fixed order: no
//     atomics and no TF32, float32 FFMA throughout, so an eager call, a graph
//     replay and two runs agree bit for bit on one card.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                     // a block
constexpr int kRowThreads = 128;                  // threads on one row in the row phases
constexpr int kRows = kThreads / kRowThreads;     // rows a chunk
constexpr int kIn = 2, kC1 = 16, kC2 = 32, kTaps = 9;
constexpr int kW1 = kC1 * kIn * kTaps;            // 288
constexpr int kW2 = kC2 * kC1 * kTaps;            // 4608
constexpr int kSplits = kThreads / (kC1 * kIn);   // conv1 weight-gradient splits over pooled positions
constexpr int kMaxN = 32;
constexpr int kStaticSmem = 48 * 1024;
// the partials' layout: the six gradients in the parameters' own order
constexpr int kOffB1 = kW1, kOffW2 = kOffB1 + kC1, kOffB2 = kOffW2 + kW2, kOffFc = kOffB2 + kC2;

__host__ __device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

// Where everything lives in the block's shared memory, in floats. Per row
// slot: the zero-padded input (2 planes), the pooled conv1 output
// zero-padded for conv2 (16 planes; overwritten in the backward by its
// masked gradient), the pooled conv2 output (the features), the two pools'
// argmax codes (bytes), the Linear's per-warp partial sums, and in the
// backward the zero-padded gradient at conv2's output (32 planes) and the
// gradient at the Linear's output.
struct Plan {
  int h, w, n, h2, w2, h3, w3, f;
  int xp, ap;  // row pitch of the padded input and of the padded pooled planes
  int xs, as;  // their plane strides, odd
  int r_x, r_a, r_feat, r_c1, r_c2, r_scr, r_d, r_du, row;
  int o_w1, o_b1, o_w2, o_w2t, o_b2, o_fc, o_fcb, o_gfc, o_gfcb, o_rows, rows_floats, total;
};

__host__ __device__ inline Plan make_plan(int h, int w, int n, bool bwd) {
  Plan p{};
  p.h = h;
  p.w = w;
  p.n = n;
  p.h2 = h / 2;
  p.w2 = w / 2;
  p.h3 = h / 4;
  p.w3 = w / 4;
  p.f = kC2 * p.h3 * p.w3;
  p.xp = w + 2;
  p.ap = p.w2 + 2;
  p.xs = ((h + 2) * p.xp) | 1;
  p.as = ((p.h2 + 2) * p.ap) | 1;
  int o = 0;
  p.r_x = o;
  o += up4(kIn * p.xs);
  p.r_a = o;
  o += up4(kC1 * p.as);
  p.r_feat = o;
  o += up4(p.f);
  p.r_c1 = o;
  o += up4((kC1 * p.h2 * p.w2 + 3) / 4);
  p.r_c2 = o;
  o += up4((p.f + 3) / 4);
  p.r_scr = o;
  o += (kRowThreads / 32) * kMaxN;
  p.r_d = o;
  if (bwd) o += up4(kC2 * p.as);
  p.r_du = o;
  if (bwd) o += kMaxN;
  p.row = o;
  o = 0;
  p.o_w1 = o;
  o += up4(kW1);
  p.o_b1 = o;
  o += up4(kC1);
  p.o_w2 = o;
  o += up4(kW2);
  p.o_w2t = o;
  if (bwd) o += up4(kW2);
  p.o_b2 = o;
  o += up4(kC2);
  p.o_fc = o;
  o += up4(n * p.f);
  p.o_fcb = o;
  o += up4(n);
  p.o_gfc = o;
  if (bwd) o += up4(n * p.f);
  p.o_gfcb = o;
  if (bwd) o += up4(n);
  p.o_rows = o;
  p.rows_floats = kRows * p.row;
  // the backward's end reuses the rows for conv1's split weight gradients
  if (bwd && p.rows_floats < kSplits * (kW1 + kC1)) p.rows_floats = kSplits * (kW1 + kC1);
  p.total = o + p.rows_floats;
  return p;
}

// torch's relu: NaN passes, -0 and below become +0
__device__ __forceinline__ float relu(float v) { return v <= 0.f ? 0.f : v; }

// torch's max_pool2d over one 2x2 window in scan order (row by row): the
// first maximum, a NaN taken. Returns its index 0..3.
__device__ __forceinline__ int pool4(float r0, float r1, float r2, float r3, float& m) {
  int idx = 0;
  m = r0;
  if (r1 > m || isnan(r1)) { m = r1; idx = 1; }
  if (r2 > m || isnan(r2)) { m = r2; idx = 2; }
  if (r3 > m || isnan(r3)) { m = r3; idx = 3; }
  return idx;
}

// conv1 + bias -> ReLU -> pool for one row. An item is 2 output channels x
// a 2 x 4 block of conv positions (two pool windows): 8 channel pairs x H/2
// x W/4 items.
__device__ __forceinline__ void conv1_pool(const Plan& p, const float* s, const float* xpad, float* a1,
                                           unsigned char* code1, int lt) {
  const int xq_n = p.w / 4;
  const int items = 8 * p.h2 * xq_n;
  for (int item = lt; item < items; item += kRowThreads) {
    const int cp = item & 7, rest = item >> 3;
    const int yq = rest / xq_n, xq = rest - yq * xq_n;
    float acc[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) acc[c][dy][dx] = 0.f;
#pragma unroll
    for (int ci = 0; ci < kIn; ++ci) {
      const float* src = xpad + ci * p.xs + 2 * yq * p.xp + 4 * xq;
      float v[4][6];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j) v[i][j] = src[i * p.xp + j];
      const float2* wv = reinterpret_cast<const float2*>(s + p.o_w1 + ci * kTaps * kC1) + cp;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float2 wk = wv[k * (kC1 / 2)];
        const int ky = k / 3, kx = k % 3;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 4; ++dx) {
            const float t = v[dy + ky][dx + kx];
            acc[0][dy][dx] = fmaf(wk.x, t, acc[0][dy][dx]);
            acc[1][dy][dx] = fmaf(wk.y, t, acc[1][dy][dx]);
          }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int co = 2 * cp + c;
      const float bias = s[p.o_b1 + co];
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        float m;
        const int idx = pool4(relu(acc[c][0][2 * px] + bias), relu(acc[c][0][2 * px + 1] + bias),
                              relu(acc[c][1][2 * px] + bias), relu(acc[c][1][2 * px + 1] + bias), m);
        const int X = 2 * xq + px;
        a1[co * p.as + (yq + 1) * p.ap + X + 1] = m;
        code1[(co * p.h2 + yq) * p.w2 + X] = static_cast<unsigned char>(idx);
      }
    }
  }
}

// conv2 + bias -> ReLU -> pool for one row. An item is 4 output channels x
// one pool window over half the input channels (the halves are lanes l and
// l ^ 1, summed by a shuffle): 8 channel quads x 2 halves x H/4 x W/4 items.
__device__ __forceinline__ void conv2_pool(const Plan& p, const float* s, const float* a1, float* feat,
                                           unsigned char* code2, int lt) {
  const int items = 16 * p.h3 * p.w3;
  const int lane = lt & 31;
  for (int base = lt - lane; base < items; base += kRowThreads) {
    const int item = base + lane;
    const bool ok = item < items;  // items is a multiple of 16: pairs are valid together
    const int it = ok ? item : (item & 15);
    const int hf = it & 1, cq = (it >> 1) & 7, pos = it >> 4;
    const int yq = pos / p.w3, xq = pos - yq * p.w3;
    float acc[4][2][2];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) acc[c][dy][dx] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < kC1 / 2; ++cc) {
      const int ci = 2 * cc + hf;
      const float* src = a1 + ci * p.as + 2 * yq * p.ap + 2 * xq;
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = src[i * p.ap + j];
      const float4* wv = reinterpret_cast<const float4*>(s + p.o_w2 + ci * kTaps * kC2) + cq;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float4 wk = wv[k * (kC2 / 4)];
        const int ky = k / 3, kx = k % 3;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float t = v[dy + ky][dx + kx];
            acc[0][dy][dx] = fmaf(wk.x, t, acc[0][dy][dx]);
            acc[1][dy][dx] = fmaf(wk.y, t, acc[1][dy][dx]);
            acc[2][dy][dx] = fmaf(wk.z, t, acc[2][dy][dx]);
            acc[3][dy][dx] = fmaf(wk.w, t, acc[3][dy][dx]);
          }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) acc[c][dy][dx] += __shfl_xor_sync(0xffffffffu, acc[c][dy][dx], 1);
    if (ok) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if ((c >> 1) != hf) continue;  // each half writes two of the four channels
        const int co = 4 * cq + c;
        const float bias = s[p.o_b2 + co];
        float m;
        const int idx = pool4(relu(acc[c][0][0] + bias), relu(acc[c][0][1] + bias), relu(acc[c][1][0] + bias),
                              relu(acc[c][1][1] + bias), m);
        const int fi = (co * p.h3 + yq) * p.w3 + xq;
        feat[fi] = m;
        code2[fi] = static_cast<unsigned char>(idx);
      }
    }
  }
}

// The Linear's per-warp partial sums for one row: thread lt takes features
// lt, lt + 128, ...; each warp's sums land in scr[warp][j].
template <int NMAX>
__device__ __forceinline__ void linear_partial(const Plan& p, const float* s, const float* feat, float* scr,
                                               int lt) {
  float part[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) part[j] = 0.f;
  for (int f = lt; f < p.f; f += kRowThreads) {
    const float a = feat[f];
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < p.n) part[j] = fmaf(s[p.o_fc + j * p.f + f], a, part[j]);
  }
  const int lane = lt & 31, wr = lt >> 5;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    if (j >= p.n) break;
    float v = part[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) scr[wr * kMaxN + j] = v;
  }
}

// The gradient at conv2's output for one row: the Linear's input gradient
// (du @ fc), through the pool (to the window's argmax) and the ReLU (where
// the pooled output is not <= 0); every interior entry is written.
__device__ __forceinline__ void unpool2(const Plan& p, const float* s, const float* du, const float* feat,
                                        const unsigned char* code2, float* dz2, int lt) {
  const int pos_n = p.h3 * p.w3;
  for (int f = lt; f < p.f; f += kRowThreads) {
    float g = 0.f;
    for (int j = 0; j < p.n; ++j) g = fmaf(du[j], s[p.o_fc + j * p.f + f], g);
    const bool keep = !(feat[f] <= 0.f);
    const int cd = code2[f];
    const int co = f / pos_n, pos = f - co * pos_n;
    const int yq = pos / p.w3, xq = pos - yq * p.w3;
    float* dst = dz2 + co * p.as + (2 * yq + 1) * p.ap + 2 * xq + 1;
    dst[0] = keep && cd == 0 ? g : 0.f;
    dst[1] = keep && cd == 1 ? g : 0.f;
    dst[p.ap] = keep && cd == 2 ? g : 0.f;
    dst[p.ap + 1] = keep && cd == 3 ? g : 0.f;
  }
}

// conv2's input gradient for one row, through pool 1 and ReLU 1, written in
// place over the pooled conv1 output it is masked by. An item is 4 input
// channels x a 2x2 block of positions over a quarter of the output channels
// (lanes l, l ^ 1, l ^ 2, l ^ 3, summed by two shuffles): 16 x H/4 x W/4
// items.
__device__ __forceinline__ void conv2_dgrad(const Plan& p, const float* s, const float* dz2, float* a1, int lt) {
  const int tw = p.w2 / 2;
  const int items = 16 * (p.h2 / 2) * tw;
  const int lane = lt & 31;
  for (int base = lt - lane; base < items; base += kRowThreads) {
    const int item = base + lane;
    const bool ok = item < items;  // a multiple of 16: quads are valid together
    const int it = ok ? item : (item & 15);
    const int q = it & 3, iq = (it >> 2) & 3, t = it >> 4;
    const int ty = t / tw, tx = t - ty * tw;
    float acc[4][2][2];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) acc[c][dy][dx] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < kC2 / 4; ++cc) {
      const int co = 4 * cc + q;
      const float* src = dz2 + co * p.as + 2 * ty * p.ap + 2 * tx;
      float v[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = src[i * p.ap + j];
      const float4* wv = reinterpret_cast<const float4*>(s + p.o_w2t + co * kTaps * kC1) + iq;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float4 wk = wv[k * (kC1 / 4)];
        const int ky = k / 3, kx = k % 3;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float t2 = v[dy + 2 - ky][dx + 2 - kx];
            acc[0][dy][dx] = fmaf(wk.x, t2, acc[0][dy][dx]);
            acc[1][dy][dx] = fmaf(wk.y, t2, acc[1][dy][dx]);
            acc[2][dy][dx] = fmaf(wk.z, t2, acc[2][dy][dx]);
            acc[3][dy][dx] = fmaf(wk.w, t2, acc[3][dy][dx]);
          }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) acc[c][dy][dx] += __shfl_xor_sync(0xffffffffu, acc[c][dy][dx], o);
    if (ok) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c != q) continue;  // lane q of the quad writes input channel 4 iq + q
        const int ci = 4 * iq + c;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            float* slot = a1 + ci * p.as + (2 * ty + dy + 1) * p.ap + 2 * tx + dx + 1;
            *slot = *slot <= 0.f ? 0.f : acc[c][dy][dx];
          }
      }
    }
  }
}

// The whole front end for a batch: the forward writes the angles; the
// backward recomputes the forward and writes this block's partial of the
// six weight gradients.
template <bool kBwd, int NMAX, int KH, int KW>
__global__ void __launch_bounds__(kThreads, 2)
    qsc_front_kernel(const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ fcw,
                     const float* __restrict__ fcb, const float* __restrict__ dang, float* __restrict__ angles,
                     float* __restrict__ partials, int batch, int n, int h_arg, int w_arg) {
  extern __shared__ __align__(16) float smem[];
  // the published image size is a compile-time constant, and with it every
  // shared-memory offset of the plan
  const int h = KH > 0 ? KH : h_arg, w = KW > 0 ? KW : w_arg;
  const Plan p = make_plan(h, w, n, kBwd);
  const int tid = threadIdx.x;

  {
    // every load of the weights in flight before the first store
    constexpr int R2 = kW2 / kThreads, R1 = (kW1 + kThreads - 1) / kThreads;
    float v2[R2], v1[R1];
#pragma unroll
    for (int r = 0; r < R2; ++r) v2[r] = w2[tid + r * kThreads];
#pragma unroll
    for (int r = 0; r < R1; ++r) v1[r] = tid + r * kThreads < kW1 ? w1[tid + r * kThreads] : 0.f;
#pragma unroll
    for (int r = 0; r < R1; ++r) {
      const int i = tid + r * kThreads;
      if (i >= kW1) break;
      const int co = i / (kIn * kTaps), ci = (i / kTaps) % kIn, k = i % kTaps;
      smem[p.o_w1 + (ci * kTaps + k) * kC1 + co] = v1[r];
    }
#pragma unroll
    for (int r = 0; r < R2; ++r) {
      const int i = tid + r * kThreads;
      const int co = i / (kC1 * kTaps), ci = (i / kTaps) % kC1, k = i % kTaps;
      smem[p.o_w2 + (ci * kTaps + k) * kC2 + co] = v2[r];
      if constexpr (kBwd) smem[p.o_w2t + (co * kTaps + k) * kC1 + ci] = v2[r];
    }
  }
  if (tid < kC1) smem[p.o_b1 + tid] = b1[tid];
  if (tid < kC2) smem[p.o_b2 + tid] = b2[tid];
  for (int i = tid; i < n * p.f; i += kThreads) smem[p.o_fc + i] = fcw[i];
  if (tid < n) smem[p.o_fcb + tid] = fcb[tid];
  // the gradient accumulators, and the rows' zero padding
  for (int i = p.o_gfc + tid; i < p.total; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int rr = tid / kRowThreads, lt = tid % kRowThreads;
  float* row = smem + p.o_rows + rr * p.row;
  float* a1 = row + p.r_a;
  float* feat = row + p.r_feat;
  unsigned char* code1 = reinterpret_cast<unsigned char*>(row + p.r_c1);
  unsigned char* code2 = reinterpret_cast<unsigned char*>(row + p.r_c2);
  float* scr = row + p.r_scr;

  // the backward's weight-gradient sums, kept over the block's chunks:
  // conv2's for output channels 2 cp, 2 cp + 1 and input channel ci2;
  // conv1's for (co1, ci1) over pooled positions split sp1, 0..7
  const int ci2 = tid & 15, cp = tid >> 4;
  const int ci1 = tid & 1, co1 = (tid >> 1) & 15, sp1 = tid >> 5;
  float gw2[2][kTaps], gb2[2] = {0.f, 0.f}, gw1[kTaps], gb1 = 0.f;
#pragma unroll
  for (int k = 0; k < kTaps; ++k) gw2[0][k] = gw2[1][k] = gw1[k] = 0.f;

  const int per = kIn * h * w;
  const int chunks = (batch + kRows - 1) / kRows;
  // the chunk's input, loaded into registers one chunk ahead so the loads
  // fly while the block computes (where a chunk's input is at most kXr
  // values a thread; larger images load when the chunk starts)
  constexpr int kXr = 4;
  const bool staged = kRows * per <= kXr * kThreads;
  float xr[kXr];
  auto fetch = [&](int chunk) {
    const int n_in = min(kRows, batch - chunk * kRows) * per;
    const float* xin = x + static_cast<size_t>(chunk) * kRows * per;
#pragma unroll
    for (int r = 0; r < kXr; ++r) {
      const int i = tid + r * kThreads;
      xr[r] = i < n_in ? xin[i] : 0.f;
    }
  };
  if (staged && static_cast<int>(blockIdx.x) < chunks) fetch(blockIdx.x);
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int row0 = c * kRows;
    const int rows = min(kRows, batch - row0);
    const bool mine = rr < rows;
    const float* xin = x + static_cast<size_t>(row0) * per;
    const int n_in = rows * per;
    if (staged) {
#pragma unroll
      for (int r = 0; r < kXr; ++r) {
        const int i = tid + r * kThreads;
        if (i >= n_in) break;
        const int rw = i / per, e = i - rw * per;
        const int ci = e / (h * w), yx = e - ci * h * w, y = yx / w, xx = yx - y * w;
        smem[p.o_rows + rw * p.row + p.r_x + ci * p.xs + (y + 1) * p.xp + xx + 1] = xr[r];
      }
      if (c + static_cast<int>(gridDim.x) < chunks) fetch(c + gridDim.x);
    } else {
      for (int i = tid; i < n_in; i += kThreads) {
        const int rw = i / per, e = i - rw * per;
        const int ci = e / (h * w), yx = e - ci * h * w, y = yx / w, xx = yx - y * w;
        smem[p.o_rows + rw * p.row + p.r_x + ci * p.xs + (y + 1) * p.xp + xx + 1] = xin[i];
      }
    }
    __syncthreads();
    if (mine) conv1_pool(p, smem, row + p.r_x, a1, code1, lt);
    __syncthreads();
    if (mine) conv2_pool(p, smem, a1, feat, code2, lt);
    __syncthreads();
    if (mine) linear_partial<NMAX>(p, smem, feat, scr, lt);
    __syncthreads();
    if (mine && lt < n) {
      float sum = scr[lt];
      for (int wi = 1; wi < kRowThreads / 32; ++wi) sum += scr[wi * kMaxN + lt];
      const float t = tanhf(sum + smem[p.o_fcb + lt]);
      const size_t o = static_cast<size_t>(row0 + rr) * n + lt;
      if constexpr (kBwd) row[p.r_du + lt] = dang[o] * (1.f - t * t);
      else angles[o] = t;
    }
    if constexpr (kBwd) {
      __syncthreads();
      if (mine) unpool2(p, smem, row + p.r_du, feat, code2, row + p.r_d, lt);
      // the Linear's weight and bias gradients: thread tid owns feature
      // columns tid, tid + 256, ...
      for (int f = tid; f < p.f; f += kThreads) {
        for (int j = 0; j < n; ++j) {
          float g = 0.f;
          for (int r = 0; r < rows; ++r) {
            const float* rb = smem + p.o_rows + r * p.row;
            g = fmaf(rb[p.r_du + j], rb[p.r_feat + f], g);
          }
          smem[p.o_gfc + j * p.f + f] += g;
        }
      }
      if (tid < n) {
        float g = 0.f;
        for (int r = 0; r < rows; ++r) g += smem[p.o_rows + r * p.row + p.r_du + tid];
        smem[p.o_gfcb + tid] += g;
      }
      __syncthreads();
      // conv2's weight and bias gradients, 2x2 positions at a time
      for (int r = 0; r < rows; ++r) {
        const float* rb = smem + p.o_rows + r * p.row;
        const float* A = rb + p.r_a + ci2 * p.as;
        const float* D0 = rb + p.r_d + 2 * cp * p.as;
        const float* D1 = D0 + p.as;
        for (int ty = 0; ty < p.h2 / 2; ++ty)
          for (int tx = 0; tx < p.w2 / 2; ++tx) {
            float v[4][4], d0[2][2], d1[2][2];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) v[i][j] = A[(2 * ty + i) * p.ap + 2 * tx + j];
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
#pragma unroll
              for (int dx = 0; dx < 2; ++dx) {
                const int at = (2 * ty + dy + 1) * p.ap + 2 * tx + dx + 1;
                d0[dy][dx] = D0[at];
                d1[dy][dx] = D1[at];
                gb2[0] += d0[dy][dx];
                gb2[1] += d1[dy][dx];
              }
#pragma unroll
            for (int k = 0; k < kTaps; ++k) {
              const int ky = k / 3, kx = k % 3;
#pragma unroll
              for (int dy = 0; dy < 2; ++dy)
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                  const float t = v[dy + ky][dx + kx];
                  gw2[0][k] = fmaf(d0[dy][dx], t, gw2[0][k]);
                  gw2[1][k] = fmaf(d1[dy][dx], t, gw2[1][k]);
                }
            }
          }
      }
      __syncthreads();
      if (mine) conv2_dgrad(p, smem, row + p.r_d, a1, lt);
      __syncthreads();
      // conv1's weight and bias gradients: dz at conv1's output is nonzero
      // only at each pool window's argmax, where it is the masked gradient
      // now held in a1
      for (int r = 0; r < rows; ++r) {
        const float* rb = smem + p.o_rows + r * p.row;
        const float* G = rb + p.r_a + co1 * p.as;
        const unsigned char* C = reinterpret_cast<const unsigned char*>(rb + p.r_c1) + co1 * p.h2 * p.w2;
        const float* X = rb + p.r_x + ci1 * p.xs;
        for (int qi = sp1; qi < p.h2 * p.w2; qi += kSplits) {
          const int qy = qi / p.w2, qx = qi - qy * p.w2;
          const float g = G[(qy + 1) * p.ap + qx + 1];
          const int cd = C[qi];
          const float* src = X + (2 * qy + (cd >> 1)) * p.xp + 2 * qx + (cd & 1);
#pragma unroll
          for (int k = 0; k < kTaps; ++k) gw1[k] = fmaf(g, src[(k / 3) * p.xp + k % 3], gw1[k]);
          gb1 += g;
        }
      }
    }
    __syncthreads();
  }

  if constexpr (kBwd) {
    // conv1's split sums through the (now free) row slots, folded in split order
    float* split = smem + p.o_rows;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) split[sp1 * kW1 + (co1 * kIn + ci1) * kTaps + k] = gw1[k];
    if (ci1 == 0) split[kSplits * kW1 + sp1 * kC1 + co1] = gb1;
    __syncthreads();
    const int entries = kOffFc + n * p.f + n;
    float* out = partials + static_cast<size_t>(blockIdx.x) * entries;
    for (int e = tid; e < kW1 + kC1; e += kThreads) {
      const float* src = e < kW1 ? split + e : split + kSplits * kW1 + (e - kW1);
      const int stride = e < kW1 ? kW1 : kC1;
      float v = src[0];
      for (int sp = 1; sp < kSplits; ++sp) v += src[sp * stride];
      out[e] = v;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int k = 0; k < kTaps; ++k) out[kOffW2 + ((2 * cp + c) * kC1 + ci2) * kTaps + k] = gw2[c][k];
      if (ci2 == 0) out[kOffB2 + 2 * cp + c] = gb2[c];
    }
    for (int e = tid; e < n * p.f + n; e += kThreads)
      out[kOffFc + e] = e < n * p.f ? smem[p.o_gfc + e] : smem[p.o_gfcb + e - n * p.f];
  }
}

// Sums the blocks' partials of each gradient entry in a fixed order: warp w
// adds blocks [w G / 8, (w + 1) G / 8) in turn, then the warps' sums are
// added in warp order. A block takes 32 entries.
__global__ void __launch_bounds__(kThreads)
    qsc_front_fold_kernel(const float* __restrict__ partials, int blocks, int entries, int nf,
                          float* __restrict__ gw1, float* __restrict__ gb1, float* __restrict__ gw2,
                          float* __restrict__ gb2, float* __restrict__ gfc, float* __restrict__ gfcb) {
  __shared__ float sums[kThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int lo = warp * blocks / (kThreads / 32), hi = (warp + 1) * blocks / (kThreads / 32);
  float acc = 0.f;
  if (e < entries)
    for (int b = lo; b < hi; ++b) acc += partials[static_cast<size_t>(b) * entries + e];
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || e >= entries) return;
  float t = sums[0][lane];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) t += sums[i][lane];
  if (e < kOffB1) gw1[e] = t;
  else if (e < kOffW2) gb1[e - kOffB1] = t;
  else if (e < kOffB2) gw2[e - kOffW2] = t;
  else if (e < kOffFc) gb2[e - kOffB2] = t;
  else if (e < kOffFc + nf) gfc[e - kOffFc] = t;
  else gfcb[e - kOffFc - nf] = t;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, const float*,
                        const float*, const float*, float*, float*, int, int, int, int);

template <bool kBwd, int KH, int KW>
Kernel by_width(int n) {
  return n <= 8 ? qsc_front_kernel<kBwd, 8, KH, KW> : qsc_front_kernel<kBwd, kMaxN, KH, KW>;
}

// the published 16 x 8 image has its own instantiation; other sizes read
// theirs at run time
Kernel kernel_for(bool bwd, int n, int h, int w) {
  const bool published = h == 16 && w == 8;
  if (bwd) return published ? by_width<true, 16, 8>(n) : by_width<true, 0, 0>(n);
  return published ? by_width<false, 16, 8>(n) : by_width<false, 0, 0>(n);
}

bool valid(int batch, int n, int h, int w) {
  return batch >= 1 && n >= 1 && n <= kMaxN && h >= 4 && w >= 4 && h % 4 == 0 && w % 4 == 0 && h <= 1024 &&
         w <= 1024;
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

// Opts the kernel in to its shared memory (refused past the card's per-block
// limit) and the carveout that lets two blocks' sit beside each other.
cudaError_t configure(Kernel kern, size_t smem) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  if (smem > kStaticSmem) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The persistent grid: every block resident at once, and no more blocks
// than chunks.
cudaError_t grid_size(bool bwd, int batch, int n, int h, int w, int* blocks) {
  const Kernel kern = kernel_for(bwd, n, h, w);
  const size_t smem = sizeof(float) * static_cast<size_t>(make_plan(h, w, n, bwd).total);
  cudaError_t err = configure(kern, smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  const long long chunks = (static_cast<long long>(batch) + kRows - 1) / kRows;
  const long long resident = static_cast<long long>(occ) * sm_count();
  *blocks = static_cast<int>(chunks < resident ? chunks : resident);
  return cudaSuccess;
}

}  // namespace

// Gradient entries a block's partial holds: the six gradients, flat.
extern "C" int qsc_front_entries(int n, int h, int w) { return kOffFc + n * kC2 * (h / 4) * (w / 4) + n; }

// Blocks of one backward launch at this shape on the current device (the
// leading size of its `partials` scratch), or minus the CUDA error.
extern "C" int qsc_front_bwd_blocks(int batch, int n, int h, int w) {
  if (!valid(batch, n, h, w)) return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = grid_size(true, batch, n, h, w, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Forward. x (batch, 2, h, w); w1 (16, 2, 3, 3), b1 (16), w2 (32, 16, 3, 3),
// b2 (32), fcw (n, 32 * h/4 * w/4), fcb (n); writes angles (batch, n). All
// float32, contiguous, on the device; h and w multiples of 4, 1 <= n <= 32.
// Returns the first CUDA error, or 0.
extern "C" int qsc_front_fwd_launch(const float* x, const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* fcw, const float* fcb, float* angles, int batch,
                                    int n, int h, int w, void* stream) {
  if (!valid(batch, n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  cudaError_t err = grid_size(false, batch, n, h, w, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(float) * static_cast<size_t>(make_plan(h, w, n, false).total);
  kernel_for(false, n, h, w)<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w1, b1, w2, b2, fcw, fcb, nullptr, angles, nullptr, batch, n, h, w);
  return static_cast<int>(cudaGetLastError());
}

// Backward. The forward's inputs, and dangles (batch, n), the angles'
// gradient; partials (blocks, qsc_front_entries(n, h, w)) scratch, blocks
// from qsc_front_bwd_blocks (refused if it differs); writes the six
// gradients gw1, gb1, gw2, gb2, gfc, gfcb in the parameters' shapes. Returns
// the first CUDA error, or 0.
extern "C" int qsc_front_bwd_launch(const float* x, const float* w1, const float* b1, const float* w2,
                                    const float* b2, const float* fcw, const float* fcb, const float* dangles,
                                    float* partials, float* gw1, float* gb1, float* gw2, float* gb2, float* gfc,
                                    float* gfcb, int blocks, int batch, int n, int h, int w, void* stream) {
  if (!valid(batch, n, h, w)) return static_cast<int>(cudaErrorInvalidValue);
  int want = 0;
  cudaError_t err = grid_size(true, batch, n, h, w, &want);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks != want) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * static_cast<size_t>(make_plan(h, w, n, true).total);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel_for(true, n, h, w)<<<blocks, kThreads, smem, s>>>(x, w1, b1, w2, b2, fcw, fcb, dangles, nullptr, partials,
                                                     batch, n, h, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int entries = qsc_front_entries(n, h, w);
  const int nf = n * kC2 * (h / 4) * (w / 4);
  qsc_front_fold_kernel<<<(entries + 31) / 32, kThreads, 0, s>>>(partials, blocks, entries, nf, gw1, gb1, gw2,
                                                                 gb2, gfc, gfcb);
  return static_cast<int>(cudaGetLastError());
}
