// B4 — compositing backward for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/render.py `_bwd_kernel` (driven by
// `_bwd_call`). Per 16x16 tile it replays the forward's front-to-back loop
// (composite.cu, same gating through composite_common.cuh) and emits one
// gradient row per instance. With g the cotangent of the blended channels,
// g_T that of the final transmittance, fg_j = f_j . g, b_j = alpha_j T_j fg_j
// and A = sum_c blended_c g_c (from the forward's output), per pixel:
//   dL/dalpha_j = T_j fg_j - (A - sum_{k<=j} b_k) / (1 - alpha_j)
//                 - g_T T_final / (1 - alpha_j)
//   d_power_j   = dL/dalpha_j * alpha_j  (0 where the 0.99 clamp is active)
//   dL/df_j     = alpha_j T_j g
// and, with power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = mean.x - px,
//   d_mx = -d_power (a dx + b dy),  d_my = -d_power (c dy + b dx),
//   d_a = -0.5 d_power dx^2,  d_b = -d_power dx dy,  d_c = -0.5 d_power dy^2,
//   d_log_opacity = d_power.
// Pairs the forward skipped or never reached (after a pixel's stop, after
// the whole tile's exit) contribute nothing.
//
// Output: rows[slot_sorted[s], :] = (d_mx, d_my, d_a, d_b, d_c, d_lo,
// d_f[0..CH), zero pad to gc) for every sorted instance s of the tile,
// summed over the tile's 256 pixels. slot_sorted is a permutation of the
// presort (Gaussian-major) slots, so each row is written by one block,
// once: no atomics. Every row is written: rows of instances that no pixel
// reached are exact zeros, and so are the rows past the valid instances
// (written by the ordering kernel below), so the caller need not zero
// `rows`.
//
// The JAX kernel evaluates power and its six partial derivatives through a
// tile-local polynomial basis and one moment matmul on the MXU; here each
// pixel evaluates them directly from dx and dy.
//
// Bound: operations (one exp and ~60 flops per composited (instance,
// pixel) pair, ~12 per gated one) plus the per-instance sums over the
// tile's pixels, which cost more than the replay: each (warp, instance)
// with a composited pixel is a warp reduction of 6 + CH values. Design:
//   - one block of 128 threads per 16x16 tile, two pixels a thread (rows
//     r and r + 1 of one column); warp w covers the 8x8 quarter (w % 2,
//     w / 2) of the tile, so fewer warps touch a splat than with 32-pixel
//     row strips, and a thread adds its two pixels' values before the
//     warp does;
//   - instances staged in shared memory 128 at a time; the tile exits at
//     a batch boundary once every pixel has stopped (no later pair adds
//     anything) and writes zero rows for the instances left;
//   - per instance, first the gates of the thread's pixels (the exp is
//     skipped where log-opacity + power rules the 1/255 gate out for
//     certain), then, only in a warp with a composited pixel, the values
//     and their warp sums: a reduce-scatter of the values padded to P = 8
//     or 16 (warp_reduce.cuh: 16 shuffles at CH = 8, where a butterfly per
//     value took 70) into shared memory;
//   - rounds of 32 instances alternate between two buffers of warp sums,
//     so one barrier a round separates a round's sums from their combine:
//     the block adds the 4 warps' sums of each instance in warp order and
//     writes its row once, four columns a thread;
//   - blocks take the tiles longest first: a ranking kernel (a warp per
//     tile) writes the tiles' order by descending instance count first, so
//     the longest tiles do not set the launch's tail. Each tile's rows are
//     the same in any order.
// Sums run in a fixed order: deterministic.
//
// The ROWS template flag picks the instance layout as in B3 (composite.cu):
// only the staging load differs, so both layouts give bitwise equal rows.

#include "composite_common.cuh"
#include "tile_order.cuh"
#include "warp_reduce.cuh"

namespace {

using adgs::kGeom;
using adgs::kPix;
using adgs::kWarpFull;

constexpr int kPx = 2;                   // pixels of a thread (rows r, r + 1)
constexpr int kThreads = kPix / kPx;     // threads of a tile's block
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = kThreads;         // instances staged at a time
constexpr int kSub = 32;   // instances per round (one bit each in a mask)
constexpr unsigned kAllDone = (1u << kPx) - 1;

// The warp sums of P values into dst[0 .. P): lane L holds value
// L / (32 / P) after the reduce-scatter; one lane of each group writes it.
template <int P>
__device__ __forceinline__ void warp_sums(float (&v)[P], int lane,
                                          float* dst) {
  adgs::reduce_scatter<P>(v, lane);
  constexpr int S = 32 / P;
  if (lane % S == 0) dst[lane / S] = v[0];
}

// ld: floats per row of `src` (F for "gather", 128 for "rows")
template <int CH, bool ROWS>
__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ src, int ld,
                     const int32_t* __restrict__ gauss_id,
                     const int32_t* __restrict__ slot_sorted,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count,
                     const int32_t* __restrict__ tile_order, int grid_x,
                     const float* __restrict__ fwd_out,
                     const float* __restrict__ g_out,
                     float* __restrict__ rows) {
  constexpr int NC = 6 + CH;
  constexpr int P = NC <= 8 ? 8 : 16;   // NC padded to a power of two
  __shared__ float4 s_g0[kBatch];   // mx, my, a, b
  __shared__ float2 s_g1[kBatch];   // c, log-opacity
  __shared__ float s_f[CH][kBatch];
  __shared__ int32_t s_slot[kBatch];
  __shared__ float s_red[2][kWarps][kSub][P];
  __shared__ unsigned s_mask[2][kWarps];

  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // thread tid: column col of rows r0 and r0 + 1; warp w covers the 8x8
  // quarter (w % 2, w / 2) of the tile, lanes 8 a row pair
  static_assert(kPx == 2, "the pixel map below is for two pixels a thread");
  const int col = ((tid >> 5) & 1) * 8 + (tid & 7);
  const int r0 = (tid >> 6) * 8 + ((tid >> 3) & 3) * 2;
  const float px = (float)((tile % grid_x) * 16 + col);
  float py[kPx];
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float g[kPx][CH];
  float A[kPx], gt_tfin[kPx], T[kPx], prefix[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const int pix = (r0 + k) * 16 + col;
    py[k] = (float)((tile / grid_x) * 16 + r0 + k);
    const float* fo = fwd_out + (size_t)tile * (CH + 1) * kPix + pix;
    const float* go = g_out + (size_t)tile * (CH + 1) * kPix + pix;
    A[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      g[k][c] = go[c * kPix];
      A[k] += fo[c * kPix] * g[k][c];
    }
    gt_tfin[k] = go[CH * kPix] * fo[CH * kPix];
    T[k] = 1.0f;
    prefix[k] = 0.0f;
  }
  unsigned done = 0;   // bit k: pixel k has stopped
  int buf = 0;

  int base = 0;
  for (; base < count; base += kBatch) {
    // the whole tile's exit once every pixel has stopped (no later pair
    // contributes); also the barrier that frees the previous batch's
    // shared memory
    if (__syncthreads_and(done == kAllDone)) break;
    const int i = base + tid;
    if (i < count) {
      const float* row = adgs::instance_row<ROWS>(src, ld, gauss_id, start + i);
      const float4 g0 = reinterpret_cast<const float4*>(row)[0];
      const float4 g1 = reinterpret_cast<const float4*>(row)[1];
      s_g0[tid] = g0;
      s_g1[tid] = make_float2(g1.x, g1.y);
#pragma unroll
      for (int c = 0; c < CH; ++c) s_f[c][tid] = row[kGeom + c];
      s_slot[tid] = slot_sorted[start + i];
    }
    __syncthreads();
    const int n = min(kBatch, count - base);
    for (int j0 = 0; j0 < n; j0 += kSub, buf ^= 1) {
      const int m = min(kSub, n - j0);
      unsigned mask = 0;
      for (int jj = 0; jj < m; ++jj) {
        const int j = j0 + jj;
        const float4 q = s_g0[j];
        const float2 r = s_g1[j];
        const float a = q.z, b = q.w, c = r.x;
        const float dx = __fsub_rn(q.x, px);
        // the gates first: bit k of `hit`, pixel k composites the pair
        // (its alpha kept); bit k of `clamped`, the 0.99 clamp is active
        float alpha[kPx];
        unsigned hit = 0, clamped = 0;
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          alpha[k] = 0.0f;
          if (done & (1u << k)) continue;
          const float dy = __fsub_rn(q.y, py[k]);
          const float power = adgs::splat_power(a, b, c, dx, dy);
          if (__fadd_rn(r.y, power) < adgs::kLogAlphaMinSafe) continue;
          float e;
          alpha[k] = adgs::splat_alpha(r.y, power, &e);
          if (alpha[k] > 0.0f) {
            if (adgs::next_t(T[k], alpha[k]) < adgs::kTEps) {
              done |= 1u << k;
            } else {
              hit |= 1u << k;
              if (!(e < adgs::kAlphaMax)) clamped |= 1u << k;
            }
          }
        }
        // warp-uniform: every lane reaches this vote; then the values
        // of the lanes' composited pixels, and their warp sums
        if (__any_sync(kWarpFull, hit)) {
          float f[CH];
#pragma unroll
          for (int ch = 0; ch < CH; ++ch) f[ch] = s_f[ch][j];
          float v[P];
#pragma unroll
          for (int k = 0; k < P; ++k) v[k] = 0.0f;
#pragma unroll
          for (int k = 0; k < kPx; ++k) {
            if (!(hit & (1u << k))) continue;
            const float dy = __fsub_rn(q.y, py[k]);
            const float w = alpha[k] * T[k];
            float fg = 0.0f;
#pragma unroll
            for (int ch = 0; ch < CH; ++ch) fg += f[ch] * g[k][ch];
            prefix[k] += w * fg;
            const float inv = __frcp_rn(__fsub_rn(1.0f, alpha[k]));
            const float d_alpha =
                T[k] * fg - (A[k] - prefix[k]) * inv - gt_tfin[k] * inv;
            const float dp =
                clamped & (1u << k) ? 0.0f : d_alpha * alpha[k];
            v[0] += -dp * (a * dx + b * dy);
            v[1] += -dp * (c * dy + b * dx);
            v[2] += -0.5f * dp * dx * dx;
            v[3] += -dp * dx * dy;
            v[4] += -0.5f * dp * dy * dy;
            v[5] += dp;
#pragma unroll
            for (int ch = 0; ch < CH; ++ch) v[6 + ch] += w * g[k][ch];
            T[k] = adgs::next_t(T[k], alpha[k]);
          }
          warp_sums<P>(v, lane, s_red[buf][warp][jj]);
          mask |= 1u << jj;
        }
      }
      if (lane == 0) s_mask[buf][warp] = mask;
      // the round's one barrier: its warp sums are complete, and the
      // combine of the round before last, which read this round's buffer
      // of sums, is over
      __syncthreads();
      // each instance's row, written once to its presort slot: the warp
      // sums of the warps that touched it, in warp order (zeros where no
      // pixel composited it), four columns a thread
      for (int e = tid; e < m * (P / 4); e += kThreads) {
        const int jj = e / (P / 4);
        const int k0 = (e % (P / 4)) * 4;
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if ((s_mask[buf][w] >> jj) & 1u) {
            const float4 x =
                reinterpret_cast<const float4*>(s_red[buf][w][jj])[k0 / 4];
            sum.x += x.x;
            sum.y += x.y;
            sum.z += x.z;
            sum.w += x.w;
          }
        }
        reinterpret_cast<float4*>(rows)[(size_t)s_slot[j0 + jj] * (P / 4) +
                                        k0 / 4] = sum;
      }
    }
  }
  // the instances after the whole tile's exit: zero rows
  float4* rows4 = reinterpret_cast<float4*>(rows);
  for (int e = base * (P / 4) + tid; e < count * (P / 4); e += kThreads)
    rows4[(size_t)slot_sorted[start + e / (P / 4)] * (P / 4) + e % (P / 4)] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The order in which B4's blocks take the tiles (tile_order.cuh), and
// the zero rows past the valid instances. The valid instances hold the
// presort slots 0 .. total - 1, total = tile_start[T - 1] + count[T - 1];
// the grid zeroes rows total .. num_rows - 1.
__global__ void __launch_bounds__(256)
tile_order_kernel(const int32_t* __restrict__ tile_start,
                  const int32_t* __restrict__ tile_count, int num_tiles,
                  int32_t* __restrict__ order, float4* __restrict__ rows4,
                  long long num_rows, int row_quads) {
  adgs::rank_tiles(tile_count, num_tiles, order);
  const long long total =
      tile_start[num_tiles - 1] + tile_count[num_tiles - 1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = total * row_quads + blockIdx.x * blockDim.x +
                     threadIdx.x;
       e < num_rows * row_quads; e += stride)
    rows4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

template <int CH>
void launch(bool rm, const float* src, int ld, const int32_t* gauss_id,
            const int32_t* slot_sorted, const int32_t* tile_start,
            const int32_t* tile_count, const int32_t* tile_order,
            int num_tiles, int grid_x, const float* fwd_out,
            const float* g_out, float* rows, cudaStream_t st) {
  if (rm)
    composite_bwd_kernel<CH, true><<<num_tiles, kThreads, 0, st>>>(
        src, ld, gauss_id, slot_sorted, tile_start, tile_count, tile_order,
        grid_x, fwd_out, g_out, rows);
  else
    composite_bwd_kernel<CH, false><<<num_tiles, kThreads, 0, st>>>(
        src, ld, gauss_id, slot_sorted, tile_start, tile_count, tile_order,
        grid_x, fwd_out, g_out, rows);
}

}  // namespace

// rows = 0: src is the packed [N, ld] rows, read through gauss_id;
// rows = 1: src is the tile-ordered [R, ld] instance rows. tile_order:
// [num_tiles] int32, written with the order the blocks take the tiles in.
// out_rows: [num_rows, gc], every row written (gc = 8 for ch <= 2, else
// 16: the padded values of a pair).
extern "C" int adgs_composite_bwd(const void* src, int ld, int rows,
                                  const void* gauss_id,
                                  const void* slot_sorted,
                                  const void* tile_start,
                                  const void* tile_count, void* tile_order,
                                  int num_tiles, int grid_x, int ch,
                                  const void* fwd_out, const void* g_out,
                                  int gc, int num_rows, void* out_rows,
                                  void* stream) {
  const float* p = (const float*)src;
  const bool rm = rows != 0;
  const int32_t* gi = (const int32_t*)gauss_id;
  const int32_t* ss = (const int32_t*)slot_sorted;
  const int32_t* ts = (const int32_t*)tile_start;
  const int32_t* tc = (const int32_t*)tile_count;
  int32_t* to = (int32_t*)tile_order;
  const float* fo = (const float*)fwd_out;
  const float* go = (const float*)g_out;
  float* r = (float*)out_rows;
  cudaStream_t st = (cudaStream_t)stream;
  if (ch < 1 || ch > 8 || gc != (6 + ch <= 8 ? 8 : 16))
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return 0;
  if (num_tiles <= 0)
    return (int)cudaMemsetAsync(r, 0, (size_t)num_rows * gc * sizeof(float),
                                st);
  tile_order_kernel<<<adgs::rank_blocks(num_tiles), 256, 0, st>>>(
      ts, tc, num_tiles, to, reinterpret_cast<float4*>(r), num_rows, gc / 4);
  switch (ch) {
    case 1: launch<1>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    case 2: launch<2>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    case 3: launch<3>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    case 4: launch<4>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    case 5: launch<5>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    case 6: launch<6>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    case 7: launch<7>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    case 8: launch<8>(rm, p, ld, gi, ss, ts, tc, to, num_tiles, grid_x, fo, go, r, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
