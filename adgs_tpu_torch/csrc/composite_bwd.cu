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
// once: no atomics. The caller zeroes `rows`, so rows of instances that
// no pixel reached, and slots past the capacity, stay exact zeros.
//
// The JAX kernel evaluates power and its six partial derivatives through a
// tile-local polynomial basis and one moment matmul on the MXU; here each
// pixel evaluates them directly from dx and dy.
//
// Bound: operations (one exp and ~60 flops per replayed (instance, pixel)
// pair) plus the per-instance reductions over the tile's pixels. Design:
// one block of 256 threads per tile, one thread per pixel, instances staged
// in shared memory in batches of 256 as in B3. Each instance's 6 + CH
// per-pixel values are summed within each warp by shuffles (skipped when
// no lane of the warp touched the instance), the 8 warp sums of 32
// instances at a time go through shared memory, and the block writes each
// touched instance's row once, in a fixed order: deterministic.
//
// The ROWS template flag picks the instance layout as in B3 (composite.cu):
// only the staging load differs, so both layouts give bitwise equal rows.

#include "composite_common.cuh"

namespace {

using adgs::kGeom;
using adgs::kPix;

constexpr int kWarps = kPix / 32;
constexpr int kSub = 32;   // instances per shared-memory reduction round
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ld: floats per row of `src` (F for "gather", 128 for "rows")
template <int CH, bool ROWS>
__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const float* __restrict__ src, int ld,
                     const int32_t* __restrict__ gauss_id,
                     const int32_t* __restrict__ slot_sorted,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count, int grid_x,
                     const float* __restrict__ fwd_out,
                     const float* __restrict__ g_out, int gc,
                     float* __restrict__ rows) {
  constexpr int NC = 6 + CH;
  __shared__ float s_mx[kPix], s_my[kPix], s_ca[kPix], s_cb[kPix],
      s_cc[kPix], s_lo[kPix];
  __shared__ float s_f[CH][kPix];
  __shared__ int32_t s_slot[kPix];
  __shared__ float s_red[kWarps][kSub][NC];
  __shared__ unsigned s_mask[kWarps];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float px = (float)((tile % grid_x) * 16 + (tid & 15));
  const float py = (float)((tile / grid_x) * 16 + (tid >> 4));
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  const float* fo = fwd_out + (size_t)tile * (CH + 1) * kPix + tid;
  const float* go = g_out + (size_t)tile * (CH + 1) * kPix + tid;
  float g[CH];
  float A = 0.0f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    g[c] = go[c * kPix];
    A += fo[c * kPix] * g[c];
  }
  const float gt_tfin = go[CH * kPix] * fo[CH * kPix];

  float T = 1.0f;
  float prefix = 0.0f;
  int done = 0;

  for (int base = 0; base < count; base += kPix) {
    // the forward's whole-tile exit, at the same batch boundary; also the
    // barrier that frees the previous batch's shared memory
    if (__syncthreads_count(done) == kPix) break;
    const int i = base + tid;
    if (i < count) {
      const float* row = adgs::instance_row<ROWS>(src, ld, gauss_id, start + i);
      const float4 g0 = reinterpret_cast<const float4*>(row)[0];
      const float4 g1 = reinterpret_cast<const float4*>(row)[1];
      s_mx[tid] = g0.x;
      s_my[tid] = g0.y;
      s_ca[tid] = g0.z;
      s_cb[tid] = g0.w;
      s_cc[tid] = g1.x;
      s_lo[tid] = g1.y;
#pragma unroll
      for (int c = 0; c < CH; ++c) s_f[c][tid] = row[kGeom + c];
      s_slot[tid] = slot_sorted[start + i];
    }
    __syncthreads();
    const int n = min(kPix, count - base);
    for (int j0 = 0; j0 < n; j0 += kSub) {
      const int m = min(kSub, n - j0);
      unsigned mask = 0;
      for (int jj = 0; jj < m; ++jj) {
        const int j = j0 + jj;
        float v[NC];
#pragma unroll
        for (int k = 0; k < NC; ++k) v[k] = 0.0f;
        bool hit = false;
        if (!done) {
          const float dx = __fsub_rn(s_mx[j], px);
          const float dy = __fsub_rn(s_my[j], py);
          const float a = s_ca[j], b = s_cb[j], c = s_cc[j];
          const float power = adgs::splat_power(a, b, c, dx, dy);
          float e;
          const float alpha = adgs::splat_alpha(s_lo[j], power, &e);
          if (alpha > 0.0f) {
            const float test_t = adgs::next_t(T, alpha);
            if (test_t < adgs::kTEps) {
              done = 1;
            } else {
              hit = true;
              const float w = alpha * T;
              float fg = 0.0f;
#pragma unroll
              for (int ch = 0; ch < CH; ++ch) fg += s_f[ch][j] * g[ch];
              prefix += w * fg;
              const float inv = 1.0f / (1.0f - alpha);
              const float d_alpha =
                  T * fg - (A - prefix) * inv - gt_tfin * inv;
              const float dp = e < adgs::kAlphaMax ? d_alpha * alpha : 0.0f;
              v[0] = -dp * (a * dx + b * dy);
              v[1] = -dp * (c * dy + b * dx);
              v[2] = -0.5f * dp * dx * dx;
              v[3] = -dp * dx * dy;
              v[4] = -0.5f * dp * dy * dy;
              v[5] = dp;
#pragma unroll
              for (int ch = 0; ch < CH; ++ch) v[6 + ch] = w * g[ch];
              T = test_t;
            }
          }
        }
        // warp-uniform: every lane reaches this vote
        if (__any_sync(kFull, hit)) {
#pragma unroll
          for (int k = 0; k < NC; ++k) v[k] = warp_sum(v[k]);
          if (lane == 0) {
#pragma unroll
            for (int k = 0; k < NC; ++k) s_red[warp][jj][k] = v[k];
          }
          mask |= 1u << jj;
        }
      }
      if (lane == 0) s_mask[warp] = mask;
      __syncthreads();
      // the 8 warp sums of each touched instance, in warp order, written
      // once to its presort row
      for (int e = tid; e < m * gc; e += kPix) {
        const int jj = e / gc;
        const int k = e - jj * gc;
        float s = 0.0f;
        bool touched = false;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          if ((s_mask[w] >> jj) & 1u) {
            touched = true;
            if (k < NC) s += s_red[w][jj][k];
          }
        }
        if (touched) rows[(size_t)s_slot[j0 + jj] * gc + k] = s;
      }
      __syncthreads();
    }
  }
}

template <int CH>
void launch(bool rm, const float* src, int ld, const int32_t* gauss_id,
            const int32_t* slot_sorted, const int32_t* tile_start,
            const int32_t* tile_count, int num_tiles, int grid_x,
            const float* fwd_out, const float* g_out, int gc, float* rows,
            cudaStream_t st) {
  if (rm)
    composite_bwd_kernel<CH, true><<<num_tiles, kPix, 0, st>>>(
        src, ld, gauss_id, slot_sorted, tile_start, tile_count, grid_x,
        fwd_out, g_out, gc, rows);
  else
    composite_bwd_kernel<CH, false><<<num_tiles, kPix, 0, st>>>(
        src, ld, gauss_id, slot_sorted, tile_start, tile_count, grid_x,
        fwd_out, g_out, gc, rows);
}

}  // namespace

// rows = 0: src is the packed [N, ld] rows, read through gauss_id;
// rows = 1: src is the tile-ordered [R, ld] instance rows.
extern "C" int adgs_composite_bwd(const void* src, int ld, int rows,
                                  const void* gauss_id,
                                  const void* slot_sorted,
                                  const void* tile_start,
                                  const void* tile_count, int num_tiles,
                                  int grid_x, int ch, const void* fwd_out,
                                  const void* g_out, int gc, void* out_rows,
                                  void* stream) {
  const float* p = (const float*)src;
  const bool rm = rows != 0;
  const int32_t* gi = (const int32_t*)gauss_id;
  const int32_t* ss = (const int32_t*)slot_sorted;
  const int32_t* ts = (const int32_t*)tile_start;
  const int32_t* tc = (const int32_t*)tile_count;
  const float* fo = (const float*)fwd_out;
  const float* go = (const float*)g_out;
  float* r = (float*)out_rows;
  cudaStream_t st = (cudaStream_t)stream;
  if (num_tiles <= 0) return 0;
  if (gc < 6 + ch) return (int)cudaErrorInvalidValue;
  switch (ch) {
    case 1: launch<1>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    case 2: launch<2>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    case 3: launch<3>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    case 4: launch<4>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    case 5: launch<5>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    case 6: launch<6>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    case 7: launch<7>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    case 8: launch<8>(rm, p, ld, gi, ss, ts, tc, num_tiles, grid_x, fo, go, gc, r, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
