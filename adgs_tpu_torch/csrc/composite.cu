// B3 — compositing forward for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/render.py `_fwd_kernel` (driven by
// `_fwd_call`). Per 16x16 tile it walks the tile's depth-sorted instances
// front to back; per pixel:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = mean.x - px
//   skip if power > 0;  alpha = min(0.99, exp(log_opacity + power));
//   skip if alpha < 1/255;  stop once T (1 - alpha) < 1e-4;
//   acc += f * alpha * T;  T *= (1 - alpha)
// Output: out[tile, c, pix] = acc[c] for c < CH, out[tile, CH, pix] = T,
// the JAX kernel's [T, ch+1, 256] layout. All 256 pixels of a tile are
// evaluated, also those beyond the image edge (cropped by the caller).
//
// The JAX kernel evaluates power as a tile-local polynomial through the
// MXU and carries T as prefix products over 128-instance blocks; both exist
// for the TPU's matrix unit and are not carried over. Here each pixel runs
// the reference rasterizer's sequential loop in f32, with the pixel offset
// taken as mean - pixel directly. The gating arithmetic lives in
// composite_common.cuh, which the backward (B4, composite_bwd.cu) replays
// bit for bit.
//
// Bound: operations (one exp and ~20 flops per composited (instance,
// pixel) pair, ~12 per gated one). Most evaluated pairs are gated off
// (~183M against ~28M composited on the served frame), so the design
// spends its effort on not evaluating them, and on the tail:
//   - blocks take the tiles longest first (tile_order.cuh, B4's ranking,
//     into an order buffer): tiles hold 440 instances on average and up
//     to ~800, and the longest ones would otherwise set the launch's tail;
//   - one block of 128 threads per tile, two pixels a thread (rows r and
//     r + 1 of one column); warp w covers the 8x8 quarter (w % 2, w / 2)
//     of the tile, the pixel map of B4;
//   - instances staged 128 at a time, geometry as a float4 (mx, my, a, b)
//     and a float2 (c, log-opacity), so a pair reads its geometry with 2
//     shared loads;
//   - quarter culling: the thread that stages an instance also computes
//     the 4-bit mask of the quarters its splat can reach at all
//     (quarter_mask below, conservative, in float64), and a warp skips an
//     instance whose bit for its quarter is clear (a warp-uniform branch).
//     It drops only pairs that the gates drop, so the output is the same
//     bit for bit;
//   - the exp is skipped where log-opacity + power < kLogAlphaMinSafe
//     rules the 1/255 gate out for certain;
//   - a thread leaves a batch once both its pixels have stopped (a warp
//     once all of its lanes have), and the block ends the tile at a batch
//     boundary once every pixel has stopped.
// The per-pixel order of pairs is the reference's, front to back, so the
// output does not depend on the design.
//
// Two instance layouts, chosen by the ROWS template flag (the JAX
// package's ADGS_RM): "gather" reads instance i of a tile as row
// gauss_id[start + i] of the packed [N, F] rows; "rows" reads it as row
// start + i of the tile-ordered [R, 128] instance rows that B6 and one row
// gather built (raster/render.py build_instances_rows). Only the staging
// load differs, so both layouts give bitwise equal outputs.

#include "composite_common.cuh"
#include "tile_order.cuh"

namespace {

using adgs::kGeom;
using adgs::kPix;

constexpr int kPx = 2;                   // pixels of a thread (rows r, r + 1)
constexpr int kThreads = kPix / kPx;     // threads of a tile's block
constexpr int kBatch = kThreads;         // instances staged at a time
constexpr unsigned kAllDone = (1u << kPx) - 1;
constexpr unsigned kAllQuarters = 0xfu;

// The quarters of the tile at (x0, y0) that the splat (mx, my, conic a, b,
// c, log-opacity lo) can reach: bit q set unless no pixel of quarter
// (q % 2, q / 2) can pass the kLogAlphaMinSafe pre-test, and so the 1/255
// gate. Rendered in raster/render.py `quarter_masks_torch`.
//
// A pixel passes the pre-test only if lo + power_f >= kLogAlphaMinSafe,
// with power_f the float power of splat_power. For a pixel at offset d,
// |power_f - power| <= 3 eps S (eps = 2^-24, S = |a| dx^2 + |c| dy^2 +
// 2 |b dx dy|: the float roundings of dx, dy and the products), so with
// t = lo - kLogAlphaMinSafe a pixel can pass only where
//   Q(d) = a dx^2 + 2 b dx dy + c dy^2 <= 2 t',  t' = t + 4 eps S_max + 1e-4
// (S_max over the tile; 1e-4 covers the final sum's rounding). That
// ellipse lies within |dx| <= sqrt(2 t' c / det), |dy| <= sqrt(2 t' a /
// det), det = a c - b^2, and the box is widened by a pixel. Never culled:
// non-finite values, a conic that is not positive definite, or values
// large enough for a float product to overflow (power would then be NaN,
// which the gates let through). Culled whole when t < 0: power <= 0 then
// leaves lo + power < kLogAlphaMinSafe, and power > 0 is skipped.
__device__ __forceinline__ unsigned quarter_mask(float4 g0, float2 g1,
                                                 int x0, int y0) {
  const double mx = g0.x, my = g0.y, a = g0.z, b = g0.w, c = g1.x,
               lo = g1.y;
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(lo)))
    return kAllQuarters;
  const double det = a * c - b * b;
  if (!(a > 0.0 && det > 0.0)) return kAllQuarters;
  const double ex = fmax(fabs(mx - x0), fabs(mx - (x0 + 15)));
  const double ey = fmax(fabs(my - y0), fabs(my - (y0 + 15)));
  const double e = fmax(1.0, fmax(ex, ey));
  if (!(fmax(fmax(fabs(a), fabs(b)), fabs(c)) * e * e < 1e37))
    return kAllQuarters;
  const double t = lo - (double)adgs::kLogAlphaMinSafe;
  if (t < 0.0) return 0u;
  const double s_max = fabs(a) * ex * ex + fabs(c) * ey * ey +
                       2.0 * fabs(b) * ex * ey;
  const double tt = t + 4.0 * 0x1p-24 * s_max + 1e-4;
  const double hx = sqrt(2.0 * tt * c / det) + 1.0;
  const double hy = sqrt(2.0 * tt * a / det) + 1.0;
  unsigned mask = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const double qx = x0 + (q & 1) * 8, qy = y0 + (q >> 1) * 8;
    if (mx + hx >= qx && mx - hx <= qx + 7.0 && my + hy >= qy &&
        my - hy <= qy + 7.0)
      mask |= 1u << q;
  }
  return mask;
}

// ld: floats per row of `src` (F for "gather", 128 for "rows")
template <int CH, bool ROWS>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ src, int ld,
                     const int32_t* __restrict__ gauss_id,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count,
                     const int32_t* __restrict__ tile_order, int grid_x,
                     float* __restrict__ out) {
  __shared__ float4 s_g0[kBatch];   // mx, my, a, b
  __shared__ float2 s_g1[kBatch];   // c, log-opacity
  __shared__ float s_f[CH][kBatch];
  __shared__ unsigned s_quad[kBatch];

  const int tile = tile_order[blockIdx.x];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  // thread tid: column col of rows r0 and r0 + 1; warp w covers the 8x8
  // quarter (w % 2, w / 2) of the tile, lanes 8 a row pair (B4's map)
  static_assert(kPx == 2, "the pixel map below is for two pixels a thread");
  const int col = (warp & 1) * 8 + (tid & 7);
  const int r0 = (tid >> 6) * 8 + ((tid >> 3) & 3) * 2;
  const int x0 = (tile % grid_x) * 16;
  const int y0 = (tile / grid_x) * 16;
  const float px = (float)(x0 + col);
  float py[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) py[k] = (float)(y0 + r0 + k);
  const int start = tile_start[tile];
  const int count = tile_count[tile];
  const unsigned qbit = 1u << warp;

  float T[kPx];
  float acc[kPx][CH];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    T[k] = 1.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[k][c] = 0.0f;
  }
  unsigned done = 0;   // bit k: pixel k has stopped

  for (int base = 0; base < count; base += kBatch) {
    // the whole tile's exit once every pixel has stopped; also the
    // barrier that frees the previous batch's shared memory
    if (__syncthreads_and(done == kAllDone)) break;
    const int i = base + tid;
    if (i < count) {
      const float* row = adgs::instance_row<ROWS>(src, ld, gauss_id, start + i);
      const float4 g0 = reinterpret_cast<const float4*>(row)[0];
      const float4 g1 = reinterpret_cast<const float4*>(row)[1];
      const float2 h = make_float2(g1.x, g1.y);
      s_g0[tid] = g0;
      s_g1[tid] = h;
#pragma unroll
      for (int c = 0; c < CH; ++c) s_f[c][tid] = row[kGeom + c];
      s_quad[tid] = quarter_mask(g0, h, x0, y0);
    }
    __syncthreads();
    const int n = min(kBatch, count - base);
    for (int j = 0; j < n && done != kAllDone; ++j) {
      if (!(s_quad[j] & qbit)) continue;   // warp-uniform
      const float4 q = s_g0[j];
      const float2 r = s_g1[j];
      const float dx = __fsub_rn(q.x, px);
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        if (done & (1u << k)) continue;
        const float dy = __fsub_rn(q.y, py[k]);
        const float power = adgs::splat_power(q.z, q.w, r.x, dx, dy);
        if (__fadd_rn(r.y, power) < adgs::kLogAlphaMinSafe) continue;
        float e;
        const float alpha = adgs::splat_alpha(r.y, power, &e);
        if (alpha == 0.0f) continue;
        const float test_t = adgs::next_t(T[k], alpha);
        if (test_t < adgs::kTEps) {
          done |= 1u << k;
          continue;
        }
        const float w = alpha * T[k];
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[k][c] += s_f[c][j] * w;
        T[k] = test_t;
      }
    }
  }

  float* o = out + (size_t)tile * (CH + 1) * kPix;
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    const int pix = (r0 + k) * 16 + col;
#pragma unroll
    for (int c = 0; c < CH; ++c) o[c * kPix + pix] = acc[k][c];
    o[CH * kPix + pix] = T[k];
  }
}

// B3's tile order (tile_order.cuh)
__global__ void __launch_bounds__(256)
fwd_order_kernel(const int32_t* __restrict__ tile_count, int num_tiles,
                 int32_t* __restrict__ order) {
  adgs::rank_tiles(tile_count, num_tiles, order);
}

template <int CH>
void launch(bool rows, const float* src, int ld, const int32_t* gauss_id,
            const int32_t* tile_start, const int32_t* tile_count,
            const int32_t* tile_order, int num_tiles, int grid_x, float* out,
            cudaStream_t st) {
  if (rows)
    composite_fwd_kernel<CH, true><<<num_tiles, kThreads, 0, st>>>(
        src, ld, gauss_id, tile_start, tile_count, tile_order, grid_x, out);
  else
    composite_fwd_kernel<CH, false><<<num_tiles, kThreads, 0, st>>>(
        src, ld, gauss_id, tile_start, tile_count, tile_order, grid_x, out);
}

}  // namespace

// rows = 0: src is the packed [N, ld] rows, read through gauss_id;
// rows = 1: src is the tile-ordered [R, ld] instance rows. tile_order:
// [num_tiles] int32, written with the order the blocks take the tiles in.
extern "C" int adgs_composite_fwd(const void* src, int ld, int rows,
                                  const void* gauss_id,
                                  const void* tile_start,
                                  const void* tile_count, void* tile_order,
                                  int num_tiles, int grid_x, int ch,
                                  void* out, void* stream) {
  const float* p = (const float*)src;
  const bool rm = rows != 0;
  const int32_t* gi = (const int32_t*)gauss_id;
  const int32_t* ts = (const int32_t*)tile_start;
  const int32_t* tc = (const int32_t*)tile_count;
  int32_t* to = (int32_t*)tile_order;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (ch < 1 || ch > 8) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return 0;
  fwd_order_kernel<<<adgs::rank_blocks(num_tiles), 256, 0, st>>>(
      tc, num_tiles, to);
  switch (ch) {
    case 1: launch<1>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    case 2: launch<2>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    case 3: launch<3>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    case 4: launch<4>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    case 5: launch<5>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    case 6: launch<6>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    case 7: launch<7>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    case 8: launch<8>(rm, p, ld, gi, ts, tc, to, num_tiles, grid_x, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
