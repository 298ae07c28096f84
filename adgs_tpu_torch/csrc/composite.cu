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
// taken as mean - pixel directly.
//
// Bound: operations (one exp and ~20 flops per instance-pixel pair until
// the pixel saturates) and, for sparse tiles, the latency of the gathered
// row loads. Design: one block of 256 threads per tile, one thread per
// pixel (forward.cu's pattern). A batch of 256 instances is staged in
// shared memory, each thread gathering one Gaussian row through gauss_id
// with 16-byte loads; every thread then reads the batch from shared memory.
// A block-wide vote (__syncthreads_count) ends the tile once every pixel
// has saturated. The gating arithmetic lives in composite_common.cuh, which
// the backward (B4, composite_bwd.cu) replays bit for bit.
//
// Two instance layouts, chosen by the ROWS template flag (the JAX
// package's ADGS_RM): "gather" reads instance i of a tile as row
// gauss_id[start + i] of the packed [N, F] rows; "rows" reads it as row
// start + i of the tile-ordered [R, 128] instance rows that B6 and one row
// gather built (raster/render.py build_instances_rows). Only the staging
// load differs, so both layouts give bitwise equal outputs.

#include "composite_common.cuh"

namespace {

using adgs::kGeom;
using adgs::kPix;

// ld: floats per row of `src` (F for "gather", 128 for "rows")
template <int CH, bool ROWS>
__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const float* __restrict__ src, int ld,
                     const int32_t* __restrict__ gauss_id,
                     const int32_t* __restrict__ tile_start,
                     const int32_t* __restrict__ tile_count, int grid_x,
                     float* __restrict__ out) {
  __shared__ float s_mx[kPix], s_my[kPix], s_ca[kPix], s_cb[kPix],
      s_cc[kPix], s_lo[kPix];
  __shared__ float s_f[CH][kPix];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * 16 + (tid & 15));
  const float py = (float)((tile / grid_x) * 16 + (tid >> 4));
  const int start = tile_start[tile];
  const int count = tile_count[tile];

  float T = 1.0f;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
  int done = 0;

  for (int base = 0; base < count; base += kPix) {
    // also the barrier that frees the previous batch's shared memory
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
    }
    __syncthreads();
    if (!done) {
      const int n = min(kPix, count - base);
      for (int j = 0; j < n; ++j) {
        const float dx = __fsub_rn(s_mx[j], px);
        const float dy = __fsub_rn(s_my[j], py);
        const float power =
            adgs::splat_power(s_ca[j], s_cb[j], s_cc[j], dx, dy);
        float e;
        const float alpha = adgs::splat_alpha(s_lo[j], power, &e);
        if (alpha == 0.0f) continue;
        const float test_t = adgs::next_t(T, alpha);
        if (test_t < adgs::kTEps) {
          done = 1;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] += s_f[c][j] * w;
        T = test_t;
      }
    }
  }

  float* o = out + (size_t)tile * (CH + 1) * kPix + tid;
#pragma unroll
  for (int c = 0; c < CH; ++c) o[c * kPix] = acc[c];
  o[CH * kPix] = T;
}

template <int CH>
void launch(bool rows, const float* src, int ld, const int32_t* gauss_id,
            const int32_t* tile_start, const int32_t* tile_count,
            int num_tiles, int grid_x, float* out, cudaStream_t st) {
  if (rows)
    composite_fwd_kernel<CH, true><<<num_tiles, kPix, 0, st>>>(
        src, ld, gauss_id, tile_start, tile_count, grid_x, out);
  else
    composite_fwd_kernel<CH, false><<<num_tiles, kPix, 0, st>>>(
        src, ld, gauss_id, tile_start, tile_count, grid_x, out);
}

}  // namespace

// rows = 0: src is the packed [N, ld] rows, read through gauss_id;
// rows = 1: src is the tile-ordered [R, ld] instance rows.
extern "C" int adgs_composite_fwd(const void* src, int ld, int rows,
                                  const void* gauss_id,
                                  const void* tile_start,
                                  const void* tile_count, int num_tiles,
                                  int grid_x, int ch, void* out,
                                  void* stream) {
  const float* p = (const float*)src;
  const bool rm = rows != 0;
  const int32_t* gi = (const int32_t*)gauss_id;
  const int32_t* ts = (const int32_t*)tile_start;
  const int32_t* tc = (const int32_t*)tile_count;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (num_tiles <= 0) return 0;
  switch (ch) {
    case 1: launch<1>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    case 2: launch<2>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    case 3: launch<3>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    case 4: launch<4>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    case 5: launch<5>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    case 6: launch<6>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    case 7: launch<7>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    case 8: launch<8>(rm, p, ld, gi, ts, tc, num_tiles, grid_x, o, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
