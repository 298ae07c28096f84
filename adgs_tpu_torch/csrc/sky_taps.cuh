// Bilinear taps of the environment-map sample, shared by B7
// (grid_sample.cu) and its adjoint B8 (grid_sample_bwd.cu), so that every
// tap of the backward lands on the cell the forward read, with the same
// weight. The arithmetic is adgs_tpu/models/env_map.py `_taps` exactly
// (torch grid_sample align_corners=True, padding_mode='zeros'):
//   x = (cx + 1) * 0.5 * (Wg - 1), x0 = floor(x), wx = x - x0 (same for y)
//   taps (x0,y0) (x0+1,y0) (x0,y0+1) (x0+1,y0+1) with weights
//   (1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy; an out-of-range tap gets
//   weight 0 (its index is clipped).
// Every operation is rounded on its own (no fused multiply-add), so the
// plain PyTorch twins compute the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adgs {

// the base tap (x0, y0) = (floor x, floor y) of a coordinate and its
// fractions (wx, wy); every tap of the sample is (x0 + dx, y0 + dy) with
// dx, dy in {0, 1}. NaN coordinates give NaN.
__device__ __forceinline__ void sky_corner(float2 cxy, int Hg, int Wg,
                                           float& x0, float& y0, float& wx,
                                           float& wy) {
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(cxy.x, 1.0f), 0.5f),
                            (float)(Wg - 1));
  const float y = __fmul_rn(__fmul_rn(__fadd_rn(cxy.y, 1.0f), 0.5f),
                            (float)(Hg - 1));
  x0 = floorf(x);
  y0 = floorf(y);
  wx = __fsub_rn(x, x0);
  wy = __fsub_rn(y, y0);
}

// cell index (yi * Wg + xi, clipped) and weight of each of the 4 taps;
// inb[t] is false for a tap off the grid (its weight is 0). Index is
// int32_t where the caller has checked Hg * Wg < 2^31, else int64_t.
template <typename Index>
__device__ __forceinline__ void sky_taps(float2 cxy, int Hg, int Wg,
                                         Index idx[4], float w[4],
                                         bool inb[4]) {
  float x0, y0, wx, wy;
  sky_corner(cxy, Hg, Wg, x0, y0, wx, wy);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);

  const float tx[4] = {x0, __fadd_rn(x0, 1.0f), x0, __fadd_rn(x0, 1.0f)};
  const float ty[4] = {y0, y0, __fadd_rn(y0, 1.0f), __fadd_rn(y0, 1.0f)};
  const float tw[4] = {__fmul_rn(ux, uy), __fmul_rn(wx, uy),
                       __fmul_rn(ux, wy), __fmul_rn(wx, wy)};
  const float xmax = (float)(Wg - 1);
  const float ymax = (float)(Hg - 1);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    inb[t] = tx[t] >= 0.0f && tx[t] <= xmax && ty[t] >= 0.0f &&
             ty[t] <= ymax;
    // fmaxf maps NaN to 0, as XLA's saturating float->int conversion does
    const int xi = (int)fminf(fmaxf(tx[t], 0.0f), xmax);
    const int yi = (int)fminf(fmaxf(ty[t], 0.0f), ymax);
    idx[t] = (Index)yi * Wg + xi;
    w[t] = inb[t] ? tw[t] : 0.0f;
  }
}

}  // namespace adgs
