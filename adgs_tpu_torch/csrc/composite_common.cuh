// Per-pixel compositing arithmetic shared by B3 (composite.cu) and B4
// (composite_bwd.cu).
//
// The backward replays the forward's front-to-back loop, so both kernels
// must gate every (instance, pixel) pair identically: the power > 0 skip,
// the 1/255 skip, the min(0.99, .) clamp and the stop once the running T
// would fall below 1e-4. Every operation here is rounded on its own
// (__fmul_rn and friends, no fused multiply-add), so the two kernels, and
// the plain twins in raster/render.py that evaluate the same expressions
// with separate PyTorch ops, compute the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace adgs {

constexpr int kPix = 256;   // pixels of a 16x16 tile, one thread each
constexpr int kGeom = 8;    // packed row: mx, my, a, b, c, log-opacity, pad, pad
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTEps = 1e-4f;
// below this, exp(log_opacity + power) < 1/255 for certain (ln(1/255) =
// -5.5413; expf is within 2 ulp), so the pair is gated off as splat_alpha
// would gate it: both kernels skip the exp of such a pair
constexpr float kLogAlphaMinSafe = -5.6f;

// power = -0.5 (a dx^2 + c dy^2) - b dx dy, dx = mean.x - px
__device__ __forceinline__ float splat_power(float a, float b, float c,
                                             float dx, float dy) {
  const float q = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                            __fmul_rn(__fmul_rn(c, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, q), __fmul_rn(__fmul_rn(b, dx), dy));
}

// The gated alpha of one pair: 0 when it is skipped (power > 0 or alpha
// below 1/255), else min(0.99, e) with e = exp(log_opacity + power)
// returned too (the clamp is active where e >= 0.99).
__device__ __forceinline__ float splat_alpha(float log_opacity, float power,
                                             float* e) {
  if (power > 0.0f) {
    *e = 0.0f;
    return 0.0f;
  }
  *e = expf(__fadd_rn(log_opacity, power));
  const float alpha = fminf(kAlphaMax, *e);
  return alpha < kAlphaMin ? 0.0f : alpha;
}

// The staged row of sorted instance s (ld floats per row of src): the
// "rows" layout reads row s of the tile-ordered instance rows, the
// "gather" layout row gauss_id[s] of the packed per-Gaussian rows.
template <bool ROWS>
__device__ __forceinline__ const float* instance_row(
    const float* __restrict__ src, int ld,
    const int32_t* __restrict__ gauss_id, int s) {
  return src + (size_t)(ROWS ? s : gauss_id[s]) * ld;
}

// transmittance after a pair of alpha; the pixel stops (and the pair is
// not composited) when this is below kTEps
__device__ __forceinline__ float next_t(float T, float alpha) {
  return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

}  // namespace adgs
