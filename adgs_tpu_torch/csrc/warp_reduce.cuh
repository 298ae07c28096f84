// Warp reduce-scatter shared by B4 (composite_bwd.cu) and E1/E2
// (lab_rowmajor.cu).
//
// Each of a warp's 32 lanes holds P partial values; the warp wants the sum
// of each value over its lanes. A butterfly per value costs 5 shuffles,
// 5 P in all. Halving exchanges cost P - 1 + log2(32 / P) for P <= 32 and
// 31 P / 32 above (P = 16: 16 shuffles against 80; P = 64: 62 against
// 320): at the step
// with offset O, a lane keeps the half of its values that its bit O
// selects and adds the partner's copy of that half, received for the half
// it gives away. Every sum is taken in a fixed order, so the result is the
// same on every launch.

#pragma once

#include <cuda_runtime.h>

namespace adgs {

constexpr unsigned kWarpFull = 0xffffffffu;

template <int P, int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[P], int lane) {
  constexpr int C = P * O / 16 > 1 ? P * O / 16 : 1;   // values still held
  if constexpr (C > 1) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float give = up ? v[i] : v[i + C / 2];
      const float keep = up ? v[i + C / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(kWarpFull, give, O);
    }
  } else {
    v[0] += __shfl_xor_sync(kWarpFull, v[0], O);
  }
  if constexpr (O > 1) reduce_scatter_step<P, O / 2>(v, lane);
}

// P a power of two from 1 to 1024. Afterwards lane L holds, in v[0 ..
// H - 1] with H = max(1, P / 32), the warp sums of values H * (L / S) ..
// H * (L / S) + H - 1, where S = max(1, 32 / P) lanes hold each of them
// (P = 16: lanes 2k and 2k + 1 hold value k; P = 64: lane L holds 2L and
// 2L + 1). The other entries of v are left undefined.
template <int P>
__device__ __forceinline__ void reduce_scatter(float (&v)[P], int lane) {
  static_assert(P >= 1 && P <= 1024 && (P & (P - 1)) == 0,
                "P must be a power of two");
  reduce_scatter_step<P, 16>(v, lane);
}

}  // namespace adgs
