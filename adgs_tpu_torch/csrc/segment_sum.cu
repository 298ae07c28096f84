// B5 — per-segment sum of contiguous rows for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/render.py `_segreduce_kernel` (driven
// by `segment_reduce_contiguous`). Input rows [R, D] f32 and bounds [n+1]
// int32 (non-decreasing, bounds[n] <= R); output out[i, :] =
// sum of rows[bounds[i] .. bounds[i+1]). On the compositing backward the
// rows are B4's gradient rows in presort (Gaussian-major) order and
// bounds are the expansion's exclusive prefix sums clipped to
// min(num_rendered, capacity), so out is the per-Gaussian gradient; the
// KNN regularizer's backward uses it on its sorted group cotangents.
//
// The JAX kernel sums through a membership one-hot matmul on the MXU over
// 512-Gaussian blocks; here each segment is summed directly.
//
// Bound: bytes (each row read once, each output row written once, one add
// per element read). Design: one warp per segment, lanes over the D
// columns (a loop of 32 columns at a time), rows added one after the
// other in index order: the sum order is fixed, so the result is
// deterministic, and no atomics are used.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void segment_sum_kernel(const float* __restrict__ rows, int D,
                                   const int32_t* __restrict__ bounds, int n,
                                   float* __restrict__ out) {
  const long long gw =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= n) return;
  const int lo = bounds[gw];
  const int hi = bounds[gw + 1];
  for (int col = lane; col < D; col += 32) {
    float acc = 0.0f;
    for (int r = lo; r < hi; ++r) acc += rows[(size_t)r * D + col];
    out[(size_t)gw * D + col] = acc;
  }
}

extern "C" int adgs_segment_sum(const void* rows, int D, const void* bounds,
                                int n, void* out, void* stream) {
  if (n <= 0 || D <= 0) return 0;
  const int threads = 256;                 // 8 segments per block
  const long long blocks = ((long long)n * 32 + threads - 1) / threads;
  segment_sum_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)rows, D, (const int32_t*)bounds, n, (float*)out);
  return (int)cudaGetLastError();
}
