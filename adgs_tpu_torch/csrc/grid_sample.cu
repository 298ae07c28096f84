// B7 — bilinear environment-map sample for sm_90a.
//
// Replaces: adgs_tpu/ops/grid_sample.py `_fwd_kernel` (driven by
// `sample_image_pallas`). Samples grid [C, Hg, Wg] at image-shaped coords
// [H, W, 2] in [-1, 1] with torch grid_sample(align_corners=True,
// padding_mode='zeros') semantics -> out [C, H, W]: the four taps of
// sky_taps.cuh (shared with the backward, B8), and
// v = ((t0 + t1) + t2) + t3, every operation rounded separately (no fused
// multiply-add), so the result equals the plain PyTorch version bit for
// bit.
//
// The JAX kernel's static [48 x 256] grid windows, seam wrap and residual
// blocks exist so the TPU can turn the gather into one-hot matmuls; here
// every thread gathers its taps directly.
//
// Bound: bytes. Per pixel it reads 8 bytes of coords and 4 taps x C
// floats of the grid, and writes C floats; neighbouring pixels tap
// neighbouring cells, so the cache serves most of the grid reads. A tap
// load is a gather whose address comes from the coords, so the kernel is
// bound by how many of them are in flight. Design: one thread per pixel,
// 256 a block; the environment map's C = 3 is a template case, so all 12
// tap loads of a pixel are issued before the first is used (a C loop at
// run time keeps at most 4 in flight; other C take that generic path);
// indices in 32 bits (the wrapper refuses grids and outputs of 2^31
// elements or more).

#include "sky_taps.cuh"

namespace {

constexpr int kThreads = 256;

// CT > 0: C == CT at compile time; CT == 0: C at run time
template <int CT>
__global__ void __launch_bounds__(kThreads)
    grid_sample_kernel(const float* __restrict__ grid, int C, int Hg, int Wg,
                       const float* __restrict__ coords, int npix,
                       float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  const int plane = Hg * Wg;
  int32_t idx[4];
  float w[4];
  bool inb[4];
  adgs::sky_taps(reinterpret_cast<const float2*>(coords)[p], Hg, Wg, idx, w,
                 inb);
  if constexpr (CT > 0) {
    float tap[CT][4];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        tap[c][t] = __ldg(grid + c * plane + idx[t]);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float v = __fmul_rn(tap[c][0], w[0]);
#pragma unroll
      for (int t = 1; t < 4; ++t) v = __fadd_rn(v, __fmul_rn(tap[c][t], w[t]));
      out[c * npix + p] = v;
    }
  } else {
    for (int c = 0; c < C; ++c) {
      const float* g = grid + c * plane;
      float v = __fmul_rn(__ldg(g + idx[0]), w[0]);
#pragma unroll
      for (int t = 1; t < 4; ++t)
        v = __fadd_rn(v, __fmul_rn(__ldg(g + idx[t]), w[t]));
      out[c * npix + p] = v;
    }
  }
}

}  // namespace

// grid [C, Hg, Wg], coords [npix, 2], out [C, npix]; C * Hg * Wg and
// C * npix below 2^31.
extern "C" int adgs_grid_sample(const void* grid, int C, int Hg, int Wg,
                                const void* coords, int npix, void* out,
                                void* stream) {
  if (npix <= 0) return 0;
  const unsigned blocks = (npix + kThreads - 1) / kThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* g = (const float*)grid;
  const float* xy = (const float*)coords;
  if (C == 3)
    grid_sample_kernel<3><<<blocks, kThreads, 0, st>>>(g, C, Hg, Wg, xy, npix,
                                                       (float*)out);
  else
    grid_sample_kernel<0><<<blocks, kThreads, 0, st>>>(g, C, Hg, Wg, xy, npix,
                                                       (float*)out);
  return (int)cudaGetLastError();
}
