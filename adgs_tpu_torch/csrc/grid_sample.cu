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
// neighbouring cells, so the cache serves most of the grid reads. Design:
// one thread per output pixel, 256 threads a block, C looped inside.

#include "sky_taps.cuh"

__global__ void grid_sample_kernel(const float* __restrict__ grid, int C,
                                   int Hg, int Wg,
                                   const float* __restrict__ coords,
                                   int npix, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  int64_t idx[4];
  float w[4];
  bool inb[4];
  adgs::sky_taps(reinterpret_cast<const float2*>(coords)[p], Hg, Wg, idx, w,
                 inb);
  const size_t plane = (size_t)Hg * Wg;
  for (int c = 0; c < C; ++c) {
    const float* g = grid + c * plane;
    float v = __fmul_rn(__ldg(g + idx[0]), w[0]);
#pragma unroll
    for (int t = 1; t < 4; ++t) v = __fadd_rn(v, __fmul_rn(__ldg(g + idx[t]), w[t]));
    out[(size_t)c * npix + p] = v;
  }
}

extern "C" int adgs_grid_sample(const void* grid, int C, int Hg, int Wg,
                                const void* coords, int npix, void* out,
                                void* stream) {
  if (npix <= 0) return 0;
  const int threads = 256;
  grid_sample_kernel<<<(npix + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)grid, C, Hg, Wg, (const float*)coords, npix,
      (float*)out);
  return (int)cudaGetLastError();
}
