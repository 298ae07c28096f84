// B7 — bilinear environment-map sample for sm_90a.
//
// Replaces: adgs_tpu/ops/grid_sample.py `_fwd_kernel` (driven by
// `sample_image_pallas`). Samples grid [C, Hg, Wg] at image-shaped coords
// [H, W, 2] in [-1, 1] with torch grid_sample(align_corners=True,
// padding_mode='zeros') semantics -> out [C, H, W]. The arithmetic is
// adgs_tpu/models/env_map.py `_taps` exactly:
//   x = (cx + 1) * 0.5 * (Wg - 1), x0 = floor(x), wx = x - x0 (same for y)
//   taps (x0,y0) (x0+1,y0) (x0,y0+1) (x0+1,y0+1) with weights
//   (1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy; an out-of-range tap gets
//   weight 0 (its index is clipped), and v = ((t0 + t1) + t2) + t3.
// Every operation is rounded separately (no fused multiply-add), so the
// result equals the plain PyTorch version bit for bit.
//
// The JAX kernel's static [48 x 256] grid windows, seam wrap and residual
// blocks exist so the TPU can turn the gather into one-hot matmuls; here
// every thread gathers its taps directly.
//
// Bound: bytes. Per pixel it reads 8 bytes of coords and 4 taps x C
// floats of the grid, and writes C floats; neighbouring pixels tap
// neighbouring cells, so the cache serves most of the grid reads. Design:
// one thread per output pixel, 256 threads a block, C looped inside.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void grid_sample_kernel(const float* __restrict__ grid, int C,
                                   int Hg, int Wg,
                                   const float* __restrict__ coords,
                                   int npix, float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const float2 cxy = reinterpret_cast<const float2*>(coords)[p];
  const float x = __fmul_rn(__fmul_rn(__fadd_rn(cxy.x, 1.0f), 0.5f),
                            (float)(Wg - 1));
  const float y = __fmul_rn(__fmul_rn(__fadd_rn(cxy.y, 1.0f), 0.5f),
                            (float)(Hg - 1));
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float wx = __fsub_rn(x, x0);
  const float wy = __fsub_rn(y, y0);
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);

  const float tx[4] = {x0, __fadd_rn(x0, 1.0f), x0, __fadd_rn(x0, 1.0f)};
  const float ty[4] = {y0, y0, __fadd_rn(y0, 1.0f), __fadd_rn(y0, 1.0f)};
  const float tw[4] = {__fmul_rn(ux, uy), __fmul_rn(wx, uy),
                       __fmul_rn(ux, wy), __fmul_rn(wx, wy)};
  const float xmax = (float)(Wg - 1);
  const float ymax = (float)(Hg - 1);
  size_t idx[4];
  float w[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool inb = tx[t] >= 0.0f && tx[t] <= xmax && ty[t] >= 0.0f &&
                     ty[t] <= ymax;
    // fmaxf maps NaN to 0, as XLA's saturating float->int conversion does
    const int xi = (int)fminf(fmaxf(tx[t], 0.0f), xmax);
    const int yi = (int)fminf(fmaxf(ty[t], 0.0f), ymax);
    idx[t] = (size_t)yi * Wg + xi;
    w[t] = inb ? tw[t] : 0.0f;
  }
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
