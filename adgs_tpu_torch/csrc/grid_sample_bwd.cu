// B8 — adjoint of the environment-map sample (B7) for sm_90a.
//
// Replaces: adgs_tpu/ops/grid_sample.py `_bwd_kernel` (driven by
// `scatter_image_pallas`): d_grid[c, cell] = sum over the taps (p, t) that
// read `cell` of w_t(p) * g[c, p], with the taps of sky_taps.cuh, which
// B7 shares, so every tap lands on the cell the forward read. Taps off the
// grid carry weight 0 and are left out. Coordinates get no gradient.
//
// The JAX kernel accumulates into static grid windows in VMEM with
// one-hot matmuls and routes the blocks whose taps leave the window
// through a residual scatter. Here the scatter is made deterministic
// without atomics, in three steps (the middle one in the wrapper):
//   1. tap_cells: the cell id of each of the 4 * npix taps (tap-major,
//      t * npix + p), or the sentinel Hg * Wg for a tap off the grid;
//   2. a stable torch.sort of those ids (ids only; the sort's indices say
//      which tap each sorted position holds);
//   3. scatter_runs: the first position of every run of equal ids sums
//      w * g over its run, in tap order, and writes each channel of that
//      cell once into the zeroed grid.
// The sum order is the plain twin's (index_add_ in tap order), so the
// two agree bit for bit where the twin runs serially.
//
// Bound: bytes. The gradient grid is dense (C x Hg x Wg f32, zeroed by the
// caller) and the work is the 4 * npix taps: read coords and g, write one
// value per touched cell and channel. Design: one thread per pixel for the
// ids, one thread per sorted position for the runs (runs are short: a
// cell is read by a few neighbouring pixels at most).

#include "sky_taps.cuh"

namespace {

constexpr int kMaxC = 8;

__global__ void tap_cells_kernel(const float* __restrict__ coords, int npix,
                                 int Hg, int Wg, int32_t* __restrict__ cells) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  int64_t idx[4];
  float w[4];
  bool inb[4];
  adgs::sky_taps(reinterpret_cast<const float2*>(coords)[p], Hg, Wg, idx, w,
                 inb);
  const int32_t off = Hg * Wg;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    cells[(size_t)t * npix + p] = inb[t] ? (int32_t)idx[t] : off;
}

__global__ void scatter_runs_kernel(const int32_t* __restrict__ sorted_cells,
                                    const int64_t* __restrict__ order,
                                    int ntaps, const float* __restrict__ coords,
                                    const float* __restrict__ g, int C,
                                    int npix, int Hg, int Wg,
                                    float* __restrict__ d_grid) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= ntaps) return;
  const int32_t cell = sorted_cells[q];
  if (cell >= Hg * Wg) return;                       // taps off the grid
  if (q > 0 && sorted_cells[q - 1] == cell) return;  // not a run's head
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.0f;
  for (int r = q; r < ntaps && sorted_cells[r] == cell; ++r) {
    const int64_t tap = order[r];
    const int p = (int)(tap % npix);
    const int t = (int)(tap / npix);
    int64_t idx[4];
    float w[4];
    bool inb[4];
    adgs::sky_taps(reinterpret_cast<const float2*>(coords)[p], Hg, Wg, idx,
                   w, inb);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(g[(size_t)c * npix + p], w[t]));
  }
  const size_t plane = (size_t)Hg * Wg;
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) d_grid[c * plane + cell] = acc[c];
}

}  // namespace

extern "C" int adgs_sky_tap_cells(const void* coords, int npix, int Hg,
                                  int Wg, void* cells, void* stream) {
  if (npix <= 0) return 0;
  const int threads = 256;
  tap_cells_kernel<<<(npix + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>((const float*)coords, npix, Hg,
                                             Wg, (int32_t*)cells);
  return (int)cudaGetLastError();
}

extern "C" int adgs_sky_scatter_runs(const void* sorted_cells,
                                     const void* order, int ntaps,
                                     const void* coords, const void* g, int C,
                                     int npix, int Hg, int Wg, void* d_grid,
                                     void* stream) {
  if (ntaps <= 0) return 0;
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  scatter_runs_kernel<<<(ntaps + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)sorted_cells, (const int64_t*)order, ntaps,
      (const float*)coords, (const float*)g, C, npix, Hg, Wg,
      (float*)d_grid);
  return (int)cudaGetLastError();
}
