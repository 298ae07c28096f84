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
// without atomics by ordering pixels, not taps. A pixel's four taps are
// the 2x2 cells from its base (x0, y0) (sky_taps.cuh), so cell (x, y) is
// fed by tap 0 of base (x, y), tap 1 of (x - 1, y), tap 2 of (x, y - 1)
// and tap 3 of (x - 1, y - 1). Bases live on a grid one larger than the
// sky's, shifted by one, so that x0 = -1 or y0 = -1 (a pixel whose only
// taps in the grid are its taps 1-3) still has a key:
//   1. pixel_keys: one thread per pixel writes the key
//      (y0 + 1) * (Wg + 1) + x0 + 1 of its base, or the sentinel
//      (Hg + 1) * (Wg + 1) when all four taps are off the grid;
//   2. the wrapper orders the npix keys with a stable torch.sort (a
//      quarter of the elements a tap-keyed order sorts);
//   3. tap_values: one thread per sorted position writes its pixel's four
//      products w_t * g[c] in sorted order (each tap's weight computed
//      once); threads 0 .. (Hg + 2) * 9 - 1 also find, by binary search,
//      the first sorted position of each base row's segments of 1024;
//   4. sum_fill: one block per segment of 1024 cells of a grid row
//      writes the segment's zeros in all C channels (the fill, fused:
//      16-byte stores that wait on no load), then, where taps land, each
//      reached cell once more with its sum over the four base runs that
//      feed it, read from the two base rows the row needs (bases of rows
//      y and y - 1, the segment's range in each read from tap_values'
//      table, the bounds of its runs held in shared memory). The sky's
//      C = 3 is a template case that loads the first product of all four
//      runs at once, so a cell waits on one load, not four in a row.
// Every cell sums tap 0's run, then tap 1's, 2's and 3's, each run in
// pixel order (the sort is stable): the tap-major order of the plain twin
// (index_add_ over tap-major ids), so the two agree bit for bit where the
// twin runs serially, and two launches agree bit for bit.
//
// Bound: bytes. The gradient is dense (C x Hg x Wg f32, 805 MB for the
// 3 x 8192^2 sky) and sum_fill writes it in one pass at the rate of a
// memset; the reached cells' second write and the taps' own traffic
// (coords, g, keys, products) are ~1-3% of it.

#include "sky_taps.cuh"

namespace {

constexpr int kMaxC = 8;
constexpr int kThreads = 256;
constexpr int kSeg = 1024;   // cells of a grid row per sum_fill block

__global__ void pixel_keys_kernel(const float2* __restrict__ coords,
                                  int npix, int Hg, int Wg,
                                  int32_t* __restrict__ keys) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= npix) return;
  float x0, y0, wx, wy;
  adgs::sky_corner(coords[p], Hg, Wg, x0, y0, wx, wy);
  // some tap lies on the grid iff x0 in [-1, Wg - 1] and y0 in [-1, Hg - 1]
  // (false for NaN)
  const bool live = x0 >= -1.0f && x0 <= (float)(Wg - 1) && y0 >= -1.0f &&
                    y0 <= (float)(Hg - 1);
  const int W1 = Wg + 1;
  keys[p] = live ? ((int)y0 + 1) * W1 + (int)x0 + 1 : (Hg + 1) * W1;
}

// first position in [lo, hi) of the sorted keys whose key is >= target
__device__ int first_at_least(const int32_t* __restrict__ skeys, int lo,
                              int hi, int32_t target) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (skeys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// one thread per sorted position i < npix: its pixel's four products, in
// sorted order. Threads i < (Hg + 2) * (nseg + 1) also find seg_start[i]
// for base row r = i / (nseg + 1) and k = i % (nseg + 1): the first
// position whose key is >= r * W1 + min(k * kSeg, W1), i.e. the first base
// of row r at x' >= k * kSeg, or row r + 1's first (row Hg + 1 holds the
// sentinels)
__global__ void tap_values_kernel(const int32_t* __restrict__ skeys,
                                  const int64_t* __restrict__ order, int npix,
                                  const float2* __restrict__ coords,
                                  const float* __restrict__ g, int C, int Hg,
                                  int Wg, float* __restrict__ vals,
                                  int32_t* __restrict__ seg_start) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int W1 = Wg + 1;
  const int nk = (Wg + kSeg - 1) / kSeg + 1;
  if (i < (Hg + 2) * nk) {
    const int r = i / nk;
    const int x = min((i - r * nk) * kSeg, W1);
    seg_start[i] = first_at_least(skeys, 0, npix, r * W1 + x);
  }
  if (i >= npix || skeys[i] / W1 > Hg) return;   // all taps off the grid
  const int p = (int)order[i];
  int32_t idx[4];
  float w[4];
  bool inb[4];
  adgs::sky_taps(coords[p], Hg, Wg, idx, w, inb);
  for (int c = 0; c < C; ++c) {
    const float gv = g[(size_t)c * npix + p];
#pragma unroll
    for (int t = 0; t < 4; ++t)
      vals[((size_t)t * C + c) * npix + i] = __fmul_rn(gv, w[t]);
  }
}

// zeros into cells [0, nx) of a row segment in every channel
__device__ __forceinline__ void zero_cells(float* out, size_t plane, int C,
                                           int nx, int Wg) {
  if ((Wg & 3) == 0) {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int c = 0; c < C; ++c)
      for (int j = threadIdx.x; j < nx / 4; j += kThreads)
        reinterpret_cast<float4*>(out + c * plane)[j] = z;
  } else {
    for (int c = 0; c < C; ++c)
      for (int j = threadIdx.x; j < nx; j += kThreads)
        out[c * plane + j] = 0.0f;
  }
}

// one block per (grid row yc, segment k of kSeg cells); CT > 0: C == CT
// at compile time, CT == 0: C at run time
template <int CT>
__global__ void __launch_bounds__(kThreads)
    sum_fill_kernel(const int32_t* __restrict__ skeys,
                    const int32_t* __restrict__ seg_start,
                    const float* __restrict__ vals, int npix, int C, int Hg,
                    int Wg, float* __restrict__ d_grid) {
  // s_run[r][0 / 1][j]: first / past-last sorted position of the run of
  // base x' = xs + j (shifted x) in base row yc + 1 (r = 0: taps 0, 1) or
  // yc (r = 1: taps 2, 3); first -1: no run
  __shared__ int s_run[2][2][kSeg + 1];
  __shared__ int s_range[4];
  const int tid = threadIdx.x;
  const int nk = (Wg + kSeg - 1) / kSeg + 1;
  const int k = blockIdx.x;
  const int yc = blockIdx.y;
  const int xs = k * kSeg;
  const int nx = min(kSeg, Wg - xs);
  const int W1 = Wg + 1;
  const size_t plane = (size_t)Hg * Wg;
  float* out = d_grid + (size_t)yc * Wg + xs;
  // the fill first: its stores need no load, so they stream while the
  // table is read; the cells that taps reach are written again below,
  // after a barrier, by their sums
  zero_cells(out, plane, C, nx, Wg);
  // base rows yc and yc + 1: positions [seg_start[yc][0], seg_start[yc+2][0])
  if (seg_start[yc * nk] == seg_start[(yc + 2) * nk]) return;
  if (tid < 2) {
    // [lo, hi) of the base keys x' in [xs, xs + nx] of base row yb
    const int yb = yc + 1 - tid;
    const int* row = seg_start + yb * nk;
    const int end = row[nk];                     // row yb + 1's first
    int hi = end;
    if (xs + nx < Wg) {                          // x' = xs + nx: a walk
      hi = row[k + 1];
      const int32_t last = yb * W1 + xs + nx;
      while (hi < end && skeys[hi] == last) ++hi;
    }
    s_range[2 * tid] = row[k];
    s_range[2 * tid + 1] = hi;
  }
  __syncthreads();
  const int loA = s_range[0], hiA = s_range[1];
  const int loB = s_range[2], hiB = s_range[3];
  if (loA == hiA && loB == hiB) return;          // no tap lands here
  for (int j = tid; j <= nx; j += kThreads) {
    s_run[0][0][j] = -1;
    s_run[1][0][j] = -1;
  }
  __syncthreads();
  for (int r = 0; r < 2; ++r) {
    const int lo = r ? loB : loA;
    const int hi = r ? hiB : hiA;
    const int32_t base = (yc + 1 - r) * W1 + xs;
    for (int i = lo + tid; i < hi; i += kThreads) {
      const int32_t key = skeys[i];
      if (i == lo || skeys[i - 1] != key) s_run[r][0][key - base] = i;
      if (i + 1 == hi || skeys[i + 1] != key) s_run[r][1][key - base] = i + 1;
    }
  }
  __syncthreads();
  constexpr int NC = CT > 0 ? CT : kMaxC;
  for (int j = tid; j < nx; j += kThreads) {
    // cell x = xs + j: tap 0 of base x' = x + 1 (run j + 1), tap 1 of
    // x' = x (run j), in row yc + 1; taps 2 and 3 likewise in row yc
    int i0[4], i1[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      i0[t] = s_run[t >> 1][0][j + 1 - (t & 1)];
      i1[t] = s_run[t >> 1][1][j + 1 - (t & 1)];
    }
    if ((i0[0] & i0[1] & i0[2] & i0[3]) < 0) continue;   // no tap: a zero
    // the first product of every run, loaded together
    float first[4][NC];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        first[t][c] = i0[t] >= 0 && (CT > 0 || c < C)
                          ? vals[((size_t)t * C + c) * npix + i0[t]]
                          : 0.0f;
    float acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
    // tap 0's run, then tap 1's, 2's and 3's, each in sorted order
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (i0[t] < 0) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], first[t][c]);
      for (int i = i0[t] + 1; i < i1[t]; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (CT > 0 || c < C)
            acc[c] =
                __fadd_rn(acc[c], vals[((size_t)t * C + c) * npix + i]);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (CT > 0 || c < C) out[c * plane + j] = acc[c];
  }
}

}  // namespace

extern "C" int adgs_sky_pixel_keys(const void* coords, int npix, int Hg,
                                   int Wg, void* keys, void* stream) {
  if (npix <= 0) return 0;
  pixel_keys_kernel<<<(npix + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>((const float2*)coords, npix, Hg,
                                              Wg, (int32_t*)keys);
  return (int)cudaGetLastError();
}

// int32 entries of the seg_start table that tap_values writes and
// sum_fill reads: Hg + 2 base rows of ceil(Wg / kSeg) + 1 segment starts
extern "C" int adgs_sky_table_len(int Hg, int Wg) {
  return (Hg + 2) * ((Wg + kSeg - 1) / kSeg + 1);
}

// seg_start: adgs_sky_table_len(Hg, Wg) int32 (the wrapper's)
extern "C" int adgs_sky_tap_values(const void* sorted_keys, const void* order,
                                   int npix, const void* coords,
                                   const void* g, int C, int Hg, int Wg,
                                   void* vals, void* seg_start,
                                   void* stream) {
  if (npix <= 0) return 0;
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const int table = adgs_sky_table_len(Hg, Wg);
  const int threads = npix > table ? npix : table;
  tap_values_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)sorted_keys, (const int64_t*)order, npix,
      (const float2*)coords, (const float*)g, C, Hg, Wg, (float*)vals,
      (int32_t*)seg_start);
  return (int)cudaGetLastError();
}

extern "C" int adgs_sky_sum_fill(const void* sorted_keys,
                                 const void* seg_start, const void* vals,
                                 int npix, int C, int Hg, int Wg,
                                 void* d_grid, void* stream) {
  if (Hg <= 0 || Wg <= 0) return 0;
  if (C < 1 || C > kMaxC || npix <= 0 || Hg > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((Wg + kSeg - 1) / kSeg, Hg);
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 3)
    sum_fill_kernel<3><<<blocks, kThreads, 0, st>>>(
        (const int32_t*)sorted_keys, (const int32_t*)seg_start,
        (const float*)vals, npix, C, Hg, Wg, (float*)d_grid);
  else
    sum_fill_kernel<0><<<blocks, kThreads, 0, st>>>(
        (const int32_t*)sorted_keys, (const int32_t*)seg_start,
        (const float*)vals, npix, C, Hg, Wg, (float*)d_grid);
  return (int)cudaGetLastError();
}
