// B5 — per-segment sum of contiguous rows for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/render.py `_segreduce_kernel` (driven
// by `segment_reduce_contiguous`). Input rows [R, D] f32 and bounds [n+1]
// int32 (non-decreasing; bounds[0] may be above 0 and bounds[n] below R);
// output out[i, :] = sum of rows[bounds[i] .. bounds[i+1]), exact zeros
// for an empty segment. On the compositing backward the rows are B4's
// gradient rows in presort (Gaussian-major) order and bounds are the
// expansion's exclusive prefix sums clipped to min(num_rendered,
// capacity), so out is the per-Gaussian gradient; the KNN regularizer's
// backward uses it on its sorted group cotangents. The JAX kernel sums
// through a membership one-hot matmul on the MXU over 512-Gaussian blocks.
//
// Bound: bytes (each row read once, each output row written once, one add
// per element read). The first design gave one warp to each segment and
// lost to index_add_ on this card twice over: the KNN rows put 2,594 rows
// of the padded anchor groups into segment 0, which one warp walked alone
// (the kernel ran at 13.4x its byte bound), and at D = 16 half of every
// warp's lanes had no column.
//
// Design: a reduce-by-key over fixed row tiles (the merge-based
// decomposition of Merrill and Garland's CSR SpMV, and CUB's
// ReduceByKey), so the work is balanced by rows, not by segments:
//   1. tiles_kernel: one block per tile of `tile_rows` rows counted from
//      bounds[0]. Two warps find the segments that start in the tile by a
//      32-ary search over bounds; the block stages their bounds in shared
//      memory. Its lane groups then take the tile's jobs in turn: the head
//      (the rows of a segment that started in an earlier tile) and each
//      segment that starts in the tile. A job sums its rows of the tile in
//      index order. A segment that also ends in the tile (or is empty) is
//      written to out; the head, and the piece of the one segment that
//      runs past the tile's end, go to the scratch `part` [tiles, 2, D],
//      and `meta[t]` names that segment (-1 if none).
//   2. spans_kernel: one warp per tile whose meta names a segment adds
//      that segment's piece and then the heads of the following tiles it
//      covers, in tile order, and writes the sum; the segments that start
//      at bounds[n] (empty ones at the end: `meta[tiles]`, set by the last
//      tile) get zeros. No warp walks more than one tile's rows.
// A lane group covers one job's D columns with float4 (D % 4 == 0),
// float2 or float loads, G lanes for D/V vectors (G = 1 .. 32, two
// vectors a lane at G = 32), so a warp holds 32 / G groups and its lanes
// read neighbouring addresses. The order of the additions depends only on
// bounds, D and tile_rows: the result is deterministic, with no atomics.
// No host synchronisation: the plan is found on the device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads of a tile's block
constexpr int kStage = 1024;    // bounds of a tile staged in shared memory

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static void add(T& a, T b) { a += b; }
};
template <> struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.0f, 0.0f); }
  __device__ static void add(T& a, T b) { a.x += b.x; a.y += b.y; }
};
template <> struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static void add(T& a, T b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
};

// First index i of b[0, len) with b[i] >= v (len if none), b
// non-decreasing. A whole warp calls it and every lane gets the answer:
// each round probes 32 evenly spaced entries and keeps the gap between the
// last probe below v and the first at or above it.
__device__ int warp_lower_bound(const int32_t* __restrict__ b, int len,
                                int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = len;                   // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int pos = lo + (int)((span * lane) >> 5);
    const int c = __popc(__ballot_sync(0xffffffffu, b[pos] < v));
    if (c == 0) return lo;
    const int nlo = lo + (int)((span * (c - 1)) >> 5) + 1;
    if (c < 32) hi = lo + (int)((span * c) >> 5);
    lo = nlo;
  }
  const bool below = lane < hi - lo && b[lo + lane] < v;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// dst[:] = sum of rows [a, b), each column in row order; lane lg of a
// group of G lanes covers vectors lg, lg + G, ... of V floats
template <int V, int G, int NV>
__device__ void sum_rows(const float* __restrict__ rows, int D, int a, int b,
                         int lg, float* __restrict__ dst) {
  using X = Vec<V>;
  using T = typename X::T;
  const int nvec = D / V;
  for (int c0 = 0; c0 < nvec; c0 += G * NV) {
    T acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = X::zero();
#pragma unroll 4
    for (int r = a; r < b; ++r) {
      const T* src = reinterpret_cast<const T*>(rows + (size_t)r * D);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = c0 + lg + k * G;
        if (j < nvec) X::add(acc[k], __ldg(src + j));
      }
    }
    T* out = reinterpret_cast<T*>(dst);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = c0 + lg + k * G;
      if (j < nvec) out[j] = acc[k];
    }
  }
}

template <int V, int G, int NV>
__global__ void __launch_bounds__(kThreads)
    tiles_kernel(const float* __restrict__ rows, int D,
                 const int32_t* __restrict__ bounds, int n, int tile_rows,
                 float* __restrict__ out, float* __restrict__ part,
                 int32_t* __restrict__ meta) {
  __shared__ int s_first, s_end;
  __shared__ int32_t sb[kStage];
  const int t = blockIdx.x;
  const int lo = bounds[0];
  const int hi = bounds[n];
  const long long start = (long long)lo + (long long)t * tile_rows;
  // tile 0 always runs: with no rows at all it is the last tile
  if (t > 0 && start >= hi) {
    if (threadIdx.x == 0) meta[t] = -1;
    return;
  }
  const int r0 = (int)start;
  const int r1 = (int)min((long long)hi, start + tile_rows);
  const int warp = threadIdx.x >> 5;
  // segments [first, end) start in the tile's rows [r0, r1)
  if (warp < 2) {
    const int v = warp_lower_bound(bounds, n + 1, warp == 0 ? r0 : r1);
    if (threadIdx.x == 0) s_first = v;
    if (threadIdx.x == 32) s_end = v;
  }
  __syncthreads();
  const int first = s_first;
  const int m = s_end - first;
  for (int k = threadIdx.x; k <= m && k < kStage; k += kThreads)
    sb[k] = bounds[first + k];
  if (threadIdx.x == 0) {
    // the last segment that starts here and runs past r1, if any
    meta[t] = (m > 0 && bounds[first + m] > r1) ? first + m - 1 : -1;
    // the last tile: the segments from s_end on are empty ones at bounds[n]
    if (r1 == hi) meta[gridDim.x] = s_end;
  }
  __syncthreads();
  // job 0: the head; job j >= 1: segment first + j - 1
  const int lg = threadIdx.x % G;
  for (int j = threadIdx.x / G; j <= m; j += kThreads / G) {
    const int b0 = j < kStage ? sb[j] : bounds[first + j];
    if (j == 0) {
      if (r0 < min(b0, r1))
        sum_rows<V, G, NV>(rows, D, r0, min(b0, r1), lg,
                           part + (size_t)(2 * t) * D);
      continue;
    }
    const int a = j - 1 < kStage ? sb[j - 1] : bounds[first + j - 1];
    float* dst = b0 > r1 ? part + (size_t)(2 * t + 1) * D
                         : out + (size_t)(first + j - 1) * D;
    sum_rows<V, G, NV>(rows, D, a, min(b0, r1), lg, dst);
  }
}

__global__ void spans_kernel(const int32_t* __restrict__ bounds, int n, int D,
                             int tile_rows, int tiles,
                             const float* __restrict__ part,
                             const int32_t* __restrict__ meta,
                             float* __restrict__ out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = tid >> 5;
  const int lane = threadIdx.x & 31;
  const int i = t < tiles ? meta[t] : -1;
  if (i >= 0) {
    const int last = (bounds[i + 1] - 1 - bounds[0]) / tile_rows;
    const float* tail = part + (size_t)(2 * t + 1) * D;
    // 4 columns a lane at once, so a long span's loads overlap
    for (int c0 = lane; c0 < D; c0 += 128) {
      float acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc[k] = c0 + 32 * k < D ? tail[c0 + 32 * k] : 0.0f;
#pragma unroll 4
      for (int u = t + 1; u <= last; ++u) {
        const float* head = part + (size_t)(2 * u) * D;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (c0 + 32 * k < D) acc[k] += head[c0 + 32 * k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + 32 * k < D) out[(size_t)i * D + c0 + 32 * k] = acc[k];
    }
  }
  const int k = meta[tiles];
  const long long total = (long long)(n - k) * D;
  for (long long e = tid; e < total; e += (long long)gridDim.x * blockDim.x)
    out[(size_t)k * D + e] = 0.0f;
}

template <int V, int G, int NV>
void launch_tiles(const float* rows, int D, const int32_t* bounds, int n,
                  int tile_rows, int tiles, float* out, float* part,
                  int32_t* meta, cudaStream_t stream) {
  tiles_kernel<V, G, NV><<<tiles, kThreads, 0, stream>>>(
      rows, D, bounds, n, tile_rows, out, part, meta);
}

template <int V>
void launch_width(const float* rows, int D, const int32_t* bounds, int n,
                  int tile_rows, int tiles, float* out, float* part,
                  int32_t* meta, cudaStream_t stream) {
  const int nvec = D / V;
  if (nvec <= 1)
    launch_tiles<V, 1, 1>(rows, D, bounds, n, tile_rows, tiles, out, part,
                          meta, stream);
  else if (nvec <= 2)
    launch_tiles<V, 2, 1>(rows, D, bounds, n, tile_rows, tiles, out, part,
                          meta, stream);
  else if (nvec <= 4)
    launch_tiles<V, 4, 1>(rows, D, bounds, n, tile_rows, tiles, out, part,
                          meta, stream);
  else if (nvec <= 8)
    launch_tiles<V, 8, 1>(rows, D, bounds, n, tile_rows, tiles, out, part,
                          meta, stream);
  else if (nvec <= 16)
    launch_tiles<V, 16, 1>(rows, D, bounds, n, tile_rows, tiles, out, part,
                           meta, stream);
  else
    launch_tiles<V, 32, 2>(rows, D, bounds, n, tile_rows, tiles, out, part,
                           meta, stream);
}

}  // namespace

// rows [R, D], bounds [n+1], out [n, D]; part [tiles, 2, D] f32 and meta
// [tiles + 1] int32 scratch, tiles = max(1, ceil(R / tile_rows)). Two
// launches on `stream`; returns cudaGetLastError().
extern "C" int adgs_segment_sum(const void* rows, int R, int D,
                                const void* bounds, int n, int tile_rows,
                                void* out, void* part, void* meta,
                                void* stream) {
  if (n <= 0 || D <= 0) return 0;
  if (tile_rows <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  const int tiles = R > 0 ? (R - 1) / tile_rows + 1 : 1;
  const uintptr_t addr = (uintptr_t)rows;
  const float* x = (const float*)rows;
  const int32_t* b = (const int32_t*)bounds;
  float* o = (float*)out;
  float* p = (float*)part;
  int32_t* mt = (int32_t*)meta;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D % 4 == 0 && addr % 16 == 0)
    launch_width<4>(x, D, b, n, tile_rows, tiles, o, p, mt, st);
  else if (D % 2 == 0 && addr % 8 == 0)
    launch_width<2>(x, D, b, n, tile_rows, tiles, o, p, mt, st);
  else
    launch_width<1>(x, D, b, n, tile_rows, tiles, o, p, mt, st);
  const int threads = 256;
  const int blocks = (int)(((long long)tiles * 32 + threads - 1) / threads);
  spans_kernel<<<blocks, threads, 0, st>>>(b, n, D, tile_rows, tiles, p, mt,
                                           o);
  return (int)cudaGetLastError();
}
