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
// Bound: bytes (each row of [bounds[0], bounds[n]) read once, each output
// row written once, one add per element read). What keeps a kernel from
// it on this card is balance, on two kinds of input the training step
// gives: a pile of empty segments (a block held at twice its alive count
// after a densify: 700,832 dead scene slots between the alive scene and
// object slots, no rows, all at one bound) and one long segment (the KNN
// groups past the valid anchors all point at value 0: 306,208 rows). The
// first design gave one warp to each segment (13.4x its bound on the
// long one); the second balanced rows alone, over fixed 64-row tiles, and
// gave every segment that starts in a tile to that tile's block, so one
// block wrote the whole pile (~10.8 ms a step), and one warp added the
// long segment's 4,784 tile heads in turn (1.5-2.6 ms).
//
// Design: a reduce-by-key over the merged sequence of rows and segment
// ends (the merge-path decomposition of Merrill and Garland's CSR SpMV,
// and CUB's), so the work is balanced over rows and segments together.
// Item q of the sequence is the end of segment i(q) or a row: segment k's
// rows come first and its end last, so its items are the positions
// [k + bounds[k] - bounds[0], k + bounds[k+1] - bounds[0]], and i(q), the
// segment open at q, is the first k with k + bounds[k+1] - bounds[0] >= q.
//   1. tiles_kernel: block b takes the `items` positions from b * items.
//      Two warps find i at its two ends by a 32-ary search over bounds;
//      the block stages the bounds of its segments (<= items + 2) in
//      shared memory. Each lane group (a worker) takes items / W of the
//      positions and walks them: rows add to its sum, an end writes the
//      sum to out and starts a new one, so a pile of empty segments is
//      written as exact zeros by as many blocks as its length takes. The
//      worker's open sum at its last position is its carry; a segmented
//      scan of the carries over the block's W workers (a tree of log2 W
//      steps in shared memory; the keys, the open segments, are
//      non-decreasing) gives each worker the rows of its first segment
//      that earlier workers of the block hold, and the block's own carry
//      (its open segment and sum) goes to `part` and `meta`.
//   2. spans_kernel<false>, once per level: the block carries are level
//      0; one warp per group of kFan = 32 of a level's partials scans
//      them in place (each its sum with the earlier partials of the group
//      that carry the same segment), and the group's last scanned partial
//      is a partial of the next level, until a level fits in one group.
//   3. spans_kernel<true>: for each block whose first ended segment began
//      in an earlier block, one warp adds to out the scanned partial one
//      below it at each level the segment's run reaches back to: one
//      partial a level, so no warp adds more than kFan partials in turn
//      anywhere, whatever the longest segment.
// A lane group covers D columns with float4 (D % 4 == 0), float2 or
// float loads, G lanes for D/V vectors (G = 1 .. 32; at G = 32, NV = 2,
// 4 or, for float loads, 8 vectors a lane, in passes past that), so its
// lanes read neighbouring addresses; a worker loads kDepth of its rows at
// once, whatever segments they fall in. The order of the additions
// depends only on bounds, D and items: the result is deterministic, with
// no atomics.
// No host synchronisation: the plan is found on the device.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // threads of a tiles_kernel block
constexpr int kMaxItems = 1024; // items of a block at most (bounds staged)
constexpr int kFan = 32;        // partials of one spans_kernel group
constexpr int kMaxLevels = 8;   // 32^7 partials > any int32 problem
constexpr int kDepth = 4;       // rows a worker loads at once

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

// First index i of [0, len) with below(i) false (len if none), below
// true then false along the index. A whole warp calls it and every lane
// gets the answer: each round probes 32 evenly spaced indices and keeps
// the gap between the last probe below and the first one not.
template <class Below>
__device__ int warp_lower_bound(int len, Below below) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = len;                   // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int pos = lo + (int)((span * lane) >> 5);
    const int c = __popc(__ballot_sync(0xffffffffu, below(pos)));
    if (c == 0) return lo;
    const int nlo = lo + (int)((span * (c - 1)) >> 5) + 1;
    if (c < 32) hi = lo + (int)((span * c) >> 5);
    lo = nlo;
  }
  const bool b = lane < hi - lo && below(lo + lane);
  return lo + __popc(__ballot_sync(0xffffffffu, b));
}

// v[u][k] = row r0 + u at vector j0 + k * G, zero for rows from b on
template <int V, int G, int NV>
__device__ void load_rows(const float* __restrict__ rows, int D, int r0,
                          int b, int j0, typename Vec<V>::T (&v)[kDepth][NV]) {
  using T = typename Vec<V>::T;
  const int nvec = D / V;
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const T* src = reinterpret_cast<const T*>(rows + (size_t)(r0 + u) * D);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = j0 + k * G;
      v[u][k] = r0 + u < b && j < nvec ? __ldg(src + j) : Vec<V>::zero();
    }
  }
}

template <int V, int G, int NV>
__device__ void store(float* __restrict__ dst, int D, int j0,
                      const typename Vec<V>::T (&v)[NV]) {
  using T = typename Vec<V>::T;
  const int nvec = D / V;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = j0 + k * G;
    if (j < nvec) reinterpret_cast<T*>(dst)[j] = v[k];
  }
}

// block b: merged positions [b * items, (b + 1) * items) (module note, 1);
// ckey[b] its open segment at its end (n: none), cval[b] that segment's
// rows in the block
template <int V, int G, int NV>
__global__ void __launch_bounds__(kThreads)
    tiles_kernel(const float* __restrict__ rows, int D,
                 const int32_t* __restrict__ bounds, int n, int items,
                 float* __restrict__ out, float* __restrict__ cval,
                 int32_t* __restrict__ ckey) {
  using X = Vec<V>;
  using T = typename X::T;
  constexpr int W = kThreads / G;          // workers of the block
  __shared__ int s_i[2];
  __shared__ int32_t sb[kMaxItems + 2];
  __shared__ int32_t skey[W];
  __shared__ T sv[W * NV * G];
  const int base = bounds[0];
  const int total = n + (bounds[n] - base);  // rows and ends
  const int d0 = min(total, (int)blockIdx.x * items);
  const int d1 = min(total, d0 + items);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int d = warp == 0 ? d0 : d1;
    const int v = warp_lower_bound(
        n, [&](int k) { return k + bounds[k + 1] - base < d; });
    if ((threadIdx.x & 31) == 0) s_i[warp] = v;
  }
  __syncthreads();
  const int i0 = s_i[0], i1 = s_i[1];
  // bounds[i0 .. min(i1 + 1, n)]: the segments the block's items touch
  const int m = min(i1 + 1, n) - i0;
  for (int k = threadIdx.x; k <= m; k += kThreads) sb[k] = bounds[i0 + k];
  __syncthreads();

  const int w = threadIdx.x / G, lg = threadIdx.x % G;
  const int per = items / W;
  const int q0 = min(d1, d0 + w * per), q1 = min(d1, q0 + per);
  // the segment open at q (in [i0, i1]), by bisection in sb
  auto open_at = [&](int q) {
    int a = i0, z = i1;
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (mid + sb[mid - i0 + 1] - base < q) a = mid + 1; else z = mid;
    }
    return a;
  };
  // the worker ends segments iw .. ie - 1 and reads rows [r_lo, r_hi)
  const int iw = open_at(q0), ie = open_at(q1);
  const int r_lo = base + q0 - iw, r_hi = base + q1 - ie;
  // segment iw began before q0: its end here takes the carry of the
  // workers before (and of the blocks before: spans_kernel<true>)
  const bool head = iw + sb[iw - i0] - base < q0;
  const int nvec = D / V;
  T* mine = sv + w * NV * G;
  for (int c0 = 0; c0 < nvec; c0 += G * NV) {
    T acc[NV], hv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = hv[k] = X::zero();
    bool held = false;
    int i = iw;
    auto end_segment = [&]() {
      if (i == iw && head) {
#pragma unroll
        for (int k = 0; k < NV; ++k) hv[k] = acc[k];
        held = true;
      } else {
        store<V, G, NV>(out + (size_t)i * D, D, c0 + lg, acc);
      }
#pragma unroll
      for (int k = 0; k < NV; ++k) acc[k] = X::zero();
      ++i;
    };
    for (int r0 = r_lo; r0 < r_hi; r0 += kDepth) {
      T v[kDepth][NV];
      load_rows<V, G, NV>(rows, D, r0, r_hi, c0 + lg, v);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (r0 + u >= r_hi) break;
        while (sb[i - i0 + 1] <= r0 + u) end_segment();  // ends before it
#pragma unroll
        for (int k = 0; k < NV; ++k) X::add(acc[k], v[u][k]);
      }
    }
    while (i < ie) end_segment();
    // inclusive segmented scan of the workers' carries, keyed by their
    // open segment i (non-decreasing over w): a tree of log2 W steps
    if (lg == 0) skey[w] = i;
#pragma unroll
    for (int k = 0; k < NV; ++k) mine[k * G + lg] = acc[k];
    for (int o = 1; o < W; o <<= 1) {
      __syncthreads();
      const bool take = w >= o && skey[w - o] == i;
      T add[NV];
      if (take) {
#pragma unroll
        for (int k = 0; k < NV; ++k) add[k] = sv[(w - o) * NV * G + k * G + lg];
      }
      __syncthreads();
      if (take) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          X::add(acc[k], add[k]);
          mine[k * G + lg] = acc[k];
        }
      }
    }
    __syncthreads();
    if (held) {
      // worker w - 1's open segment is iw (w = 0: the block's first)
      if (w > 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
          X::add(hv[k], sv[(w - 1) * NV * G + k * G + lg]);
      }
      store<V, G, NV>(out + (size_t)iw * D, D, c0 + lg, hv);
    }
    if (w == W - 1)
      store<V, G, NV>(cval + (size_t)blockIdx.x * D, D, c0 + lg, acc);
    __syncthreads();                       // sv and skey free again
  }
  if (threadIdx.x == 0) ckey[blockIdx.x] = i1;
}

// the number of partials at each level: blocks at level 0, then one per
// group of kFan of the level below, until a level fits in one group
__host__ __device__ int level_size(int blocks, int level) {
  int s = blocks;
  for (int l = 0; l < level; ++l) s = (s + kFan - 1) / kFan;
  return s;
}

__host__ __device__ int level_offset(int blocks, int level) {
  int off = 0;
  for (int l = 0; l < level; ++l) off += level_size(blocks, l);
  return off;
}

// kFix false: scan level `level`'s partials in place, one warp per group
// of kFan, and put each group's last (its trailing run's sum) at the next
// level unless this level fits in one group. kFix true: one warp per
// block b >= 1 whose first ended segment k began in an earlier block:
// out[k] += the scanned partial of block b - 1 and, level by level while
// k's run reaches back past its group, the scanned partial one level up
// that ends just before that group.
template <bool kFix>
__global__ void spans_kernel(const int32_t* __restrict__ bounds, int n, int D,
                             int items, int blocks, int level,
                             float* __restrict__ part,
                             int32_t* __restrict__ meta,
                             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int g = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  if (!kFix) {
    const int size = level_size(blocks, level);
    const int off = level_offset(blocks, level);
    const int cs = g * kFan;
    if (cs >= size) return;
    const int len = min(kFan, size - cs);
    const int32_t* key = meta + off;
    float* val = part + (size_t)off * D;
    const int kk = lane < len ? key[cs + lane] : INT_MIN;
    const int prev = __shfl_up_sync(0xffffffffu, kk, 1);
    // bit t: partial cs + t carries the same segment as cs + t - 1
    const unsigned same =
        __ballot_sync(0xffffffffu, lane > 0 && lane < len && kk == prev);
    const bool up = size > kFan;
    const int last = __shfl_sync(0xffffffffu, kk, len - 1);
    const int noff = off + size;
    for (int c = lane; c < D; c += 32) {
      float* p = val + (size_t)cs * D + c;
      float v[kFan];
#pragma unroll
      for (int t = 0; t < kFan; ++t) v[t] = t < len ? p[(size_t)t * D] : 0.0f;
      float r = 0.0f;
#pragma unroll
      for (int t = 0; t < kFan; ++t) {
        if (t < len) {
          r = (same >> t) & 1u ? r + v[t] : v[t];
          p[(size_t)t * D] = r;
        }
      }
      if (up) part[(size_t)(noff + g) * D + c] = r;
    }
    if (up && lane == 0) meta[noff + g] = last;
    return;
  }
  const int b = g + 1;
  if (b >= blocks) return;
  const int k = meta[b - 1];
  if (k >= n || meta[b] == k) return;      // nothing open, or not ended in b
  if (k + bounds[k] - bounds[0] >= b * items) return;  // began in block b
  int pos[kMaxLevels];
  int nlev = 0, x = b - 1, off = 0, size = blocks;
  while (true) {
    pos[nlev++] = off + x;
    const int cs = x / kFan * kFan;
    // keys are non-decreasing: the run reaches back past cs iff the
    // partial before the group carries k
    if (cs == 0 || meta[off + cs - 1] != k) break;
    off += size;
    size = (size + kFan - 1) / kFan;
    x = cs / kFan - 1;
  }
  for (int c = lane; c < D; c += 32) {
    float t = part[(size_t)pos[0] * D + c];
    for (int l = 1; l < nlev; ++l) t += part[(size_t)pos[l] * D + c];
    out[(size_t)k * D + c] += t;
  }
}

template <int V, int G, int NV>
void launch_tiles(const float* rows, int D, const int32_t* bounds, int n,
                  int items, int blocks, float* out, float* part,
                  int32_t* meta, cudaStream_t stream) {
  tiles_kernel<V, G, NV><<<blocks, kThreads, 0, stream>>>(
      rows, D, bounds, n, items, out, part, meta);
}

template <int V>
void launch_width(const float* rows, int D, const int32_t* bounds, int n,
                  int items, int blocks, float* out, float* part,
                  int32_t* meta, cudaStream_t stream) {
  const int nvec = D / V;
  if (nvec <= 1)
    launch_tiles<V, 1, 1>(rows, D, bounds, n, items, blocks, out, part, meta,
                          stream);
  else if (nvec <= 2)
    launch_tiles<V, 2, 1>(rows, D, bounds, n, items, blocks, out, part, meta,
                          stream);
  else if (nvec <= 4)
    launch_tiles<V, 4, 1>(rows, D, bounds, n, items, blocks, out, part, meta,
                          stream);
  else if (nvec <= 8)
    launch_tiles<V, 8, 1>(rows, D, bounds, n, items, blocks, out, part, meta,
                          stream);
  else if (nvec <= 16)
    launch_tiles<V, 16, 1>(rows, D, bounds, n, items, blocks, out, part,
                           meta, stream);
  else if (nvec <= 32)
    launch_tiles<V, 32, 1>(rows, D, bounds, n, items, blocks, out, part,
                           meta, stream);
  else if (nvec <= 64)
    launch_tiles<V, 32, 2>(rows, D, bounds, n, items, blocks, out, part,
                           meta, stream);
  else if (V > 1 || nvec <= 128)
    launch_tiles<V, 32, 4>(rows, D, bounds, n, items, blocks, out, part,
                           meta, stream);
  else if constexpr (V == 1)
    launch_tiles<V, 32, 8>(rows, D, bounds, n, items, blocks, out, part,
                           meta, stream);
}

}  // namespace

// rows [R, D], bounds [n+1], out [n, D]; part [S, D] f32 and meta [S]
// int32 scratch, S = the sum over levels of the partials (level_size:
// blocks = max(1, ceil((n + R) / items)) at level 0, then ceil(/ 32)
// while above 32). items: positions of a block, a multiple of 128 up to
// 1024. 2 + levels launches on `stream`; returns cudaGetLastError().
extern "C" int adgs_segment_sum(const void* rows, int R, int D,
                                const void* bounds, int n, int items,
                                void* out, void* part, void* meta,
                                void* stream) {
  if (n <= 0 || D <= 0) return 0;
  if (items <= 0 || items % kThreads != 0 || items > kMaxItems || R < 0 ||
      (long long)n + R + items > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n + R + items - 1) / items);
  const uintptr_t addr = (uintptr_t)rows;
  const float* x = (const float*)rows;
  const int32_t* b = (const int32_t*)bounds;
  float* o = (float*)out;
  float* p = (float*)part;
  int32_t* mt = (int32_t*)meta;
  const cudaStream_t st = (cudaStream_t)stream;
  if (D % 4 == 0 && addr % 16 == 0)
    launch_width<4>(x, D, b, n, items, blocks, o, p, mt, st);
  else if (D % 2 == 0 && addr % 8 == 0)
    launch_width<2>(x, D, b, n, items, blocks, o, p, mt, st);
  else
    launch_width<1>(x, D, b, n, items, blocks, o, p, mt, st);
  const int threads = 256;
  for (int l = 0;; ++l) {
    const int groups = (level_size(blocks, l) + kFan - 1) / kFan;
    const int grid = (int)(((long long)groups * 32 + threads - 1) / threads);
    spans_kernel<false><<<grid, threads, 0, st>>>(b, n, D, items, blocks, l,
                                                  p, mt, o);
    if (level_size(blocks, l) <= kFan) break;
  }
  if (blocks > 1) {
    const int grid =
        (int)(((long long)(blocks - 1) * 32 + threads - 1) / threads);
    spans_kernel<true><<<grid, threads, 0, st>>>(b, n, D, items, blocks, 0,
                                                 p, mt, o);
  }
  return (int)cudaGetLastError();
}
