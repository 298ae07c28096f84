// B1 — instance expansion (duplicateWithKeys) for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/expand.py `_expand_kernel` (driven by
// `expand_pallas`), and its XLA twin `_expand_xla` in
// adgs_tpu/raster/binning.py. Those resolve slot -> Gaussian by a gather
// (a one-hot MXU matmul over a static Gaussian window on the TPU); here
// each slot finds its owner by a search, as the plain twin `expand_torch`
// (raster/binning.py) does with searchsorted.
//
// Input: the live-first table of B2 (compact.cu), int32 [n, 8] rows
// (excl, incl, rmin_x, rmin_y, rect_w, depth_q, gid, 0), and n_live; the
// live rows [0, n_live) hold non-empty, contiguous spans in slot order.
// Output, per instance slot s in [0, capacity):
//   key[s] = (tile << d_bits) | depth_q[g]  (int64; same low 32 bits as the
//            JAX uint32 key, so the top tile bit never makes it negative)
//   gid[s] = g
// where g owns s (excl <= s < incl) and, with local = s - excl,
// tile = (rmin_y + local / rect_w) * grid_x + rmin_x + local % rect_w.
// Slots at or beyond capacity are dropped (JAX mode="drop"); slots in
// [min(num_rendered, capacity), capacity) get key num_tiles << d_bits and
// gid 0.
//
// Bound: bytes. It reads one 32-byte row per live Gaussian and writes 12
// bytes per slot, with almost no arithmetic. Design: one launch of blocks
// of 256 threads, each taking a contiguous run of kRun slots:
//   - the block finds the owners of its first and last slot with two
//     128-ary searches over the incl column (half the block each, a
//     ballot a round; 3 rounds up to two million live rows: wider
//     searches cost more in scattered loads than they save in rounds);
//   - the rows between them (at most kRun, as every live row owns a slot)
//     are staged in shared memory with coalesced 16-byte loads;
//   - each thread then takes the block's slots kThreads apart, finds a
//     slot's owner by a binary search of the staged incl column and
//     writes its key and gid, so a warp's stores are 32 consecutive
//     slots, whatever the rects' sizes;
//   - slots past num_rendered get the pad key in the same pass, and the
//     grid covers only [0, capacity), which drops the rest.
// n_live and num_rendered are read on the device, so the host never waits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 1024;                   // slots of a block
constexpr int kPer = kRun / kThreads;        // slots of a thread
constexpr int kHalf = kThreads / 2;          // threads (probes) of a search
constexpr int kLog2Run = 10;
static_assert(kRun == 1 << kLog2Run, "kRun must be 1 << kLog2Run");

// One round of a 128-ary search for the owner of slot s (the first row
// whose incl exceeds s) among rows [lo, hi), the owner in [lo, hi]:
// thread k of a half-block probes row lo + k * step; the half's four
// warps' counts of probes with incl <= s go to cnt[0..3].
__device__ __forceinline__ void probe(const int4* __restrict__ table, int s,
                                      int lo, int hi, int k,
                                      unsigned* cnt) {
  const int step = (hi - lo + kHalf - 1) / kHalf;
  const int pos = lo + k * step;
  const bool le = pos < hi && table[2 * pos].y <= s;
  const unsigned ballot = __ballot_sync(0xffffffffu, le);
  if ((threadIdx.x & 31) == 0) cnt[k >> 5] = __popc(ballot);
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int4* __restrict__ table,
              const int32_t* __restrict__ n_live,
              const int32_t* __restrict__ num_rendered, int capacity,
              int grid_x, int d_bits, long long pad_key,
              int64_t* __restrict__ key, int32_t* __restrict__ gid) {
  __shared__ int s_incl[kRun];
  __shared__ int4 s_row[kRun];      // excl, rmin_x, rmin_y, rect_w
  __shared__ int2 s_id[kRun];       // depth_q, gid
  __shared__ unsigned s_cnt[2][kHalf / 32];
  __shared__ int s_owner[2];        // owners of the first, last slot

  const int tid = threadIdx.x;
  const int s_lo = blockIdx.x * kRun;
  const int filled = min(*num_rendered, capacity);
  const int s_last = min(s_lo + kRun, filled) - 1;
  int r_lo = 0, m = 0;
  if (s_last >= s_lo) {   // block-uniform
    // owners of s_lo (threads 0-127) and s_last (threads 128-255)
    const int half = tid / kHalf;
    const int k = tid % kHalf;
    const int s = half ? s_last : s_lo;
    int lo = 0;
    int hi = min(*n_live, s + 1);   // every live row owns a slot
    while (true) {
      if (__syncthreads_and(hi <= lo)) break;
      if (hi > lo) probe(table, s, lo, hi, k, s_cnt[half]);
      __syncthreads();
      if (hi > lo) {
        unsigned c = 0;
#pragma unroll
        for (int w = 0; w < kHalf / 32; ++w) c += s_cnt[half][w];
        const int step = (hi - lo + kHalf - 1) / kHalf;
        const int new_lo = c > 0 ? lo + ((int)c - 1) * step + 1 : lo;
        hi = min(hi, lo + (int)c * step);
        lo = new_lo;
      }
    }
    if (k == 0) s_owner[half] = lo;
    __syncthreads();
    r_lo = s_owner[0];
    m = s_owner[1] - r_lo + 1;
    for (int i = tid; i < m; i += kThreads) {
      const int4 a = table[2 * (r_lo + i)];
      const int4 b = table[2 * (r_lo + i) + 1];
      s_incl[i] = a.y;
      s_row[i] = make_int4(a.x, a.z, a.w, b.x);
      s_id[i] = make_int2(b.y, b.z);
    }
    __syncthreads();
  }
  // each slot's owner among the staged rows: the number of staged rows
  // whose incl is <= s, by a branch-free binary search of fixed length,
  // so the kPer searches of a thread interleave
  int own[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) own[p] = 0;
#pragma unroll
  for (int b = kLog2Run - 1; b >= 0; --b) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int s = s_lo + p * kThreads + tid;
      const int next = own[p] + (1 << b);
      if (next <= m && s_incl[next - 1] <= s) own[p] = next;
    }
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int s = s_lo + p * kThreads + tid;
    if (s >= capacity) break;
    if (s < filled) {
      const int4 r = s_row[own[p]];
      const int2 id = s_id[own[p]];
      const int local = s - r.x;
      const int ly = local / r.w;
      const int lx = local - ly * r.w;
      const int64_t tile = (int64_t)(r.z + ly) * grid_x + (r.y + lx);
      key[s] = (tile << d_bits) | (int64_t)(uint32_t)id.x;
      gid[s] = id.y;
    } else {
      key[s] = pad_key;
      gid[s] = 0;
    }
  }
}

}  // namespace

extern "C" int adgs_expand(const void* table, const void* n_live,
                           const void* num_rendered, int n, int capacity,
                           int grid_x, int d_bits, int num_tiles, void* key,
                           void* gid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || capacity <= 0) return 0;
  expand_kernel<<<(capacity + kRun - 1) / kRun, kThreads, 0, st>>>(
      (const int4*)table, (const int32_t*)n_live,
      (const int32_t*)num_rendered, capacity, grid_x, d_bits,
      (long long)num_tiles << d_bits, (int64_t*)key, (int32_t*)gid);
  return (int)cudaGetLastError();
}
