// B2 — stable live-first compaction of the expansion table, for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/expand.py `_compact_kernel` (driven by
// `compact_live_table_kernel`). On the TPU it reorders the f32 expansion
// table live-first so a static Gaussian window covers every slot block;
// there a one-hot MXU matmul places each live column. Here the table is
// int32 and the expansion (B1, expand.cu) runs one thread per ROW of it:
// compacting first packs the live Gaussians (tiles > 0) into the first
// n_live rows, so B1's warps are full of Gaussians that write instances
// instead of mostly exiting on culled, time-gated or padding slots.
//
// Output: table int32 [n, 8], rows
//   (excl, incl, rmin_x, rmin_y, rect_w, depth_q, gid, 0)
// with rect_w = max(rmax_x - rmin_x, 1) and incl = excl + tiles. The live
// rows come first in Gaussian order, then the dead ones, also in order,
// as empty spans at num_rendered: (total, total, 0, 0, 0, 0, 0, 0). So
// the incl column is non-decreasing and each slot in [0, total) lies in
// exactly one row's span. n_live [1] is written on the device.
//
// Bound: bytes. It reads 7 ints per Gaussian (tiles twice) and writes 8,
// with a few integer operations. Design: three launches, no atomics, so
// the order is stable by construction: (1) each block of 1024 counts its
// live Gaussians with __syncthreads_count; (2) one block scans the block
// counts (about 1000 at 1M Gaussians) into block offsets and n_live;
// (3) each block ranks its Gaussians by a warp-ballot scan and writes
// every row once with two 16-byte stores, live rows to offset + rank and
// dead rows to n_live + (index - live before it).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int CBLK = 1024;           // Gaussians per block; 32 full warps
constexpr unsigned FULL = 0xffffffffu;

// Exclusive scan of v over a block of CBLK threads; *sum gets the total.
__device__ int block_excl_scan(int v, int* warp_sums, int* sum) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int excl = x - v + (w > 0 ? warp_sums[w - 1] : 0);
  *sum = warp_sums[31];
  __syncthreads();  // warp_sums is reused by the next call
  return excl;
}

__global__ void __launch_bounds__(CBLK)
count_kernel(const int32_t* __restrict__ tiles, int n,
             int32_t* __restrict__ block_live) {
  const int g = blockIdx.x * CBLK + threadIdx.x;
  const int c = __syncthreads_count(g < n && tiles[g] > 0);
  if (threadIdx.x == 0) block_live[blockIdx.x] = c;
}

__global__ void __launch_bounds__(CBLK)
scan_kernel(int32_t* __restrict__ block_live, int nb,
            int32_t* __restrict__ n_live) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < nb; base += CBLK) {
    const int i = base + threadIdx.x;
    const int v = i < nb ? block_live[i] : 0;
    int sum;
    const int excl = block_excl_scan(v, warp_sums, &sum);
    if (i < nb) block_live[i] = carry + excl;
    carry += sum;
  }
  if (threadIdx.x == 0) *n_live = carry;
}

__global__ void __launch_bounds__(CBLK)
scatter_kernel(const int32_t* __restrict__ starts,
               const int32_t* __restrict__ tiles,
               const int32_t* __restrict__ rect_min,
               const int32_t* __restrict__ rect_max,
               const int32_t* __restrict__ depth_q,
               const int32_t* __restrict__ num_rendered, int n,
               const int32_t* __restrict__ block_base,
               const int32_t* __restrict__ n_live,
               int4* __restrict__ table) {
  __shared__ int warp_sums[32];
  const int g = blockIdx.x * CBLK + threadIdx.x;
  const int cnt = g < n ? tiles[g] : 0;
  const int live = cnt > 0;
  int sum;
  const int before = block_base[blockIdx.x]
                   + block_excl_scan(live, warp_sums, &sum);
  if (g >= n) return;
  if (live) {
    const int s0 = starts[g];
    const int x0 = rect_min[2 * g];
    const int rw = max(rect_max[2 * g] - x0, 1);
    table[2 * before] = make_int4(s0, s0 + cnt, x0, rect_min[2 * g + 1]);
    table[2 * before + 1] = make_int4(rw, depth_q[g], g, 0);
  } else {
    const int row = *n_live + (g - before);
    const int total = *num_rendered;
    table[2 * row] = make_int4(total, total, 0, 0);
    table[2 * row + 1] = make_int4(0, 0, 0, 0);
  }
}

extern "C" int adgs_compact_live(const void* starts, const void* tiles,
                                 const void* rect_min, const void* rect_max,
                                 const void* depth_q, const void* num_rendered,
                                 int n, void* block_live, void* n_live,
                                 void* table, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nb = (n + CBLK - 1) / CBLK;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  count_kernel<<<nb, CBLK, 0, st>>>((const int32_t*)tiles, n,
                                    (int32_t*)block_live);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, CBLK, 0, st>>>((int32_t*)block_live, nb,
                                  (int32_t*)n_live);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<nb, CBLK, 0, st>>>(
      (const int32_t*)starts, (const int32_t*)tiles,
      (const int32_t*)rect_min, (const int32_t*)rect_max,
      (const int32_t*)depth_q, (const int32_t*)num_rendered, n,
      (const int32_t*)block_live, (const int32_t*)n_live, (int4*)table);
  return (int)cudaGetLastError();
}
