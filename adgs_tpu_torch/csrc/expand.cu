// B1 — instance expansion (duplicateWithKeys) for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/expand.py `_expand_kernel` (driven by
// `expand_pallas`), and its XLA twin `_expand_xla` in
// adgs_tpu/raster/binning.py. Those resolve slot -> Gaussian by a gather
// (a one-hot MXU matmul over a static Gaussian window on the TPU); here
// each Gaussian SCATTERS its own instances, as the reference rasterizer's
// duplicateWithKeys does, so there is no window and no f32 table.
//
// Input: the live-first table of B2 (compact.cu), int32 [n, 8] rows
// (excl, incl, rmin_x, rmin_y, rect_w, depth_q, gid, 0), and n_live.
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
// bytes per slot, with almost no arithmetic. Design: one thread per live
// row (rows past n_live exit at once, in whole warps) reads its row with
// two 16-byte loads and walks its rect row-major, writing contiguous slots
// (neighbouring threads write neighbouring runs); integers stay integers.
// A second trivial pass fills the padding, reading num_rendered on the
// device so the host never waits.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void expand_kernel(const int4* __restrict__ table,
                              const int32_t* __restrict__ n_live,
                              int n, int capacity, int grid_x, int d_bits,
                              int64_t* __restrict__ key,
                              int32_t* __restrict__ gid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || i >= *n_live) return;
  const int4 a = table[2 * i];
  const int4 b = table[2 * i + 1];
  const int s0 = a.x;
  if (s0 >= capacity) return;
  const int x0 = a.z;
  const int y0 = a.w;
  const int rw = b.x;
  const int64_t dq = (int64_t)(uint32_t)b.y;
  const int g = b.z;
  const int64_t end = a.y < capacity ? (int64_t)a.y : (int64_t)capacity;
  int ly = 0, lx = 0;
  for (int64_t s = s0; s < end; ++s) {
    const int64_t tile = (int64_t)(y0 + ly) * grid_x + (x0 + lx);
    key[s] = (tile << d_bits) | dq;
    gid[s] = g;
    if (++lx == rw) {
      lx = 0;
      ++ly;
    }
  }
}

__global__ void pad_kernel(const int32_t* __restrict__ num_rendered,
                           int capacity, int64_t pad_key,
                           int64_t* __restrict__ key,
                           int32_t* __restrict__ gid) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= capacity) return;
  if (s >= *num_rendered) {
    key[s] = pad_key;
    gid[s] = 0;
  }
}

extern "C" int adgs_expand(const void* table, const void* n_live,
                           const void* num_rendered, int n, int capacity,
                           int grid_x, int d_bits, int num_tiles, void* key,
                           void* gid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  if (n > 0) {
    expand_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(
        (const int4*)table, (const int32_t*)n_live, n, capacity, grid_x,
        d_bits, (int64_t*)key, (int32_t*)gid);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (capacity > 0) {
    pad_kernel<<<(capacity + threads - 1) / threads, threads, 0, st>>>(
        (const int32_t*)num_rendered, capacity,
        (int64_t)num_tiles << d_bits, (int64_t*)key, (int32_t*)gid);
  }
  return (int)cudaGetLastError();
}
