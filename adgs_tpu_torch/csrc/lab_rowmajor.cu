// E1 and E2 — the row-major lab's block readers for sm_90a.
//
// Replace: exp/lab_rowmajor.py `cm_kernel` (E1, driven by `call_cm`) and
// `rm_kernel` / `rm_notrans_kernel` (E2, driven by `call_rm`). Each of
// nprog programs reads `per` consecutive chunks of 256 instances and sums,
// over those per * 256 instances j, the outer product of the first 8 and
// the next 8 of their 16 values:
//   out[i, a, b] = sum_j x[j, a] * x[j, 8 + b],  j in [i per 256, (i+1) per 256)
// Instances past nprog * per * 256 are never read, as in the lab.
// The three ways of reading the same 16 values of instance j:
//   mode 0, E1 component-major: src [16, ld], x[j, k] = src[k * ld + j]
//     (the lab's [16, CHUNK] blocks of build_current's [16, R] output);
//   mode 1, E2 staged: src [*, ld] row-major, each [256, 16] block passed
//     through shared memory as [16, 256] (the relayout rm_kernel pays,
//     `rows[:, :16].T`): a two-slot ring of row-major blocks filled by
//     cp.async 16-byte copies, chunk c + 1's copies issued before chunk c
//     is read, as the lab's two-slot DMA (`get((c+1)%2, c+1).start()`
//     before `get(c%2, c).wait()`); the block then moves chunk c out of
//     the ring into a [16, 256] tile, thread j granule j % 4 of rows
//     j / 4 + 64 k (k = 0..3, not its own row), and thread j reads column
//     j of the tile. The ring's granules and the tile's columns are
//     XOR-swizzled, so that the copies, the relayout and the column reads
//     are free of bank conflicts;
//   mode 2, E2 direct: src [*, ld] row-major, each thread reads its row's
//     16 floats with four float4 loads (rm_notrans_kernel's row-major math).
// ld is 128 (the lane-padded rows of build_wide) or 16 (the narrow rows).
//
// Bound: bytes (64 bytes of each covered instance read once; 64 f32 fused
// multiply-adds each, far below the card's rate). Design: one block of 256
// threads per program, one thread per instance of a chunk; in mode 1 the
// copies of the next chunk are in flight while a chunk is relaid out and
// summed. Each thread keeps the 64 partial sums in registers over the
// program's chunks; each warp then reduce-scatters them
// (warp_reduce.cuh: 62 shuffles, where a butterfly per value took 320), so
// lane L holds the warp's sums of values 2L and 2L + 1, and the block adds
// the 8 warps' sums through shared memory in a fixed order and writes the
// [8, 8] result once: deterministic, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_reduce.cuh"

namespace {

constexpr int kChunk = 256;
constexpr int kVals = 16;
constexpr int kOut = 64;
constexpr int kWarps = kChunk / 32;
constexpr int kSlots = 2;          // mode 1's ring of staged chunks
constexpr int kGran = kVals / 4;   // 16-byte granules of a row's 16 values

// granule q of row r in a ring slot ([256 rows][4 granules], swizzled):
// a quarter warp's 8 threads then touch 8 distinct groups of 4 banks when
// they copy or read two rows' four granules
__device__ __forceinline__ int swizzle(int r, int q) {
  return r * kGran + (q ^ ((r >> 1) & (kGran - 1)));
}

// value k of instance r in mode 1's [16, 256] tile, columns swizzled by
// 8 * (k / 4): a warp that stores value 4q + i of 8 rows for q = 0..3 and
// a warp that reads value k of 32 rows both touch 32 distinct banks
__device__ __forceinline__ int tile_at(int k, int r) {
  return k * kChunk + (r ^ ((k >> 2) << 3));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// issue the copies of chunk c (rows base .. base + 255, 16 values each)
// into ring slot `slot`: four 16-byte granules per thread
__device__ __forceinline__ void stage_chunk(float4* ring, const float* src,
                                            long long ld, long long base,
                                            int tid) {
#pragma unroll
  for (int k = 0; k < kGran; ++k) {
    const int e = tid + k * kChunk;
    const int r = e / kGran;
    const int q = e % kGran;
    cp_async16(ring + swizzle(r, q), src + (base + r) * ld + 4 * q);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kChunk)
block_sums_kernel(const float* __restrict__ src, long long ld, int per,
                  float* __restrict__ out) {
  // the warps' partial sums go through the ring's memory: mode 1's loop
  // leaves the ring behind the barrier after its last relayout, and modes
  // 0 and 2 have no ring (static shared memory holds 48 KiB: mode 1's ring
  // takes 32 KiB, its tile 16 KiB)
  __shared__ __align__(16) float4 s_ring[MODE == 1 ? kSlots : 1]
                                       [MODE == 1 ? kChunk * kGran
                                                  : kWarps * kOut / 4];
  __shared__ float s_tile[MODE == 1 ? kVals * kChunk : 1];
  float(*s_red)[kOut] = reinterpret_cast<float(*)[kOut]>(&s_ring[0][0]);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  const long long first = (long long)blockIdx.x * per * kChunk;
  if constexpr (MODE == 1) {
    stage_chunk(s_ring[0], src, ld, first, tid);
    cp_async_commit();
  }
  for (int c = 0; c < per; ++c) {
    const long long base = first + (long long)c * kChunk;
    float x[kVals];
    if constexpr (MODE == 0) {
#pragma unroll
      for (int k = 0; k < kVals; ++k) x[k] = src[k * ld + base + tid];
    } else if constexpr (MODE == 1) {
      // chunk c + 1 into the other slot (moved out at c - 1, released by
      // the barrier after that), then wait for chunk c's copies only; the
      // barrier also ends chunk c - 1's reads of the tile
      if (c + 1 < per)
        stage_chunk(s_ring[(c + 1) % kSlots], src, ld, base + kChunk, tid);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      // the relayout: granule q of row r to values 4q .. 4q + 3 of column r
      const float4* ring = s_ring[c % kSlots];
#pragma unroll
      for (int k = 0; k < kGran; ++k) {
        const int e = tid + k * kChunk;
        const int r = e / kGran;
        const int q = e % kGran;
        const float4 v = ring[swizzle(r, q)];
        s_tile[tile_at(4 * q + 0, r)] = v.x;
        s_tile[tile_at(4 * q + 1, r)] = v.y;
        s_tile[tile_at(4 * q + 2, r)] = v.z;
        s_tile[tile_at(4 * q + 3, r)] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kVals; ++k) x[k] = s_tile[tile_at(k, tid)];
    } else {
      const float4* row =
          reinterpret_cast<const float4*>(src + (base + tid) * ld);
#pragma unroll
      for (int q = 0; q < kVals / 4; ++q) {
        const float4 v = row[q];
        x[4 * q + 0] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a * 8 + b] += x[a] * x[8 + b];
    }
  }

  adgs::reduce_scatter<kOut>(acc, lane);
  reinterpret_cast<float2*>(s_red[warp])[lane] = make_float2(acc[0], acc[1]);
  __syncthreads();
  if (tid < kOut) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_red[w][tid];
    out[(size_t)blockIdx.x * kOut + tid] = s;
  }
}

}  // namespace

extern "C" int adgs_lab_block_sums(const void* src, int mode, long long ld,
                                   int nprog, int per, void* out,
                                   void* stream) {
  if (nprog <= 0) return 0;
  // modes 1 and 2 read 16-byte granules: rows must start 16-byte aligned
  if (per < 1 || ld < kVals ||
      (mode != 0 && (ld % 4 != 0 || (uintptr_t)src % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const float* s = (const float*)src;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0: block_sums_kernel<0><<<nprog, kChunk, 0, st>>>(s, ld, per, o); break;
    case 1: block_sums_kernel<1><<<nprog, kChunk, 0, st>>>(s, ld, per, o); break;
    case 2: block_sums_kernel<2><<<nprog, kChunk, 0, st>>>(s, ld, per, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
