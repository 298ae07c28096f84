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
//     through shared memory as [16, 256] (the relayout rm_kernel pays);
//   mode 2, E2 direct: src [*, ld] row-major, each thread reads its row's
//     16 floats with four float4 loads (rm_notrans_kernel's row-major math).
// ld is 128 (the lane-padded rows of build_wide) or 16 (the narrow rows).
//
// Bound: bytes (64 bytes of each covered instance read once; 64 f32 fused
// multiply-adds each, far below the card's rate). Design: one block of 256
// threads per program, one thread per instance of a chunk. Each thread
// keeps the 64 partial sums in registers over the program's chunks; the
// block then sums them by warp shuffles and through shared memory in a
// fixed order and writes the [8, 8] result once: deterministic, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;
constexpr int kVals = 16;
constexpr int kOut = 64;
constexpr int kWarps = kChunk / 32;
constexpr unsigned kFull = 0xffffffffu;

template <int MODE>
__global__ void __launch_bounds__(kChunk)
block_sums_kernel(const float* __restrict__ src, long long ld, int per,
                  float* __restrict__ out) {
  __shared__ float s_blk[kVals][kChunk + 1];
  __shared__ float s_red[kWarps][kOut];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  float acc[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.0f;

  for (int c = 0; c < per; ++c) {
    const long long base = ((long long)blockIdx.x * per + c) * kChunk;
    float x[kVals];
    if (MODE == 0) {
#pragma unroll
      for (int k = 0; k < kVals; ++k) x[k] = src[k * ld + base + tid];
    } else if (MODE == 1) {
      // coalesced: 16 neighbouring threads read one row's 64 bytes
      for (int e = tid; e < kChunk * kVals; e += kChunk) {
        const int r = e >> 4;
        const int k = e & 15;
        s_blk[k][r] = src[(base + r) * ld + k];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kVals; ++k) x[k] = s_blk[k][tid];
      __syncthreads();
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

#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) s_red[warp][k] = v;
  }
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
  if (per < 1 || ld < kVals || (mode == 2 && ld % 4 != 0))
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
