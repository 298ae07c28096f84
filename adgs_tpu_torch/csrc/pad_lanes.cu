// B6 — transposing lane pad for sm_90a.
//
// Replaces: adgs_tpu/raster/pallas/render.py `_pad_lanes_kernel` (driven by
// `pad_to_lanes`). Input src [F, N] f32 (F <= 128) taken by its strides
// (stride_f, stride_n), so `packed.t()` of the [N, F] packed rows needs no
// copy; output out [N_pad, 128] row-major with out[n, f] = src[f, n] for
// n < N and f < F, and exact zeros in the 128 - F pad columns and in the
// pad rows n >= N. N_pad is N rounded up to 1024 (the JAX kernel's block),
// which the wrapper computes. The rows layout of the compositor gathers
// these rows into tile order (raster/render.py build_instances_rows).
//
// Bound: bytes (F N floats read once, N_pad rows of 512 bytes written
// once; no arithmetic). Design: one block of 256 threads per 64 output
// rows. The block reads its [F, 64] slab in the order that makes
// neighbouring threads read neighbouring addresses (along n when
// stride_n == 1, along f otherwise, which for packed.t() is the packed
// rows themselves, contiguous), stores it transposed in shared memory
// ([64][F + 1], the +1 spreads the banks), then writes the 64 rows as
// float4s, 32 threads per 512-byte row: both sides are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 64;       // output rows per block
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pad_lanes_kernel(const float* __restrict__ src, int F, long long N,
                 long long stride_f, long long stride_n,
                 float* __restrict__ out) {
  extern __shared__ float s_tile[];   // [kRows][F + 1]
  const int ld = F + 1;
  const long long n0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int total = kRows * F;
  const bool along_n = stride_n == 1 && stride_f != 1;
  for (int e = tid; e < total; e += kThreads) {
    int f, r;
    if (along_n) {
      f = e / kRows;
      r = e - f * kRows;
    } else {
      r = e / F;
      f = e - r * F;
    }
    const long long n = n0 + r;
    s_tile[r * ld + f] =
        n < N ? src[(long long)f * stride_f + n * stride_n] : 0.0f;
  }
  __syncthreads();
  // 64 rows x 32 float4 each
  for (int e = tid; e < kRows * (kLanes / 4); e += kThreads) {
    const int r = e >> 5;
    const int c = (e & 31) * 4;
    float4 v;
    v.x = c + 0 < F ? s_tile[r * ld + c + 0] : 0.0f;
    v.y = c + 1 < F ? s_tile[r * ld + c + 1] : 0.0f;
    v.z = c + 2 < F ? s_tile[r * ld + c + 2] : 0.0f;
    v.w = c + 3 < F ? s_tile[r * ld + c + 3] : 0.0f;
    reinterpret_cast<float4*>(out + (n0 + r) * kLanes)[c >> 2] = v;
  }
}

}  // namespace

extern "C" int adgs_pad_lanes(const void* src, int F, long long N,
                              long long stride_f, long long stride_n,
                              long long n_pad, void* out, void* stream) {
  if (n_pad <= 0) return 0;
  if (F < 1 || F > kLanes || n_pad % kRows != 0 || n_pad < N)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRows * (F + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pad_lanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = n_pad / kRows;
  pad_lanes_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)src, F, N, stride_f, stride_n, (float*)out);
  return (int)cudaGetLastError();
}
