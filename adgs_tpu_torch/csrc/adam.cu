// Adam over every trainable leaf in one launch, for sm_90a.
//
// Replaces no TPU kernel: the JAX package writes its per-group Adam in jnp
// (adgs_tpu/train/optim.py `adam_update`) and XLA fuses each leaf's update
// into one pass. The port's eager update (train/optim.py
// `adam_leaves_torch`) runs 14 PyTorch ops a leaf, each reading one or two
// full-size tensors and writing a temporary: about 128 B of traffic a
// float, 266 launches a step over the 19 leaves (18 Gaussian fields and
// the 3 x 8192^2 sky).
//
// Computes, for each leaf l and element i (b1 = 0.9, b2 = 0.999, eps =
// 1e-15 added outside the sqrt, lr the leaf's rate, bc1 and bc2 the bias
// corrections of the step count):
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   p' = p - lr (m' / bc1) / (sqrt(v' / bc2) + eps)
// into fresh outputs p', m', v' (the callers keep the old trees). Every
// operation rounds as the eager path's does on the card, so the result is
// bitwise the plain twin's there: explicit _rn intrinsics keep nvcc from
// contracting a product and a sum into an FMA, and `m / bc1`, `v / bc2`
// are products with the float reciprocals 1 / bc1, 1 / bc2 (which the
// wrapper computes), as PyTorch divides a CUDA tensor by a CPU scalar.
//
// Bound: bytes. Each float is read once from p, g, m and v and written
// once to p', m' and v': 28 B a float, against about 5 f32 operations, far
// below the card's 20 operations a byte. Design: one launch for all
// leaves; a leaf table passed by value as a __grid_constant__ kernel
// parameter (no copy to the card, no synchronisation), so the launch costs
// the host one call whatever the leaf count. The grid is cut into chunks
// of kChunk floats; block b takes chunk b of the concatenated leaves and
// finds its leaf from the chunk prefix sums (a scan over at most
// kMaxLeaves entries of parameter memory), so the 201 M-float sky gets its
// share of the grid, an 87-float leaf one block, and an empty leaf none.
// A leaf whose seven pointers are all 16-byte aligned runs its body as
// float4 loads and stores (n_vec vectors) and its last n % 4 floats one
// at a time; any other leaf runs one float at a time, four floats a
// thread in flight. Loads and stores use the streaming hints (ld/st.cs):
// the 14-16 GB a step pass once through a 50 MB L2.
//
// Measured on an H100 80GB HBM3 (700 W) at the KITTI-75 train cell's 19
// leaves (487,170,135 floats, bound 4.07 ms): 4.62 ms at kChunk 4096
// (88% of 3.35 TB/s), 4.70 at 16384, 4.75 at 65536, 4.68 with 512
// threads. ptxas gives 50 registers, four blocks of 256 an SM; forcing
// eight (32 registers, a stack frame) or six ran 0.5-1% slower, and
// unrolling the float4 loop changed nothing: half occupancy keeps enough
// bytes in flight.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 4096;    // floats of a block; a multiple of 4
constexpr int kMaxLeaves = 32;

struct Leaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  long long n;        // floats
  long long n_vec;    // float4 vectors of the body; 0: one float at a time
  long long chunk0;   // the leaf's first chunk
  float lr;
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int count;
  float b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps;
};

struct Coef {
  float b1, omb1, b2, omb2, inv_bc1, inv_bc2, eps, lr;
};

// one element, in the eager path's order and roundings
__device__ __forceinline__ void adam_one(const Coef& c, float p, float g,
                                         float m, float v, float& p2,
                                         float& m2, float& v2) {
  m2 = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v2 = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(c.lr, __fmul_rn(m2, c.inv_bc1));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, c.inv_bc2)), c.eps);
  p2 = __fsub_rn(p, __fdiv_rn(num, den));
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const __grid_constant__ Table t) {
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < t.count && t.leaf[l + 1].chunk0 <= b) ++l;
  const Leaf& L = t.leaf[l];
  const Coef c{t.b1, t.omb1, t.b2, t.omb2, t.inv_bc1, t.inv_bc2, t.eps,
               L.lr};
  const float* __restrict__ P = L.p;
  const float* __restrict__ G = L.g;
  const float* __restrict__ M = L.m;
  const float* __restrict__ V = L.v;
  float* __restrict__ P2 = L.p_out;
  float* __restrict__ M2 = L.m_out;
  float* __restrict__ V2 = L.v_out;
  const long long start = (b - L.chunk0) * kChunk;
  const long long end = min(start + kChunk, L.n);
  const int tid = threadIdx.x;

  // the float4 body of the chunk
  const long long body = 4 * L.n_vec;
  const long long v_end = min(end, body) / 4;
  for (long long i = start / 4 + tid; i < v_end; i += kThreads) {
    const float4 p = __ldcs(reinterpret_cast<const float4*>(P) + i);
    const float4 g = __ldcs(reinterpret_cast<const float4*>(G) + i);
    const float4 m = __ldcs(reinterpret_cast<const float4*>(M) + i);
    const float4 v = __ldcs(reinterpret_cast<const float4*>(V) + i);
    float4 p2, m2, v2;
    adam_one(c, p.x, g.x, m.x, v.x, p2.x, m2.x, v2.x);
    adam_one(c, p.y, g.y, m.y, v.y, p2.y, m2.y, v2.y);
    adam_one(c, p.z, g.z, m.z, v.z, p2.z, m2.z, v2.z);
    adam_one(c, p.w, g.w, m.w, v.w, p2.w, m2.w, v2.w);
    __stcs(reinterpret_cast<float4*>(P2) + i, p2);
    __stcs(reinterpret_cast<float4*>(M2) + i, m2);
    __stcs(reinterpret_cast<float4*>(V2) + i, v2);
  }

  // the rest one float at a time: the tail of a vector leaf, or the whole
  // chunk of an unaligned one; four floats a thread per pass
  constexpr int kU = 4;
  for (long long i0 = max(start, body) + tid; i0 < end;
       i0 += kU * kThreads) {
    float p[kU], g[kU], m[kU], v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < end) {
        p[u] = __ldcs(P + i);
        g[u] = __ldcs(G + i);
        m[u] = __ldcs(M + i);
        v[u] = __ldcs(V + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const long long i = i0 + (long long)u * kThreads;
      if (i < end) {
        float p2, m2, v2;
        adam_one(c, p[u], g[u], m[u], v[u], p2, m2, v2);
        __stcs(P2 + i, p2);
        __stcs(M2 + i, m2);
        __stcs(V2 + i, v2);
      }
    }
  }
}

}  // namespace

// ptrs [count, 7] (p, g, m, v, p', m', v' of each leaf), sizes [count, 3]
// (floats, float4 vectors of the body, first chunk), lr [count], scalars
// [7] (b1, 1 - b1, b2, 1 - b2, 1 / bc1, 1 / bc2, eps), all host arrays;
// chunks: the total, the grid's size. The table is copied into the launch's
// parameters, so the host arrays may go as soon as this returns.
extern "C" int adgs_adam_update(const long long* ptrs, const long long* sizes,
                                const float* lr, const float* scalars,
                                int count, long long chunks, void* stream) {
  if (chunks <= 0) return 0;
  if (count < 1 || count > kMaxLeaves || chunks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Table t = {};
  long long next = 0;   // the chunk prefix sum, checked against the table's
  for (int l = 0; l < count; ++l) {
    const long long n = sizes[3 * l];
    if (n < 0 || sizes[3 * l + 1] < 0 || 4 * sizes[3 * l + 1] > n ||
        sizes[3 * l + 2] != next)
      return (int)cudaErrorInvalidValue;
    next += (n + kChunk - 1) / kChunk;
    const long long* q = ptrs + 7 * l;
    Leaf& L = t.leaf[l];
    L.p = (const float*)q[0];
    L.g = (const float*)q[1];
    L.m = (const float*)q[2];
    L.v = (const float*)q[3];
    L.p_out = (float*)q[4];
    L.m_out = (float*)q[5];
    L.v_out = (float*)q[6];
    L.n = sizes[3 * l];
    L.n_vec = sizes[3 * l + 1];
    L.chunk0 = sizes[3 * l + 2];
    L.lr = lr[l];
  }
  if (next != chunks) return (int)cudaErrorInvalidValue;
  t.count = count;
  t.b1 = scalars[0];
  t.omb1 = scalars[1];
  t.b2 = scalars[2];
  t.omb2 = scalars[3];
  t.inv_bc1 = scalars[4];
  t.inv_bc2 = scalars[5];
  t.eps = scalars[6];
  adam_update_kernel<<<(unsigned)chunks, kThreads, 0, (cudaStream_t)stream>>>(
      t);
  return (int)cudaGetLastError();
}
