// P1 and P2 — the EWA preprocess of the Gaussians and its backward, for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package writes the per-Gaussian
// preprocess in jnp (adgs_tpu/raster/preprocess.py `preprocess`) and XLA
// fuses it into a few passes; the reference rasterizer runs it as one CUDA
// kernel each way (preprocessCUDA, forward.cu:156-256, and its backward,
// backward.cu:144-414). The port's plain version (raster/preprocess.py)
// runs it as ~390 eager PyTorch ops a call and an autograd graph of ~316
// nodes, each reading and writing whole [N] columns: the host's launches,
// not the card, set its pace.
//
// P1 (preprocess_fwd_kernel), one thread a Gaussian slot: the view and
// clip transforms, the pixel centre (+ screen_offset), the 3D covariance
// from scale and rotation, its EWA projection with the frustum clamp, the
// conic, the radius, the opacity-aware extent, the tile rect, the tiles
// touched, visibility and the SH colour (degree 0-3, clamped at 0), every
// field of Preprocessed but the opacity, written once. The camera's
// matrices and centre are read from device memory, so nothing is copied
// in and nothing waits. P2 (preprocess_bwd_kernel) recomputes the
// forward's intermediates from the inputs (nothing is saved but the
// inputs) and takes dL/d(mean2d, depth, conic, rgb) to dL/d(means3d,
// scales, rotations, shs), following the plain autograd graph: the clamp
// of tx/tz and ty/tz passes gradient inside its inclusive limits,
// safe_view none behind the camera, det == 0 none through det, rgb's
// clamp where raw >= 0; the SH direction's gradient reaches means3d. rgb
// passes gradient only where P1 wrote it, on a visible slot, whose radius
// P1 wrote above 0 (P2 reads P1's radii, which the step keeps anyway):
// elsewhere it is the constant 0. A slot whose incoming gradients are all
// zero gets exact zeros.
//
// Bound: bytes. P1 reads 12 + 12 + 16 + 4 + 8 + 1 B of geometry a slot
// and, for a visible slot, its 16 x 3 SH floats (192 B), and writes 69 B:
// about 310 B a visible slot against ~250 f32 operations, far below the
// card's 20 operations a byte. P2 reads the 53 B of geometry, 36 B of
// gradients, the 4 B radius and the SH row of a slot with a gradient, and
// writes 40 B and the 192 B of dL/dshs of every slot: about 510 B a live
// slot. The SH rows are the bulk: a warp stages its 32 rows (32 x 3K
// contiguous floats) through shared memory with 16-byte loads, so the
// reads are coalesced, and each lane then reads its own row there (rows
// padded to an odd stride, so the lanes hit 32 different banks); P2
// writes dL/dshs back the same way. A slot that is not visible (dead, behind the camera,
// below the 1/255 gate, off screen) reads rgb 0, which nothing downstream
// reads, and a warp with no visible slot skips its SH loads; a warp with
// no incoming gradient writes zeros without loading anything. Measured on
// an H100 80GB HBM3 (700 W) by chip_smoke.py (phase 11c, seed 0) at
// 2,007,040 slots, SH 3, 1,036,343 visible: P1 0.195 ms of device time
// against a 0.133 ms byte bound (68%), P2 0.324 ms against 0.235 ms (72%).
//
// Rounding: P1 rounds every operation as the eager op it replaces does on
// the card: explicit _rn intrinsics (no multiply-add contraction), x / s by
// a CPU scalar s as x * (1 / s) (the wrapper passes the reciprocals as
// PyTorch forms them), 1 / x as a rounded reciprocal, the small matrix
// products as cuBLAS accumulates them (fma from the first term on), clamp
// and maximum passing NaN on, and int32(floor(v)) saturating as XLA's
// conversion (NaN to 0). So rect_min, rect_max, tiles_touched, visible and
// radii come out bitwise the plain version's. P2 computes in `Rn`, a float
// whose operators round each step on their own, in the order of its plain
// twin (raster/preprocess.py `preprocess_bwd_torch`), so the two agree to
// a few ulps; the twin's sums are taken in another order than autograd's,
// and the CPU tests hold it to autograd at 1e-5.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the plain version's SH constants (core/sh.py), as float32
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC2_0 = 1.0925484305920792f, kC2_1 = -1.0925484305920792f,
                kC2_2 = 0.31539156525252005f, kC2_3 = -1.0925484305920792f,
                kC2_4 = 0.5462742152960396f;
constexpr float kC3_0 = -0.5900435899266435f, kC3_1 = 2.890611442640554f,
                kC3_2 = -0.4570457994644658f, kC3_3 = 0.3731763325901154f,
                kC3_4 = -0.4570457994644658f, kC3_5 = 1.445305721320277f,
                kC3_6 = -0.5900435899266435f;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.clamp / clamp_min / torch.maximum: NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float maximum_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// int32(floor(v)) as the plain version's _ifloor: NaN -> 0, out of range ->
// the nearest int32 bound
__device__ __forceinline__ int ifloor(float v) {
  const float f = floorf(v);
  if (isnan(f)) return 0;
  if (f >= 2147483647.0f) return 2147483647;
  if (f <= -2147483648.0f) return (-2147483647 - 1);
  return (int)f;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// a [4, 4] matrix in device memory at its strides
struct Mat {
  const float* p;
  int s0, s1;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return __ldg(p + i * s0 + j * s1);
  }
};

// [m0 m1 m2] times column j of M, plus M[3][j]: the plain version's
// `p @ M[:3, :] + M[3, :]`, accumulated as cuBLAS does
__device__ __forceinline__ float affine(float m0, float m1, float m2,
                                        const Mat& M, int j) {
  const float dot = __fmaf_rn(m2, M(2, j), __fmaf_rn(m1, M(1, j),
                                                     mul(m0, M(0, j))));
  return add(dot, M(3, j));
}

struct Cam {
  Mat view;               // [4, 4] transposed world -> view
  Mat proj;               // [4, 4] transposed world -> NDC
  const float* campos;    // [3]
  int campos_stride;
  float width, height;
  float focal_x, focal_y, neg_focal_x, neg_focal_y;
  float lim_x, lim_y;     // float32(1.3 tan(fov / 2))
  float scale_modifier;
  float inv_tile_x, inv_tile_y;   // 1 / TILE, as a product (CPU scalar)
  float inv_nine;                 // 1 / 9
  int grid_x, grid_y;
  int sh_degree;
};

// the forward's intermediates of one slot, each rounded as the plain
// version rounds it
struct Geo {
  float pv[3];          // p_view
  bool in_front;
  float ph0, ph1, ph3;  // p_hom (x, y, w)
  float pw;             // 1 / (w + 1e-7)
  float tx, ty, tz;     // safe_view
  float rx, ry;         // tx / tz, ty / tz
  float cx, cy;         // their clamps
  float txz, tyz;
  float inv_z, inv_z2;
  float j00, j02, j11, j12;
  float R[3][3];        // rotation rows (core/covariance.py r00 .. r22)
  float sm[3], sq[3];   // scale_modifier * s, its square
  float v[6];           // cov3d upper triangle
  float a[3][3];        // a[r][c] = view[c][r]
  float t[3][3];        // a @ Sigma
  float s00, s01, s02, s11, s12, s22;
  float A, B, C, D, E, F;
  float cxx, cxy, cyy, det, det_inv;
};

__device__ __forceinline__ void geometry(const Cam& c, float m0, float m1,
                                         float m2, float3 s, float4 q,
                                         Geo& g) {
#pragma unroll
  for (int j = 0; j < 3; ++j) g.pv[j] = affine(m0, m1, m2, c.view, j);
  g.in_front = g.pv[2] > 0.2f;
  g.ph0 = affine(m0, m1, m2, c.proj, 0);
  g.ph1 = affine(m0, m1, m2, c.proj, 1);
  g.ph3 = affine(m0, m1, m2, c.proj, 3);
  g.pw = __frcp_rn(add(g.ph3, 1e-7f));

  // build_cov3d
  const float r = q.x, x = q.y, y = q.z, z = q.w;
  g.R[0][0] = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  g.R[0][1] = mul(2.0f, sub(mul(x, y), mul(r, z)));
  g.R[0][2] = mul(2.0f, add(mul(x, z), mul(r, y)));
  g.R[1][0] = mul(2.0f, add(mul(x, y), mul(r, z)));
  g.R[1][1] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  g.R[1][2] = mul(2.0f, sub(mul(y, z), mul(r, x)));
  g.R[2][0] = mul(2.0f, sub(mul(x, z), mul(r, y)));
  g.R[2][1] = mul(2.0f, add(mul(y, z), mul(r, x)));
  g.R[2][2] = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  g.sm[0] = mul(s.x, c.scale_modifier);
  g.sm[1] = mul(s.y, c.scale_modifier);
  g.sm[2] = mul(s.z, c.scale_modifier);
#pragma unroll
  for (int k = 0; k < 3; ++k) g.sq[k] = mul(g.sm[k], g.sm[k]);
  const int ia[6] = {0, 0, 0, 1, 1, 2}, ib[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int e = 0; e < 6; ++e) {
    float acc = mul(mul(g.sq[0], g.R[0][ia[e]]), g.R[0][ib[e]]);
    acc = add(acc, mul(mul(g.sq[1], g.R[1][ia[e]]), g.R[1][ib[e]]));
    g.v[e] = add(acc, mul(mul(g.sq[2], g.R[2][ia[e]]), g.R[2][ib[e]]));
  }

  // project_cov3d_to_2d at safe_view
  g.tx = g.in_front ? g.pv[0] : 0.0f;
  g.ty = g.in_front ? g.pv[1] : 0.0f;
  g.tz = g.in_front ? g.pv[2] : 1.0f;
  g.rx = __fdiv_rn(g.tx, g.tz);
  g.ry = __fdiv_rn(g.ty, g.tz);
  g.cx = clamp_nan(g.rx, -c.lim_x, c.lim_x);
  g.cy = clamp_nan(g.ry, -c.lim_y, c.lim_y);
  g.txz = mul(g.cx, g.tz);
  g.tyz = mul(g.cy, g.tz);
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc) g.a[rr][cc] = c.view(cc, rr);
  const float* v = g.v;
  // Sigma's columns: (v0 v1 v2), (v1 v3 v4), (v2 v4 v5)
  const float col[3][3] = {{v[0], v[1], v[2]}, {v[1], v[3], v[4]},
                           {v[2], v[4], v[5]}};
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      g.t[rr][cc] = add(add(mul(g.a[rr][0], col[cc][0]),
                            mul(g.a[rr][1], col[cc][1])),
                        mul(g.a[rr][2], col[cc][2]));
  g.inv_z = __frcp_rn(g.tz);
  g.inv_z2 = mul(g.inv_z, g.inv_z);
  g.j00 = mul(g.inv_z, c.focal_x);
  g.j02 = mul(mul(g.txz, c.neg_focal_x), g.inv_z2);
  g.j11 = mul(g.inv_z, c.focal_y);
  g.j12 = mul(mul(g.tyz, c.neg_focal_y), g.inv_z2);
  // s_rc = t[r] . a[c]
#define ADGS_S(rr, cc)                                              \
  add(add(mul(g.t[rr][0], g.a[cc][0]), mul(g.t[rr][1], g.a[cc][1])), \
      mul(g.t[rr][2], g.a[cc][2]))
  g.s00 = ADGS_S(0, 0);
  g.s01 = ADGS_S(0, 1);
  g.s02 = ADGS_S(0, 2);
  g.s11 = ADGS_S(1, 1);
  g.s12 = ADGS_S(1, 2);
  g.s22 = ADGS_S(2, 2);
#undef ADGS_S
  g.A = add(mul(g.j00, g.s00), mul(g.j02, g.s02));
  g.B = add(mul(g.j00, g.s02), mul(g.j02, g.s22));
  g.C = add(mul(g.j11, g.s01), mul(g.j12, g.s02));
  g.D = add(mul(g.j11, g.s12), mul(g.j12, g.s22));
  g.E = add(mul(g.j11, g.s11), mul(g.j12, g.s12));
  g.F = add(mul(g.j11, g.s12), mul(g.j12, g.s22));
  g.cxx = add(add(mul(g.j00, g.A), mul(g.j02, g.B)), 0.3f);
  g.cxy = add(mul(g.j00, g.C), mul(g.j02, g.D));
  g.cyy = add(add(mul(g.j11, g.E), mul(g.j12, g.F)), 0.3f);
  g.det = sub(mul(g.cxx, g.cyy), mul(g.cxy, g.cxy));
  g.det_inv = __frcp_rn(g.det == 0.0f ? 1.0f : g.det);
}

// the unit direction from the camera to the mean (core/sh.py
// eval_sh_color); d and the norm as the backward needs them
struct Dir {
  float d[3], n, den, u[3];
  bool zero;
};

__device__ __forceinline__ void sh_dir(const Cam& c, float m0, float m1,
                                       float m2, Dir& r) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r.d[k] = sub(k == 0 ? m0 : (k == 1 ? m1 : m2),
                 __ldg(c.campos + k * c.campos_stride));
  const float sq =
      add(add(mul(r.d[0], r.d[0]), mul(r.d[1], r.d[1])), mul(r.d[2], r.d[2]));
  r.zero = sq == 0.0f;
  r.n = __fsqrt_rn(r.zero ? 1.0f : sq);
  r.den = r.zero ? 1.0f : r.n;
#pragma unroll
  for (int k = 0; k < 3; ++k) r.u[k] = __fdiv_rn(r.d[k], r.den);
}

// sh_basis with the coefficients folded in; entries past the degree are 0
__device__ __forceinline__ void sh_basis(int deg, float x, float y, float z,
                                         float (&b)[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) b[k] = 0.0f;
  b[0] = kC0;
  if (deg > 0) {
    b[1] = mul(y, -kC1);
    b[2] = mul(z, kC1);
    b[3] = mul(x, -kC1);
    if (deg > 1) {
      const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
      const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
      b[4] = mul(xy, kC2_0);
      b[5] = mul(yz, kC2_1);
      b[6] = mul(sub(sub(mul(zz, 2.0f), xx), yy), kC2_2);
      b[7] = mul(xz, kC2_3);
      b[8] = mul(sub(xx, yy), kC2_4);
      if (deg > 2) {
        b[9] = mul(mul(y, kC3_0), sub(mul(xx, 3.0f), yy));
        b[10] = mul(mul(xy, kC3_1), z);
        b[11] = mul(mul(y, kC3_2), sub(sub(mul(zz, 4.0f), xx), yy));
        b[12] = mul(mul(z, kC3_3),
                    sub(sub(mul(zz, 2.0f), mul(xx, 3.0f)), mul(yy, 3.0f)));
        b[13] = mul(mul(x, kC3_4), sub(sub(mul(zz, 4.0f), xx), yy));
        b[14] = mul(mul(z, kC3_5), sub(xx, yy));
        b[15] = mul(mul(x, kC3_6), sub(xx, mul(yy, 3.0f)));
      }
    }
  }
}

// rows of K SH coefficients (3K floats) staged in shared memory at an odd
// stride
template <int K>
struct Rows {
  static constexpr int kLen = 3 * K;
  static constexpr int kStride = kLen % 2 ? kLen : kLen + 1;
};

// the warp's `cnt` rows from `src` (16-byte aligned) into `s`
template <int K>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int cnt, float* s, int lane) {
  constexpr int L = Rows<K>::kLen, S = Rows<K>::kStride;
  const int total = cnt * L;
  const int nvec = total / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int vi = lane; vi < nvec; vi += 32) {
    const float4 x = __ldg(src4 + vi);
    const float e4[4] = {x.x, x.y, x.z, x.w};
    int row = (4 * vi) / L, j = 4 * vi - row * L;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[row * S + j] = e4[k];
      if (++j == L) { j = 0; ++row; }
    }
  }
  for (int e = 4 * nvec + lane; e < total; e += 32)
    s[(e / L) * S + e % L] = __ldg(src + e);
}

// the warp's `cnt` rows from `s` to `dst` (16-byte aligned)
template <int K>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int cnt,
                                           const float* s, int lane) {
  constexpr int L = Rows<K>::kLen, S = Rows<K>::kStride;
  const int total = cnt * L;
  const int nvec = total / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int vi = lane; vi < nvec; vi += 32) {
    float e4[4];
    int row = (4 * vi) / L, j = 4 * vi - row * L;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      e4[k] = s[row * S + j];
      if (++j == L) { j = 0; ++row; }
    }
    dst4[vi] = make_float4(e4[0], e4[1], e4[2], e4[3]);
  }
  for (int e = 4 * nvec + lane; e < total; e += 32)
    dst[e] = s[(e / L) * S + e % L];
}

template <int K>
__device__ __forceinline__ void zero_rows(float* __restrict__ dst, int cnt,
                                          int lane) {
  const int total = cnt * Rows<K>::kLen;
  const int nvec = total / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int vi = lane; vi < nvec; vi += 32)
    dst4[vi] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = 4 * nvec + lane; e < total; e += 32) dst[e] = 0.0f;
}

struct FwdArgs {
  const float* means;     // [N, 3]
  const float* scales;    // [N, 3]
  const float* rots;      // [N, 4] (w, x, y, z)
  const float* opac;      // [N]
  const float* shs;       // [N, K, 3], or null (K == 0)
  const float* offset;    // [N, 2] screen_offset, or null
  const bool* active;     // [N], or null
  float* mean2d;          // [N, 2]
  float* depth;           // [N]
  float* conic;           // [N, 3]
  float* rgb;             // [N, 3]
  float* radii;           // [N]
  float* extent;          // [N, 2]
  int* rect_min;          // [N, 2]
  int* rect_max;          // [N, 2]
  int* tiles;             // [N]
  bool* visible;          // [N]
  long long n;
  Cam cam;
};

template <int K>
__global__ void __launch_bounds__(kThreads)
    preprocess_fwd_kernel(const __grid_constant__ FwdArgs a) {
  constexpr int S = Rows<(K > 0 ? K : 1)>::kStride;
  __shared__ float rows[K > 0 ? kWarps * 32 * S : 1];
  const Cam& c = a.cam;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.n;
  bool vis = false;
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;
  if (live) {
    m0 = a.means[3 * i];
    m1 = a.means[3 * i + 1];
    m2 = a.means[3 * i + 2];
    const float3 s = make_float3(a.scales[3 * i], a.scales[3 * i + 1],
                                 a.scales[3 * i + 2]);
    const float4 q = reinterpret_cast<const float4*>(a.rots)[i];
    const float op = a.opac[i];
    Geo g;
    geometry(c, m0, m1, m2, s, q, g);

    float mx = mul(sub(mul(add(mul(g.ph0, g.pw), 1.0f), c.width), 1.0f), 0.5f);
    float my = mul(sub(mul(add(mul(g.ph1, g.pw), 1.0f), c.height), 1.0f),
                   0.5f);
    if (a.offset) {
      const float2 o = reinterpret_cast<const float2*>(a.offset)[i];
      mx = add(mx, o.x);
      my = add(my, o.y);
    }
    const float mid = mul(0.5f, add(g.cxx, g.cyy));
    const float disc = __fsqrt_rn(clamp_min_nan(sub(mul(mid, mid), g.det),
                                                0.1f));
    const float radius = ceilf(mul(
        __fsqrt_rn(maximum_nan(add(mid, disc), sub(mid, disc))), 3.0f));
    // the opacity-aware support q <= 2 ln(255 op) + 1e-3, at most 3 sigma
    const float qmax = add(mul(logf(mul(clamp_min_nan(op, 1e-30f), 255.0f)),
                               2.0f),
                           1e-3f);
    const float shrink = __fsqrt_rn(mul(clamp_nan(qmax, 0.0f, 9.0f),
                                        c.inv_nine));
    const float ex = mul(mul(__fsqrt_rn(clamp_min_nan(g.cxx, 0.0f)), 3.0f),
                         shrink);
    const float ey = mul(mul(__fsqrt_rn(clamp_min_nan(g.cyy, 0.0f)), 3.0f),
                         shrink);
    const bool alive_op = mul(op, 255.0f) >= 0.99999f;
    const int rmin_x = clampi(ifloor(mul(ceilf(sub(mx, ex)), c.inv_tile_x)),
                              0, c.grid_x);
    const int rmin_y = clampi(ifloor(mul(ceilf(sub(my, ey)), c.inv_tile_y)),
                              0, c.grid_y);
    // + 1 wraps in int32 as the plain version's tensor add does
    const int rmax_x = clampi(
        (int)((unsigned)ifloor(mul(floorf(add(mx, ex)), c.inv_tile_x)) + 1u),
        0, c.grid_x);
    const int rmax_y = clampi(
        (int)((unsigned)ifloor(mul(floorf(add(my, ey)), c.inv_tile_y)) + 1u),
        0, c.grid_y);
    const int tiles = (int)((unsigned)(rmax_x - rmin_x) *
                            (unsigned)(rmax_y - rmin_y));
    vis = g.in_front && g.det != 0.0f && tiles > 0 && alive_op &&
          (a.active == nullptr || a.active[i]);

    reinterpret_cast<float2*>(a.mean2d)[i] = make_float2(mx, my);
    a.depth[i] = g.pv[2];
    a.conic[3 * i] = mul(g.cyy, g.det_inv);
    a.conic[3 * i + 1] = mul(-g.cxy, g.det_inv);
    a.conic[3 * i + 2] = mul(g.cxx, g.det_inv);
    a.radii[i] = vis ? radius : 0.0f;
    reinterpret_cast<float2*>(a.extent)[i] = make_float2(ex, ey);
    reinterpret_cast<int2*>(a.rect_min)[i] = make_int2(rmin_x, rmin_y);
    reinterpret_cast<int2*>(a.rect_max)[i] = make_int2(rmax_x, rmax_y);
    a.tiles[i] = vis ? tiles : 0;
    a.visible[i] = vis;
  }

  float col[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (K > 0) {
    // the warp stages its rows only if one of its slots is visible
    if (__ballot_sync(kFull, vis)) {
      const long long base = (long long)blockIdx.x * kThreads + warp * 32;
      const int cnt = (int)min(32LL, a.n - base);
      float* s = rows + warp * 32 * S;
      if (cnt > 0) load_rows<K>(a.shs + base * 3 * K, cnt, s, lane);
      __syncwarp();
      if (vis) {
        Dir d;
        sh_dir(c, m0, m1, m2, d);
        float b[16];
        sh_basis(c.sh_degree, d.u[0], d.u[1], d.u[2], b);
        const int kd = (c.sh_degree + 1) * (c.sh_degree + 1);
        const float* row = s + lane * S;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float acc = mul(b[0], row[ch]);
#pragma unroll
          for (int k = 1; k < (K < 16 ? K : 16); ++k)
            if (k < kd) acc = add(acc, mul(b[k], row[3 * k + ch]));
          col[ch] = clamp_min_nan(add(acc, 0.5f), 0.0f);
        }
      }
    }
  }
  if (live) {
    a.rgb[3 * i] = col[0];
    a.rgb[3 * i + 1] = col[1];
    a.rgb[3 * i + 2] = col[2];
  }
}

// A float whose every operation rounds on its own, as an eager PyTorch op
// does: P2 computes in it, so that nvcc contracts nothing and P2 takes
// each of its twin's steps in the twin's order and rounding.
struct Rn {
  float v;
  __device__ __forceinline__ Rn(float x = 0.0f) : v(x) {}
};
__device__ __forceinline__ Rn operator+(Rn a, Rn b) {
  return __fadd_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator-(Rn a, Rn b) {
  return __fsub_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator*(Rn a, Rn b) {
  return __fmul_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator/(Rn a, Rn b) {
  return __fdiv_rn(a.v, b.v);
}
__device__ __forceinline__ Rn operator-(Rn a) { return -a.v; }

// [x0 x1 x2] times row k of M's columns c0, c1, c2: the twin's
// `x @ M[:3, cols].T`, accumulated as cuBLAS does
__device__ __forceinline__ Rn dot_rows(Rn x0, Rn x1, Rn x2, const Mat& M,
                                       int k, int c0, int c1, int c2) {
  return __fmaf_rn(x2.v, M(k, c2), __fmaf_rn(x1.v, M(k, c1),
                                             mul(x0.v, M(k, c0))));
}

struct BwdArgs {
  const float* means;
  const float* scales;
  const float* rots;
  const float* shs;       // [N, K, 3], or null (K == 0)
  const float* g_mean2d;  // [N, 2]
  const float* g_depth;   // [N]
  const float* g_conic;   // [N, 3]
  const float* g_rgb;     // [N, 3], or null (K == 0)
  const float* radii;     // [N], P1's: > 0 where visible, and rgb is a
                          // constant 0 elsewhere
  float* g_means;         // [N, 3]
  float* g_scales;        // [N, 3]
  float* g_rots;          // [N, 4]
  float* g_shs;           // [N, K, 3], or null (K == 0)
  long long n;
  Cam cam;
};

template <int K>
__global__ void __launch_bounds__(kThreads)
    preprocess_bwd_kernel(const __grid_constant__ BwdArgs a) {
  constexpr int S = Rows<(K > 0 ? K : 1)>::kStride;
  __shared__ float rows[K > 0 ? kWarps * 32 * S : 1];
  const Cam& c = a.cam;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < a.n;

  float gm[2] = {0.0f, 0.0f}, gd = 0.0f, gc[3] = {0.0f, 0.0f, 0.0f};
  float grgb[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    gm[0] = a.g_mean2d[2 * i];
    gm[1] = a.g_mean2d[2 * i + 1];
    gd = a.g_depth[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) gc[k] = a.g_conic[3 * i + k];
    if (K > 0 && a.radii[i] > 0.0f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) grgb[k] = a.g_rgb[3 * i + k];
    }
  }
  const bool any_geo = gm[0] != 0.0f || gm[1] != 0.0f || gd != 0.0f ||
                       gc[0] != 0.0f || gc[1] != 0.0f || gc[2] != 0.0f;
  const bool any_rgb = grgb[0] != 0.0f || grgb[1] != 0.0f || grgb[2] != 0.0f;
  const bool work = live && (any_geo || any_rgb);

  Rn gmean[3], gscale[3], grot[4];
  float m0 = 0.0f, m1 = 0.0f, m2 = 0.0f;
  if (work) {
    m0 = a.means[3 * i];
    m1 = a.means[3 * i + 1];
    m2 = a.means[3 * i + 2];
    const float3 s = make_float3(a.scales[3 * i], a.scales[3 * i + 1],
                                 a.scales[3 * i + 2]);
    const float4 q = reinterpret_cast<const float4*>(a.rots)[i];
    Geo g;
    geometry(c, m0, m1, m2, s, q, g);

    // conic = (cyy, -cxy, cxx) / det (no gradient through det at det == 0)
    const Rn ga = gc[0], gb = gc[1], gcc = gc[2];
    const Rn gdinv = ga * g.cyy + gb * (-g.cxy) + gcc * g.cxx;
    const Rn gdet = g.det != 0.0f ? -gdinv * (Rn(g.det_inv) * g.det_inv)
                                  : Rn(0.0f);
    const Rn gcxx = gcc * g.det_inv + gdet * g.cyy;
    const Rn gcyy = ga * g.det_inv + gdet * g.cxx;
    const Rn gcxy = -(gb * g.det_inv) + Rn(-2.0f) * gdet * g.cxy;
    // cxx = j00 A + j02 B + 0.3, cxy = j00 C + j02 D, cyy = j11 E + j12 F
    const Rn gA = gcxx * g.j00, gB = gcxx * g.j02, gC = gcxy * g.j00;
    const Rn gD = gcxy * g.j02, gE = gcyy * g.j11, gF = gcyy * g.j12;
    const Rn gj00 = gcxx * g.A + gcxy * g.C + gA * g.s00 + gB * g.s02;
    const Rn gj02 = gcxx * g.B + gcxy * g.D + gA * g.s02 + gB * g.s22;
    const Rn gj11 = gcyy * g.E + gC * g.s01 + gD * g.s12 + gE * g.s11 +
                    gF * g.s12;
    const Rn gj12 = gcyy * g.F + gC * g.s02 + gD * g.s22 + gE * g.s12 +
                    gF * g.s22;
    const Rn gs00 = gA * g.j00;
    const Rn gs01 = gC * g.j11;
    const Rn gs02 = gA * g.j02 + gB * g.j00 + gC * g.j12;
    const Rn gs11 = gE * g.j11;
    const Rn gs12 = gD * g.j11 + gE * g.j12 + gF * g.j11;
    const Rn gs22 = gB * g.j02 + gD * g.j12 + gF * g.j12;
    // s_rc = t[r] . a[c] -> dL/dt
    Rn gt[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gt[0][k] = gs00 * g.a[0][k] + gs01 * g.a[1][k] + gs02 * g.a[2][k];
      gt[1][k] = gs11 * g.a[1][k] + gs12 * g.a[2][k];
      gt[2][k] = gs22 * g.a[2][k];
    }
    // t = a Sigma -> dL/dSigma (full), then the upper triangle
    Rn gS[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        gS[k][cc] = Rn(g.a[0][k]) * gt[0][cc] + Rn(g.a[1][k]) * gt[1][cc] +
                    Rn(g.a[2][k]) * gt[2][cc];
    const Rn gv[6] = {gS[0][0], gS[0][1] + gS[1][0], gS[0][2] + gS[2][0],
                      gS[1][1], gS[1][2] + gS[2][1], gS[2][2]};
    // Sigma = R^T diag(sq) R
    Rn gR[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Rn r0 = g.R[k][0], r1 = g.R[k][1], r2 = g.R[k][2];
      const Rn gsq = gv[0] * r0 * r0 + gv[1] * r0 * r1 + gv[2] * r0 * r2 +
                     gv[3] * r1 * r1 + gv[4] * r1 * r2 + gv[5] * r2 * r2;
      gscale[k] = gsq * (Rn(2.0f) * g.sm[k]) * c.scale_modifier;
      gR[k][0] = g.sq[k] * (Rn(2.0f) * gv[0] * r0 + gv[1] * r1 + gv[2] * r2);
      gR[k][1] = g.sq[k] * (gv[1] * r0 + Rn(2.0f) * gv[3] * r1 + gv[4] * r2);
      gR[k][2] = g.sq[k] * (gv[2] * r0 + gv[4] * r1 + Rn(2.0f) * gv[5] * r2);
    }
    {
      const Rn r = q.x, x = q.y, y = q.z, z = q.w, two = 2.0f;
      grot[0] = two * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] -
                       x * gR[1][2] - y * gR[2][0] + x * gR[2][1]);
      grot[1] = two * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] -
                       two * x * gR[1][1] - r * gR[1][2] + z * gR[2][0] +
                       r * gR[2][1] - two * x * gR[2][2]);
      grot[2] = two * (-two * y * gR[0][0] + x * gR[0][1] + r * gR[0][2] +
                       x * gR[1][0] + z * gR[1][2] - r * gR[2][0] +
                       z * gR[2][1] - two * y * gR[2][2]);
      grot[3] = two * (-two * z * gR[0][0] - r * gR[0][1] + x * gR[0][2] +
                       r * gR[1][0] - two * z * gR[1][1] + y * gR[1][2] +
                       x * gR[2][0] + y * gR[2][1]);
    }
    // J: j00 = fx / z, j02 = -fx txz / z^2 (likewise y)
    const Rn gtxz = gj02 * g.inv_z2 * c.neg_focal_x;
    const Rn gtyz = gj12 * g.inv_z2 * c.neg_focal_y;
    const Rn ginv_z2 = gj02 * (Rn(g.txz) * c.neg_focal_x) +
                       gj12 * (Rn(g.tyz) * c.neg_focal_y);
    const Rn ginv_z = gj00 * c.focal_x + gj11 * c.focal_y +
                      Rn(2.0f) * ginv_z2 * g.inv_z;
    // the clamps pass gradient inside their inclusive limits
    const Rn grx = (g.rx >= -c.lim_x && g.rx <= c.lim_x) ? gtxz * g.tz
                                                          : Rn(0.0f);
    const Rn gry = (g.ry >= -c.lim_y && g.ry <= c.lim_y) ? gtyz * g.tz
                                                          : Rn(0.0f);
    const Rn gtz = -ginv_z * (Rn(g.inv_z) * g.inv_z) + gtxz * g.cx +
                   gtyz * g.cy - grx * (Rn(g.rx) / g.tz) -
                   gry * (Rn(g.ry) / g.tz);
    // safe_view: no gradient behind the camera; depth is p_view's z
    const Rn gpv0 = g.in_front ? grx / g.tz : Rn(0.0f);
    const Rn gpv1 = g.in_front ? gry / g.tz : Rn(0.0f);
    const Rn gpv2 = (g.in_front ? gtz : Rn(0.0f)) + gd;
    // mean2d = ((p_hom . w + 1) size - 1) / 2
    const Rn gpp0 = Rn(gm[0]) * 0.5f * c.width;
    const Rn gpp1 = Rn(gm[1]) * 0.5f * c.height;
    const Rn gpw = gpp0 * g.ph0 + gpp1 * g.ph1;
    const Rn gph0 = gpp0 * g.pw, gph1 = gpp1 * g.pw;
    const Rn gph3 = -gpw * (Rn(g.pw) * g.pw);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gmean[k] = dot_rows(gpv0, gpv1, gpv2, c.view, k, 0, 1, 2) +
                 dot_rows(gph0, gph1, gph3, c.proj, k, 0, 1, 3);
  }

  if constexpr (K > 0) {
    constexpr int L = 3 * K;
    const long long base = (long long)blockIdx.x * kThreads + warp * 32;
    const int cnt = (int)min(32LL, a.n - base);
    const bool need = work && any_rgb;
    if (__ballot_sync(kFull, need)) {
      float* s = rows + warp * 32 * S;
      if (cnt > 0) load_rows<K>(a.shs + base * L, cnt, s, lane);
      __syncwarp();
      float* row = s + lane * S;
      if (need) {
        Dir d;
        sh_dir(c, m0, m1, m2, d);
        float b[16];
        sh_basis(c.sh_degree, d.u[0], d.u[1], d.u[2], b);
        const int deg = c.sh_degree;
        const int kd = (deg + 1) * (deg + 1);
        // raw = sum_k b_k sh_k + 0.5; rgb = max(raw, 0)
        Rn graw[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float acc = mul(b[0], row[ch]);
#pragma unroll
          for (int k = 1; k < (K < 16 ? K : 16); ++k)
            if (k < kd) acc = add(acc, mul(b[k], row[3 * k + ch]));
          graw[ch] = add(acc, 0.5f) >= 0.0f ? grgb[ch] : 0.0f;
        }
        Rn gb[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < K && k < kd)
            gb[k] = Rn(row[3 * k]) * graw[0] + Rn(row[3 * k + 1]) * graw[1] +
                    Rn(row[3 * k + 2]) * graw[2];
        // dL/dsh in place of the row (zeros past the degree)
#pragma unroll
        for (int k = 0; k < (K < 16 ? K : 16); ++k)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            row[3 * k + ch] = k < kd ? (Rn(b[k]) * graw[ch]).v : 0.0f;
        // d basis / d direction
        const Rn x = d.u[0], y = d.u[1], z = d.u[2];
        Rn gx, gy, gz;
        if (deg > 0) {
          gx = Rn(-kC1) * gb[3];
          gy = Rn(-kC1) * gb[1];
          gz = Rn(kC1) * gb[2];
        }
        if (deg > 1) {
          gx = gx + Rn(kC2_0) * y * gb[4] +
               Rn(kC2_2) * (Rn(-2.0f) * x) * gb[6] + Rn(kC2_3) * z * gb[7] +
               Rn(kC2_4) * (Rn(2.0f) * x) * gb[8];
          gy = gy + Rn(kC2_0) * x * gb[4] + Rn(kC2_1) * z * gb[5] +
               Rn(kC2_2) * (Rn(-2.0f) * y) * gb[6] +
               Rn(kC2_4) * (Rn(-2.0f) * y) * gb[8];
          gz = gz + Rn(kC2_1) * y * gb[5] + Rn(kC2_2) * (Rn(4.0f) * z) * gb[6] +
               Rn(kC2_3) * x * gb[7];
        }
        if (deg > 2) {
          const Rn xx = x * x, yy = y * y, zz = z * z;
          const Rn three = 3.0f, four = 4.0f;
          gx = gx + Rn(kC3_0) * y * (Rn(6.0f) * x) * gb[9] +
               Rn(kC3_1) * y * z * gb[10] +
               Rn(kC3_2) * y * (Rn(-2.0f) * x) * gb[11] +
               Rn(kC3_3) * z * (Rn(-6.0f) * x) * gb[12] +
               Rn(kC3_4) * (four * zz - three * xx - yy) * gb[13] +
               Rn(kC3_5) * z * (Rn(2.0f) * x) * gb[14] +
               Rn(kC3_6) * (three * xx - three * yy) * gb[15];
          gy = gy + Rn(kC3_0) * (three * xx - three * yy) * gb[9] +
               Rn(kC3_1) * x * z * gb[10] +
               Rn(kC3_2) * (four * zz - xx - three * yy) * gb[11] +
               Rn(kC3_3) * z * (Rn(-6.0f) * y) * gb[12] +
               Rn(kC3_4) * x * (Rn(-2.0f) * y) * gb[13] +
               Rn(kC3_5) * z * (Rn(-2.0f) * y) * gb[14] +
               Rn(kC3_6) * x * (Rn(-6.0f) * y) * gb[15];
          gz = gz + Rn(kC3_1) * x * y * gb[10] +
               Rn(kC3_2) * y * (Rn(8.0f) * z) * gb[11] +
               Rn(kC3_3) * (Rn(6.0f) * zz - three * xx - three * yy) * gb[12] +
               Rn(kC3_4) * x * (Rn(8.0f) * z) * gb[13] +
               Rn(kC3_5) * (xx - yy) * gb[14];
        }
        // u = d / den, den = |d| (1 where d = 0)
        const Rn gu[3] = {gx, gy, gz};
        const Rn dot = gu[0] * (Rn(d.u[0]) / d.den) +
                       gu[1] * (Rn(d.u[1]) / d.den) +
                       gu[2] * (Rn(d.u[2]) / d.den);
        const Rn half = d.zero ? Rn(0.0f) : dot / (Rn(2.0f) * d.n);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          gmean[k] = gmean[k] + (gu[k] / d.den -
                                 (d.zero ? Rn(0.0f)
                                         : half * Rn(2.0f) * d.d[k]));
      } else {
        for (int e = 0; e < L; ++e) row[e] = 0.0f;
      }
      __syncwarp();
      if (cnt > 0) store_rows<K>(a.g_shs + base * L, cnt, s, lane);
    } else if (cnt > 0) {
      zero_rows<K>(a.g_shs + base * L, cnt, lane);
    }
  }

  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.g_means[3 * i + k] = gmean[k].v;
      a.g_scales[3 * i + k] = gscale[k].v;
    }
    reinterpret_cast<float4*>(a.g_rots)[i] =
        make_float4(grot[0].v, grot[1].v, grot[2].v, grot[3].v);
  }
}

Cam make_cam(const long long* ptrs, const float* consts,
             const long long* ints) {
  Cam c;
  c.view = Mat{(const float*)ptrs[0], (int)ints[5], (int)ints[6]};
  c.proj = Mat{(const float*)ptrs[1], (int)ints[7], (int)ints[8]};
  c.campos = (const float*)ptrs[2];
  c.campos_stride = (int)ints[9];
  c.width = consts[0];
  c.height = consts[1];
  c.focal_x = consts[2];
  c.focal_y = consts[3];
  c.neg_focal_x = consts[4];
  c.neg_focal_y = consts[5];
  c.lim_x = consts[6];
  c.lim_y = consts[7];
  c.scale_modifier = consts[8];
  c.inv_tile_x = consts[9];
  c.inv_tile_y = consts[10];
  c.inv_nine = consts[11];
  c.grid_x = (int)ints[2];
  c.grid_y = (int)ints[3];
  c.sh_degree = (int)ints[4];
  return c;
}

bool bad_shape(long long n, long long K, long long deg) {
  return n < 0 || n > 0x7fffffffLL * kThreads ||
         !(K == 0 || K == 1 || K == 4 || K == 9 || K == 16) || deg < 0 ||
         deg > 3 || (K > 0 && (deg + 1) * (deg + 1) > K);
}

template <typename Args, typename Fn>
int launch(Fn kernel, const Args& a, void* stream) {
  const unsigned blocks = (unsigned)((a.n + kThreads - 1) / kThreads);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: view, proj, campos, means, scales, rots, opac, shs, offset, active,
// then the outputs mean2d, depth, conic, rgb, radii, extent, rect_min,
// rect_max, tiles, visible (null for shs, offset and active where absent);
// consts: width, height, focal_x, focal_y, -focal_x, -focal_y, lim_x,
// lim_y, scale_modifier, 1 / TILE_X, 1 / TILE_Y, 1 / 9 (float32); ints: n,
// K (SH coefficients a row, 0 without SH), grid_x, grid_y, sh_degree, the
// strides of view and proj (rows, columns) and of campos. All host arrays,
// copied into the launch's parameters.
extern "C" int adgs_preprocess_fwd(const long long* ptrs, const float* consts,
                                   const long long* ints, void* stream) {
  const long long n = ints[0], K = ints[1];
  if (bad_shape(n, K, ints[4]) || (K > 0 && ptrs[7] == 0))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  FwdArgs a;
  a.cam = make_cam(ptrs, consts, ints);
  a.means = (const float*)ptrs[3];
  a.scales = (const float*)ptrs[4];
  a.rots = (const float*)ptrs[5];
  a.opac = (const float*)ptrs[6];
  a.shs = (const float*)ptrs[7];
  a.offset = (const float*)ptrs[8];
  a.active = (const bool*)ptrs[9];
  a.mean2d = (float*)ptrs[10];
  a.depth = (float*)ptrs[11];
  a.conic = (float*)ptrs[12];
  a.rgb = (float*)ptrs[13];
  a.radii = (float*)ptrs[14];
  a.extent = (float*)ptrs[15];
  a.rect_min = (int*)ptrs[16];
  a.rect_max = (int*)ptrs[17];
  a.tiles = (int*)ptrs[18];
  a.visible = (bool*)ptrs[19];
  a.n = n;
  switch (K) {
    case 0: return launch(preprocess_fwd_kernel<0>, a, stream);
    case 1: return launch(preprocess_fwd_kernel<1>, a, stream);
    case 4: return launch(preprocess_fwd_kernel<4>, a, stream);
    case 9: return launch(preprocess_fwd_kernel<9>, a, stream);
    default: return launch(preprocess_fwd_kernel<16>, a, stream);
  }
}

// ptrs: view, proj, campos, means, scales, rots, shs, g_mean2d, g_depth,
// g_conic, g_rgb, then the outputs g_means, g_scales, g_rots, g_shs (null
// for shs, g_rgb and g_shs without SH), then P1's radii; consts and ints
// as the forward's.
extern "C" int adgs_preprocess_bwd(const long long* ptrs, const float* consts,
                                   const long long* ints, void* stream) {
  const long long n = ints[0], K = ints[1];
  if (bad_shape(n, K, ints[4]) ||
      (K > 0 && (ptrs[6] == 0 || ptrs[10] == 0 || ptrs[14] == 0 ||
                 ptrs[15] == 0)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  BwdArgs a;
  a.cam = make_cam(ptrs, consts, ints);
  a.means = (const float*)ptrs[3];
  a.scales = (const float*)ptrs[4];
  a.rots = (const float*)ptrs[5];
  a.shs = (const float*)ptrs[6];
  a.g_mean2d = (const float*)ptrs[7];
  a.g_depth = (const float*)ptrs[8];
  a.g_conic = (const float*)ptrs[9];
  a.g_rgb = (const float*)ptrs[10];
  a.g_means = (float*)ptrs[11];
  a.g_scales = (float*)ptrs[12];
  a.g_rots = (float*)ptrs[13];
  a.g_shs = (float*)ptrs[14];
  a.radii = (const float*)ptrs[15];
  a.n = n;
  switch (K) {
    case 0: return launch(preprocess_bwd_kernel<0>, a, stream);
    case 1: return launch(preprocess_bwd_kernel<1>, a, stream);
    case 4: return launch(preprocess_bwd_kernel<4>, a, stream);
    case 9: return launch(preprocess_bwd_kernel<9>, a, stream);
    default: return launch(preprocess_bwd_kernel<16>, a, stream);
  }
}
