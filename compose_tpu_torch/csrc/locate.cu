// Cell location of the ISL departure points (transport/isl.py:
// IslTransport._locate on a uniform mesh), one thread per point, templated
// over the geometry type T and the weights' type W: locate_f64 (f64 -> f64),
// locate_f32 (f32 -> f32, or f32 -> f64 with `wide`), and locate_ab_f64 /
// locate_ab_f32, which write the reference coordinates (a, b) in place of
// the weights for a basis or np the kernel does not evaluate.
//
// Replaces no TPU kernel: the JAX package leaves cell location to XLA,
// which fuses the chain (compose_tpu/mesh/cubed_sphere.py, ops/sqr.py,
// basis.py). Eager PyTorch runs it as ~700 launches per ne30 step (the
// equiangular index, 3-4 Newton iterations of ~50 ops each, the np4 basis
// weights), each a few microseconds of device work behind ~10 us of host
// work, and 8 host syncs (scalar and node tensors made on the card).
//
// Semantics: IslTransport._locate_plain, bitwise: every operation of the
// eager chain in its order and rounding, in T. Built with --fmad=false, so
// no product is fused into a sum. Mirrored:
//   - cubed_sphere.get_cell_coords: the face by the same comparison tree
//     (ties and NaN as torch.where's), x / d per face, (-x) / d for the
//     negated ones, atan, the division by the Python float pi / 4 as a
//     multiply by its reciprocal rounded on the host (PyTorch divides by a
//     CPU scalar so), gx = (0.5 (1 + fx)) ne, floor, the int64 cast and the
//     clamp to [0, ne - 1], ci = ne^2 face + ne iy + ix, a0 = 2 (gx - ix) - 1;
//     a rotated mesh passes its rotated points (p R, in torch) for the index;
//   - ops/sqr.sphere_to_ref from (a0, b0): the shape functions left to right
//     with the Python float factors (+-0.25), the corner sums over 4 corners
//     and the dot products over 3 components in the order and with the
//     zero (-0.0 + 0.0 is +0.0) of PyTorch's CUDA reduction (sum4, sum3),
//     clamp_min's tiny, the residual test norm2(r) > tol^2 against the
//     Python double rounded to T, _solve_Jxr's Gram-Schmidt, the masked
//     update and the +-1e3 clamp (NaN kept, as torch.clamp keeps it);
//   - basis._np4_subgrid_eval for a and b: the Lagrange numerators as
//     _prod_chain's left-to-right products of the x - x_j, divided by the
//     denominators the eager path forms on the card (computed on the host
//     in T, same operations), the 0.306 blend with its left | right select,
//     then w[4 j + i] = vb[j] va[i], widened to W.
// The host-side scalars (the reciprocal, tol^2, the nodes, the
// denominators, the blend's constants) come in `table`, already rounded to
// T (isl.locate_table).
//
// Bound: operations; a point reads 24 or 48 bytes and its cell's 4 corners
// (the corner table, 5,400 x 12 values at ne30, stays in L2) and writes 8 +
// 16 x sizeof(W) bytes. Per point: the index (~25 operations, 2 divisions,
// 2 atan), per Newton iteration ~150 operations with 9 divisions and 3
// square roots, the weights ~120 operations with 18 divisions. The count
// is in chip_smoke.py's phase 2.
//
// Design: one thread per point holds the point, its cell's 12 corner
// values and the Newton state in registers from the index to the weights;
// nothing is written between the stages.

#include <cuda_runtime.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kBlock = 128;

template <class T>
struct Params {
  T qinv;           // 1 / (pi / 4), both rounded to T
  T tol2;           // tol * tol (a Python double) rounded to T
  T c1, c1k;        // 0.306 and 0.5 - 0.306, rounded to T
  T one_m_x2;       // 1 - x[2] in T
  T x[4];           // the np4 nodes in T
  T den4[4];        // Lagrange denominators over x[0..3]
  T denl[3];        // over x[0..2]
  T denr[3];        // over x[1..3]
};

template <class T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ double tiny<double>() { return DBL_MIN; }
template <>
__device__ __forceinline__ float tiny<float>() { return FLT_MIN; }

// torch.sum over a contiguous row of 3 on the card: the reduction splits the
// row over two lanes (elements 0, 2 and element 1), each lane starting from
// 0, and adds the lanes; the result is never -0.0.
template <class T>
__device__ __forceinline__ T sum3(T x0, T x1, T x2) {
  return ((x0 + x2) + x1) + T(0);
}

// torch.sum over the corner axis (size 4, stride 3) of an (N, 4, 3)
// product: one thread per output adds the 4 values in order, each
// accumulator starting from 0.
template <class T>
__device__ __forceinline__ T sum4(T x0, T x1, T x2, T x3) {
  return (((x0 + x1) + x2) + x3) + T(0);
}

template <class T>
__device__ __forceinline__ T dot3(const T* u, const T* v) {
  return sum3(u[0] * v[0], u[1] * v[1], u[2] * v[2]);
}

// torch.clamp_min(v, lo) and torch.clamp(v, lo, hi): NaN passes.
template <class T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : (v < lo ? lo : v);
}
template <class T>
__device__ __forceinline__ T clamp(T v, T lo, T hi) {
  if (v != v) return v;
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// sum_i N[i] c[i][k] for the point's cell corners c (4 x 3).
template <class T>
__device__ __forceinline__ void combine(const T* N, const T (*c)[3], T* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = sum4(N[0] * c[0][k], N[1] * c[1][k], N[2] * c[2][k],
                  N[3] * c[3][k]);
}

// basis._np4_subgrid_eval at one coordinate.
template <class T>
__device__ __forceinline__ void np4_eval(const Params<T>& P, T x, T* y) {
  const T d0 = x - P.x[0], d1 = x - P.x[1], d2 = x - P.x[2],
          d3 = x - P.x[3];
  T y4[4], yl[4], yr[4];
  y4[0] = ((d1 * d2) * d3) / P.den4[0];
  y4[1] = ((d0 * d2) * d3) / P.den4[1];
  y4[2] = ((d0 * d1) * d3) / P.den4[2];
  y4[3] = ((d0 * d1) * d2) / P.den4[3];
  yl[0] = (d1 * d2) / P.denl[0];
  yl[1] = (d0 * d2) / P.denl[1];
  yl[2] = (d0 * d1) / P.denl[2];
  yl[3] = T(0);
  yr[0] = T(0);
  yr[1] = (d2 * d3) / P.denr[0];
  yr[2] = (d1 * d3) / P.denr[1];
  yr[3] = (d1 * d2) / P.denr[2];
  const bool left = x < P.x[1];
  const bool right = x > P.x[2];
  const T x0 = ((T(2) * (T(1) - fabs(x))) / P.one_m_x2) - T(1);
  const T alpha = (P.c1 + x0 * P.c1k) * (x0 + T(1));
  const T beta = T(1) - alpha;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T ysub = left ? yl[j] : yr[j];
    const T yb = alpha * ysub + beta * y4[j];
    y[j] = (left || right) ? yb : y4[j];
  }
}

template <class T, class W, bool kWeights>
__global__ void __launch_bounds__(kBlock)
locate_kernel(const T* __restrict__ pidx, const T* __restrict__ p,
              const T* __restrict__ corners, int64_t* __restrict__ ci_out,
              void* __restrict__ out0, T* __restrict__ out1, int n, int ne,
              int max_its, const __grid_constant__ Params<T> P) {
  const long i = (long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;

  // cubed_sphere.get_cell_coords on the (rotated) point.
  const T x = pidx[3 * i], y = pidx[3 * i + 1], z = pidx[3 * i + 2];
  const T ax = fabs(x), ay = fabs(y), az = fabs(z);
  int face;
  if (ax >= ay)
    face = ax >= az ? (x > T(0) ? 1 : 3) : (z > T(0) ? 4 : 5);
  else
    face = ay >= az ? (y > T(0) ? 2 : 0) : (z > T(0) ? 4 : 5);
  const T d = (face == 0 || face == 2) ? ay
              : (face == 1 || face == 3) ? ax : az;
  T fx;
  switch (face) {
    case 0: fx = x / d; break;
    case 1: fx = y / d; break;
    case 2: fx = (-x) / d; break;
    case 3: fx = (-y) / d; break;
    case 4: fx = x / d; break;
    default: fx = (-x) / d; break;
  }
  T fy = face >= 4 ? y / d : z / d;
  fx = atan(fx) * P.qinv;
  fy = atan(fy) * P.qinv;
  const T nef = T(ne);
  const T gx = (T(0.5) * (T(1) + fx)) * nef;
  const T gy = (T(0.5) * (T(1) + fy)) * nef;
  int64_t ix = static_cast<int64_t>(floor(gx));
  int64_t iy = static_cast<int64_t>(floor(gy));
  ix = ix < 0 ? 0 : (ix > ne - 1 ? ne - 1 : ix);
  iy = iy < 0 ? 0 : (iy > ne - 1 ? ne - 1 : iy);
  const int64_t ci = (int64_t)ne * ne * face + (int64_t)ne * iy + ix;
  T a = T(2) * (gx - T(ix)) - T(1);
  T b = T(2) * (gy - T(iy)) - T(1);
  ci_out[i] = ci;

  // sqr.sphere_to_ref on the cell's corners.
  T c[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < 3; ++l) c[k][l] = corners[12 * ci + 3 * k + l];
  const T q[3] = {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
  const T qtr = T(0.25), lim = T(1e3), tn = tiny<T>();
  for (int it = 0; it < max_its; ++it) {
    const T oma = T(1) - a, opa = T(1) + a, omb = T(1) - b, opb = T(1) + b;
    const T N[4] = {(qtr * oma) * omb, (qtr * opa) * omb, (qtr * opa) * opb,
                    (qtr * oma) * opb};
    const T Na[4] = {(-qtr) * omb, qtr * omb, qtr * opb, (-qtr) * opb};
    const T Nb[4] = {(-qtr) * oma, (-qtr) * opa, qtr * opa, qtr * oma};
    T s[3], sa[3], sb[3];
    combine(N, c, s);
    combine(Na, c, sa);
    combine(Nb, c, sb);
    const T r2 = clamp_min(dot3(s, s), tn);
    const T r = sqrt(r2);
    const T ta = dot3(s, sa) / r2;
    const T tb = dot3(s, sb) / r2;
    T res[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sa[k] = (sa[k] - s[k] * ta) / r;
      sb[k] = (sb[k] - s[k] * tb) / r;
      res[k] = s[k] / r - q[k];
    }
    const bool active = dot3(res, res) > P.tol2;
    // _solve_Jxr
    const T n1 = clamp_min(sqrt(dot3(sa, sa)), tn);
    T q1[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) q1[k] = sa[k] / n1;
    const T alpha = dot3(q1, sb);
    T v2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v2[k] = sb[k] - alpha * q1[k];
    const T n2 = clamp_min(sqrt(dot3(v2, v2)), tn);
    T q2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) q2[k] = v2[k] / n2;
    const T qtr1 = dot3(q1, res);
    const T qtr2 = dot3(q2, res);
    const T db = qtr2 / n2;
    const T da = (qtr1 - alpha * db) / n1;
    a = clamp(active ? a - da : a, -lim, lim);
    b = clamp(active ? b - db : b, -lim, lim);
  }

  if (kWeights) {
    T va[4], vb[4];
    np4_eval(P, a, va);
    np4_eval(P, b, vb);
    W* w = static_cast<W*>(out0) + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) w[4 * j + k] = W(vb[j] * va[k]);
  } else {
    static_cast<T*>(out0)[i] = a;
    out1[i] = b;
  }
}

// table: qinv, tol2, c1, c1k, one_m_x2, x[4], den4[4], denl[3], denr[3], as
// doubles holding values already rounded to T.
template <class T>
Params<T> params(const double* t) {
  Params<T> P = {};
  P.qinv = T(t[0]);
  P.tol2 = T(t[1]);
  P.c1 = T(t[2]);
  P.c1k = T(t[3]);
  P.one_m_x2 = T(t[4]);
  for (int k = 0; k < 4; ++k) P.x[k] = T(t[5 + k]);
  for (int k = 0; k < 4; ++k) P.den4[k] = T(t[9 + k]);
  for (int k = 0; k < 3; ++k) P.denl[k] = T(t[13 + k]);
  for (int k = 0; k < 3; ++k) P.denr[k] = T(t[16 + k]);
  return P;
}

template <class T, class W, bool kWeights>
int launch(const T* pidx, const T* p, const T* corners, int64_t* ci,
           void* out0, T* out1, int n, int ne, int max_its,
           const double* table, void* stream) {
  if (n < 0 || ne < 1 || max_its < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const int blocks = (n + kBlock - 1) / kBlock;
    locate_kernel<T, W, kWeights>
        <<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
            pidx, p, corners, ci, out0, out1, n, ne, max_its,
            params<T>(table));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The weights: out0 is w (n, 16) of W = double when `wide`, else T; out1 is
// unused.
extern "C" int locate_f64(const double* pidx, const double* p,
                          const double* corners, int64_t* ci, void* out0,
                          double* out1, int n, int ne, int max_its, int wide,
                          const double* table, void* stream) {
  (void)out1;
  (void)wide;
  return launch<double, double, true>(pidx, p, corners, ci, out0, nullptr, n,
                                      ne, max_its, table, stream);
}

extern "C" int locate_f32(const float* pidx, const float* p,
                          const float* corners, int64_t* ci, void* out0,
                          float* out1, int n, int ne, int max_its, int wide,
                          const double* table, void* stream) {
  (void)out1;
  if (wide)
    return launch<float, double, true>(pidx, p, corners, ci, out0, nullptr,
                                       n, ne, max_its, table, stream);
  return launch<float, float, true>(pidx, p, corners, ci, out0, nullptr, n,
                                    ne, max_its, table, stream);
}

// The reference coordinates: out0 is a (n,), out1 b (n,), both T.
extern "C" int locate_ab_f64(const double* pidx, const double* p,
                             const double* corners, int64_t* ci, void* out0,
                             double* out1, int n, int ne, int max_its,
                             int wide, const double* table, void* stream) {
  (void)wide;
  return launch<double, double, false>(pidx, p, corners, ci, out0, out1, n,
                                       ne, max_its, table, stream);
}

extern "C" int locate_ab_f32(const float* pidx, const float* p,
                             const float* corners, int64_t* ci, void* out0,
                             float* out1, int n, int ne, int max_its,
                             int wide, const double* table, void* stream) {
  (void)wide;
  return launch<float, float, false>(pidx, p, corners, ci, out0, out1, n,
                                     ne, max_its, table, stream);
}
