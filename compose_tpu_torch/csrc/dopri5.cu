// The departure trajectories of transport/timeint.integrate: nsub fixed
// Dormand-Prince RK5(4) substeps of an analytic wind, then the projection
// back onto the sphere, one thread per point, templated over the real type:
// dopri5_f64 and dopri5_f32.
//
// Replaces no TPU kernel: the JAX package leaves the trajectories to XLA,
// which fuses the whole chain (compose_tpu/transport/timeint.py). Eager
// PyTorch runs it as ~4,565 launches per ne30 step (8 substeps x 7 wind
// stages of ~70 elementwise ops, plus the stage sums), each a few
// microseconds of device work behind ~10 us of host work, so the card idled
// through the step's departure phase.
//
// Semantics: timeint.integrate_plain(wind.velocity, ts, tf, p, nsub) for
// the divergent (wind 0) and nondivergent (wind 1) deformational flows of
// transport/gallery.py, bitwise: every operation of the eager chain in its
// order and rounding, in the point type. Built with --fmad=false, so no
// product is fused into a sum unless written with fma. Mirrored:
//   - gallery._trig_frame: r = sqrt((x x + y y) + z z), d = sqrt(x x + y y),
//     the polar selects (d < FLT_MIN / DBL_MIN), the shifted longitude's
//     sin/cos from the host's time scalars;
//   - the wind's u and v, left to right, with each Python float factor
//     (2.5/T or 10/T, 1/T, 2 pi) rounded to the point type first, as
//     PyTorch casts a scalar operand;
//   - gallery._uv2xyz: w = (1 - r) * (1/R), since PyTorch's CUDA division
//     by a Python scalar multiplies by the reciprocal it rounds on the host;
//     e_n = cross(e_r, e_e) as torch.linalg.cross's kernel computes it (not
//     built with --fmad=false: see cross_term);
//   - the stage sums pi + (dt a_ij) k_j left to right, zero coefficients
//     included, and out = p + (dt b_j) k_j over the nonzero b_j only;
//   - ops/sphere.normalize: p / sqrt(torch.sum(p * p, -1)), the sum in the
//     order of PyTorch's CUDA reduction over a row of 3 (see norm2).
// The time-only scalars (the 21 + 7 step coefficients, and per stage
// cos c, sin c, cos(pi t/T)) are computed on the host exactly as the eager
// path computes them (timeint.dopri5_table) and passed by value.
//
// Bound: operations, not memory (24 or 48 bytes per point in and out). Per
// wind stage ~60 arithmetic operations, 7 divisions (z / r serves sinth and
// e_r) and 2 square roots; per substep 7 stages, 126 stage-sum and 30
// output operations; per point 8 substeps. The count is in chip_smoke.py's
// phase 2.
//
// Design: one thread per point keeps its position, the seven stage vectors
// and the sums in registers from the first substep to the normalized
// output; nothing is written between substeps. The time table is a
// __grid_constant__ parameter, read through the constant cache with a
// warp-uniform index. A launch takes at most kSub substeps; the wrapper
// chains launches for more, normalizing in the last (the positions between
// launches are stored and reloaded unchanged, so the chain is bitwise the
// same).

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kStages = 7;
constexpr int kSub = 8;        // substeps per launch
constexpr int kA = 21;         // a_ij, i = 1..6, j < i, row by row
constexpr int kScalars = 4;    // vscale, uscale, two_pi, inv_r

template <class T>
struct Params {
  T vscale, uscale, two_pi, inv_r;
  T a[kA];                     // dt * a_ij as the point type rounds it
  T b[kStages];                // dt * b_j
  T trig[kSub][kStages][3];    // (cos c, sin c, cos(pi t/T)) per stage
};

template <class T>
__device__ __forceinline__ T tiny();
template <>
__device__ __forceinline__ double tiny<double>() { return DBL_MIN; }
template <>
__device__ __forceinline__ float tiny<float>() { return FLT_MIN; }

// a*b - c*d as torch.linalg.cross's CUDA kernel evaluates it: PyTorch builds
// it with nvcc's default --fmad=true, which contracts the expression to
// fma(a, b, -(c*d)).
template <class T>
__device__ __forceinline__ T cross_term(T a, T b, T c, T d) {
  return fma(a, b, -(c * d));
}

// torch.sum(v * v, -1) over a row of 3 on the card: the reduction splits
// the row over two lanes (elements 0, 2 and element 1) and adds the lanes.
template <class T>
__device__ __forceinline__ T norm2(T x, T y, T z) {
  return (x * x + z * z) + y * y;
}

// The wind at one point and stage: gallery._trig_frame, the flow's u and v,
// gallery._uv2xyz.
template <class T>
__device__ __forceinline__ void velocity(const Params<T>& P, int wind,
                                         const T* trig, T x, T y, T z,
                                         T& vx, T& vy, T& vz) {
  const T one = T(1), zero = T(0);
  const T cc = trig[0], sc = trig[1], cost = trig[2];
  const T xx = x * x, yy = y * y;
  const T r = sqrt((xx + yy) + z * z);
  const T d = sqrt(xx + yy);
  const T sinth = z / r;
  const T costh = d / r;
  const bool polar = d < tiny<T>();
  const T ds = polar ? one : d;
  const T xd = x / ds;
  const T coslam = polar ? one : xd;
  const T sinlam = polar ? zero : y / ds;
  const T sinlp = sinlam * cc - coslam * sc;
  const T coslp = coslam * cc + sinlam * sc;
  const T sin2lat = (T(2) * sinth) * costh;
  T u, v;
  if (wind == 0) {             // DivergentWindField
    const T costh2 = costh * costh;
    v = P.vscale * sinlp * costh2 * costh * cost;
    u = P.uscale * (T(-5) * (T(0.5) * (one - coslp)) * sin2lat * costh2 * cost
                    + P.two_pi * costh);
  } else {                     // NonDivergentWindField
    v = P.vscale * ((T(2) * sinlp) * coslp) * costh * cost;
    u = P.uscale * (T(10) * sinlp * sinlp * sin2lat * cost + P.two_pi * costh);
  }
  const T w = (one - r) * P.inv_r;
  const T erx = x / r, ery = y / r, erz = z / r;
  const T eex = polar ? zero : -y / ds;
  const T eey = polar ? one : xd;
  const T eez = zero;
  const T enx = cross_term(ery, eez, erz, eey);
  const T eny = cross_term(erz, eex, erx, eez);
  const T enz = cross_term(erx, eey, ery, eex);
  vx = u * eex + v * enx + w * erx;
  vy = u * eey + v * eny + w * ery;
  vz = u * eez + v * enz + w * erz;
}

template <class T>
__global__ void __launch_bounds__(kBlock)
dopri5_kernel(const T* __restrict__ p, T* __restrict__ out, int n, int nsub,
              int normalize, int wind, const __grid_constant__ Params<T> P) {
  const long i = (long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  T x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
  for (int s = 0; s < nsub; ++s) {
    T kx[kStages], ky[kStages], kz[kStages];
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      T px = x, py = y, pz = z;
#pragma unroll
      for (int j = 0; j < st; ++j) {
        const T a = P.a[st * (st - 1) / 2 + j];
        px = px + a * kx[j];
        py = py + a * ky[j];
        pz = pz + a * kz[j];
      }
      velocity(P, wind, P.trig[s][st], px, py, pz, kx[st], ky[st], kz[st]);
    }
#pragma unroll
    for (int j = 0; j < kStages; ++j) {
      if (j == 1 || j == 6) continue;   // b_j == 0: not summed
      x = x + P.b[j] * kx[j];
      y = y + P.b[j] * ky[j];
      z = z + P.b[j] * kz[j];
    }
  }
  if (normalize) {
    const T nr = sqrt(norm2(x, y, z));
    x = x / nr;
    y = y / nr;
    z = z / nr;
  }
  out[3 * i] = x;
  out[3 * i + 1] = y;
  out[3 * i + 2] = z;
}

// table: vscale, uscale, two_pi, inv_r, the 21 a_ij, the 7 b_j, then nsub
// x 7 x 3 time scalars, all already rounded to T.
template <class T>
int launch(const T* p, T* out, int n, int nsub, int normalize, int wind,
           const double* table, void* stream) {
  if (n < 0 || nsub < 1 || nsub > kSub || (wind != 0 && wind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T> P = {};
  P.vscale = T(table[0]);
  P.uscale = T(table[1]);
  P.two_pi = T(table[2]);
  P.inv_r = T(table[3]);
  const double* a = table + kScalars;
  for (int k = 0; k < kA; ++k) P.a[k] = T(a[k]);
  for (int k = 0; k < kStages; ++k) P.b[k] = T(a[kA + k]);
  const double* t = a + kA + kStages;
  for (int s = 0; s < nsub; ++s)
    for (int st = 0; st < kStages; ++st)
      for (int c = 0; c < 3; ++c) P.trig[s][st][c] = T(*t++);
  if (n > 0) {
    const int blocks = (n + kBlock - 1) / kBlock;
    dopri5_kernel<T><<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        p, out, n, nsub, normalize, wind, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dopri5_f64(const double* p, double* out, int n, int nsub,
                          int normalize, int wind, const double* table,
                          void* stream) {
  return launch(p, out, n, nsub, normalize, wind, table, stream);
}

extern "C" int dopri5_f32(const float* p, float* out, int n, int nsub,
                          int normalize, int wind, const double* table,
                          void* stream) {
  return launch(p, out, n, nsub, normalize, wind, table, stream);
}
