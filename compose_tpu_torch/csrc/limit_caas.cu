// K2: cell-local CAAS limiter, one thread per (tracer, node), 16 lanes a cell,
// templated over the real type: limit_caas_f64 and limit_caas_f32.
//
// Replaces the TPU kernel compose_tpu/transport/cdr_fused.py:_limit_kernel
// (df64 pairs, in-group suffix rolls). Semantics per (tracer, cell) are the
// body of limiter.limit_tracer(limiter="caas", precomp=..., return_q=True)
// followed by the zero-density select of isl.py:679, in the tensors' own
// type (f64, or f32 on the single-precision route):
//   a = max(rhom, tiny);  y = Q / rho  (as Q * (1 / rho), rho == 0 -> 1)
//   x = clip(y, qmin, qmax);  dm = b - sum(a x)
//   x += dm / sum(a * headroom) * headroom   (toward qmax if dm > 0)
//   x = clip(x, qmin, qmax);  rho == 0 nodes take qmin.
// tiny is 1e-300 as the plain version rounds it: 0 in f32.
//
// Bound: memory; per node it reads five values (rhom, rho, Q, qmin, qmax)
// and writes one, ~114 MB in f64 at the flagship 40 x 86400.
//
// Design: the 16 nodes of a cell are 16 adjacent lanes of a warp, so the
// loads are coalesced. The three per-cell sums are XOR-butterfly shuffles
// over the 16-lane group: level m adds lane i and lane i^m, which is
// exactly the adjacent-pair tree (a + b == b + a in IEEE), the fold the
// plain version uses; every lane ends with the cell total. Built with
// --fmad=false, so results are bitwise the plain version's.

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

constexpr int kNp2 = 16;
constexpr int kBlock = 256;

template <class T>
__device__ __forceinline__ T cell_sum(T v) {
#pragma unroll
  for (int m = 1; m < kNp2; m <<= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <class T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return real::min(real::max(x, lo), hi);
}

template <class T>
__global__ void limit_caas_kernel(const T* __restrict__ rhom,
                                  const T* __restrict__ rho,
                                  const T* __restrict__ Q,
                                  const T* __restrict__ qmin,
                                  const T* __restrict__ qmax,
                                  const T* __restrict__ b,
                                  T* __restrict__ out, long total, int ncell) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < total;
  const long ndgll = (long)ncell * kNp2;
  const long g = live ? idx % ndgll : 0;     // node within the tracer row
  const long t = live ? idx / ndgll : 0;     // tracer
  const long cell = g / kNp2;
  const T zero = T(0), one = T(1);

  const T r = live ? rho[g] : one;
  const T a = live ? real::max(rhom[g], real::tiny<T>()) : zero;
  const T lo = live ? qmin[idx] : zero;
  const T hi = live ? qmax[idx] : zero;
  const T bb = live ? b[t * ncell + cell] : zero;
  const T y = live ? Q[idx] * (one / (r == zero ? one : r)) : zero;

  T x = clip(y, lo, hi);
  const T dm = bb - cell_sum(a * x);
  const T dhi = hi - x, dlo = x - lo;
  const T fh = cell_sum(a * dhi);
  const T fl = cell_sum(a * dlo);
  const bool up = dm > zero;
  const T fac = up ? fh : fl;
  const T scale = fac > zero ? dm / fac : zero;
  x = x + scale * (up ? dhi : dlo);
  x = clip(x, lo, hi);
  if (live) out[idx] = r == zero ? lo : x;
}

template <class T>
int launch(const T* rhom, const T* rho, const T* Q, const T* qmin,
           const T* qmax, const T* b, T* out, int nt, int ncell,
           void* stream) {
  const long total = (long)nt * ncell * kNp2;
  const long blocks = (total + kBlock - 1) / kBlock;
  if (total > 0)
    limit_caas_kernel<T><<<(unsigned)blocks, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        rhom, rho, Q, qmin, qmax, b, out, total, ncell);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int limit_caas_f64(const double* rhom, const double* rho,
                              const double* Q, const double* qmin,
                              const double* qmax, const double* b, double* out,
                              int nt, int ncell, void* stream) {
  return launch(rhom, rho, Q, qmin, qmax, b, out, nt, ncell, stream);
}

extern "C" int limit_caas_f32(const float* rhom, const float* rho,
                              const float* Q, const float* qmin,
                              const float* qmax, const float* b, float* out,
                              int nt, int ncell, void* stream) {
  return launch(rhom, rho, Q, qmin, qmax, b, out, nt, ncell, stream);
}
