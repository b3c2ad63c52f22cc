// K2: cell-local CAAS limiter at any np, one thread per (tracer, node lane),
// templated over the real type: limit_caas_f64 and limit_caas_f32.
//
// Replaces the TPU kernel compose_tpu/transport/cdr_fused.py:_limit_kernel
// (df64 pairs, in-group suffix rolls, np2 = 16 only). Semantics per (tracer,
// cell) are the body of limiter.limit_tracer(limiter="caas", precomp=...,
// return_q=True) followed by the zero-density select of isl.py:679, in the
// tensors' own type (f64, or f32 on the single-precision route):
//   a = max(rhom, tiny);  y = Q / rho  (as Q * (1 / rho), rho == 0 -> 1)
//   x = clip(y, qmin, qmax);  dm = b - sum(a x)
//   x += dm / sum(a * headroom) * headroom   (toward qmax if dm > 0)
//   x = clip(x, qmin, qmax);  rho == 0 nodes take qmin.
// tiny is 1e-300 as the plain version rounds it: 0 in f32.
//
// Bound: memory; per node it reads five values (rhom, rho, Q, qmin, qmax)
// and writes one, ~114 MB in f64 at 40 x 86400 slots (ne30 np4 or ne15 np8).
//
// Design: a cell of np2 nodes is a group of P = next_pow2(np2) adjacent
// lanes, P a template parameter (4 .. 256); thread (t * ncell + cell) * P +
// lane owns node `lane` of that (tracer, cell), so the loads of a cell's
// real nodes are coalesced. The three cell sums are bfb_sum's adjacent-pair
// tree over the cell padded with +0.0 to P, which is what the plain version
// computes: lanes >= np2 read nothing and add a literal +0.0. Within a warp
// the sums are XOR butterflies over the P-lane group (P <= 32): level m adds
// lane i and lane i^m, exactly the adjacent-pair tree (a + b == b + a in
// IEEE), and every lane ends with the cell total. For P > 32 a cell spans
// P/32 warps of the 256-thread block: each warp's total goes to shared
// memory, and every lane folds its cell's warp totals in warp order by the
// same adjacent-pair tree. Built with --fmad=false, so results are bitwise
// the plain version's.

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;

template <class T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return real::min(real::max(x, lo), hi);
}

template <int P, class T>
__device__ __forceinline__ void warp_sums(T& s0, T& s1, T& s2) {
  constexpr int W = P < 32 ? P : 32;
#pragma unroll
  for (int m = 1; m < W; m <<= 1) {
    s0 = s0 + __shfl_xor_sync(0xffffffffu, s0, m);
    s1 = s1 + __shfl_xor_sync(0xffffffffu, s1, m);
    s2 = s2 + __shfl_xor_sync(0xffffffffu, s2, m);
  }
}

// The cell sums of (s0, s1, s2) over its P lanes, in every lane.
template <int P, class T>
__device__ __forceinline__ void cell_sums(T& s0, T& s1, T& s2, T (*part)[kWarps]) {
  warp_sums<P>(s0, s1, s2);
  if constexpr (P > 32) {
    constexpr int W = P / 32;                    // warps per cell
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      part[0][warp] = s0;
      part[1][warp] = s1;
      part[2][warp] = s2;
    }
    __syncthreads();
    const int w0 = (warp / W) * W;               // the cell's first warp
    T v0[W], v1[W], v2[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      v0[k] = part[0][w0 + k];
      v1[k] = part[1][w0 + k];
      v2[k] = part[2][w0 + k];
    }
#pragma unroll
    for (int n = W; n > 1; n >>= 1) {
#pragma unroll
      for (int k = 0; k < n / 2; ++k) {
        v0[k] = v0[2 * k] + v0[2 * k + 1];
        v1[k] = v1[2 * k] + v1[2 * k + 1];
        v2[k] = v2[2 * k] + v2[2 * k + 1];
      }
    }
    s0 = v0[0];
    s1 = v1[0];
    s2 = v2[0];
  }
}

template <int P, class T>
__global__ void __launch_bounds__(kBlock)
limit_caas_kernel(const T* __restrict__ rhom, const T* __restrict__ rho,
                  const T* __restrict__ Q, const T* __restrict__ qmin,
                  const T* __restrict__ qmax, const T* __restrict__ b,
                  T* __restrict__ out, long rows, int ncell, int np2) {
  __shared__ T part[3][kWarps];
  const long idx = (long)blockIdx.x * kBlock + threadIdx.x;
  const long row = idx / P;                       // t * ncell + cell
  const int lane = (int)(idx % P);
  const bool live = row < rows && lane < np2;
  // The cell: 32-bit modulo unless the rows outgrow it (warp-uniform).
  const long cell = rows <= 0x7fffffffL ? (long)((unsigned)row % (unsigned)ncell)
                                        : row % ncell;
  const long g = cell * np2 + lane;               // node within a tracer
  const long k = row * np2 + lane;                // (t, cell, lane)
  const T zero = T(0), one = T(1);

  T r = one, a = zero, lo = zero, hi = zero, bb = zero, y = zero;
  if (live) {
    r = rho[g];
    a = real::max(rhom[g], real::tiny<T>());
    lo = qmin[k];
    hi = qmax[k];
    bb = b[row];
    y = Q[k] * (one / (r == zero ? one : r));
  }

  T x = clip(y, lo, hi);
  const T dhi = hi - x, dlo = x - lo;
  T sx = zero, sh = zero, sl = zero;             // padding lanes: +0.0
  if (live) {
    sx = a * x;
    sh = a * dhi;
    sl = a * dlo;
  }
  cell_sums<P>(sx, sh, sl, part);
  const T dm = bb - sx;
  const bool up = dm > zero;
  const T fac = up ? sh : sl;
  const T scale = fac > zero ? dm / fac : zero;
  x = x + scale * (up ? dhi : dlo);
  x = clip(x, lo, hi);
  if (live) out[k] = r == zero ? lo : x;
}

template <int P, class T>
void launch_p(const T* rhom, const T* rho, const T* Q, const T* qmin,
              const T* qmax, const T* b, T* out, long rows, int ncell,
              int np2, void* stream) {
  const long blocks = (rows * P + kBlock - 1) / kBlock;
  limit_caas_kernel<P, T><<<(unsigned)blocks, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      rhom, rho, Q, qmin, qmax, b, out, rows, ncell, np2);
}

template <class T>
int launch(const T* rhom, const T* rho, const T* Q, const T* qmin,
           const T* qmax, const T* b, T* out, int nt, int ncell, int np2,
           void* stream) {
  if (nt < 0 || ncell < 0 || np2 < 1 || np2 > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const long rows = (long)nt * ncell;
  int P = 4;
  while (P < np2) P <<= 1;
  if (rows > 0) {
    switch (P) {
#define LIMIT_CAAS_CASE(p)                                                \
  case p:                                                                 \
    launch_p<p, T>(rhom, rho, Q, qmin, qmax, b, out, rows, ncell, np2,   \
                   stream);                                               \
    break;
      LIMIT_CAAS_CASE(4)
      LIMIT_CAAS_CASE(8)
      LIMIT_CAAS_CASE(16)
      LIMIT_CAAS_CASE(32)
      LIMIT_CAAS_CASE(64)
      LIMIT_CAAS_CASE(128)
      LIMIT_CAAS_CASE(256)
#undef LIMIT_CAAS_CASE
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int limit_caas_f64(const double* rhom, const double* rho,
                              const double* Q, const double* qmin,
                              const double* qmax, const double* b, double* out,
                              int nt, int ncell, int np2, void* stream) {
  return launch(rhom, rho, Q, qmin, qmax, b, out, nt, ncell, np2, stream);
}

extern "C" int limit_caas_f32(const float* rhom, const float* rho,
                              const float* Q, const float* qmin,
                              const float* qmax, const float* b, float* out,
                              int nt, int ncell, int np2, void* stream) {
  return launch(rhom, rho, Q, qmin, qmax, b, out, nt, ncell, np2, stream);
}
