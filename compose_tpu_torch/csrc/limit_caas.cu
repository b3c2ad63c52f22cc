// K2: cell-local CAAS limiter, one thread per (tracer, node), 16 lanes a cell.
//
// Replaces the TPU kernel compose_tpu/transport/cdr_fused.py:_limit_kernel
// (df64 pairs, in-group suffix rolls). Semantics per (tracer, cell) are the
// body of limiter.limit_tracer(limiter="caas", precomp=..., return_q=True)
// followed by the zero-density select of isl.py:679, in native f64:
//   a = max(rhom, 1e-300);  y = Q / rho  (as Q * (1 / rho), rho == 0 -> 1)
//   x = clip(y, qmin, qmax);  dm = b - sum(a x)
//   x += dm / sum(a * headroom) * headroom   (toward qmax if dm > 0)
//   x = clip(x, qmin, qmax);  rho == 0 nodes take qmin.
//
// Bound: memory; per node it reads five f64 values (rhom, rho, Q, qmin,
// qmax) and writes one, ~48 bytes, ~166 MB at the flagship 40 x 86400.
//
// Design: the 16 nodes of a cell are 16 adjacent lanes of a warp, so the
// loads are coalesced. The three per-cell sums are XOR-butterfly shuffles
// over the 16-lane group: level m adds lane i and lane i^m, which is
// exactly the adjacent-pair tree (a + b == b + a in IEEE), the fold the
// plain version uses; every lane ends with the cell total. Built with
// --fmad=false, so results are bitwise the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kNp2 = 16;
constexpr int kBlock = 256;

__device__ __forceinline__ double cell_sum(double v) {
#pragma unroll
  for (int m = 1; m < kNp2; m <<= 1) v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ double clip(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

__global__ void limit_caas_kernel(const double* __restrict__ rhom,
                                  const double* __restrict__ rho,
                                  const double* __restrict__ Q,
                                  const double* __restrict__ qmin,
                                  const double* __restrict__ qmax,
                                  const double* __restrict__ b,
                                  double* __restrict__ out, long total,
                                  int ncell) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < total;
  const long ndgll = (long)ncell * kNp2;
  const long g = live ? idx % ndgll : 0;     // node within the tracer row
  const long t = live ? idx / ndgll : 0;     // tracer
  const long cell = g / kNp2;

  const double r = live ? rho[g] : 1.0;
  const double a = live ? fmax(rhom[g], 1e-300) : 0.0;
  const double lo = live ? qmin[idx] : 0.0;
  const double hi = live ? qmax[idx] : 0.0;
  const double bb = live ? b[t * ncell + cell] : 0.0;
  const double y = live ? Q[idx] * (1.0 / (r == 0.0 ? 1.0 : r)) : 0.0;

  double x = clip(y, lo, hi);
  const double dm = bb - cell_sum(a * x);
  const double dhi = hi - x, dlo = x - lo;
  const double fh = cell_sum(a * dhi);
  const double fl = cell_sum(a * dlo);
  const bool up = dm > 0.0;
  const double fac = up ? fh : fl;
  const double scale = fac > 0.0 ? dm / fac : 0.0;
  x = x + scale * (up ? dhi : dlo);
  x = clip(x, lo, hi);
  if (live) out[idx] = r == 0.0 ? lo : x;
}

}  // namespace

extern "C" int limit_caas_f64(const double* rhom, const double* rho,
                              const double* Q, const double* qmin,
                              const double* qmax, const double* b, double* out,
                              int nt, int ncell, void* stream) {
  const long total = (long)nt * ncell * kNp2;
  const long blocks = (total + kBlock - 1) / kBlock;
  if (total > 0)
    limit_caas_kernel<<<(unsigned)blocks, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        rhom, rho, Q, qmin, qmax, b, out, total, ncell);
  return static_cast<int>(cudaGetLastError());
}
