// K1: global CAAS mass redistribution over cells, one block per tracer row.
//
// Replaces the TPU kernel compose_tpu/transport/cdr_fused.py:_glbl_caas_kernel
// (df64 pairs, fold-in-half row sums). Semantics are those of
// compose_tpu/transport/spf.py:glbl_caas_gsum with gsum = bfb_sum, in native
// f64:
//   delta = clip(mass, [min, max]) - mass
//   m     = extra - sum(delta)
//   v     = headroom toward max if m > 0, else toward min
//   out   = (mass + delta) + (m / sum(v)) * v        (0 if sum(v) == 0)
//
// Bound: memory; three f64 reads per cell per pass over a row of ~5400 cells
// (40 rows at the flagship size, ~5 MB in all), so the kernel is launch- and
// latency-bound rather than bandwidth-bound.
//
// Design: the row is zero-padded (virtually) to npad = 2^k. Each of T threads
// sums E = npad / T adjacent values with a binary-counter stack (completed
// subtrees merge as soon as they exist), then a shared-memory pair tree
// combines the T partials. Every aligned block is a subtree, so both sums
// are exactly the adjacent-pair tree of ops/reduce.bfb_sum: the result is
// bitwise the plain version's. No atomics; repeated runs are bitwise equal.
// Built with --fmad=false, so no product is fused into an add.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLevels = 32;

__device__ __forceinline__ double clip_delta(double ms, double lo, double hi) {
  return ms < lo ? lo - ms : (ms > hi ? hi - ms : 0.0);
}

// Adjacent-pair tree sum of f(lo), ..., f(lo + n - 1), n a power of two.
template <class F>
__device__ double serial_pair_tree(F f, int lo, int n) {
  double stack[kMaxLevels];
  int top = 0;
  for (int i = 0; i < n; ++i) {
    double v = f(lo + i);
    int lvl = 0;
    for (int j = i; j & 1; j >>= 1) {
      v = stack[lvl] + v;
      ++lvl;
    }
    stack[lvl] = v;
    top = lvl;
  }
  return stack[top];
}

// Adjacent-pair tree over the block's T = blockDim.x partials (T a power of
// two). All threads receive the total.
__device__ double block_pair_tree(double v, double* sh) {
  const int t = threadIdx.x, T = blockDim.x;
  sh[t] = v;
  __syncthreads();
  for (int s = 1; s < T; s <<= 1) {
    if ((t & (2 * s - 1)) == 0) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  const double total = sh[0];
  __syncthreads();
  return total;
}

__global__ void glbl_caas_kernel(const double* __restrict__ qmin,
                                 const double* __restrict__ qmass,
                                 const double* __restrict__ qmax,
                                 const double* __restrict__ extra,
                                 double* __restrict__ out, int ncell, int E) {
  __shared__ double sh[kMaxThreads];
  const long base = (long)blockIdx.x * ncell;
  const double* mn = qmin + base;
  const double* ms = qmass + base;
  const double* mx = qmax + base;
  const int lo = threadIdx.x * E;

  auto delta_at = [&](int i) -> double {
    return i < ncell ? clip_delta(ms[i], mn[i], mx[i]) : 0.0;
  };
  const double dsum = block_pair_tree(serial_pair_tree(delta_at, lo, E), sh);
  const double m = extra[blockIdx.x] - dsum;
  const bool up = m > 0.0;

  auto v_at = [&](int i) -> double {
    if (i >= ncell) return 0.0;
    const double a = ms[i], l = mn[i], h = mx[i];
    const double msd = a + clip_delta(a, l, h);
    return up ? (a >= h ? 0.0 : h - msd) : (a <= l ? 0.0 : msd - l);
  };
  const double vsum = block_pair_tree(serial_pair_tree(v_at, lo, E), sh);
  const double fac = vsum != 0.0 ? m / vsum : 0.0;

  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    const double a = ms[i];
    const double msd = a + clip_delta(a, mn[i], mx[i]);
    out[base + i] = msd + fac * v_at(i);
  }
}

}  // namespace

extern "C" int glbl_caas_f64(const double* qmin, const double* qmass,
                             const double* qmax, const double* extra,
                             double* out, int nt, int ncell, void* stream) {
  int npad = 1;
  while (npad < ncell) npad <<= 1;
  const int T = npad < kMaxThreads ? npad : kMaxThreads;
  const int E = npad / T;
  if (nt > 0 && ncell > 0)
    glbl_caas_kernel<<<nt, T, 0, static_cast<cudaStream_t>(stream)>>>(
        qmin, qmass, qmax, extra, out, ncell, E);
  return static_cast<int>(cudaGetLastError());
}
