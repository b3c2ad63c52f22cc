// K1: global CAAS mass redistribution over cells, one block per tracer row,
// templated over the real type: glbl_caas_f64 and glbl_caas_f32.
//
// Replaces the TPU kernel compose_tpu/transport/cdr_fused.py:_glbl_caas_kernel
// (df64 pairs, fold-in-half row sums). Semantics are those of
// compose_tpu/transport/spf.py:glbl_caas_gsum with gsum = bfb_sum, in the
// tensors' own type (f64, or f32 on the single-precision route):
//   delta = clip(mass, [min, max]) - mass
//   m     = extra - sum(delta)
//   v     = headroom toward max if m > 0, else toward min
//   out   = (mass + delta) + (m / sum(v)) * v        (0 if sum(v) == 0)
//
// Bound: memory; three reads per cell per pass over a row of ~5400 cells
// and one write (40 rows at the flagship size, ~6.9 MB in f64), so the
// kernel is launch- and latency-bound rather than bandwidth-bound.
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

template <class T>
__device__ __forceinline__ T clip_delta(T ms, T lo, T hi) {
  return ms < lo ? lo - ms : (ms > hi ? hi - ms : T(0));
}

// Adjacent-pair tree sum of f(lo), ..., f(lo + n - 1), n a power of two.
template <class T, class F>
__device__ T serial_pair_tree(F f, int lo, int n) {
  T stack[kMaxLevels];
  int top = 0;
  for (int i = 0; i < n; ++i) {
    T v = f(lo + i);
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

// Adjacent-pair tree over the block's blockDim.x partials (a power of two).
// All threads receive the total.
template <class T>
__device__ T block_pair_tree(T v, T* sh) {
  const int t = threadIdx.x, nthreads = blockDim.x;
  sh[t] = v;
  __syncthreads();
  for (int s = 1; s < nthreads; s <<= 1) {
    if ((t & (2 * s - 1)) == 0) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  const T total = sh[0];
  __syncthreads();
  return total;
}

template <class T>
__global__ void glbl_caas_kernel(const T* __restrict__ qmin,
                                 const T* __restrict__ qmass,
                                 const T* __restrict__ qmax,
                                 const T* __restrict__ extra,
                                 T* __restrict__ out, int ncell, int E) {
  __shared__ T sh[kMaxThreads];
  const long base = (long)blockIdx.x * ncell;
  const T* mn = qmin + base;
  const T* ms = qmass + base;
  const T* mx = qmax + base;
  const int lo = threadIdx.x * E;
  const T zero = T(0);

  auto delta_at = [&](int i) -> T {
    return i < ncell ? clip_delta(ms[i], mn[i], mx[i]) : zero;
  };
  const T dsum = block_pair_tree(serial_pair_tree<T>(delta_at, lo, E), sh);
  const T m = extra[blockIdx.x] - dsum;
  const bool up = m > zero;

  auto v_at = [&](int i) -> T {
    if (i >= ncell) return zero;
    const T a = ms[i], l = mn[i], h = mx[i];
    const T msd = a + clip_delta(a, l, h);
    return up ? (a >= h ? zero : h - msd) : (a <= l ? zero : msd - l);
  };
  const T vsum = block_pair_tree(serial_pair_tree<T>(v_at, lo, E), sh);
  const T fac = vsum != zero ? m / vsum : zero;

  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    const T a = ms[i];
    const T msd = a + clip_delta(a, mn[i], mx[i]);
    out[base + i] = msd + fac * v_at(i);
  }
}

template <class T>
int launch(const T* qmin, const T* qmass, const T* qmax, const T* extra,
           T* out, int nt, int ncell, void* stream) {
  int npad = 1;
  while (npad < ncell) npad <<= 1;
  const int threads = npad < kMaxThreads ? npad : kMaxThreads;
  const int E = npad / threads;
  if (nt > 0 && ncell > 0)
    glbl_caas_kernel<T><<<nt, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        qmin, qmass, qmax, extra, out, ncell, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int glbl_caas_f64(const double* qmin, const double* qmass,
                             const double* qmax, const double* extra,
                             double* out, int nt, int ncell, void* stream) {
  return launch(qmin, qmass, qmax, extra, out, nt, ncell, stream);
}

extern "C" int glbl_caas_f32(const float* qmin, const float* qmass,
                             const float* qmax, const float* extra,
                             float* out, int nt, int ncell, void* stream) {
  return launch(qmin, qmass, qmax, extra, out, nt, ncell, stream);
}
