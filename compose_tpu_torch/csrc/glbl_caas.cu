// K1: global CAAS mass redistribution over cells, each tracer row spread
// over a thread-block cluster, templated over the real type: glbl_caas_f64
// and glbl_caas_f32.
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
// Bound: memory, three reads and one write per cell (~6.9 MB in f64 for
// the 40 rows of 5400 cells at the flagship size, 2 us at the HBM rate).
// At that size the row sums' latency, not the bytes, sets the time: the
// design cuts the chain to one read, one reduction and one exchange.
//
// Design: the row is zero-padded (virtually) to npad = 2^k and cut into
//   cluster x warps x rounds x chunks x width
// aligned power-of-two pieces (row-major; the caller's launch geometry,
// cdr_fused.glbl_caas_geometry). Grid (cluster, nt): the `cluster` blocks of
// a row form one thread-block cluster, each block owning one slice. Lane l
// of a warp reads element base + l + width*j of each chunk j (coalesced),
// and keeps qmin, qmass and qmax in registers when rounds == 1 (npad up to
// 8 x 8 x 4 x 32 = 8192), so each input is read once; with rounds > 1 the
// output pass reads the slice again. v's direction is uniform over a row,
// so sum(v) is sum(v_up) or sum(v_down), each over the same tree: one pass
// takes the three sums (delta, v_up, v_down) together, each by the
// adjacent-pair tree of ops/reduce.bfb_sum, level by level:
//   1. within a chunk of `width` lanes, an XOR-butterfly of shuffles
//      (a + b == b + a in IEEE, so both partners hold the pair's sum);
//   2. across a lane's chunks, in registers; across rounds, a binary
//      counter;
//   3. across warps, a butterfly over the warp partials in shared memory;
//   4. across the cluster's blocks, a butterfly over the block partials
//      read through distributed shared memory after one cluster.sync().
// Every piece is an aligned subtree, so the sums are bitwise the plain
// version's; padding lanes and all-padding blocks add exact zeros, as the
// plain version's padding does. Each block then writes its cells from what
// it holds. No atomics; built with --fmad=false, so no product is fused
// into an add.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChunks = 4;
constexpr int kMaxWarps = 8;
constexpr int kMaxCluster = 8;
constexpr int kMaxLevels = 32;

template <class T>
__device__ __forceinline__ T clip_delta(T ms, T lo, T hi) {
  return ms < lo ? lo - ms : (ms > hi ? hi - ms : T(0));
}

// One cell's three summands: delta, the headroom up and the headroom down.
template <class T>
struct Sums {
  T delta, up, down;
};

template <class T>
__device__ __forceinline__ Sums<T> operator+(const Sums<T>& a,
                                             const Sums<T>& b) {
  return {a.delta + b.delta, a.up + b.up, a.down + b.down};
}

template <class T>
__device__ __forceinline__ Sums<T> summands(T a, T l, T h) {
  const T zero = T(0);
  const T msd = a + clip_delta(a, l, h);
  return {clip_delta(a, l, h), a >= h ? zero : h - msd,
          a <= l ? zero : msd - l};
}

// Adjacent-pair tree over groups of n lanes (n a power of two <= 32): every
// lane receives the sum of its group's values.
template <class T>
__device__ __forceinline__ Sums<T> lane_tree(Sums<T> v, int n) {
  for (int s = 1; s < n; s <<= 1)
    v = v + Sums<T>{__shfl_xor_sync(kFull, v.delta, s),
                    __shfl_xor_sync(kFull, v.up, s),
                    __shfl_xor_sync(kFull, v.down, s)};
  return v;
}

struct Layout {
  int ncell, width, chunks, rounds, warps, cluster;
};

template <class T>
struct Cells {
  T mn[kMaxChunks], ms[kMaxChunks], mx[kMaxChunks];
};

template <class T>
__device__ __forceinline__ void load(Cells<T>& c, const T* mn, const T* ms,
                                     const T* mx, long base, int lane,
                                     const Layout& g) {
  const T zero = T(0);
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j) {
    if (j < g.chunks) {
      const long i = base + (long)j * g.width + lane;
      const bool in = lane < g.width && i < g.ncell;
      c.mn[j] = in ? mn[i] : zero;
      c.ms[j] = in ? ms[i] : zero;
      c.mx[j] = in ? mx[i] : zero;
    }
  }
}

// The subtree sums of one round of a warp: butterflies within chunks, then
// the pair tree over the lane's chunks.
template <class T>
__device__ __forceinline__ Sums<T> round_sums(const Cells<T>& c,
                                              const Layout& g) {
  Sums<T> p[kMaxChunks];
#pragma unroll
  for (int j = 0; j < kMaxChunks; ++j)
    if (j < g.chunks)
      p[j] = lane_tree(summands(c.ms[j], c.mn[j], c.mx[j]), g.width);
#pragma unroll
  for (int s = 1; s < kMaxChunks; s <<= 1)
#pragma unroll
    for (int j = 0; j + s < kMaxChunks; j += 2 * s)
      if (j + s < g.chunks) p[j] = p[j] + p[j + s];
  return p[0];
}

template <class T>
__global__ void __launch_bounds__(32 * kMaxWarps)
    glbl_caas_kernel(const T* __restrict__ qmin, const T* __restrict__ qmass,
                     const T* __restrict__ qmax, const T* __restrict__ extra,
                     T* __restrict__ out, Layout g) {
  __shared__ Sums<T> wpart[kMaxWarps];
  __shared__ Sums<T> cpart;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long row = blockIdx.y;
  const T* mn = qmin + row * g.ncell;
  const T* ms = qmass + row * g.ncell;
  const T* mx = qmax + row * g.ncell;
  const long span = (long)g.chunks * g.width;
  const long warp_base =
      ((long)cluster.block_rank() * g.warps + warp) * g.rounds * span;
  const T zero = T(0);

  // The warp's subtree sums: its rounds by a binary counter.
  Cells<T> c;
  Sums<T> part;
  if (g.rounds == 1) {
    load(c, mn, ms, mx, warp_base, lane, g);
    part = round_sums(c, g);
  } else {
    Sums<T> stack[kMaxLevels];
    int top = 0;
    for (int r = 0; r < g.rounds; ++r) {
      load(c, mn, ms, mx, warp_base + r * span, lane, g);
      Sums<T> v = round_sums(c, g);
      int lvl = 0;
      for (int k = r; k & 1; k >>= 1) v = stack[lvl++] + v;
      stack[lvl] = v;
      top = lvl;
    }
    part = stack[top];
  }
  // Warps, then the cluster's blocks.
  if (lane == 0) wpart[warp] = part;
  __syncthreads();
  part = lane_tree(wpart[lane & (g.warps - 1)], g.warps);
  if (threadIdx.x == 0) cpart = part;
  cluster.sync();
  const Sums<T> tot =
      lane_tree(*cluster.map_shared_rank(&cpart, lane & (g.cluster - 1)),
                g.cluster);
  // Other blocks may still read cpart: arrive now, wait before exiting.
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  const T m = extra[row] - tot.delta;
  const bool up = m > zero;
  const T vsum = up ? tot.up : tot.down;
  const T fac = vsum != zero ? m / vsum : zero;
  T* o = out + row * g.ncell;
  for (int r = 0; r < g.rounds; ++r) {
    const long base = warp_base + r * span;
    if (g.rounds > 1) load(c, mn, ms, mx, base, lane, g);
#pragma unroll
    for (int j = 0; j < kMaxChunks; ++j) {
      const long i = base + (long)j * g.width + lane;
      if (j < g.chunks && lane < g.width && i < g.ncell) {
        const T a = c.ms[j];
        const Sums<T> s = summands(a, c.mn[j], c.mx[j]);
        o[i] = (a + s.delta) + fac * (up ? s.up : s.down);
      }
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

template <class T>
int launch(const T* qmin, const T* qmass, const T* qmax, const T* extra,
           T* out, int nt, int ncell, int cluster, int warps, int width,
           int chunks, int rounds, void* stream) {
  long npad = 1;
  while (npad < ncell) npad <<= 1;
  const bool ok = pow2(cluster) && cluster <= kMaxCluster && pow2(warps) &&
                  warps <= kMaxWarps && pow2(width) && width <= 32 &&
                  pow2(chunks) && chunks <= kMaxChunks && pow2(rounds) &&
                  (long)cluster * warps * rounds * chunks * width == npad;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0 || ncell <= 0) return static_cast<int>(cudaGetLastError());

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, nt, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Layout g{ncell, width, chunks, rounds, warps, cluster};
  const cudaError_t err = cudaLaunchKernelEx(&cfg, glbl_caas_kernel<T>, qmin,
                                             qmass, qmax, extra, out, g);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" int glbl_caas_f64(const double* qmin, const double* qmass,
                             const double* qmax, const double* extra,
                             double* out, int nt, int ncell, int cluster,
                             int warps, int width, int chunks, int rounds,
                             void* stream) {
  return launch(qmin, qmass, qmax, extra, out, nt, ncell, cluster, warps,
                width, chunks, rounds, stream);
}

extern "C" int glbl_caas_f32(const float* qmin, const float* qmass,
                             const float* qmax, const float* extra,
                             float* out, int nt, int ncell, int cluster,
                             int warps, int width, int chunks, int rounds,
                             void* stream) {
  return launch(qmin, qmass, qmax, extra, out, nt, ncell, cluster, warps,
                width, chunks, rounds, stream);
}
