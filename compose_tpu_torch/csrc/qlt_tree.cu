// The QLT tree of the spf 'qlt' filter (cdr/qlt.py: QLT.run for the
// problem type SHAPEPRESERVE with a root-mass extra), both sweeps in one
// launch, templated over the real type: qlt_tree_f64 and qlt_tree_f32.
//
// Replaces no TPU kernel: the JAX package runs the level loop under XLA,
// which fuses each level. Eager PyTorch runs it as ~3,000 launches per call
// at ne30 (13 levels, each a few gathers, index_copy_ and the closed-form
// node QP's ~150 elementwise ops), each a few microseconds of device work
// behind ~10 us of host work, so the card idled through the CDR.
//
// Semantics: QLT.run_plain(rhom, Qm, Qm_min, Qm_max, root_extra=extra) for
// problem type SHAPEPRESERVE without prefer_mass_con_to_bounds, bitwise:
// every operation of the eager level loop in its order and rounding, in
// the tensors' type. Built with --fmad=false, so no product is fused into a
// sum. Mirrored:
//   - leaf to root: each level's node value V[k0] + V[k1] in the four
//     summed channels (rho, Qm_min, Qm, Qm_max), a single kid adding 0.0
//     (torch.where(single, 0.0, V[k1]) then the sum: -0.0 becomes +0.0);
//   - the root mass Qm(root) + extra;
//   - root to leaf: solve_node_problem with r2l_nl_adjust_bounds and
//     solve_1eq_bc_qp_2d, a = (1, 1) kept in every product and quotient
//     the eager path computes (all exact), w = 1 / rho_kid (PyTorch's
//     1.0 / t is reciprocal(t) * 1.0), the tolerances 10 eps as the point
//     type rounds the Python float, torch.maximum / minimum / amax with
//     their NaN propagation, and torch.argsort(stable=True) of the four
//     wall crossings as a stable rank (NaN last, -0.0 tied with +0.0);
//   - the overrides in the eager order: no_change, then the corner, then
//     the free optimum, then the wall solution; a single-kid node hands its
//     mass to its kid unchanged.
//
// Bound: latency. Per row it reads the four leaf channels (rhom once per
// row) and writes the leaf masses once; the node arrays live in a global
// scratch (5 x (nnodes - nleaf) values per row, ~8.6 MB in f64 for 40 rows
// at ne30) that stays in L2. The time is the tree's depth: 2 x 13 levels,
// each a barrier and a dependent L2 round trip, plus the node QP's
// division chain.
//
// Design: one thread block per row, a loop over the levels with
// __syncthreads() between them (the block's global writes are then visible
// to the whole block); in a level each thread takes nodes
// threadIdx.x + k * blockDim.x. Leaves are read from the inputs and written
// to the output directly; internal nodes go to the scratch. The level
// table is one int32 array built once per device (cdr/qlt.py,
// QLT._kernel_table): nlev + 1 level offsets, then every internal node's
// id, kid 0 and kid 1 (-1 when absent) level by level, leaves up.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 512;

// 10 * eps(f64), the Python float of cdr/qlt.py's `tol` and of
// local_qp.calc_r_tol's factor; T(kTol) rounds it as PyTorch rounds a
// Python scalar operand.
constexpr double kTol = 2.220446049250313e-15;

// torch.maximum / torch.minimum on the card.
template <class T>
__device__ __forceinline__ T tmax(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return ::max(a, b);
}
template <class T>
__device__ __forceinline__ T tmin(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return ::min(a, b);
}

// torch.amax over two values: NaN wins.
template <class T>
__device__ __forceinline__ T amax2(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// The comparator of torch.sort: NaN sorts after every number.
template <class T>
__device__ __forceinline__ bool sort_lt(T a, T b) {
  return (b != b && a == a) || a < b;
}

// r2l_nl_adjust_bounds on one node's two kid bounds (b0, b1), in place.
template <class T>
__device__ __forceinline__ void adjust_bounds(T& b0, T& b1, T r0, T r1,
                                              T extra) {
  const T q0 = b0 / r0, q1 = b1 / r1;
  const bool neg = extra < T(0);
  const bool i0_is_0 = neg ? (q0 >= q1) : (q0 <= q1);
  const T q_i0 = i0_is_0 ? q0 : q1;
  const T q_i1 = i0_is_0 ? q1 : q0;
  const T r_i0 = i0_is_0 ? r0 : r1;
  const T gap = (q_i1 - q_i0) * r_i0;
  const bool single_ok = neg ? (gap <= extra) : (gap >= extra);
  if (single_ok) {
    const T zero = T(0);
    b0 = b0 + (i0_is_0 ? extra : zero);
    b1 = b1 + (i0_is_0 ? zero : extra);
  } else {
    const T tot = (b0 + b1) + extra;
    const T q_tot = tot / (r0 + r1);
    b0 = q_tot * r0;
    b1 = q_tot * r1;
  }
}

// solve_1eq_bc_qp_2d(w, a = 1, b, xlo, xhi, y) with clip and the early
// exit on the tolerance; returns x in (x0, x1).
template <class T>
__device__ __forceinline__ void qp_2d(T w0, T w1, T b, T xlo0, T xlo1,
                                      T xhi0, T xhi1, T y0, T y1, T& x0,
                                      T& x1) {
  const T one = T(1), tol = T(kTol);
  const T ab = tmax(fabs(b), amax2(fabs(one * y0), fabs(one * y1)));
  const T r_tol = tol * ab;
  const T r_lo = (one * xlo0 + one * xlo1) - b;
  const T r_hi = (one * xhi0 + one * xhi1) - b;
  const bool lo_is_sol = fabs(r_lo) <= r_tol;
  const bool hi_is_sol = fabs(r_hi) <= r_tol;
  const bool infeas = !lo_is_sol && !hi_is_sol && (r_lo > T(0) || r_hi < T(0));
  if (lo_is_sol || hi_is_sol || infeas) {
    const bool corner_lo = lo_is_sol || (infeas && r_lo > T(0));
    x0 = corner_lo ? xlo0 : xhi0;
    x1 = corner_lo ? xlo1 : xhi1;
    return;
  }
  // The unconstrained optimum along the constraint line.
  const T q0 = one / w0, q1 = one / w1;
  const T qmass = one * q0 + one * q1;
  const T dm = b - (one * y0 + one * y1);
  const T lam = dm / qmass;
  const T xf0 = y0 + lam * q0, xf1 = y1 + lam * q1;
  if (xf0 >= xlo0 && xf0 <= xhi0 && xf1 >= xlo1 && xf1 <= xhi1) {
    x0 = xf0;
    x1 = xf1;
    return;
  }
  // The line a'x = b against the box walls: bottom, right, top, left.
  const T xb = (T(0.5) * b) / one;
  const T d0 = -one, d1 = one;            // x_dir = (-a1, a0)
  T al[4];
  al[0] = (xlo1 - xb) / d1;
  al[1] = (xhi0 - xb) / d0;
  al[2] = (xhi1 - xb) / d1;
  al[3] = (xlo0 - xb) / d0;
  // Stable ranks; the walls ranked 1 and 2 are the middle two.
  int mid[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int rank = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j != i && (sort_lt(al[j], al[i]) ||
                     (j < i && !sort_lt(al[i], al[j]))))
        ++rank;
    if (rank == 1) mid[0] = i;
    if (rank == 2) mid[1] = i;
  }
  T obj[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const T alpha = al[mid[k]];
    const T e0 = y0 - (xb + alpha * d0);
    const T e1 = y1 - (xb + alpha * d1);
    obj[k] = w0 * (e0 * e0) + w1 * (e1 * e1);
  }
  const int ai = obj[0] <= obj[1] ? mid[0] : mid[1];
  // Fix one coordinate at its wall, solve the other from the constraint.
  const bool fixed_is_x1 = ai == 0 || ai == 2;
  const T fixed = ai == 0 ? xlo1 : (ai == 1 ? xhi0 : (ai == 2 ? xhi1 : xlo0));
  T free_val = (b - one * fixed) / one;
  const T free_lo = fixed_is_x1 ? xlo0 : xlo1;
  const T free_hi = fixed_is_x1 ? xhi0 : xhi1;
  free_val = tmin(tmax(free_val, free_lo), free_hi);
  x0 = fixed_is_x1 ? free_val : fixed;
  x1 = fixed_is_x1 ? fixed : free_val;
}

// One row's channels: leaves in the inputs and the output, internal nodes
// in the scratch.
template <class T>
struct Row {
  const T* leaf[4];      // rho, Qm_min, Qm, Qm_max
  T* inner[5];           // the same, then the masses M
  T* out;                // the leaf masses
  int nl;

  __device__ __forceinline__ T get(int c, int node) const {
    return node < nl ? leaf[c][node] : inner[c][node - nl];
  }
  __device__ __forceinline__ T mass(int node) const {
    return node < nl ? out[node] : inner[4][node - nl];
  }
  __device__ __forceinline__ void set_mass(int node, T v) const {
    if (node < nl) out[node] = v;
    else inner[4][node - nl] = v;
  }
};

template <class T>
__global__ void __launch_bounds__(kBlock)
qlt_tree_kernel(const T* __restrict__ rhom, const T* __restrict__ qmin,
                const T* __restrict__ qm, const T* __restrict__ qmax,
                const T* __restrict__ extra, int extra_stride,
                T* __restrict__ out, T* __restrict__ scratch,
                const int* __restrict__ table, int nlev, int nl) {
  const int* off = table;
  const int ni = off[nlev];               // internal nodes
  const int* ids = table + nlev + 1;
  const int* k0s = ids + ni;
  const int* k1s = k0s + ni;
  const long row = blockIdx.x;
  Row<T> R;
  R.nl = nl;
  R.leaf[0] = rhom;
  R.leaf[1] = qmin + row * nl;
  R.leaf[2] = qm + row * nl;
  R.leaf[3] = qmax + row * nl;
  for (int c = 0; c < 5; ++c) R.inner[c] = scratch + (row * 5 + c) * ni;
  R.out = out + row * nl;

  // Leaf to root: the kid sums of the four channels.
  for (int l = 0; l < nlev; ++l) {
    for (int i = off[l] + threadIdx.x; i < off[l + 1]; i += kBlock) {
      const int id = ids[i] - nl, k0 = k0s[i], k1 = k1s[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const T v1 = k1 < 0 ? T(0) : R.get(c, k1);
        R.inner[c][id] = R.get(c, k0) + v1;
      }
    }
    __syncthreads();
  }

  // The root: its mass plus the extra.
  if (threadIdx.x == 0) {
    const int root = nl + ni - 1;
    T m = R.get(2, root);
    if (extra != nullptr) m = m + extra[row * extra_stride];
    R.set_mass(root, m);
  }
  __syncthreads();

  // Root to leaf: the node problems, level by level.
  const T tol = T(kTol);
  for (int l = nlev - 1; l >= 0; --l) {
    for (int i = off[l] + threadIdx.x; i < off[l + 1]; i += kBlock) {
      const int id = ids[i], k0 = k0s[i], k1 = k1s[i];
      const T m = R.mass(id);
      if (k1 < 0) {
        R.set_mass(k0, m);
        continue;
      }
      const T p_min = R.get(1, id), p_qm = R.get(2, id),
              p_max = R.get(3, id);
      const T r0 = R.get(0, k0), r1 = R.get(0, k1);
      T mn0 = R.get(1, k0), mn1 = R.get(1, k1);
      const T y0 = R.get(2, k0), y1 = R.get(2, k1);
      T mx0 = R.get(3, k0), mx1 = R.get(3, k1);

      const bool lo = m < p_min;
      const bool hi = m > p_max;
      const T disc = lo ? p_min - m : m - p_max;
      const bool act = (lo || hi) && (disc > tol * (p_max - p_min));
      const T target = m - (lo ? p_min : p_max);
      if (act && lo) adjust_bounds(mn0, mn1, r0, r1, target);
      if (act && hi) adjust_bounds(mx0, mx1, r0, r1, target);
      const bool no_change = !lo && !hi && m == p_qm && y0 >= mn0 &&
                             y0 <= mx0 && y1 >= mn1 && y1 <= mx1;
      T x0 = y0, x1 = y1;
      if (!no_change) {
        const T w0 = (T(1) / r0) * T(1), w1 = (T(1) / r1) * T(1);
        qp_2d(w0, w1, m, mn0, mn1, mx0, mx1, y0, y1, x0, x1);
      }
      R.set_mass(k0, x0);
      R.set_mass(k1, x1);
    }
    __syncthreads();
  }
}

// table: see the header; extra: null for no extra, else its value of row r
// at extra[r * extra_stride]; scratch: nt x 5 x (table's internal nodes).
template <class T>
int launch(const T* rhom, const T* qmin, const T* qm, const T* qmax,
           const T* extra, int extra_stride, T* out, T* scratch,
           const int* table, int nlev, int nt, int nl, void* stream) {
  if (nt < 0 || nl < 1 || nlev < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt > 0)
    qlt_tree_kernel<T><<<nt, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        rhom, qmin, qm, qmax, extra, extra_stride, out, scratch, table, nlev,
        nl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qlt_tree_f64(const double* rhom, const double* qmin,
                            const double* qm, const double* qmax,
                            const double* extra, int extra_stride,
                            double* out, double* scratch, const int* table,
                            int nlev, int nt, int nl, void* stream) {
  return launch(rhom, qmin, qm, qmax, extra, extra_stride, out, scratch,
                table, nlev, nt, nl, stream);
}

extern "C" int qlt_tree_f32(const float* rhom, const float* qmin,
                            const float* qm, const float* qmax,
                            const float* extra, int extra_stride, float* out,
                            float* scratch, const int* table, int nlev,
                            int nt, int nl, void* stream) {
  return launch(rhom, qmin, qm, qmax, extra, extra_stride, out, scratch,
                table, nlev, nt, nl, stream);
}
