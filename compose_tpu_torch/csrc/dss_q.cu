// K3 and K4: mixing-ratio DSS merge, one thread per DGLL slot looping over
// a chunk of tracers, templated over the real type: dss_q_f64 (K3) and
// dss_q_f32 (K4).
//
// Replaces the TPU kernels compose_tpu/transport/dss_face.py:_q_kernel_dd
// (K3, df64 lane-roll merges) and dss_face.py:_q_kernel (K4, the f32 merge
// used when x64 is off), both with the cube-edge nodes fixed outside the
// kernel by FaceDss._fix_q / cdr_fused.fix_q_pairs. Semantics are those of
// compose_tpu/transport/dss.py:dss_q_gather_t, in the tensors' own type:
// over the <= 4 coincident slots s of a continuous node,
//   cg = sum(w_s q_s) / sum(w_s)            if sum(w_s) > 0
//      = sum(F_s q_s) / sum(F_s)            otherwise (zero-mass node)
//   cg = clip(cg, min_s q_s, max_s q_s),  written back to every slot.
// The caller passes w = F * rho for tracers and w = F for a density field
// (dss_gather_t), where the fallback never fires.
//
// Bound: memory; one q read and one write per slot and tracer (~55 MB in
// f64, ~28 MB in f32 at 40 x 86400), plus the weights and the slot table
// (~2 MB, read once per slot, not per tracer).
//
// Design: slot-parallel. Grid (slots / 256, tracer chunks): thread s owns
// DGLL slot s, in slot order, and loops over a chunk of kTracers tracers,
// so nt = 1 still fills the card. Row s of the private slot table
// (dss.slot_table: c2d_idx[dgll2cgll[s]] as int32, -1 where c2d_mask is
// False) names the node's slots in c2d_idx's column order; the thread
// reads it, the node's weights, den and the fallback's F weights once,
// outside the tracer loop. Per tracer it reads its own slot (coalesced),
// gathers the node's other <= 3 slots (in neighbouring cells, L1/L2
// resident) and writes only its own slot (coalesced). Every slot of a node
// runs the same operations in the same order, ((s0 + s1) + s2) + s3 with
// masked slots contributing exact zeros, so all copies agree and equal the
// plain version's; cube-edge nodes need no fix pass. No atomics; built
// with --fmad=false.
//
// Shard-local use: the rows of w, F and q may be longer (nin) than the
// number of output slots (nout = rows of the slot table): a shard's DGLL
// slots followed by the halo slots received from its neighbours, which
// the slot table indexes but which get no output. A slot whose table row
// is all -1 (a pad row of a ragged or tiled block) is written 0; every
// real slot's column 0 is valid, so its result is unchanged.

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kTracers = 8;

template <class T>
__device__ __forceinline__ T sum4(const T* x) {
  return ((x[0] + x[1]) + x[2]) + x[3];
}

template <class T>
__global__ void __launch_bounds__(kBlock)
    dss_q_kernel(const T* __restrict__ w, const T* __restrict__ F,
                 const T* __restrict__ q, const int4* __restrict__ slots,
                 T* __restrict__ out, int nt, int nin, int nout) {
  const int s = blockIdx.x * kBlock + threadIdx.x;
  if (s >= nout) return;
  const T zero = T(0);
  const int4 row = slots[s];
  const int t0 = static_cast<int>(blockIdx.y) * kTracers;
  const int t1 = min(nt, t0 + kTracers);
  if (row.x < 0) {  // a pad row
    for (int t = t0; t < t1; ++t) out[(long)t * nout + s] = zero;
    return;
  }
  const int idx[4] = {row.x, row.y, row.z, row.w};
  bool m[4];
  T c[4];  // the merge weights: w, or F at a zero-mass node
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = idx[k] >= 0;
    c[k] = m[k] ? w[idx[k]] : zero;
  }
  T den = sum4(c);
  if (!(den > zero)) {
#pragma unroll
    for (int k = 0; k < 4; ++k) c[k] = m[k] ? F[idx[k]] : zero;
    den = sum4(c);
  }

#pragma unroll 2
  for (int t = t0; t < t1; ++t) {
    const T* qt = q + (long)t * nin;
    T v[4], p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = m[k] ? qt[idx[k]] : zero;
      p[k] = c[k] * v[k];
    }
    T mn = v[0], mx = v[0];  // column 0 is always valid
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      if (m[k]) {
        mn = real::min(mn, v[k]);
        mx = real::max(mx, v[k]);
      }
    }
    out[(long)t * nout + s] = real::min(real::max(sum4(p) / den, mn), mx);
  }
}

template <class T>
int launch(const T* w, const T* F, const T* q, const int* slots, T* out,
           int nt, int nin, int nout, void* stream) {
  if (nt > 0 && nout > 0) {
    const dim3 grid((nout + kBlock - 1) / kBlock,
                    (nt + kTracers - 1) / kTracers);
    dss_q_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        w, F, q, reinterpret_cast<const int4*>(slots), out, nt, nin, nout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dss_q_f64(const double* w, const double* F, const double* q,
                         const int* slots, double* out, int nt, int nin,
                         int nout, void* stream) {
  return launch(w, F, q, slots, out, nt, nin, nout, stream);
}

extern "C" int dss_q_f32(const float* w, const float* F, const float* q,
                         const int* slots, float* out, int nt, int nin,
                         int nout, void* stream) {
  return launch(w, F, q, slots, out, nt, nin, nout, stream);
}
