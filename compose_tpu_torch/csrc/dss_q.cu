// K3 and K4: mixing-ratio DSS merge, one thread per (tracer, continuous
// node), templated over the real type: dss_q_f64 (K3) and dss_q_f32 (K4).
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
// Bound: memory; per slot one q read and one write plus the node's index,
// mask and weights (~2-4 MB of tables at the flagship size, L2-resident and
// shared by all tracers), ~55 MB (f64) or ~28 MB (f32) of q traffic at
// 40 x 86400.
//
// Design: the TPU's roll merges were a workaround for slow gathers. Here
// each thread gathers its node's slots through c2d_idx/c2d_mask in column
// order and sums in the fixed order ((s0 + s1) + s2) + s3, masked slots
// contributing exact zeros; the plain version spells out the same order.
// Cube-edge nodes are ordinary nodes in this formulation, so no fix pass is
// needed. Each slot belongs to exactly one node, so every output is written
// by one thread: no atomics. K4 divides num / den like K3 (the TPU kernel
// divided by an f64-merged den0 at the fallback). Built with --fmad=false.

#include <cuda_runtime.h>

#include "real.cuh"

namespace {

constexpr int kBlock = 256;

template <class T>
__global__ void dss_q_kernel(const T* __restrict__ w, const T* __restrict__ F,
                             const T* __restrict__ q,
                             const int* __restrict__ c2d_idx,
                             const unsigned char* __restrict__ c2d_mask,
                             T* __restrict__ out, long total, int cnn,
                             int ndgll) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const long t = tid / cnn;
  const int c = (int)(tid % cnn);
  const T* qt = q + t * ndgll;
  T* ot = out + t * ndgll;
  const T zero = T(0);

  int s[4];
  bool m[4];
  T v[4], ws[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = c2d_idx[4 * c + k];
    m[k] = c2d_mask[4 * c + k] != 0;
    v[k] = m[k] ? qt[s[k]] : zero;
    ws[k] = m[k] ? w[s[k]] : zero;
  }
  const T den = ((ws[0] + ws[1]) + ws[2]) + ws[3];
  T cg;
  if (den > zero) {
    const T num = ((ws[0] * v[0] + ws[1] * v[1]) + ws[2] * v[2]) +
                  ws[3] * v[3];
    cg = num / den;
  } else {
    T f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = m[k] ? F[s[k]] : zero;
    const T num0 = ((f[0] * v[0] + f[1] * v[1]) + f[2] * v[2]) + f[3] * v[3];
    const T den0 = ((f[0] + f[1]) + f[2]) + f[3];
    cg = num0 / den0;
  }
  T mn = v[0], mx = v[0];  // slot 0 is always valid
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (m[k]) {
      mn = real::min(mn, v[k]);
      mx = real::max(mx, v[k]);
    }
  }
  cg = real::min(real::max(cg, mn), mx);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (m[k]) ot[s[k]] = cg;
}

template <class T>
int launch(const T* w, const T* F, const T* q, const int* c2d_idx,
           const unsigned char* c2d_mask, T* out, int nt, int cnn, int ndgll,
           void* stream) {
  const long total = (long)nt * cnn;
  const long blocks = (total + kBlock - 1) / kBlock;
  if (total > 0)
    dss_q_kernel<T><<<(unsigned)blocks, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        w, F, q, c2d_idx, c2d_mask, out, total, cnn, ndgll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dss_q_f64(const double* w, const double* F, const double* q,
                         const int* c2d_idx, const unsigned char* c2d_mask,
                         double* out, int nt, int cnn, int ndgll,
                         void* stream) {
  return launch(w, F, q, c2d_idx, c2d_mask, out, nt, cnn, ndgll, stream);
}

extern "C" int dss_q_f32(const float* w, const float* F, const float* q,
                         const int* c2d_idx, const unsigned char* c2d_mask,
                         float* out, int nt, int cnn, int ndgll,
                         void* stream) {
  return launch(w, F, q, c2d_idx, c2d_mask, out, nt, cnn, ndgll, stream);
}
