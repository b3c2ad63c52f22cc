// K3: mixing-ratio DSS merge, one thread per (tracer, continuous node).
//
// Replaces the TPU kernel compose_tpu/transport/dss_face.py:_q_kernel_dd
// (df64 lane-roll merges, with the cube-edge nodes fixed outside the kernel
// by FaceDss._fix_q / cdr_fused.fix_q_pairs). Semantics are those of
// compose_tpu/transport/dss.py:dss_q_gather_t, in native f64: over the <= 4
// coincident slots s of a continuous node,
//   cg = sum(w_s q_s) / sum(w_s)            if sum(w_s) > 0
//      = sum(F_s q_s) / sum(F_s)            otherwise (zero-mass node)
//   cg = clip(cg, min_s q_s, max_s q_s),  written back to every slot.
// The caller passes w = F * rho for tracers and w = F for a density field
// (dss_gather_t), where the fallback never fires.
//
// Bound: memory; per slot one q read and one write plus the node's index,
// mask and weights (~4 MB of tables at the flagship size, L2-resident and
// shared by all tracers), ~55 MB of q traffic at 40 x 86400.
//
// Design: the TPU's roll merges were a workaround for slow gathers. Here
// each thread gathers its node's slots through c2d_idx/c2d_mask in column
// order and sums in the fixed order ((s0 + s1) + s2) + s3, masked slots
// contributing exact zeros; the plain version spells out the same order.
// Cube-edge nodes are ordinary nodes in this formulation, so no fix pass is
// needed. Each slot belongs to exactly one node, so every output is written
// by one thread: no atomics. Built with --fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void dss_q_kernel(const double* __restrict__ w,
                             const double* __restrict__ F,
                             const double* __restrict__ q,
                             const int* __restrict__ c2d_idx,
                             const unsigned char* __restrict__ c2d_mask,
                             double* __restrict__ out, long total, int cnn,
                             int ndgll) {
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const long t = tid / cnn;
  const int c = (int)(tid % cnn);
  const double* qt = q + t * ndgll;
  double* ot = out + t * ndgll;

  int s[4];
  bool m[4];
  double v[4], ws[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = c2d_idx[4 * c + k];
    m[k] = c2d_mask[4 * c + k] != 0;
    v[k] = m[k] ? qt[s[k]] : 0.0;
    ws[k] = m[k] ? w[s[k]] : 0.0;
  }
  const double den = ((ws[0] + ws[1]) + ws[2]) + ws[3];
  double cg;
  if (den > 0.0) {
    const double num = ((ws[0] * v[0] + ws[1] * v[1]) + ws[2] * v[2]) +
                       ws[3] * v[3];
    cg = num / den;
  } else {
    double f[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = m[k] ? F[s[k]] : 0.0;
    const double num0 = ((f[0] * v[0] + f[1] * v[1]) + f[2] * v[2]) +
                        f[3] * v[3];
    const double den0 = ((f[0] + f[1]) + f[2]) + f[3];
    cg = num0 / den0;
  }
  double mn = v[0], mx = v[0];  // slot 0 is always valid
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (m[k]) {
      mn = fmin(mn, v[k]);
      mx = fmax(mx, v[k]);
    }
  }
  cg = fmin(fmax(cg, mn), mx);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (m[k]) ot[s[k]] = cg;
}

}  // namespace

extern "C" int dss_q_f64(const double* w, const double* F, const double* q,
                         const int* c2d_idx, const unsigned char* c2d_mask,
                         double* out, int nt, int cnn, int ndgll,
                         void* stream) {
  const long total = (long)nt * cnn;
  const long blocks = (total + kBlock - 1) / kBlock;
  if (total > 0)
    dss_q_kernel<<<(unsigned)blocks, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        w, F, q, c2d_idx, c2d_mask, out, total, cnn, ndgll);
  return static_cast<int>(cudaGetLastError());
}
