// The iLQR feedback rollout for B step sizes over the whole horizon in one
// launch: the CUDA replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_substep.py::rollout_feedback (kernel
// _rollout_feedback_kernel). The arithmetic lives in feedback_warp.cuh, on
// the team substep of substep_team.cuh (contact-free, implicit, the cube
// pinned), which K1 and K2 share; this file holds the kernel and its C
// entry point.
//
// Design: one warp per step size alpha (B = 6 for the line search, 1 for
// the nominal rollout), each in a block of its own, so the B warps run on B
// SMs. A warp keeps its rollout's state, the substep's intermediates (frames,
// axes, the COM-Jacobian columns, the packed mass matrix and its factor,
// tau, the constraint forces) and the model in shared memory, and splits
// what is independent over its lanes: the hinge sines, the tree's levels,
// the inertial loads, the mass matrix's entries, the factor's rows, the
// per-joint torque, constraint and integration updates, and the feedback
// law, one lane per control. The step's gains and nominal are copied ahead
// into a double-buffered shared stage (cp.async) while the step before runs.
//
// What bounds it: latency and the warp's instruction issue. Each warp runs
// H x n_substeps dependent substeps; what is left on the chain are the tree
// recursions (a warp sync per level), the factor (a shuffle per pivot and
// per column entry) and the four triangular solves, which every lane runs
// at once in registers. No tensor cores: the
// products are FP32 dot products that must round as the plain version does
// (the kernel agrees bit for bit with a serial rollout over substep_core),
// and TF32 would not hold K3's band. Bytes (the gains, H x nu x 2nq floats)
// and FLOPs are far below the card's rates.

#include <cuda_runtime.h>

#include "feedback_warp.cuh"

namespace kmanip {

template <int NQ, int T>
__global__ void __launch_bounds__(32)
    rollout_feedback_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i,
                            StepConsts c, int n_substeps, int H,
                            const float* __restrict__ alphas, const float* __restrict__ x0,
                            const float* __restrict__ xs_nom, const float* __restrict__ us_nom,
                            const float* __restrict__ ks, const float* __restrict__ Ks,
                            const float* __restrict__ ctrl_lo, const float* __restrict__ ctrl_hi,
                            float* __restrict__ xs_out, float* __restrict__ us_out) {
  __shared__ FeedbackShared<NQ, T> s;
  rollout_feedback_team<NQ, T>(WarpTeam{(int)threadIdx.x}, s, blockIdx.x, model_f, model_i, c,
                               n_substeps, H, alphas, x0, xs_nom, us_nom, ks, Ks, ctrl_lo,
                               ctrl_hi, xs_out, us_out);
}

template <int NQ, int T>
cudaError_t launch_feedback(int B, cudaStream_t stream, const void* mf, const void* mi,
                            StepConsts c, int n_substeps, int H, const void* alphas,
                            const void* x0, const void* xs_nom, const void* us_nom,
                            const void* ks, const void* Ks, const void* ctrl_lo,
                            const void* ctrl_hi, void* xs_out, void* us_out) {
  rollout_feedback_kernel<NQ, T><<<B, 32, 0, stream>>>(
      (const float*)mf, (const int*)mi, c, n_substeps, H, (const float*)alphas,
      (const float*)x0, (const float*)xs_nom, (const float*)us_nom, (const float*)ks,
      (const float*)Ks, (const float*)ctrl_lo, (const float*)ctrl_hi, (float*)xs_out,
      (float*)us_out);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = launched). The cube's pinned state is not an argument: a
// contact-free rollout never reads it.
int kmanip_rollout_feedback(int nq, int T, const void* model_f, const void* model_i,
                            double dt, int n_substeps, int B, int H, const void* alphas,
                            const void* x0, const void* xs_nom,
                            const void* us_nom, const void* ks, const void* Ks,
                            const void* ctrl_lo, const void* ctrl_hi, void* xs_out,
                            void* us_out, void* stream) {
  using namespace kmanip;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  const StepConsts c = make_consts(dt);
  cudaStream_t st = (cudaStream_t)stream;
  if (nq == 10 && T == 2)
    return (int)launch_feedback<10, 2>(B, st, model_f, model_i, c, n_substeps, H, alphas, x0,
                                       xs_nom, us_nom, ks, Ks, ctrl_lo, ctrl_hi, xs_out,
                                       us_out);
  if (nq == 20 && T == 4)
    return (int)launch_feedback<20, 4>(B, st, model_f, model_i, c, n_substeps, H, alphas, x0,
                                       xs_nom, us_nom, ks, Ks, ctrl_lo, ctrl_hi, xs_out,
                                       us_out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
