// The iLQR feedback rollout for B step sizes over the whole horizon in one
// launch: the CUDA replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_substep.py::rollout_feedback (kernel
// _rollout_feedback_kernel). The arithmetic lives in rollout.cuh and
// substep.cuh; this file holds the kernel and its C entry point.
//
// Design: one thread per step size alpha (B = 6 for the line search, 1 for
// the nominal rollout), looping over the H control steps with the state in
// registers and local memory: the control law, then n_substeps
// contact-free substeps, the cube reset to its template every step.
//
// What bounds it: latency. B threads fill part of one warp on one of the
// 132 SMs, and each runs H x n_substeps dependent substeps in a row, so
// the launch takes about H times one substep's latency. Bytes (the gains,
// H x nu x 2nq floats) and FLOPs are far below the card's rates. It
// replaces H launches of the substep kernel and their torch glue per
// forward pass; spreading one rollout over a warp is later work.

#include <cuda_runtime.h>

#include "rollout.cuh"

namespace kmanip {

template <int NQ, int T>
__global__ void __launch_bounds__(128)
    rollout_feedback_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i,
                            StepConsts c, int n_substeps, int B, int H,
                            const float* __restrict__ alphas, const float* __restrict__ x0,
                            const float* __restrict__ cube0, const float* __restrict__ xs_nom,
                            const float* __restrict__ us_nom, const float* __restrict__ ks,
                            const float* __restrict__ Ks, const float* __restrict__ ctrl_lo,
                            const float* __restrict__ ctrl_hi, float* __restrict__ xs_out,
                            float* __restrict__ us_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const ModelView<NQ, T> m{model_f, model_i};
  rollout_feedback_thread<NQ, T>(b, m, c, n_substeps, H, alphas, x0, cube0, xs_nom, us_nom,
                                 ks, Ks, ctrl_lo, ctrl_hi, xs_out, us_out);
}

template <int NQ, int T>
cudaError_t launch_feedback(int B, cudaStream_t stream, const void* mf, const void* mi,
                            StepConsts c, int n_substeps, int H, const void* alphas,
                            const void* x0, const void* cube0, const void* xs_nom,
                            const void* us_nom, const void* ks, const void* Ks,
                            const void* ctrl_lo, const void* ctrl_hi, void* xs_out,
                            void* us_out) {
  const int threads = B < 128 ? ((B + 31) / 32) * 32 : 128;
  rollout_feedback_kernel<NQ, T><<<(B + threads - 1) / threads, threads, 0, stream>>>(
      (const float*)mf, (const int*)mi, c, n_substeps, B, H, (const float*)alphas,
      (const float*)x0, (const float*)cube0, (const float*)xs_nom, (const float*)us_nom,
      (const float*)ks, (const float*)Ks, (const float*)ctrl_lo, (const float*)ctrl_hi,
      (float*)xs_out, (float*)us_out);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).
int kmanip_rollout_feedback(int nq, int T, const void* model_f, const void* model_i,
                            double dt, int n_substeps, int B, int H, const void* alphas,
                            const void* x0, const void* cube0, const void* xs_nom,
                            const void* us_nom, const void* ks, const void* Ks,
                            const void* ctrl_lo, const void* ctrl_hi, void* xs_out,
                            void* us_out, void* stream) {
  using namespace kmanip;
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  const StepConsts c = make_consts(dt);
  cudaStream_t st = (cudaStream_t)stream;
  if (nq == 10 && T == 2)
    return (int)launch_feedback<10, 2>(B, st, model_f, model_i, c, n_substeps, H, alphas, x0,
                                       cube0, xs_nom, us_nom, ks, Ks, ctrl_lo, ctrl_hi,
                                       xs_out, us_out);
  if (nq == 20 && T == 4)
    return (int)launch_feedback<20, 4>(B, st, model_f, model_i, c, n_substeps, H, alphas, x0,
                                       cube0, xs_nom, us_nom, ks, Ks, ctrl_lo, ctrl_hi,
                                       xs_out, us_out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
