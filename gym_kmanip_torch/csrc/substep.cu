// One physics substep for K rollouts: the CUDA replacement of the JAX
// package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_substep.py::substep_batched (its body
// _substep_core, with _rnea_rows and _contact_rows inlined). The arithmetic
// lives in substep.cuh; this file holds the kernel and its C entry points.
//
// Design: one thread per rollout, 128 threads per block, grid ceil(K/128),
// the ragged edge masked. Model constants come from one packed float32 and
// one int32 buffer (built once per model and device by
// gym_kmanip_torch/ops/substep_cuda.py). State is read and written as the
// caller's row-major (K, n) tensors.
//
// What bounds it: each thread runs a long dependent scalar chain (tree
// recursion, an nq x nq mass matrix, a dense Cholesky, 3 constraint
// sweeps) with its working set in registers and local memory. At the MPPI
// batch K = 256 that is 2 blocks, so 2 of the H100's 132 SMs are busy and
// the kernel is latency-bound, not bound by bytes or FLOPs. Spreading one
// rollout over a warp, more work per launch (the whole horizon in one
// launch) and coalesced layouts are later work.
//
// Build (gym_kmanip_torch/ops/_build.py): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false -shared
// -Xcompiler -fPIC. No --use_fast_math; no multiply-add contraction, so
// the kernel rounds like the plain PyTorch version it is checked against.

#include <cuda_runtime.h>

#include "substep.cuh"

namespace kmanip {

template <int NQ, int T>
__global__ void __launch_bounds__(128)
    substep_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i,
                   StepConsts c, int contact, int implicit, int K,
                   const float* __restrict__ qpos, const float* __restrict__ qvel,
                   const float* __restrict__ ctrl, const float* __restrict__ cube13,
                   float* __restrict__ qpos_out, float* __restrict__ qvel_out,
                   float* __restrict__ cube_out, bool* __restrict__ touch_out,
                   float* __restrict__ xpos_out, float* __restrict__ xquat_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const ModelView<NQ, T> m{model_f, model_i};
  substep_rollout<NQ, T>(k, m, c, contact != 0, implicit != 0, qpos, qvel, ctrl, cube13,
                         qpos_out, qvel_out, cube_out, touch_out, xpos_out, xquat_out);
}

template <int NQ, int T>
cudaError_t launch(int K, cudaStream_t stream, const void* mf, const void* mi, StepConsts c,
                   int contact, int implicit, const void* qpos, const void* qvel,
                   const void* ctrl, const void* cube13, void* qpos_out, void* qvel_out,
                   void* cube_out, void* touch_out, void* xpos_out, void* xquat_out) {
  substep_kernel<NQ, T><<<(K + 127) / 128, 128, 0, stream>>>(
      (const float*)mf, (const int*)mi, c, contact, implicit, K, (const float*)qpos,
      (const float*)qvel, (const float*)ctrl, (const float*)cube13, (float*)qpos_out,
      (float*)qvel_out, (float*)cube_out, (bool*)touch_out, (float*)xpos_out,
      (float*)xquat_out);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// Sizes of the packed model buffers for (nq, T); -1 if not instantiated.
int kmanip_substep_model_sizes(int nq, int T, int* n_floats, int* n_ints) {
  using namespace kmanip;
  if (nq == 10 && T == 2) {
    *n_floats = ModelView<10, 2>::N_FLOATS;
    *n_ints = ModelView<10, 2>::N_INTS;
  } else if (nq == 20 && T == 4) {
    *n_floats = ModelView<20, 4>::N_FLOATS;
    *n_ints = ModelView<20, 4>::N_INTS;
  } else {
    return -1;
  }
  return 0;
}

// Launches one substep on `stream`; returns cudaGetLastError() after the
// launch (0 = launched).
int kmanip_substep(int nq, int T, const void* model_f, const void* model_i, double dt,
                   int contact, int implicit, int K, const void* qpos, const void* qvel,
                   const void* ctrl, const void* cube13, void* qpos_out, void* qvel_out,
                   void* cube_out, void* touch_out, void* xpos_out, void* xquat_out,
                   void* stream) {
  using namespace kmanip;
  if (K <= 0) return (int)cudaSuccess;
  const StepConsts c = make_consts(dt);
  cudaStream_t s = (cudaStream_t)stream;
  if (nq == 10 && T == 2)
    return (int)launch<10, 2>(K, s, model_f, model_i, c, contact, implicit, qpos, qvel, ctrl,
                              cube13, qpos_out, qvel_out, cube_out, touch_out, xpos_out,
                              xquat_out);
  if (nq == 20 && T == 4)
    return (int)launch<20, 4>(K, s, model_f, model_i, c, contact, implicit, qpos, qvel, ctrl,
                              cube13, qpos_out, qvel_out, cube_out, touch_out, xpos_out,
                              xquat_out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
