// Batched FK + RNEA (frames, joint axes and bias forces) in one launch: the
// CUDA replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_dynamics.py::rnea_terms_batched (its body
// _rnea_rows). The per-item code is staged.cuh::rnea_item, which runs
// substep.cuh::rnea_rows, the same device function as the fused substep.
//
// Design: one thread per rollout, 128 threads per block, grid ceil(K/128),
// the ragged edge masked; the model comes from the substep kernel's packed
// buffers (ops/substep_cuda.py), instantiated for (nq, fingertips) =
// (10, 2) and (20, 4).
//
// What bounds it: latency. Each thread runs the serial tree recursion
// (a few hundred dependent float operations per joint), at K = 256 on 2 of
// the 132 SMs; the bytes (qpos, qvel in, 11 floats per joint out) are a few
// hundred KB. Spreading a rollout's joints over a warp is later work.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include "staged.cuh"

namespace kmanip {

template <int NQ, int T>
__global__ void __launch_bounds__(128)
    rnea_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i, int K,
                const float* __restrict__ qpos, const float* __restrict__ qvel,
                float* __restrict__ xpos, float* __restrict__ xquat, float* __restrict__ axis,
                float* __restrict__ bias) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const ModelView<NQ, T> m{model_f, model_i};
  rnea_item<NQ, T>(k, m, qpos, qvel, xpos, xquat, axis, bias);
}

template <int NQ, int T>
cudaError_t launch_rnea(int K, cudaStream_t s, const void* mf, const void* mi, const void* qpos,
                        const void* qvel, void* xpos, void* xquat, void* axis, void* bias) {
  rnea_kernel<NQ, T><<<(K + 127) / 128, 128, 0, s>>>(
      (const float*)mf, (const int*)mi, K, (const float*)qpos, (const float*)qvel,
      (float*)xpos, (float*)xquat, (float*)axis, (float*)bias);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// Launches FK + RNEA for K rollouts on `stream`; returns cudaGetLastError()
// after the launch (0 = launched).
int kmanip_rnea(int nq, int T, const void* model_f, const void* model_i, int K, const void* qpos,
                const void* qvel, void* xpos, void* xquat, void* axis, void* bias,
                void* stream) {
  using namespace kmanip;
  if (K <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (nq == 10 && T == 2)
    return (int)launch_rnea<10, 2>(K, s, model_f, model_i, qpos, qvel, xpos, xquat, axis, bias);
  if (nq == 20 && T == 4)
    return (int)launch_rnea<20, 4>(K, s, model_f, model_i, qpos, qvel, xpos, xquat, axis, bias);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
