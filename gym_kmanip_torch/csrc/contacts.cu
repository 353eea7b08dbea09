// Batched penalty contacts (fingertip spheres vs the cube, then the cube's
// corners vs the table) in one launch: the CUDA replacement of the JAX
// package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_contacts.py::contact_forces_batched (its body
// _contact_rows). The per-item code is staged.cuh::contacts_item, which runs
// substep.cuh::contact_rows, the same device function as the fused
// substep.
//
// Design: one thread per rollout, 128 threads per block, grid ceil(K/128),
// the ragged edge masked; the fingertip radii come from the substep
// kernel's packed model (ops/substep_cuda.py), instantiated for
// (nq, fingertips) = (10, 2) and (20, 4).
//
// What bounds it: latency. A thread does ~1,200 dependent float operations
// (per fingertip a sphere-box test and an impedance force, then eight
// corners against the table) and moves ~150 bytes; at K = 256 two SMs of
// 132 are busy.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include "staged.cuh"

namespace kmanip {

template <int NQ, int T>
__global__ void __launch_bounds__(128)
    contacts_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i, int K,
                    const float* __restrict__ tip_pos, const float* __restrict__ tip_vel,
                    const float* __restrict__ cube_pos, const float* __restrict__ cube_quat,
                    const float* __restrict__ cube_lv, const float* __restrict__ cube_av,
                    float* __restrict__ force, float* __restrict__ torque,
                    float* __restrict__ tip_forces, bool* __restrict__ touch_tip,
                    bool* __restrict__ touch_table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const ModelView<NQ, T> m{model_f, model_i};
  contacts_item<NQ, T>(k, m, tip_pos, tip_vel, cube_pos, cube_quat, cube_lv, cube_av, force,
                       torque, tip_forces, touch_tip, touch_table);
}

template <int NQ, int T>
cudaError_t launch_contacts(int K, cudaStream_t s, const void* mf, const void* mi,
                            const void* const* in, void* const* out) {
  contacts_kernel<NQ, T><<<(K + 127) / 128, 128, 0, s>>>(
      (const float*)mf, (const int*)mi, K, (const float*)in[0], (const float*)in[1],
      (const float*)in[2], (const float*)in[3], (const float*)in[4], (const float*)in[5],
      (float*)out[0], (float*)out[1], (float*)out[2], (bool*)out[3], (bool*)out[4]);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// Launches the contact model for K rollouts on `stream`; returns
// cudaGetLastError() after the launch (0 = launched).
int kmanip_contacts(int nq, int T, const void* model_f, const void* model_i, int K,
                    const void* tip_pos, const void* tip_vel, const void* cube_pos,
                    const void* cube_quat, const void* cube_lv, const void* cube_av, void* force,
                    void* torque, void* tip_forces, void* touch_tip, void* touch_table,
                    void* stream) {
  using namespace kmanip;
  if (K <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[6] = {tip_pos, tip_vel, cube_pos, cube_quat, cube_lv, cube_av};
  void* out[5] = {force, torque, tip_forces, touch_tip, touch_table};
  if (nq == 10 && T == 2) return (int)launch_contacts<10, 2>(K, s, model_f, model_i, in, out);
  if (nq == 20 && T == 4) return (int)launch_contacts<20, 4>(K, s, model_f, model_i, in, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
