// The whole (K, H) rollout and the cube-pick cost in one launch: the CUDA
// replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_substep.py::rollout_pick_costs (kernel
// _rollout_pick_kernel). The arithmetic lives in rollout.cuh and
// substep.cuh; this file holds the kernel and its C entry point.
//
// Design: one thread per candidate sequence, 128 threads per block, the
// launch shape of the substep kernel. Each thread keeps its state in
// registers and local memory for all H x n_substeps substeps, adds the
// pick cost every control step, and writes only its (K,) total. The
// shared start state is read once per thread, not copied K times.
//
// What bounds it: the same long dependent scalar chain per thread as the
// substep kernel, now H x n_substeps of them in a row; at the MPPI batch
// K = 256 two of the H100's 132 SMs are busy. It is latency-bound, far
// from the card's bytes or FLOPs. What it removes is the host: the K1
// route dispatches ~172 torch launches of glue per horizon step.

#include <cuda_runtime.h>

#include "rollout.cuh"

namespace kmanip {

template <int NQ, int T>
__global__ void __launch_bounds__(128)
    rollout_pick_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i,
                        StepConsts c, int contact, int implicit, int n_substeps, int K, int H,
                        PickSpec spec, const float* __restrict__ ctrl_seqs,
                        const float* __restrict__ state0, float* __restrict__ cost_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const ModelView<NQ, T> m{model_f, model_i};
  cost_out[k] = rollout_pick_thread<NQ, T>(k, m, c, contact != 0, implicit != 0, n_substeps,
                                            H, spec, ctrl_seqs, state0);
}

template <int NQ, int T>
cudaError_t launch_pick(int K, cudaStream_t stream, const void* mf, const void* mi,
                        StepConsts c, int contact, int implicit, int n_substeps, int H,
                        const PickSpec& spec, const void* ctrl_seqs, const void* state0,
                        void* cost_out) {
  rollout_pick_kernel<NQ, T><<<(K + 127) / 128, 128, 0, stream>>>(
      (const float*)mf, (const int*)mi, c, contact, implicit, n_substeps, K, H, spec,
      (const float*)ctrl_seqs, (const float*)state0, (float*)cost_out);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// spec_f, spec_i: the cost spec as host arrays (make_pick_spec). Launches
// on `stream`; returns cudaGetLastError() after the launch (0 = launched).
int kmanip_rollout_pick(int nq, int T, const void* model_f, const void* model_i, double dt,
                        int contact, int implicit, int n_substeps, int K, int H,
                        const float* spec_f, const int* spec_i, const void* ctrl_seqs,
                        const void* state0, void* cost_out, void* stream) {
  using namespace kmanip;
  if (K <= 0) return (int)cudaSuccess;
  const StepConsts c = make_consts(dt);
  const PickSpec spec = make_pick_spec(spec_f, spec_i);
  cudaStream_t st = (cudaStream_t)stream;
  if (nq == 10 && T == 2)
    return (int)launch_pick<10, 2>(K, st, model_f, model_i, c, contact, implicit, n_substeps,
                                   H, spec, ctrl_seqs, state0, cost_out);
  if (nq == 20 && T == 4)
    return (int)launch_pick<20, 4>(K, st, model_f, model_i, c, contact, implicit, n_substeps,
                                   H, spec, ctrl_seqs, state0, cost_out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
