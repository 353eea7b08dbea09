// Batched FK + RNEA (frames, joint axes and bias forces) in one launch: the
// CUDA replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_dynamics.py::rnea_terms_batched (its body
// _rnea_rows). The per-rollout arithmetic is staged.cuh::rnea_item's
// (substep.cuh::rnea_rows), run by a team of lanes:
// staged_team.cuh::rnea_team_row.
//
// Design: one team per rollout, as the substep kernel K1 (substep.cu): a
// warp, four per block at solo width (nq = 10) and one at torso width,
// joint i on lane i % 32. The FK, the inertial loads and the backward pass
// are the team substep's own device functions (fk_team,
// inertial_loads_team, rnea_backward_team in substep_team.cuh): the tree's
// levels one after another, all joints of a level at once, a sync per
// level. The block copies what they read of the packed model (its first
// 14 nq floats and 2 nq ints: joint frames, masses, COMs, inertias,
// parents and joint types; staged_team.cuh::TreeModel) into shared memory,
// once for its rollouts, and derives the joints' depths there; each lane
// keeps its joints' constants in registers, and stores its joints' rows of
// the four outputs. Instantiated for (nq, fingertips) = (10, 2) and
// (20, 4); the model comes from the substep kernel's packed buffers
// (ops/substep_cuda.py).
//
// What bounds it: latency. A team's chain is the tree's depth in FK levels
// (a quaternion product, rotations and cross products each) and again in
// backward levels, each behind a sync; the bytes (qpos, qvel in, 11 floats
// per joint out) are ~130 KB at K = 256, solo. Warps per block are a build
// constant: chip_smoke.py builds the solo-width alternative with -D and
// times it beside these (PERF.md §6).
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include "staged_team.cuh"

// Warps per block at solo width.
#ifndef KMANIP_RNEA_WARPS
#define KMANIP_RNEA_WARPS 4
#endif

namespace kmanip {

template <int NQ>
__host__ __device__ constexpr int rnea_warps() {
  return NQ <= 16 ? KMANIP_RNEA_WARPS : 1;
}

template <int NQ>
__global__ void __launch_bounds__(32 * rnea_warps<NQ>())
    rnea_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i, int K,
                const float* __restrict__ qpos, const float* __restrict__ qvel,
                float* __restrict__ xpos, float* __restrict__ xquat, float* __restrict__ axis,
                float* __restrict__ bias) {
  constexpr int W = rnea_warps<NQ>(), NT = 32 * W;
  __shared__ TreeModel<NQ> M;
  __shared__ TreeWork<NQ> s[W];
  tree_model_load(M, (int)threadIdx.x, NT, model_f, model_i, BlockSync{});
  const int team = threadIdx.x / 32;
  const int row = blockIdx.x * W + team;
  rnea_team_row<NQ>(WarpTeam{(int)threadIdx.x % 32}, M, s[team], row < K ? row : K - 1, row < K,
                    qpos, qvel, xpos, xquat, axis, bias);
}

template <int NQ>
cudaError_t launch_rnea(int K, cudaStream_t s, const void* mf, const void* mi, const void* qpos,
                        const void* qvel, void* xpos, void* xquat, void* axis, void* bias) {
  constexpr int W = rnea_warps<NQ>();
  rnea_kernel<NQ><<<(K + W - 1) / W, 32 * W, 0, s>>>(
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
    return (int)launch_rnea<10>(K, s, model_f, model_i, qpos, qvel, xpos, xquat, axis, bias);
#ifndef KMANIP_SOLO_ONLY  // set for the solo-width alternates that chip_smoke.py times
  if (nq == 20 && T == 4)
    return (int)launch_rnea<20>(K, s, model_f, model_i, qpos, qvel, xpos, xquat, axis, bias);
#endif
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
