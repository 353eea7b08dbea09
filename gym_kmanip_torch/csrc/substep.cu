// One physics substep for K rollouts: the CUDA replacement of the JAX
// package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_substep.py::substep_batched (its body
// _substep_core, with _rnea_rows and _contact_rows inlined). The arithmetic
// lives in substep_team.cuh (on substep.cuh's device functions); this file
// holds the kernel and its C entry points.
//
// Design: one team of lanes per rollout (substep_team.cuh), each reading and
// writing its row of the caller's row-major (K, n) tensors: a warp, four of
// them per block at solo width (nq = 10) and one at torso width. The block
// copies the packed model (built once per model and device by
// gym_kmanip_torch/ops/substep_cuda.py) into shared memory and derives the
// tree's tables there, joint by joint; each lane keeps its joints'
// constants in registers. contact and implicit actuation are compile-time
// choices, four instantiations per model. The team width and warps per
// block are build constants: chip_smoke.py builds the solo-width
// alternatives (16-lane teams, two rollouts per warp, where the per-joint
// phases leave 22 of 32 lanes idle; one warp per block) and times them
// beside these, which were the faster on an H100 (PERF.md §6).
//
// What bounds it: latency and the team's instruction issue. A launch is one
// substep's dependent chain per team (the tree's levels with a sync each,
// the contact lanes, the factor with a shuffle per pivot and column entry,
// four triangular solves in registers) plus the setup that a single
// substep does not amortize: the model's copy and tables, the lane
// constants and the inputs, a fifth to a quarter of a launch
// (tools/kernel_phases.py).
// Bytes (a few hundred per rollout) and FLOPs are far below the card's
// rates. On the main paths the wrapper's host time is longer than the
// kernel, so back-to-back calls measure the host; chip_smoke.py reads the
// kernel's device time with the profiler.
//
// Build (gym_kmanip_torch/ops/_build.py): nvcc -gencode
// arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false -shared
// -Xcompiler -fPIC. No --use_fast_math; no multiply-add contraction, so
// the kernel rounds like the plain PyTorch version it is checked against
// (and, on the host build, bit for bit like substep_rollout).

#include <cuda_runtime.h>

#include "substep_team.cuh"

// Lanes per team at solo width, and warps per block (chip_smoke.py builds
// the other widths with -D to time them beside these).
#ifndef KMANIP_SOLO_LANES
#define KMANIP_SOLO_LANES 32
#endif
#ifndef KMANIP_TEAM_WARPS
#define KMANIP_TEAM_WARPS 4
#endif

namespace kmanip {

// lanes per team and warps per block; at torso width one warp-wide team
// per block, whose working set (~20 KB) would overflow 48 KB of static
// shared memory four times over
template <int NQ>
__host__ __device__ constexpr int team_lanes() {
  return NQ <= 16 ? KMANIP_SOLO_LANES : 32;
}
template <int NQ>
__host__ __device__ constexpr int team_warps() {
  return NQ <= 16 ? KMANIP_TEAM_WARPS : 1;
}

template <int NQ, int T, bool CONTACT, bool IMPLICIT>
__global__ void __launch_bounds__(32 * team_warps<NQ>())
    substep_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i,
                   StepConsts c, int K, const float* __restrict__ qpos,
                   const float* __restrict__ qvel, const float* __restrict__ ctrl,
                   const float* __restrict__ cube13, float* __restrict__ qpos_out,
                   float* __restrict__ qvel_out, float* __restrict__ cube_out,
                   bool* __restrict__ touch_out, float* __restrict__ xpos_out,
                   float* __restrict__ xquat_out) {
  constexpr int S = team_lanes<NQ>(), NT = 32 * team_warps<NQ>(), W = NT / S;
  __shared__ TeamModel<NQ, T> M;
  __shared__ TeamWork<NQ, T> s[W];
  KMANIP_PHASE_START();
  team_model_load(M, (int)threadIdx.x, NT, model_f, model_i, c, IMPLICIT, BlockSync{});
  const int team = threadIdx.x / S;
  const int row = blockIdx.x * W + team;
  substep_team_row<NQ, T, CONTACT, IMPLICIT>(
      typename TeamOf<S>::type{(int)threadIdx.x % S}, M, s[team], c, row < K ? row : K - 1,
      row < K, qpos, qvel, ctrl, cube13, qpos_out, qvel_out, cube_out, touch_out, xpos_out,
      xquat_out);
  KMANIP_PHASE_STOP();
}

template <int NQ, int T, bool CONTACT, bool IMPLICIT>
cudaError_t launch(int K, cudaStream_t stream, const void* mf, const void* mi, StepConsts c,
                   const void* qpos, const void* qvel, const void* ctrl, const void* cube13,
                   void* qpos_out, void* qvel_out, void* cube_out, void* touch_out,
                   void* xpos_out, void* xquat_out) {
  constexpr int NT = 32 * team_warps<NQ>(), W = NT / team_lanes<NQ>();
  substep_kernel<NQ, T, CONTACT, IMPLICIT><<<(K + W - 1) / W, NT, 0, stream>>>(
      (const float*)mf, (const int*)mi, c, K, (const float*)qpos, (const float*)qvel,
      (const float*)ctrl, (const float*)cube13, (float*)qpos_out, (float*)qvel_out,
      (float*)cube_out, (bool*)touch_out, (float*)xpos_out, (float*)xquat_out);
  return cudaGetLastError();
}

template <int NQ, int T>
cudaError_t launch_modes(int K, cudaStream_t s, const void* mf, const void* mi, StepConsts c,
                         int contact, int implicit, const void* qpos, const void* qvel,
                         const void* ctrl, const void* cube13, void* qo, void* vo, void* co,
                         void* to, void* xp, void* xq) {
  if (contact && implicit)
    return launch<NQ, T, true, true>(K, s, mf, mi, c, qpos, qvel, ctrl, cube13, qo, vo, co, to,
                                     xp, xq);
  if (contact)
    return launch<NQ, T, true, false>(K, s, mf, mi, c, qpos, qvel, ctrl, cube13, qo, vo, co,
                                      to, xp, xq);
  if (implicit)
    return launch<NQ, T, false, true>(K, s, mf, mi, c, qpos, qvel, ctrl, cube13, qo, vo, co,
                                      to, xp, xq);
  return launch<NQ, T, false, false>(K, s, mf, mi, c, qpos, qvel, ctrl, cube13, qo, vo, co, to,
                                     xp, xq);
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
    return (int)launch_modes<10, 2>(K, s, model_f, model_i, c, contact, implicit, qpos, qvel,
                                    ctrl, cube13, qpos_out, qvel_out, cube_out, touch_out,
                                    xpos_out, xquat_out);
#ifndef KMANIP_SOLO_ONLY  // set for the solo-width alternates that chip_smoke.py times
  if (nq == 20 && T == 4)
    return (int)launch_modes<20, 4>(K, s, model_f, model_i, c, contact, implicit, qpos, qvel,
                                    ctrl, cube13, qpos_out, qvel_out, cube_out, touch_out,
                                    xpos_out, xquat_out);
#endif
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
