// The whole (K, H) rollout and the cube-pick cost in one launch: the CUDA
// replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_substep.py::rollout_pick_costs (kernel
// _rollout_pick_kernel). The arithmetic lives in rollout.cuh, on the team
// substep of substep_team.cuh; this file holds the kernel and its C entry
// point.
//
// Design: one team of lanes per candidate sequence for the whole horizon,
// a warp in a block of its own. The block copies the packed model into
// shared memory once; each lane keeps its joints' constants and state in
// registers, the team its frames, mass matrix and cube in shared memory.
// Each control step's nu controls are copied into a double-buffered shared
// stage (cp.async) while the step before runs; the step's pick cost runs on
// lane 0 in the reference's order, the cube's table touch one corner per
// lane, OR-ed across the team. Only the (K,) total is written. contact and
// implicit actuation are compile-time choices. The team width and warps
// per block are build constants: chip_smoke.py builds the solo-width
// alternatives (16-lane teams; four warps per block, the model's copy
// shared) and times them beside these; 16 lanes were slower and four warps
// per block no faster on an H100 (PERF.md §6).
//
// What bounds it: latency and the team's instruction issue, H x n_substeps
// dependent substeps per team (per substep: the tree's levels with a sync
// each, the contact lanes, the cube's integration on one lane, the factor's
// shuffles, four triangular solves in registers; then the pick cost on one
// lane). At the MPPI batch K = 256 that is 256 warps on the 132 SMs, about
// two per SM, each on a sub-partition of its own, so a launch takes one
// team's chain. Bytes (the controls, H x nu floats per sequence) and FLOPs
// are far below the card's rates.

#include <cuda_runtime.h>

#include "rollout.cuh"

// Lanes per team at solo width, and warps per block (chip_smoke.py builds
// the other choices with -D to time them beside these).
#ifndef KMANIP_SOLO_LANES
#define KMANIP_SOLO_LANES 32
#endif
#ifndef KMANIP_TEAM_WARPS
#define KMANIP_TEAM_WARPS 1
#endif

namespace kmanip {

// lanes per team and warps per block; at torso width one warp-wide team
// per block (see substep.cu)
template <int NQ>
__host__ __device__ constexpr int pick_lanes() {
  return NQ <= 16 ? KMANIP_SOLO_LANES : 32;
}
template <int NQ>
__host__ __device__ constexpr int pick_warps() {
  return NQ <= 16 ? KMANIP_TEAM_WARPS : 1;
}

template <int NQ, int T, bool CONTACT, bool IMPLICIT>
__global__ void __launch_bounds__(32 * pick_warps<NQ>())
    rollout_pick_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i,
                        StepConsts c, int n_substeps, int K, int H, PickSpec spec,
                        const float* __restrict__ ctrl_seqs, const float* __restrict__ state0,
                        float* __restrict__ cost_out) {
  constexpr int S = pick_lanes<NQ>(), NT = 32 * pick_warps<NQ>(), W = NT / S;
  __shared__ TeamModel<NQ, T> M;
  __shared__ TeamWork<NQ, T> s[W];
  __shared__ float stage[W][2 * NQ];
  KMANIP_PHASE_START();
  team_model_load(M, (int)threadIdx.x, NT, model_f, model_i, c, IMPLICIT, BlockSync{});
  const int team = threadIdx.x / S, lane = threadIdx.x % S;
  const int k = blockIdx.x * W + team;
  const long nu = ModelView<NQ, T>{M.mf, M.mi}.nu();
  const float total = rollout_pick_team<NQ, T, CONTACT, IMPLICIT>(
      typename TeamOf<S>::type{lane}, M, s[team], stage[team], c, n_substeps, H, spec,
      ctrl_seqs + (long)(k < K ? k : K - 1) * H * nu, state0);
  if (lane == 0 && k < K) cost_out[k] = total;
  KMANIP_PHASE_STOP();
}

template <int NQ, int T, bool CONTACT, bool IMPLICIT>
cudaError_t launch_pick(int K, cudaStream_t stream, const void* mf, const void* mi,
                        StepConsts c, int n_substeps, int H, const PickSpec& spec,
                        const void* ctrl_seqs, const void* state0, void* cost_out) {
  constexpr int NT = 32 * pick_warps<NQ>(), W = NT / pick_lanes<NQ>();
  rollout_pick_kernel<NQ, T, CONTACT, IMPLICIT><<<(K + W - 1) / W, NT, 0, stream>>>(
      (const float*)mf, (const int*)mi, c, n_substeps, K, H, spec, (const float*)ctrl_seqs,
      (const float*)state0, (float*)cost_out);
  return cudaGetLastError();
}

template <int NQ, int T>
cudaError_t launch_pick_modes(int K, cudaStream_t st, const void* mf, const void* mi,
                              StepConsts c, int contact, int implicit, int n_substeps, int H,
                              const PickSpec& spec, const void* ctrl_seqs, const void* state0,
                              void* cost_out) {
  if (contact && implicit)
    return launch_pick<NQ, T, true, true>(K, st, mf, mi, c, n_substeps, H, spec, ctrl_seqs,
                                          state0, cost_out);
  if (contact)
    return launch_pick<NQ, T, true, false>(K, st, mf, mi, c, n_substeps, H, spec, ctrl_seqs,
                                           state0, cost_out);
  if (implicit)
    return launch_pick<NQ, T, false, true>(K, st, mf, mi, c, n_substeps, H, spec, ctrl_seqs,
                                           state0, cost_out);
  return launch_pick<NQ, T, false, false>(K, st, mf, mi, c, n_substeps, H, spec, ctrl_seqs,
                                          state0, cost_out);
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
    return (int)launch_pick_modes<10, 2>(K, st, model_f, model_i, c, contact, implicit,
                                         n_substeps, H, spec, ctrl_seqs, state0, cost_out);
#ifndef KMANIP_SOLO_ONLY  // set for the solo-width alternates that chip_smoke.py times
  if (nq == 20 && T == 4)
    return (int)launch_pick_modes<20, 4>(K, st, model_f, model_i, c, contact, implicit,
                                         n_substeps, H, spec, ctrl_seqs, state0, cost_out);
#endif
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
