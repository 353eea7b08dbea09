// The whole (K, H) rollout and the cube-pick cost in one launch: the CUDA
// replacement of the JAX package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_substep.py::rollout_pick_costs (kernel
// _rollout_pick_kernel). The arithmetic lives in rollout.cuh, on the team
// substep of substep_team.cuh; this file holds the kernel and its C entry
// points.
//
// Design: one team of lanes per candidate sequence for the whole horizon:
// a warp, or at solo width (nq <= 16) a half-warp, so that two sequences
// share a warp; a warp in a block of its own. The block copies the packed
// model into shared memory once; each lane keeps its joints' constants and
// state in registers, the team its frames, mass matrix and cube in shared
// memory. Each control step's nu controls are copied into a double-buffered
// shared stage (cp.async) while the step before runs; the step's pick cost
// runs on lane 0 of the team in the reference's order, the cube's table
// touch one corner per lane, OR-ed across the team. Only the (K,) total is
// written. contact and implicit actuation are compile-time choices, and so
// is the team (WarpTeam or HalfWarpTeam): both solo-width instantiations
// are in the library, and the wrapper (ops/rollout_pick_cuda.py) picks one
// per launch from K and the card's counts that kmanip_rollout_pick_resident
// reports. Every sum stays on its lane in substep_core's order whatever the
// team's width, so the two give the same totals bit for bit. The warps per
// block are a build constant: chip_smoke.py builds four warps per block
// and times it beside this; it was no faster on an H100 (PERF.md §6).
//
// What bounds it: latency and the team's instruction issue, H x n_substeps
// dependent substeps per team (per substep: the tree's levels with a sync
// each, the contact lanes, the cube's integration on one lane, the factor's
// shuffles, four triangular solves in registers; then the pick cost on one
// lane). At the MPPI batch K = 256 that is 256 warps on the 132 SMs' 528
// warp schedulers, so a launch takes one team's chain, and the warp team's
// is the shorter. Once the warp teams would share schedulers, the issue
// slots bound it: a solo team does most of its work on 10 of its 32 lanes,
// and a half-warp team issues about as many warp instructions for two
// sequences as a warp team does for one. Bytes (the controls, H x nu floats
// per sequence) and FLOPs are far below the card's rates.

#include <cuda_runtime.h>

#include "rollout.cuh"

// Warps per block (chip_smoke.py builds the other choice with -D to time it
// beside this one).
#ifndef KMANIP_TEAM_WARPS
#define KMANIP_TEAM_WARPS 1
#endif

namespace kmanip {

// warps per block; at torso width one warp-wide team per block (see
// substep.cu)
template <int NQ>
__host__ __device__ constexpr int pick_warps() {
  return NQ <= 16 ? KMANIP_TEAM_WARPS : 1;
}

template <int NQ, int T, bool CONTACT, bool IMPLICIT, class Team>
__global__ void __launch_bounds__(32 * pick_warps<NQ>())
    rollout_pick_kernel(const float* __restrict__ model_f, const int* __restrict__ model_i,
                        StepConsts c, int n_substeps, int K, int H, PickSpec spec,
                        const float* __restrict__ ctrl_seqs, const float* __restrict__ state0,
                        float* __restrict__ cost_out) {
  constexpr int S = Team::SIZE, NT = 32 * pick_warps<NQ>(), W = NT / S;
  // Where two teams share a warp, the second's working set starts S banks
  // after the first's (TeamWork<10, 2> is 1,104 words), so lane i of each
  // half meets another bank at every access that the halves make in step.
  static_assert(S == 32 || sizeof(TeamWork<NQ, T>) / 4 % 32 == S,
                "pad TeamWork so that the teams of a warp start S banks apart");
  __shared__ TeamModel<NQ, T> M;
  __shared__ TeamWork<NQ, T> s[W];
  __shared__ float stage[W][2 * NQ];
  KMANIP_PHASE_START();
  team_model_load(M, (int)threadIdx.x, NT, model_f, model_i, c, IMPLICIT, BlockSync{});
  const int team = threadIdx.x / S, lane = threadIdx.x % S;
  const int k = blockIdx.x * W + team;
  const long nu = ModelView<NQ, T>{M.mf, M.mi}.nu();
  const float total = rollout_pick_team<NQ, T, CONTACT, IMPLICIT>(
      Team{lane}, M, s[team], stage[team], c, n_substeps, H, spec,
      ctrl_seqs + (long)(k < K ? k : K - 1) * H * nu, state0);
  if (lane == 0 && k < K) cost_out[k] = total;
  KMANIP_PHASE_STOP();
}

// A kernel of the library and its launch shape.
using PickKernel = void (*)(const float*, const int*, StepConsts, int, int, int, PickSpec,
                            const float*, const float*, float*);
struct PickLaunch {
  PickKernel kernel;  // nullptr where the library has no such kernel
  int threads, teams;  // per block
};

template <int NQ, int T, class Team>
PickLaunch pick_modes(int contact, int implicit) {
  constexpr int NT = 32 * pick_warps<NQ>(), W = NT / Team::SIZE;
  if (contact && implicit) return {rollout_pick_kernel<NQ, T, true, true, Team>, NT, W};
  if (contact) return {rollout_pick_kernel<NQ, T, true, false, Team>, NT, W};
  if (implicit) return {rollout_pick_kernel<NQ, T, false, true, Team>, NT, W};
  return {rollout_pick_kernel<NQ, T, false, false, Team>, NT, W};
}

// The kernel for the model (nq, T) and the modes on teams of `lanes` lanes:
// 32 for every model, 16 at solo width.
PickLaunch pick_launch(int nq, int T, int lanes, int contact, int implicit) {
  if (nq == 10 && T == 2 && lanes == 32) return pick_modes<10, 2, WarpTeam>(contact, implicit);
  if (nq == 10 && T == 2 && lanes == 16)
    return pick_modes<10, 2, HalfWarpTeam>(contact, implicit);
#ifndef KMANIP_SOLO_ONLY  // set for the solo-width alternate that chip_smoke.py times
  if (nq == 20 && T == 4 && lanes == 32) return pick_modes<20, 4, WarpTeam>(contact, implicit);
#endif
  return {nullptr, 0, 0};
}

}  // namespace kmanip

extern "C" {

// spec_f, spec_i: the cost spec as host arrays (make_pick_spec); lanes: 32
// or, at solo width, 16 per team. Launches on `stream`; returns
// cudaGetLastError() after the launch (0 = launched).
int kmanip_rollout_pick(int nq, int T, int lanes, const void* model_f, const void* model_i,
                        double dt, int contact, int implicit, int n_substeps, int K, int H,
                        const float* spec_f, const int* spec_i, const void* ctrl_seqs,
                        const void* state0, void* cost_out, void* stream) {
  using namespace kmanip;
  if (K <= 0) return (int)cudaSuccess;
  const PickLaunch p = pick_launch(nq, T, lanes, contact, implicit);
  if (p.kernel == nullptr) return (int)cudaErrorInvalidValue;
  const PickKernel kernel = p.kernel;
  kernel<<<(K + p.teams - 1) / p.teams, p.threads, 0, (cudaStream_t)stream>>>(
      (const float*)model_f, (const int*)model_i, make_consts(dt), n_substeps, K, H,
      make_pick_spec(spec_f, spec_i), (const float*)ctrl_seqs, (const float*)state0,
      (float*)cost_out);
  return (int)cudaGetLastError();
}

// What the current device holds at once of the kernel for (nq, T, contact,
// implicit) on teams of `lanes` lanes: *teams, the teams resident on the
// whole card (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the teams
// per block times the SMs), and *sms, its SMs. Returns the CUDA error (0 =
// read).
int kmanip_rollout_pick_resident(int nq, int T, int lanes, int contact, int implicit,
                                 int* teams, int* sms) {
  using namespace kmanip;
  const PickLaunch p = pick_launch(nq, T, lanes, contact, implicit);
  if (p.kernel == nullptr) return (int)cudaErrorInvalidValue;
  int device = 0, blocks = 0;
  *teams = *sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, p.kernel, p.threads, 0);
  if (e == cudaSuccess) *teams = blocks * p.teams * *sms;
  return (int)e;
}

}  // extern "C"
