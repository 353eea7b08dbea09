// Batched penalty contacts (fingertip spheres vs the cube, then the cube's
// corners vs the table) in one launch: the CUDA replacement of the JAX
// package's Pallas TPU kernel
// gym_kmanip_tpu/ops/pallas_contacts.py::contact_forces_batched (its body
// _contact_rows). The per-item arithmetic is staged.cuh::contacts_item's
// (substep.cuh::contact_rows), run by a team of lanes:
// staged_team.cuh::contacts_block.
//
// Design: one team per rollout, on the team substep's contact lanes
// (substep_team.cuh::contacts_team, which K1 and K2 run inside their
// substep): each fingertip on a lane of its own and each cube corner on a
// lane of its own, so the tips' sphere-box tests and the corners' states
// against the table run at once; a sync; each corner's a0 (after the tips'
// force on the cube) and its force on its lane; a sync; then the last lane
// sums the tips' and corners' forces in contact_rows' order. A team is a
// warp: the T tips on lanes 0 .. T-1 and the 8 corners on lanes 24 .. 31
// (Corners<32>), four warps per block. (Half-warp teams, two rollouts per
// warp with the corners on lanes 8 .. 15, build with
// -DKMANIP_CONTACT_LANES=16: within 3%, and chip_smoke.py times them
// beside; PERF.md §6.) A block's rollouts are contiguous, so it copies
// their rows of the six inputs into shared memory with consecutive threads
// on consecutive words (cp.async), and each lane reads its item from
// there; tip t's lane stores the item's tip force and flag, the last lane
// its force, torque and table flag. The ragged edge is masked: a team past
// the batch's end runs the block's last rollout and stores nothing, so
// every lane reaches every sync. Instantiated for (nq, fingertips) =
// (10, 2) and (20, 4); the fingertip radii come from the substep kernel's
// packed model (ops/substep_cuda.py).
//
// What bounds it: latency. A team's chain is one sphere-box test and
// impedance force (the tips' lanes) or one corner state (the corners'),
// then one corner's a0 and force, then 2 T + 16 vector additions on one
// lane, each behind a sync; the bytes (25 floats in, 12 floats and 3 flags
// out per rollout at T = 2) are ~39 KB at K = 256, in 64 blocks. The
// thread-per-rollout kernel this replaced ran ~1,200 dependent float
// operations per thread on 2 SMs.
//
// Build (ops/_build.py): nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 --fmad=false -shared -Xcompiler -fPIC (the penalty
// contact turns a position ulp into cube velocity with gain kappa dt = 200:
// the plain version's rounding is kept, no contraction).

#include <cuda_runtime.h>

#include "staged_team.cuh"

// Lanes per team: 32 (a warp) or 16 (a half-warp).
#ifndef KMANIP_CONTACT_LANES
#define KMANIP_CONTACT_LANES 32
#endif

namespace kmanip {

constexpr int CONTACT_LANES = KMANIP_CONTACT_LANES;
constexpr int CONTACT_THREADS = 128;  // four warps
constexpr int CONTACT_ITEMS = CONTACT_THREADS / CONTACT_LANES;  // rollouts per block

template <int NQ, int T>
__global__ void __launch_bounds__(CONTACT_THREADS)
    contacts_kernel(const float* __restrict__ model_f, int K, const float* __restrict__ tip_pos,
                    const float* __restrict__ tip_vel, const float* __restrict__ cube_pos,
                    const float* __restrict__ cube_quat, const float* __restrict__ cube_lv,
                    const float* __restrict__ cube_av, float* __restrict__ force,
                    float* __restrict__ torque, float* __restrict__ tip_forces,
                    bool* __restrict__ touch_tip, bool* __restrict__ touch_table) {
  __shared__ float stage[contact_stage_floats<T>(CONTACT_ITEMS)];
  __shared__ ContactWork<T> work[CONTACT_ITEMS];
  const int tid = threadIdx.x;
  using Team = typename TeamOf<CONTACT_LANES>::type;
  contacts_block<T>(tid, CONTACT_THREADS, Team{tid % CONTACT_LANES}, BlockSync{}, CONTACT_ITEMS,
                    (long)blockIdx.x * CONTACT_ITEMS, K,
                    model_f + ModelView<NQ, T>::F_TIPRAD, stage, work, tip_pos, tip_vel,
                    cube_pos, cube_quat, cube_lv, cube_av, force, torque, tip_forces, touch_tip,
                    touch_table);
}

template <int NQ, int T>
cudaError_t launch_contacts(int K, cudaStream_t s, const void* mf, const void* const* in,
                            void* const* out) {
  contacts_kernel<NQ, T><<<(K + CONTACT_ITEMS - 1) / CONTACT_ITEMS, CONTACT_THREADS, 0, s>>>(
      (const float*)mf, K, (const float*)in[0], (const float*)in[1], (const float*)in[2],
      (const float*)in[3], (const float*)in[4], (const float*)in[5], (float*)out[0],
      (float*)out[1], (float*)out[2], (bool*)out[3], (bool*)out[4]);
  return cudaGetLastError();
}

}  // namespace kmanip

extern "C" {

// Launches the contact model for K rollouts on `stream`; returns
// cudaGetLastError() after the launch (0 = launched).
// model_f is the packed model's floats, of which it reads the fingertip
// radii.
int kmanip_contacts(int nq, int T, const void* model_f, int K, const void* tip_pos,
                    const void* tip_vel, const void* cube_pos, const void* cube_quat,
                    const void* cube_lv, const void* cube_av, void* force, void* torque,
                    void* tip_forces, void* touch_tip, void* touch_table, void* stream) {
  using namespace kmanip;
  if (K <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[6] = {tip_pos, tip_vel, cube_pos, cube_quat, cube_lv, cube_av};
  void* out[5] = {force, torque, tip_forces, touch_tip, touch_table};
  if (nq == 10 && T == 2) return (int)launch_contacts<10, 2>(K, s, model_f, in, out);
  if (nq == 20 && T == 4) return (int)launch_contacts<20, 4>(K, s, model_f, in, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
