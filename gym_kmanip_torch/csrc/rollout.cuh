// Device functions of the whole-horizon pick-cost rollout kernel (K2):
// H control steps of n_substeps substeps and the cube-pick cost
// (pallas_substep.py::_rollout_pick_kernel with _pick_cost_row and
// _table_touch_row). rollout_pick_team is the kernel's body, one team of
// lanes per candidate sequence on the team substep (substep_team.cuh);
// rollout_pick_thread, one rollout on one thread over substep_core, is its
// serial reference, which the host build holds it to bit for bit and no
// kernel launches. Kept in a header behind __device__ only, so the host test
// harness compiles it as C++.
#pragma once

#include "substep_team.cuh"

namespace kmanip {

constexpr double PICK_EPSILON = 1e-6;  // constants.EPSILON

// The cube-pick cost's weights and gripper sites (built on the host from
// ops/rollout_pick_cuda.PickCostSpec and the model's sites).
struct PickSpec {
  float w_vel, w_grip_dist, w_touch, w_lift, w_ctrl;
  int n_sites;  // 0, 1 or 2 gripper sites whose distance to the cube counts
  int site_parent[2];
  float site_off[2][3];  // site position in its parent's frame
};

// The spec from its host arrays (ops/rollout_pick_cuda.spec_arrays):
// spec_f = 5 weights, then two site offsets; spec_i = n_sites, then two
// site parents.
inline PickSpec make_pick_spec(const float* spec_f, const int* spec_i) {
  PickSpec spec;
  spec.w_vel = spec_f[0];
  spec.w_grip_dist = spec_f[1];
  spec.w_touch = spec_f[2];
  spec.w_lift = spec_f[3];
  spec.w_ctrl = spec_f[4];
  spec.n_sites = spec_i[0];
  for (int s = 0; s < 2; ++s) {
    spec.site_parent[s] = spec_i[1 + s];
    for (int j = 0; j < 3; ++j) spec.site_off[s][j] = spec_f[5 + 3 * s + j];
  }
  return spec;
}

// Corner c of the cube below the table top while over the table
// (contacts.cube_table's `touching` is any corner's).
__device__ __forceinline__ bool corner_on_table(const M3& R, const Cube& cube, int c) {
  V3 arm, vc;
  float pen;
  bool over;
  corner_state(R, cube, c, arm, pen, vc, over);
  return pen > 0.f && over;
}

__device__ __forceinline__ bool cube_on_table(const Cube& cube) {
  const M3 R = quat_to_mat(cube.quat);
  bool touching = false;
  for (int c = 0; c < 8; ++c) touching = touching || corner_on_table(R, cube, c);
  return touching;
}

// mpc/cost.cube_pick_cost for one rollout at one control step, with
// mpc_step's time alignment: post-step q, v and cube; the PRE-step frames
// (x, qq) of the last substep for the sites; that substep's touch flags;
// `table`, the table touch of the post-step cube.
template <int NQ, int T>
__device__ float pick_cost_step(const ModelView<NQ, T>& m, const PickSpec& s, const float* q,
                                const float* v, const Cube& cube, const float* u,
                                const bool* touch, const V3* x, const Q4* qq, bool table) {
  float sq = 0.f;
  for (int i = 0; i < NQ; ++i) sq = sq + v[i] * v[i];
  sq = sq + dot(cube.lv, cube.lv);
  sq = sq + dot(cube.av, cube.av);
  float c = s.w_vel * sqrtf(fmaxf(sq, 1e-16f));
  for (int i = 0; i < s.n_sites; ++i) {
    int par = s.site_parent[i];
    V3 p = x[par] + qrot(qq[par], V3{s.site_off[i][0], s.site_off[i][1], s.site_off[i][2]});
    V3 d = cube.pos - p;
    c = c - s.w_grip_dist / (sqrtf(dot(d, d)) + (float)PICK_EPSILON);
  }
  bool touched = false;
  for (int t = 0; t < T; ++t) touched = touched || touch[t];
  c = c - (touched ? s.w_touch : 0.f);
  c = c - ((touched && !table) ? s.w_lift : 0.f);
  const int nu = m.nu();
  float effort = 0.f;
  for (int i = 0; i < nu; ++i) {
    float e = u[i] - q[i];
    effort = effort + e * e;
  }
  return c + s.w_ctrl * effort;
}

// Rollout k: H control steps of n_substeps substeps from the shared
// state0 = [qpos (NQ), qvel (NQ), cube13], controls ctrl_seqs[k] (H, nu);
// returns the summed pick cost. The team kernel's serial reference.
template <int NQ, int T>
__device__ float rollout_pick_thread(int k, const ModelView<NQ, T>& m, const StepConsts& c,
                                     bool contact, bool implicit, int n_substeps, int H,
                                     const PickSpec& spec, const float* __restrict__ ctrl_seqs,
                                     const float* __restrict__ state0) {
  const int nu = m.nu();
  float q[NQ], v[NQ], u[NQ];
  for (int i = 0; i < NQ; ++i) {
    q[i] = state0[i];
    v[i] = state0[NQ + i];
    u[i] = 0.f;
  }
  Cube cube = cube_from(state0 + 2 * NQ);
  bool touch[T];
  V3 x[NQ];
  Q4 qq[NQ];
  float total = 0.f;
  for (int h = 0; h < H; ++h) {
    const float* uk = ctrl_seqs + ((long)k * H + h) * nu;
    for (int i = 0; i < nu; ++i) u[i] = uk[i];
    for (int s = 0; s < n_substeps; ++s)
      substep_core<NQ, T>(m, c, contact, implicit, q, v, u, cube, touch, x, qq);
    total = total + pick_cost_step<NQ, T>(m, spec, q, v, cube, u, touch, x, qq,
                                          contact && cube_on_table(cube));
  }
  return total;
}

// Copies step h's nu controls of the team's sequence into `stage` without
// waiting.
template <class Team>
__device__ __forceinline__ void stage_controls(const Team& team, int h, int nu, float* stage,
                                               const float* __restrict__ seq) {
  for (int i = team.lane; i < nu; i += Team::SIZE) copy_async(stage + i, seq + (long)h * nu + i);
  copy_commit();
}

// The kernel's body for the candidate sequence seq = ctrl_seqs[k] (H, nu):
// rollout_pick_thread on a team, the state in the lanes' registers and in
// s, each step's controls copied into the double-buffered `stage` (2 NQ
// floats of shared memory) while the step before runs. The pick cost of
// each step runs in pick_cost_step's order on lane 0, the table touch one
// corner per lane and OR-ed across the team. Returns the total on lane 0
// (0 on the others). M is loaded; every lane of the team calls this.
template <int NQ, int T, bool CONTACT, bool IMPLICIT, class Team>
__device__ float rollout_pick_team(const Team& team, const TeamModel<NQ, T>& M,
                                   TeamWork<NQ, T>& s, float* stage, const StepConsts& c,
                                   int n_substeps, int H, const PickSpec& spec,
                                   const float* __restrict__ seq,
                                   const float* __restrict__ state0) {
  constexpr int S = Team::SIZE;
  using LC = LaneConsts<NQ, T, S>;
  using CN = Corners<S>;
  const int lane = team.lane;
  const ModelView<NQ, T> m{M.mf, M.mi};
  const LC k = lane_consts<NQ, T, S>(M, lane, c);
  const int nu = k.nu;
  LaneState<LC::RPL> st;
#pragma unroll
  for (int r = 0; r < LC::RPL; ++r) {
    const int i = lane + r * S < NQ ? lane + r * S : NQ - 1;
    st.q[r] = state0[i];
    st.v[r] = state0[NQ + i];
    st.u[r] = 0.f;
  }
  for (int i = lane; i < NQ; i += S) {
    s.q[i] = state0[i];
    s.v[i] = state0[NQ + i];
  }
  if (lane == 0) s.cube = cube_from(state0 + 2 * NQ);
  if (H > 0) stage_controls(team, 0, nu, stage, seq);
  float total = 0.f;
  KMANIP_PHASE(11);  // the model's load, the lane constants, the start state
  for (int h = 0; h < H; ++h) {
    copy_wait_all();
    team.sync();
    const float* u = stage + (h & 1) * NQ;
    if (h + 1 < H) stage_controls(team, h + 1, nu, stage + ((h + 1) & 1) * NQ, seq);
#pragma unroll
    for (int r = 0; r < LC::RPL; ++r) {
      const int i = lane + r * S;
      if (i < nu) st.u[r] = u[i];
    }
    KMANIP_PHASE(0);  // the copies' wait, the step's controls
    for (int sub = 0; sub < n_substeps; ++sub)
      substep_team<NQ, T, CONTACT, IMPLICIT, true>(team, m, c, k, st, M, s);
    team.sync();
    KMANIP_PHASE(7);  // integration
    bool table = false;
    if (CONTACT) {
      const Cube cube = s.cube;
      const M3 R = quat_to_mat(cube.quat);
#pragma unroll
      for (int r = 0; r < CN::PER_LANE; ++r) {
        const int cc = CN::of(lane, r);
        if (cc >= 0) table = table || corner_on_table(R, cube, cc);
      }
      table = team.max(table ? 1.f : 0.f) > 0.f;
    }
    if (lane == 0)
      total = total + pick_cost_step<NQ, T>(m, spec, s.q, s.v, s.cube, u, s.touch, s.x, s.qq,
                                            table);
    KMANIP_PHASE(10);  // the pick cost
  }
  team.sync();  // a team that runs another sequence next waits for lane 0's reads
  return total;
}

}  // namespace kmanip
