// Device functions of the whole-horizon pick-cost rollout kernel (K2), one
// rollout per thread, built on substep_core (substep.cuh):
// rollout_pick_thread runs the (H-step) rollout and the cube-pick cost
// (pallas_substep.py::_rollout_pick_kernel with _pick_cost_row and
// _table_touch_row). Kept in a header behind __device__ only, so the host
// test harness compiles it as C++ and holds it to its plain PyTorch
// version.
#pragma once

#include "substep.cuh"

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

// contacts.cube_table's `touching`: any cube corner below the table top
// while over the table.
__device__ __forceinline__ bool cube_on_table(const Cube& cube) {
  const M3 R = quat_to_mat(cube.quat);
  const float h = (float)CUBE_HALF;
  bool touching = false;
  for (int c = 0; c < 8; ++c) {
    float sx = (c & 4) ? 1.f : -1.f, sy = (c & 2) ? 1.f : -1.f, sz = (c & 1) ? 1.f : -1.f;
    V3 cw = cube.pos + rmul(R, V3{sx * h, sy * h, sz * h});
    bool over = fabsf(cw.x - (float)TABLE_X) < (float)TABLE_HALF_X &&
                fabsf(cw.y - (float)TABLE_Y) < (float)TABLE_HALF_Y;
    float pen = (over ? (float)TABLE_TOP_Z : 0.f) - cw.z;
    touching = touching || (pen > 0.f && over);
  }
  return touching;
}

// mpc/cost.cube_pick_cost for one rollout at one control step, with
// mpc_step's time alignment: post-step q, v and cube; the PRE-step frames
// (x, qq) of the last substep for the sites; that substep's touch flags;
// the table touch of the post-step cube.
template <int NQ, int T>
__device__ float pick_cost_step(const ModelView<NQ, T>& m, const PickSpec& s, bool contact,
                                const float* q, const float* v, const Cube& cube,
                                const float* u, const bool* touch, const V3* x,
                                const Q4* qq) {
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
  bool table = contact && cube_on_table(cube);
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
// returns the summed pick cost.
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
  const float* cb = state0 + 2 * NQ;
  Cube cube{{cb[0], cb[1], cb[2]}, {cb[3], cb[4], cb[5], cb[6]}, {cb[7], cb[8], cb[9]},
            {cb[10], cb[11], cb[12]}};
  bool touch[T];
  V3 x[NQ];
  Q4 qq[NQ];
  float total = 0.f;
  for (int h = 0; h < H; ++h) {
    const float* uk = ctrl_seqs + ((long)k * H + h) * nu;
    for (int i = 0; i < nu; ++i) u[i] = uk[i];
    for (int s = 0; s < n_substeps; ++s)
      substep_core<NQ, T>(m, c, contact, implicit, q, v, u, cube, touch, x, qq);
    total = total + pick_cost_step<NQ, T>(m, spec, contact, q, v, cube, u, touch, x, qq);
  }
  return total;
}

}  // namespace kmanip
