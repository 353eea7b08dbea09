// The staged substep's FK + RNEA (K5, rnea.cu), contact model (K6,
// contacts.cu) and SPD solve (K7, chol_solve.cu), one team of lanes per
// item, on the team substep's device functions (substep_team.cuh): K5 runs
// its FK, inertial loads and backward pass (fk_team, inertial_loads_team,
// rnea_backward_team), K6 its contact lanes (contacts_team), K7 its
// Cholesky factor (chol_factor_team) and substitutions (solve_lower_regs,
// solve_upper_regs). Each agrees bit for bit with the serial per-item code
// of staged.cuh (rnea_item, contacts_item, chol_solve_item), held on the
// host build with one thread and with a team of threads behind a barrier.
//
// No tensor cores: K7's products are n <= 24 wide, in FP32, in the fixed
// order of chol_factor and chol_solve; a TF32 mma would round them
// otherwise, and the staged route is held to the plain version's rounding.
#pragma once

#include "substep_team.cuh"

namespace kmanip {

// ---- K5: FK + RNEA ----

// What FK + RNEA read of the packed model, which a block shares: the
// prefixes of its floats (jnt_pos, jnt_quat, mass, com, inertia) and of its
// ints (parent, jnt_type), so a ModelView over them serves those accessors;
// and each joint's depth in the tree. The rest (ancestors, actuation,
// limits, fingertips: 7 NQ + 4 T floats and NQ^2 + T + 1 ints) is not read.
template <int NQ>
struct TreeModel {
  using MV = ModelView<NQ, 0>;
  static constexpr int N_FLOATS = MV::F_ARMATURE, N_INTS = MV::I_ANC;
  static_assert(MV::F_JPOS + 3 * NQ <= N_FLOATS && MV::F_JQUAT + 4 * NQ <= N_FLOATS &&
                    MV::F_MASS + NQ <= N_FLOATS && MV::F_COM + 3 * NQ <= N_FLOATS &&
                    MV::F_INERTIA + 3 * NQ <= N_FLOATS,
                "FK + RNEA's floats must lie before the armature in ModelView's layout");
  static_assert(MV::I_PARENT + NQ <= N_INTS && MV::I_TYPE + NQ <= N_INTS,
                "the parents and joint types must lie before the ancestors in ModelView's layout");
  float mf[N_FLOATS];
  int mi[N_INTS];
  int depth[NQ];
  int max_depth;
};

// Copies the tree's part of the model into M and derives the joints'
// depths; thread tid of nthreads, `sync` a barrier over all of them.
template <int NQ, class Sync>
__device__ void tree_model_load(TreeModel<NQ>& M, int tid, int nthreads,
                                const float* __restrict__ mf, const int* __restrict__ mi,
                                const Sync& sync) {
  using TM = TreeModel<NQ>;
  for (int e = tid; e < TM::N_FLOATS; e += nthreads) M.mf[e] = mf[e];
  for (int e = tid; e < TM::N_INTS; e += nthreads) M.mi[e] = mi[e];
  sync();
  const ModelView<NQ, 0> m{M.mf, M.mi};
  for (int i = tid; i < NQ; i += nthreads) M.depth[i] = joint_depth(m, i);
  sync();
  if (tid == 0) {
    int md = 0;
    for (int i = 0; i < NQ; ++i) md = M.depth[i] > md ? M.depth[i] : md;
    M.max_depth = md;
  }
  sync();
}

// One team's working set: the frames, velocities, accelerations and
// loads of one rollout's joints.
template <int NQ>
struct TreeWork {
  V3 x[NQ], axis[NQ], w[NQ], vb[NQ], alpha[NQ], a[NQ], F[NQ], Nt[NQ];
  alignas(16) Q4 qq[NQ];
};

// K5's body: rnea_item for row `row` of qpos, qvel (K, NQ) on a team, each
// lane its joints' rows of xpos (K, NQ, 3), xquat (K, NQ, 4), axis (K, NQ,
// 3) and bias (K, NQ); `valid` false runs the row without writing it (an
// idle team of the block's last rollouts). M is loaded; every lane of the
// team calls this.
template <int NQ, class Team>
__device__ void rnea_team_row(const Team& team, const TreeModel<NQ>& M, TreeWork<NQ>& s, int row,
                              bool valid, const float* __restrict__ qpos,
                              const float* __restrict__ qvel, float* __restrict__ xpos,
                              float* __restrict__ xquat, float* __restrict__ axis_out,
                              float* __restrict__ bias_out) {
  constexpr int S = Team::SIZE, RPL = TreeConsts<NQ, S>::RPL;
  const int lane = team.lane;
  TreeConsts<NQ, S> k;
  load_tree_consts<NQ, 0, S>(k, ModelView<NQ, 0>{M.mf, M.mi}, M.depth, lane);
  float q[RPL], v[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S < NQ ? lane + r * S : NQ - 1;
    q[r] = qpos[(long)row * NQ + i];
    v[r] = qvel[(long)row * NQ + i];
  }
  fk_team<NQ, S>(team, k, M.max_depth, q, v, s);
  // no sync after the loads: the backward pass's first level (the deepest)
  // reads only each lane's own joints, and syncs before the next reads a
  // child's
  V3 cb[RPL];
  inertial_loads_team<NQ, S>(lane, k, s, cb);
  float bias[RPL];
  V3 axr[RPL], xr[RPL];
  rnea_backward_team<NQ, S>(team, k, M.max_depth, cb, s, bias, axr, xr);
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
    if (i >= NQ) continue;
    const long o = (long)row * NQ + i;
    const Q4 qq = s.qq[i];
    xpos[o * 3] = xr[r].x;
    xpos[o * 3 + 1] = xr[r].y;
    xpos[o * 3 + 2] = xr[r].z;
    xquat[o * 4] = qq.w;
    xquat[o * 4 + 1] = qq.x;
    xquat[o * 4 + 2] = qq.y;
    xquat[o * 4 + 3] = qq.z;
    axis_out[o * 3] = axr[r].x;
    axis_out[o * 3 + 1] = axr[r].y;
    axis_out[o * 3 + 2] = axr[r].z;
    bias_out[o] = bias[r];
  }
}

// ---- K6: the contact model ----

// One team's working set: what contacts_team's lanes pass to each other.
template <int T>
struct ContactWork {
  V3 tip_fc[T], tip_tc[T];  // each tip's force on the cube and its moment
  V3 tip_f[T];              // the force on each tip
  bool touch[T];
  float corner_pen[8];
  bool corner_table[8];     // each corner on the table, penetrating
  V3 corner_fc[8], corner_tc[8];  // each corner's force on the cube and its moment
};

// Floats of a block's stage for `items` items of T tips: per item tip_pos,
// tip_vel (3 T each), cube_pos (3), cube_quat (4), cube_linvel and
// cube_angvel (3 each); then the T fingertip radii.
template <int T>
KMANIP_HD constexpr int contact_stage_floats(int items) {
  return items * (6 * T + 13) + T;
}

// K6's block: contacts_item for items item0 .. item0 + items - 1 of the
// caller's (K, ...) tensors (fewer at the batch's end), one team per item;
// thread tid of nthr = items * SIZE, `sync` a barrier over all of them.
// The block copies its items' rows of each input into `stage` (consecutive
// threads on consecutive words: the rows are contiguous), and the T
// fingertip radii `radius` (the packed model's) with them, then team j runs
// contacts_team on item j; a team past the batch's end runs the block's
// last item and stores nothing. Tip t's lane writes the item's tip_forces
// and touch_tip rows, lane SIZE - 1 its force, torque and touch_table.
template <int T, class Team, class Sync>
__device__ void contacts_block(int tid, int nthr, const Team& team, const Sync& sync, int items,
                               long item0, int K, const float* radius, float* stage,
                               ContactWork<T>* work, const float* __restrict__ tip_pos,
                               const float* __restrict__ tip_vel,
                               const float* __restrict__ cube_pos,
                               const float* __restrict__ cube_quat,
                               const float* __restrict__ cube_lv,
                               const float* __restrict__ cube_av, float* __restrict__ force_out,
                               float* __restrict__ torque_out, float* __restrict__ tip_forces,
                               bool* __restrict__ touch_tip, bool* __restrict__ touch_table) {
  constexpr int S = Team::SIZE, TF = 3 * T;
  KMANIP_PHASE_START();
  const int n_items = K - item0 < items ? (int)(K - item0) : items;
  float* s_tp = stage;
  float* s_tv = s_tp + items * TF;
  float* s_cp = s_tv + items * TF;
  float* s_cq = s_cp + items * 3;
  float* s_cl = s_cq + items * 4;
  float* s_ca = s_cl + items * 3;
  float* s_rad = s_ca + items * 3;
  const auto rows = [&](float* dst, const float* src, int width) {
    for (int e = tid; e < n_items * width; e += nthr) copy_async(dst + e, src + item0 * width + e);
  };
  for (int e = tid; e < T; e += nthr) copy_async(s_rad + e, radius + e);
  rows(s_tp, tip_pos, TF);
  rows(s_tv, tip_vel, TF);
  rows(s_cp, cube_pos, 3);
  rows(s_cq, cube_quat, 4);
  rows(s_cl, cube_lv, 3);
  rows(s_ca, cube_av, 3);
  copy_commit();
  copy_wait_all();
  sync();
  KMANIP_PHASE(0);  // the stage
  const int t = tid / S;
  const int j = t < n_items ? t : n_items - 1;
  const float *cp = s_cp + 3 * j, *cq = s_cq + 4 * j, *cl = s_cl + 3 * j, *ca = s_ca + 3 * j;
  const Cube cube{{cp[0], cp[1], cp[2]}, {cq[0], cq[1], cq[2], cq[3]}, {cl[0], cl[1], cl[2]},
                  {ca[0], ca[1], ca[2]}};
  ContactWork<T>& w = work[t];
  V3 force, torque;
  bool touching;
  contacts_team<T>(team, cube, s_tp + j * TF, s_tv + j * TF, s_rad, w, force, torque, touching);
  if (t >= n_items) return;
  const long k = item0 + j;
  for (int tip = team.lane; tip < T; tip += S) {
    float* f = tip_forces + (k * T + tip) * 3;
    f[0] = w.tip_f[tip].x;
    f[1] = w.tip_f[tip].y;
    f[2] = w.tip_f[tip].z;
    touch_tip[k * T + tip] = w.touch[tip];
  }
  if (team.lane == S - 1) {
    force_out[k * 3] = force.x;
    force_out[k * 3 + 1] = force.y;
    force_out[k * 3 + 2] = force.z;
    torque_out[k * 3] = torque.x;
    torque_out[k * 3 + 1] = torque.y;
    torque_out[k * 3 + 2] = torque.z;
    touch_table[k] = touching;
  }
  KMANIP_PHASE(3);  // the sums (lane SIZE - 1) and the outputs
  KMANIP_PHASE_STOP();
}

// ---- K7: the SPD solve ----

// Floats of a team's scratch for an N x N solve: the factor's packed rows,
// its diagonal and the diagonal's reciprocals.
template <int N>
KMANIP_HD constexpr int chol_scratch() {
  return N * (N + 1) / 2 + 2 * N;
}

// K7's body: x = M^-1 b for one item on a team, chol_solve_item's
// arithmetic. Mk is the item's N x N matrix (row-major; its lower triangle
// is read), bk its right side; lane i takes row i. L is the team's scratch
// (chol_scratch<N>() floats). With `store`, row i's lane writes x[i] to
// xk[i]. Both substitutions run in every lane in registers, from the
// factor's packed rows in L: each element sees chol_solve's subtractions in
// its order, and each division is div_by's correctly rounded quotient.
template <int N, class Team>
__device__ void chol_solve_team(const Team& team, const float* Mk, const float* bk, float* L,
                                float* __restrict__ xk, bool store) {
  constexpr int S = Team::SIZE, RPL = (N + S - 1) / S;
  const int lane = team.lane;
  float row[RPL][N];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
#pragma unroll
    for (int kk = 0; kk < N; ++kk) row[r][kk] = (i < N && kk <= i) ? Mk[i * N + kk] : 0.f;
  }
  float* Ld = L + N * (N + 1) / 2;
  float* Lr = Ld + N;
  chol_factor_team<N>(team, row, Ld, Lr);
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
#pragma unroll
    for (int kk = 0; kk < N; ++kk)
      if (kk < i && i < N) L[tri(i, kk)] = row[r][kk];
  }
  team.sync();
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) y[i] = bk[i];
  solve_lower_regs<N>(L, Ld, Lr, y);
  solve_upper_regs<N>(L, Ld, Lr, y);
  if (!store) return;
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
    if (i < N) xk[i] = pick<N>(y, i);
  }
}

}  // namespace kmanip
