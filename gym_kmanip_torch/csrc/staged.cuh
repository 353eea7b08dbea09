// Per-item device code of the staged substep's three kernels, one item per
// thread: FK + RNEA (K5), the contact model (K6, which contacts.cu runs so)
// and the dense SPD solve (K7). Each reads its item's rows of the caller's
// row-major (K, ...) tensors, runs the device function that the fused
// substep (substep.cuh) runs for that stage, and writes its item's rows of
// the outputs. rnea.cu and chol_solve.cu run K5 and K7 on teams of lanes
// (staged_team.cuh); rnea_item and chol_solve_item are their serial
// references. Kept in a header so the host test harness compiles the same
// code as C++ and holds it to the plain versions, and the teams to it.
#pragma once

#include "substep.cuh"

namespace kmanip {

// K5: item k of rnea_terms: qpos, qvel (K, NQ) -> xpos (K, NQ, 3), xquat
// (K, NQ, 4), axis (K, NQ, 3), bias (K, NQ).
template <int NQ, int T>
__device__ void rnea_item(int k, const ModelView<NQ, T>& m, const float* __restrict__ qpos,
                          const float* __restrict__ qvel, float* __restrict__ xpos,
                          float* __restrict__ xquat, float* __restrict__ axis_out,
                          float* __restrict__ bias_out) {
  float q[NQ], v[NQ], bias[NQ];
  for (int i = 0; i < NQ; ++i) {
    q[i] = qpos[k * NQ + i];
    v[i] = qvel[k * NQ + i];
  }
  V3 x[NQ], axis[NQ], w[NQ], vb[NQ];
  Q4 qq[NQ];
  M3 R[NQ];
  rnea_rows<NQ, T>(m, q, v, x, qq, axis, w, vb, R, bias);
  for (int i = 0; i < NQ; ++i) {
    const long o = (long)k * NQ + i;
    xpos[o * 3] = x[i].x;
    xpos[o * 3 + 1] = x[i].y;
    xpos[o * 3 + 2] = x[i].z;
    xquat[o * 4] = qq[i].w;
    xquat[o * 4 + 1] = qq[i].x;
    xquat[o * 4 + 2] = qq[i].y;
    xquat[o * 4 + 3] = qq[i].z;
    axis_out[o * 3] = axis[i].x;
    axis_out[o * 3 + 1] = axis[i].y;
    axis_out[o * 3 + 2] = axis[i].z;
    bias_out[o] = bias[i];
  }
}

// K6: item k of contact_forces: tip_pos, tip_vel (K, T, 3), cube_pos (K, 3),
// cube_quat (K, 4), cube_linvel, cube_angvel (K, 3) -> force, torque
// (K, 3), tip_forces (K, T, 3), touch_tip (K, T), touch_table (K). The
// fingertip radii come from the packed model.
template <int NQ, int T>
__device__ void contacts_item(int k, const ModelView<NQ, T>& m, const float* __restrict__ tip_pos,
                              const float* __restrict__ tip_vel,
                              const float* __restrict__ cube_pos,
                              const float* __restrict__ cube_quat,
                              const float* __restrict__ cube_lv, const float* __restrict__ cube_av,
                              float* __restrict__ force_out, float* __restrict__ torque_out,
                              float* __restrict__ tip_forces, bool* __restrict__ touch_tip,
                              bool* __restrict__ touch_table) {
  V3 tp[T], tv[T], tf[T];
  float radius[T];
  bool touch[T];
  for (int t = 0; t < T; ++t) {
    const float* p = tip_pos + ((long)k * T + t) * 3;
    const float* u = tip_vel + ((long)k * T + t) * 3;
    tp[t] = V3{p[0], p[1], p[2]};
    tv[t] = V3{u[0], u[1], u[2]};
    radius[t] = m.tip_radius(t);
  }
  const float* cp = cube_pos + (long)k * 3;
  const float* cq = cube_quat + (long)k * 4;
  const float* cl = cube_lv + (long)k * 3;
  const float* ca = cube_av + (long)k * 3;
  const Cube cube{{cp[0], cp[1], cp[2]}, {cq[0], cq[1], cq[2], cq[3]}, {cl[0], cl[1], cl[2]},
                  {ca[0], ca[1], ca[2]}};
  V3 force, torque;
  bool touching;
  contact_rows<T>(radius, tp, tv, cube, force, torque, tf, touch, touching);
  force_out[k * 3] = force.x;
  force_out[k * 3 + 1] = force.y;
  force_out[k * 3 + 2] = force.z;
  torque_out[k * 3] = torque.x;
  torque_out[k * 3 + 1] = torque.y;
  torque_out[k * 3 + 2] = torque.z;
  for (int t = 0; t < T; ++t) {
    float* f = tip_forces + ((long)k * T + t) * 3;
    f[0] = tf[t].x;
    f[1] = tf[t].y;
    f[2] = tf[t].z;
    touch_tip[(long)k * T + t] = touch[t];
  }
  touch_table[k] = touching;
}

// K7: item k of the SPD solve M x = b, M (K, N, N) row-major (its lower
// triangle is read), b and x (K, N). The Cholesky-Crout factor and the two
// substitutions of the fused substep (chol_factor, chol_solve): a
// non-positive pivot gives a NaN, as sqrtf does.
template <int N>
__device__ void chol_solve_item(int k, const float* __restrict__ M, const float* __restrict__ b,
                                float* __restrict__ x) {
  float L[N * (N + 1) / 2], y[N];
  const float* Mk = M + (long)k * N * N;
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j <= i; ++j) L[tri(i, j)] = Mk[i * N + j];
    y[i] = b[(long)k * N + i];
  }
  chol_factor<N>(L);
  chol_solve<N>(L, y);
  for (int i = 0; i < N; ++i) x[(long)k * N + i] = y[i];
}

}  // namespace kmanip
