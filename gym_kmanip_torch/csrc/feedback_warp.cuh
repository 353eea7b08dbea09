// Device code of the iLQR feedback rollout (K3), one team of lanes (one
// warp on the card) per step size: the JAX package's
// pallas_substep.py::_rollout_feedback_kernel, with the contact-free,
// implicitly actuated substep of substep_core (substep.cuh) split over the
// lanes. Written against a team (team.cuh: a lane index, a lane count, a
// sync and a broadcast), so the host test harness runs it with one thread
// or with several host threads behind a barrier.
//
// Every value is computed as substep_core computes it, each sum by one lane
// in the same order, so the rollout agrees bit for bit with a serial
// rollout over substep_core (held on the host build). Joint i belongs to
// lane i % SIZE, which keeps the joint's model constants, state and
// constraint forces in registers. What the lanes split:
//   - the hinge sines and cosines, ahead of the FK recursion;
//   - the FK and the RNEA backward pass, level by level of the kinematic
//     tree (all joints of one depth at once, a sync per level);
//   - the per-body inertial loads, the fingertip positions and the
//     COM-Jacobian columns J, IA of every (body, ancestor) pair;
//   - the packed mass matrix, one (j, k) entry per lane, summed over the
//     bodies in substep_core's order;
//   - the torque law, the Cholesky factor (right-looking, each lane's row in
//     registers, every pivot and column entry broadcast: the same operations
//     in the same order as chol_factor's), the constraint sweeps' per-joint
//     updates and the integration;
//   - the feedback law, one lane per control, on the step's gains and
//     nominal, which were copied into a double-buffered shared stage
//     (cp.async) while the step before ran.
// The triangular solves stay serial, run by every lane at once in
// registers, so no broadcast is needed after them; their divisions by the
// factor's diagonal use its reciprocals and one correction (Markstein's
// correctly rounded quotient), which is the division's result bit for bit
// and shortens the chain. The cube is pinned to its template every control
// step and the substep is contact-free, so the cube's own integration has
// no effect on the outputs and is not run.
#pragma once

#include "substep.cuh"
#include "team.cuh"

namespace kmanip {

// The team's shared working set: the model, the rollout's state as the
// other lanes read it, the substep's intermediates and the feedback stage.
template <int NQ, int T>
struct FeedbackShared {
  using MV = ModelView<NQ, T>;
  static constexpr int N = 2 * NQ;
  static constexpr int NTRI = NQ * (NQ + 1) / 2;
  // stage: Ks[h] (nu x N), then xs_nom[h] (N), us_nom[h] (nu), ks[h] (nu)
  static constexpr int ST_X = NQ * N, ST_U = ST_X + N, ST_K = ST_U + NQ, ST_SIZE = ST_K + NQ;

  float mf[MV::N_FLOATS];
  int mi[MV::N_INTS];
  int depth[NQ];
  int max_depth;
  int n_pairs;
  int pair_body[NQ * NQ], pair_joint[NQ * NQ];  // (body, ancestor joint)
  float diag_extra[NQ];                         // the mass matrix's diagonal terms
  float q[NQ], v[NQ], dx[N];
  V3 x[NQ], axis[NQ], w[NQ], vb[NQ], alpha[NQ], a[NQ], F[NQ], Nt[NQ];
  Q4 qq[NQ];
  V3 tip_p[T];
  V3 J[NQ][NQ], IA[NQ][NQ];
  float L[NTRI];  // the mass matrix, then its factor (packed rows)
  float Ld[NQ], Lr[NQ];  // the factor's diagonal and its reciprocal
  float tau[NQ], df[2][NQ];
  float stage[2][ST_SIZE];
};

// Each lane's model constants: its joints i = lane + r SIZE and its mass
// matrix entries e = lane + r SIZE, kept in registers.
template <int NQ, int T, int S>
struct LaneConsts {
  static constexpr int RPL = (NQ + S - 1) / S;
  static constexpr int RPE = (NQ * (NQ + 1) / 2 + S - 1) / S;
  int nu;
  int parent[RPL], depth[RPL], n_children[RPL];
  int child[RPL][NQ - 1];  // child joints in ascending order
  unsigned tips[RPL];      // bit mask: the fingertips below the joint
  bool hinge[RPL];
  V3 jpos[RPL], com[RPL], inertia[RPL];
  Q4 jquat[RPL];
  float mass[RPL], kp[RPL], kp_dt[RPL], flo[RPL], fhi[RPL], rlo[RPL], rhi[RPL], fl[RPL];
  float lo[RPL], hi[RPL];  // control range
  int ej[RPE], ek[RPE];
  unsigned ebodies[RPE];  // bodies i with anc(i, j) and anc(i, k)
  bool ehh[RPE];          // both joints hinges
};

// b[i] for a runtime i, read with compile-time indices only (no local
// memory).
template <int N>
__device__ __forceinline__ float pick(const float (&b)[N], int i) {
  float r = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k == i) r = b[k];
  return r;
}

// s / d from r = 1 / d (both correctly rounded): q0 = s r, then one
// correction with the exact residual s - q0 d. For normal operands this is
// the correctly rounded quotient (Markstein), i.e. s / d bit for bit; a
// zero keeps its sign.
__device__ __forceinline__ float div_by(float s, float d, float r) {
  const float q0 = s * r;
  return s == 0.f ? q0 : fma_rn(fma_rn(-q0, d, s), r, q0);
}

// chol_solve on b in registers: the factor's rows from L, its diagonal
// from Ld with reciprocals Lr.
template <int NQ>
__device__ __forceinline__ void solve_regs(const float* L, const float* Ld, const float* Lr,
                                           float (&b)[NQ]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * b[k];
    b[i] = div_by(s, Ld[i], Lr[i]);
  }
#pragma unroll
  for (int i = NQ - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < NQ; ++k) s = s - L[tri(k, i)] * b[k];
    b[i] = div_by(s, Ld[i], Lr[i]);
  }
}

// The lane's registers of the rollout's state: its joints' q, v, u.
template <int RPL>
struct LaneState {
  float q[RPL], v[RPL], u[RPL];
};

// One contact-free substep with implicit actuation: substep_core(m, c,
// false, true, ...) without the cube, on the lanes' state st.
template <int NQ, int T, class Team>
__device__ void substep_team(const Team& team, const ModelView<NQ, T>& m, const StepConsts& c,
                             const LaneConsts<NQ, T, Team::SIZE>& k,
                             LaneState<LaneConsts<NQ, T, Team::SIZE>::RPL>& st,
                             FeedbackShared<NQ, T>& s) {
  constexpr int S = Team::SIZE;
  constexpr int RPL = LaneConsts<NQ, T, S>::RPL, RPE = LaneConsts<NQ, T, S>::RPE;
  constexpr int NTRI = FeedbackShared<NQ, T>::NTRI;
  const int lane = team.lane;
  const V3 zero{0.f, 0.f, 0.f};
  const V3 ez{0.f, 0.f, 1.f};

  float cs[RPL], sn[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    cs[r] = sn[r] = 0.f;
    if (lane + r * S < NQ && k.hinge[r]) {
      float half = 0.5f * st.q[r];
      cs[r] = cosf(half);
      sn[r] = sinf(half);
    }
  }
  // FK, level by level (rnea_rows' forward loop)
  for (int d = 0; d <= s.max_depth; ++d) {
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * S;
      if (i >= NQ || k.depth[r] != d) continue;
      const int par = k.parent[r];
      V3 xp, wp, vp, alp, ap;
      Q4 qp;
      if (par < 0) {
        xp = zero;
        qp = Q4{1.f, 0.f, 0.f, 0.f};
        wp = zero;
        vp = zero;
        alp = zero;
        ap = V3{0.f, 0.f, (float)(-GRAV_Z)};
      } else {
        xp = s.x[par];
        qp = s.qq[par];
        wp = s.w[par];
        vp = s.vb[par];
        alp = s.alpha[par];
        ap = s.a[par];
      }
      V3 rr = qrot(qp, k.jpos[r]);
      V3 xi = xp + rr;
      Q4 qi = qmul(qp, k.jquat[r]);
      V3 wi, ali, vi, ai, ax;
      const float qv = st.q[r], vv = st.v[r];
      if (k.hinge[r]) {
        qi = qmul(qi, Q4{cs[r], 0.f, 0.f, sn[r]});
        ax = qrot(qi, ez);
        wi = wp + ax * vv;
        ali = alp + cross(wp, ax * vv);
        vi = vp + cross(wp, rr);
        ai = ap + cross(alp, rr) + cross(wp, cross(wp, rr));
      } else {
        ax = qrot(qi, ez);
        xi = xi + ax * qv;
        wi = wp;
        ali = alp;
        V3 r_eff = rr + ax * qv;
        vi = vp + cross(wp, r_eff) + ax * vv;
        ai = ap + cross(alp, r_eff) + cross(wp, cross(wp, r_eff)) + cross(wp, ax * vv) * 2.f;
      }
      s.x[i] = xi;
      s.qq[i] = qi;
      s.axis[i] = ax;
      s.w[i] = wi;
      s.vb[i] = vi;
      s.alpha[i] = ali;
      s.a[i] = ai;
    }
    team.sync();
  }

  KMANIP_PHASE(1);  // FK
  // inertial loads (rnea_rows), fingertips, and the COM-Jacobian columns
  // of every (body, ancestor) pair (substep_core's mass matrix)
  V3 cb[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
    if (i >= NQ) continue;
    const Q4 qi = s.qq[i];
    const V3 ai = s.a[i], ali = s.alpha[i], wi = s.w[i];
    V3 ci = qrot(qi, k.com[r]);
    V3 a_com = ai + cross(ali, ci) + cross(wi, cross(wi, ci));
    M3 R = quat_to_mat(qi);
    cb[r] = ci;
    s.F[i] = a_com * k.mass[r];
    s.Nt[i] = iw_mul(R, k.inertia[r], ali) + cross(wi, iw_mul(R, k.inertia[r], wi));
  }
  for (int t = lane; t < T; t += S) {
    int par = m.tip_parent(t);
    s.tip_p[t] = s.x[par] + qrot(s.qq[par], m.tip_pos(t));
  }
  for (int p = lane; p < s.n_pairs; p += S) {
    const int i = s.pair_body[p], j = s.pair_joint[p];
    V3 com_w = s.x[i] + qrot(s.qq[i], m.com(i));
    if (m.hinge(j)) {
      s.J[i][j] = cross(s.axis[j], com_w - s.x[j]);
      s.IA[i][j] = iw_mul(quat_to_mat(s.qq[i]), m.inertia(i), s.axis[j]);
    } else {
      s.J[i][j] = s.axis[j];
    }
  }
  team.sync();

  KMANIP_PHASE(2);  // inertial loads, fingertips, Jacobian columns
  // the packed mass matrix, one entry per lane, bodies in order
#pragma unroll
  for (int r = 0; r < RPE; ++r) {
    const int e = lane + r * S;
    if (e >= NTRI) continue;
    const int j = k.ej[r], kk = k.ek[r];
    const unsigned bodies = k.ebodies[r];
    const V3 axj = s.axis[j];
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {  // selects, not branches: J, IA of other pairs are stale
      const bool in = (bodies >> i) & 1u;
      const float a1 = acc + m.mass(i) * dot(s.J[i][j], s.J[i][kk]);
      const float a2 = a1 + dot(axj, s.IA[i][kk]);
      acc = in ? (k.ehh[r] ? a2 : a1) : acc;
    }
    if (j == kk) acc = acc + s.diag_extra[j];
    s.L[e] = acc;
  }
  KMANIP_PHASE(3);  // mass matrix
  // the RNEA backward pass level by level
  float bias[RPL];
  V3 axr[RPL], xr[RPL];
  for (int d = s.max_depth; d >= 0; --d) {
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * S;
      if (i >= NQ || k.depth[r] != d) continue;
      const V3 Fo = s.F[i], xi = s.x[i], axi = s.axis[i];
      V3 Fi = Fo;
      V3 Ni = s.Nt[i] + cross(cb[r], Fo);
#pragma unroll
      for (int ci = 0; ci < NQ - 1; ++ci) {
        if (ci >= k.n_children[r]) break;
        const int ch = k.child[r][ci];
        const V3 Fc = s.F[ch];
        Fi = Fi + Fc;
        Ni = Ni + s.Nt[ch] + cross(s.x[ch] - xi, Fc);
      }
      s.F[i] = Fi;
      s.Nt[i] = Ni;
      bias[r] = k.hinge[r] ? dot(axi, Ni) : dot(axi, Fi);
      axr[r] = axi;
      xr[r] = xi;
    }
    team.sync();
  }
  // each joint's torque: clamped servo, damping, bias, stable-PD term, and
  // the contact reactions of a contact-free substep (zero forces)
  float Mdiag[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
    if (i >= NQ) continue;
    float t_i = 0.f;
    if (i < k.nu && k.kp[r] != 0.f) {
      float raw = k.kp[r] * (st.u[r] - st.q[r]);
      t_i = t_i + clampf(raw, k.flo[r], k.fhi[r]);
    }
    t_i = t_i - (float)JOINT_DAMPING * st.v[r];
    t_i = t_i - bias[r];
    if (i < k.nu) t_i = t_i - k.kp_dt[r] * st.v[r];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (!((k.tips[r] >> t) & 1u)) continue;
      V3 jv = k.hinge[r] ? cross(axr[r], s.tip_p[t] - xr[r]) : axr[r];
      t_i = t_i + dot(jv, zero);
    }
    s.tau[i] = t_i;
  }

  KMANIP_PHASE(4);  // RNEA backward pass, torques
  // Cholesky factor, right-looking: lane i holds row i; pivot j's d and
  // each scaled entry L[k][j] are broadcast. Element (i, k) sees the same
  // subtractions in the same order as chol_factor's left-looking sums, and
  // the same scaling by 1 / d.
  float row[RPL][NQ];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) row[r][kk] = (i < NQ && kk <= i) ? s.L[tri(i, kk)] : 0.f;
    Mdiag[r] = i < NQ ? pick<NQ>(row[r], i) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const float sd = team.bcast(row[j / S][j], j % S);
    const float dj = sqrtf(sd);
    const float inv_d = 1.f / dj;
    float l[RPL];
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * S;
      l[r] = row[r][j] * inv_d;
      row[r][j] = i > j ? l[r] : row[r][j];
    }
#pragma unroll
    for (int kk = j + 1; kk < NQ; ++kk) {
      const float lk = team.bcast(l[kk / S], kk % S);
#pragma unroll
      for (int r = 0; r < RPL; ++r)  // entries above the diagonal are never read
        row[r][kk] = row[r][kk] - l[r] * lk;
    }
    if (lane == j % S) {
      s.Ld[j] = dj;
      s.Lr[j] = 1.f / dj;
    }
  }
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk)
      if (kk < i && i < NQ) s.L[tri(i, kk)] = row[r][kk];
  }
  team.sync();

  KMANIP_PHASE(5);  // Cholesky factor
  // qacc0 = M^-1 tau, then the limit and frictionloss sweeps
  float b[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) b[i] = s.tau[i];
  solve_regs<NQ>(s.L, s.Ld, s.Lr, b);
  float qacc0[RPL], qacc[RPL], f_fric[RPL], f_lo[RPL], f_hi[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    qacc0[r] = qacc[r] = pick<NQ>(b, lane + r * S);
    f_fric[r] = f_lo[r] = f_hi[r] = 0.f;
  }
  const float d_imp = (float)LIMIT_IMPEDANCE, d_fr = (float)FRICTION_IMPEDANCE;
  for (int it = 0; it < CONSTRAINT_ITERS; ++it) {
    float* df = s.df[it & 1];
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * S;
      if (i >= NQ) continue;
      const float qi = st.q[r], vi = st.v[r], Mi = Mdiag[r];
      const float fl = k.fl[r];
      if (fl != 0.f) {
        f_fric[r] = clampf(f_fric[r] + d_fr * Mi * (-(float)FRICTION_BETA * vi - qacc[r]) -
                               (float)(1.0 - FRICTION_IMPEDANCE) * f_fric[r],
                           -fl, fl);
      }
      float viol_lo = k.rlo[r] - qi;
      float viol_hi = qi - k.rhi[r];
      float aref_lo = (float)LIMIT_KAPPA * viol_lo - (float)LIMIT_BETA * vi;
      float aref_hi = -(float)LIMIT_KAPPA * viol_hi - (float)LIMIT_BETA * vi;
      f_lo[r] = viol_lo > 0.f ? fmaxf(f_lo[r] + d_imp * Mi * (aref_lo - qacc[r]), 0.f) : 0.f;
      f_hi[r] = viol_hi > 0.f ? fminf(f_hi[r] + d_imp * Mi * (aref_hi - qacc[r]), 0.f) : 0.f;
      df[i] = f_fric[r] + f_lo[r] + f_hi[r];
    }
    team.sync();
#pragma unroll
    for (int i = 0; i < NQ; ++i) b[i] = df[i];
    solve_regs<NQ>(s.L, s.Ld, s.Lr, b);
#pragma unroll
    for (int r = 0; r < RPL; ++r) qacc[r] = qacc0[r] + pick<NQ>(b, lane + r * S);
  }

  KMANIP_PHASE(6);  // the four solves and the constraint sweeps
  // semi-implicit Euler with the wide safety clamp
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
    if (i >= NQ) continue;
    float v_new = st.v[r] + c.dt_f * qacc[r];
    float q_new = st.q[r] + c.dt_f * v_new;
    float lo_s = k.rlo[r] - (float)LIMIT_SAFETY_MARGIN;
    float hi_s = k.rhi[r] + (float)LIMIT_SAFETY_MARGIN;
    bool stop = (q_new > hi_s && v_new > 0.f) || (q_new < lo_s && v_new < 0.f);
    st.q[r] = clampf(q_new, lo_s, hi_s);
    st.v[r] = stop ? 0.f : v_new;
    s.q[i] = st.q[r];
    s.v[i] = st.v[r];
  }
}

// Copies step h's gains and nominal into stage buffer `st` without waiting.
template <int NQ, class Team>
__device__ __forceinline__ void stage_step(const Team& team, int h, int nu, float* st,
                                           const float* __restrict__ xs_nom,
                                           const float* __restrict__ us_nom,
                                           const float* __restrict__ ks,
                                           const float* __restrict__ Ks) {
  constexpr int N = 2 * NQ, S = Team::SIZE;
  constexpr int ST_X = NQ * N, ST_U = ST_X + N, ST_K = ST_U + NQ;
  const float* Kh = Ks + (long)h * nu * N;
  for (int e = team.lane; e < nu * N; e += S) copy_async(st + e, Kh + e);
  for (int e = team.lane; e < N; e += S) copy_async(st + ST_X + e, xs_nom + (long)h * N + e);
  for (int e = team.lane; e < nu; e += S) {
    copy_async(st + ST_U + e, us_nom + (long)h * nu + e);
    copy_async(st + ST_K + e, ks + (long)h * nu + e);
  }
  copy_commit();
}

// Step size b of the feedback rollout on the reduced state x = [qpos,
// qvel]: for each control step h,
//   u = clip(us_nom[h] + alpha_b ks[h] + Ks[h] (x - xs_nom[h]), lo, hi)
// (the feedback sum first, then one add to the feedforward term, as the
// reference), then n_substeps contact-free substeps with implicit
// actuation. Writes xs_out[b] (H, 2NQ), the post-step states, and
// us_out[b] (H, nu), the controls as applied. `mf`, `mi` are the packed
// model (ops/substep_cuda.pack_model); every lane of the team calls this.
template <int NQ, int T, class Team>
__device__ void rollout_feedback_team(
    const Team& team, FeedbackShared<NQ, T>& s, int b, const float* __restrict__ mf,
    const int* __restrict__ mi, const StepConsts& c, int n_substeps, int H,
    const float* __restrict__ alphas, const float* __restrict__ x0,
    const float* __restrict__ xs_nom, const float* __restrict__ us_nom,
    const float* __restrict__ ks, const float* __restrict__ Ks,
    const float* __restrict__ ctrl_lo, const float* __restrict__ ctrl_hi,
    float* __restrict__ xs_out, float* __restrict__ us_out) {
  using Sh = FeedbackShared<NQ, T>;
  constexpr int N = Sh::N, S = Team::SIZE;
  using LC = LaneConsts<NQ, T, S>;
  constexpr int RPL = LC::RPL;
  const int lane = team.lane;
  for (int e = lane; e < Sh::MV::N_FLOATS; e += S) s.mf[e] = mf[e];
  for (int e = lane; e < Sh::MV::N_INTS; e += S) s.mi[e] = mi[e];
  team.sync();
  const ModelView<NQ, T> m{s.mf, s.mi};
  const int nu = m.nu();
  if (lane == 0) {  // the tree's levels and the (body, ancestor) pairs
    int md = 0, np = 0;
    for (int i = 0; i < NQ; ++i) {
      const int par = m.parent(i);  // parents precede their children
      s.depth[i] = par < 0 ? 0 : s.depth[par] + 1;
      md = s.depth[i] > md ? s.depth[i] : md;
      for (int j = 0; j < NQ; ++j)
        if (m.anc(i, j)) {
          s.pair_body[np] = i;
          s.pair_joint[np] = j;
          ++np;
        }
    }
    s.max_depth = md;
    s.n_pairs = np;
  }
  for (int i = lane; i < NQ; i += S) {
    double extra = (double)m.armature(i) + c.dt * JOINT_DAMPING;
    if (i < nu) extra += c.dt * c.dt * (double)m.kp(i);
    s.diag_extra[i] = (float)extra;
  }
  team.sync();
  LC k;
  LaneState<RPL> st;
  k.nu = nu;
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S < NQ ? lane + r * S : NQ - 1;
    k.parent[r] = m.parent(i);
    k.depth[r] = s.depth[i];
    k.hinge[r] = m.hinge(i);
    int nc = 0;
#pragma unroll
    for (int ci = 0; ci < NQ - 1; ++ci) k.child[r][ci] = 0;
    for (int ch = i + 1; ch < NQ; ++ch) {
      if (m.parent(ch) != i) continue;
#pragma unroll
      for (int ci = 0; ci < NQ - 1; ++ci)
        if (ci == nc) k.child[r][ci] = ch;
      ++nc;
    }
    k.n_children[r] = nc;
    k.tips[r] = 0u;
    for (int t = 0; t < T; ++t)
      if (m.anc(m.tip_parent(t), i)) k.tips[r] |= 1u << t;
    k.jpos[r] = m.jnt_pos(i);
    k.jquat[r] = m.jnt_quat(i);
    k.com[r] = m.com(i);
    k.inertia[r] = m.inertia(i);
    k.mass[r] = m.mass(i);
    k.kp[r] = m.kp(i);
    k.kp_dt[r] = (float)(c.dt * (double)m.kp(i));
    k.flo[r] = m.force_lo(i);
    k.fhi[r] = m.force_hi(i);
    k.rlo[r] = m.range_lo(i);
    k.rhi[r] = m.range_hi(i);
    k.fl[r] = m.frictionloss(i);
    k.lo[r] = i < nu ? ctrl_lo[i] : 0.f;
    k.hi[r] = i < nu ? ctrl_hi[i] : 0.f;
    st.q[r] = x0[i];
    st.v[r] = x0[NQ + i];
    st.u[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < LC::RPE; ++r) {
    int e = lane + r * S, j = 0;
    while (e >= 0 && (j + 1) * (j + 2) / 2 <= e) ++j;  // packed index -> (j, k)
    const int kk = e < Sh::NTRI ? e - j * (j + 1) / 2 : 0;
    j = e < Sh::NTRI ? j : 0;
    k.ej[r] = j;
    k.ek[r] = kk;
    k.ehh[r] = m.hinge(j) && m.hinge(kk);
    k.ebodies[r] = 0u;
    for (int i = 0; i < NQ; ++i)
      if (m.anc(i, j) && m.anc(i, kk)) k.ebodies[r] |= 1u << i;
  }
  for (int i = lane; i < NQ; i += S) {
    s.q[i] = x0[i];
    s.v[i] = x0[NQ + i];
  }
  stage_step<NQ>(team, 0, nu, s.stage[0], xs_nom, us_nom, ks, Ks);
  const float alpha = alphas[b];
  KMANIP_PHASE_START();
  for (int h = 0; h < H; ++h) {
    copy_wait_all();
    team.sync();
    if (h + 1 < H) stage_step<NQ>(team, h + 1, nu, s.stage[(h + 1) & 1], xs_nom, us_nom, ks, Ks);
    const float* stg = s.stage[h & 1];
    for (int j = lane; j < N; j += S)
      s.dx[j] = (j < NQ ? s.q[j] : s.v[j - NQ]) - stg[Sh::ST_X + j];
    team.sync();
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int i = lane + r * S;
      if (i >= nu) continue;
      const float* Ki = stg + i * N;
      float fb = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) fb = fb + Ki[j] * s.dx[j];
      st.u[r] = clampf((stg[Sh::ST_U + i] + alpha * stg[Sh::ST_K + i]) + fb, k.lo[r], k.hi[r]);
    }
    KMANIP_PHASE(0);  // the outputs before, the copies' wait, the feedback law
    for (int sub = 0; sub < n_substeps; ++sub) substep_team<NQ, T>(team, m, c, k, st, s);
    KMANIP_PHASE(7);  // integration
    team.sync();
    float* xo = xs_out + ((long)b * H + h) * N;
    for (int j = lane; j < N; j += S) xo[j] = j < NQ ? s.q[j] : s.v[j - NQ];
    float* uo = us_out + ((long)b * H + h) * nu;
#pragma unroll
    for (int r = 0; r < RPL; ++r)
      if (lane + r * S < nu) uo[lane + r * S] = st.u[r];
  }
  KMANIP_PHASE_STOP();
}

}  // namespace kmanip
