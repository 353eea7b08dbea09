// The physics substep of one rollout split over a team of lanes (one warp,
// or one half-warp, on the card): substep_core (substep.cuh) with
// everything it does, the contact model, explicit or implicit actuation
// and the cube's free body, each a compile-time choice. K1 (one substep per
// rollout, substep.cu), K2 (the pick-cost rollout, rollout_pick.cu) and K3
// (the feedback rollout, rollout_feedback.cu) all run this one copy, and
// the staged route's FK + RNEA (K5), contact model (K6) and SPD solve (K7,
// staged_team.cuh) run its FK, inertial loads, backward pass, contact lanes
// and factor (fk_team, inertial_loads_team, rnea_backward_team,
// contacts_team, chol_factor_team).
// Written against a team (team.cuh: a lane index, a lane count, a sync and
// a broadcast), so the host test harness runs it with one thread or with
// several host threads behind a barrier.
//
// Every value is computed as substep_core computes it, each sum by one lane
// in the same order, so a team rollout agrees bit for bit with a serial one
// over substep_core (held on the host build). Joint i belongs to lane
// i % SIZE, which keeps the joint's model constants, state and constraint
// forces in registers. What the lanes split:
//   - the hinge sines and cosines, ahead of the FK recursion;
//   - the FK and the RNEA backward pass, level by level of the kinematic
//     tree (all joints of one depth at once, a sync per level);
//   - the per-body inertial loads, the fingertips (one lane per tip: its
//     position, velocity and contact with the cube) and the cube corners'
//     state against the table (one lane per corner), and the COM-Jacobian
//     columns J, IA of every (body, ancestor) pair;
//   - the corners' contact forces (one lane per corner, after the tips'
//     force on the cube, which feeds their a0), beside the packed mass
//     matrix, one (j, k) entry per lane, summed over the bodies in
//     substep_core's order;
//   - the force and torque sums onto the cube and the cube's integration,
//     by one lane in the tips-then-corners order, the result left in shared
//     memory for the next substep and the caller;
//   - the torque law with the contact reactions, the Cholesky factor
//     (right-looking, each lane's row in registers, every pivot and column
//     entry broadcast: the same operations in the same order as
//     chol_factor's), the constraint sweeps' per-joint updates and the
//     integration.
// The triangular solves stay serial, run by every lane at once in
// registers, so no broadcast is needed after them; their divisions by the
// factor's diagonal use its reciprocals and one correction (Markstein's
// correctly rounded quotient), which is the division's result bit for bit
// and shortens the chain.
#pragma once

#include "substep.cuh"
#include "team.cuh"

namespace kmanip {

// What every team of a block reads: the model, the tree's levels, the
// (body, ancestor) pairs and the mass matrix's diagonal terms.
template <int NQ, int T>
struct TeamModel {
  using MV = ModelView<NQ, T>;
  float mf[MV::N_FLOATS];
  int mi[MV::N_INTS];
  int depth[NQ], pair_count[NQ];  // each joint's depth and number of ancestors
  int max_depth;
  int n_pairs;
  int pair_body[NQ * NQ], pair_joint[NQ * NQ];  // (body, ancestor joint)
  float diag_extra[NQ];                         // the mass matrix's diagonal terms
};

// One team's working set: the rollout's state as the other lanes read it,
// the cube, and the substep's intermediates.
template <int NQ, int T>
struct TeamWork {
  static constexpr int NTRI = NQ * (NQ + 1) / 2;
  float q[NQ], v[NQ];
  Cube cube;
  V3 x[NQ], axis[NQ], w[NQ], vb[NQ], alpha[NQ], a[NQ], F[NQ], Nt[NQ];
  alignas(16) Q4 qq[NQ];  // a frame's quaternion in one 16-byte load
  V3 tip_p[T], tip_f[T];
  V3 tip_fc[T], tip_tc[T];      // each tip's force on the cube and its moment
  bool touch[T];
  float corner_pen[8];
  V3 corner_fc[8], corner_tc[8];  // each corner's force on the cube and its moment
  V3 J[NQ][NQ], IA[NQ][NQ];
  float L[NTRI];  // the mass matrix, then its factor (packed rows)
  float Ld[NQ], Lr[NQ];  // the factor's diagonal and its reciprocal
  float tau[NQ], df[2][NQ];
};

// Joint i's depth in the tree: the number of its ancestors but itself.
template <int NQ, int T>
__device__ __forceinline__ int joint_depth(const ModelView<NQ, T>& m, int i) {
  int d = 0;
  for (int p = m.parent(i); p >= 0; p = m.parent(p)) ++d;
  return d;
}

// Copies the model into M and derives the tree's levels, the pairs and
// the diagonal terms; thread tid of nthreads, `sync` a barrier over all of
// them (the block's, or one team's).
template <int NQ, int T, class Sync>
__device__ void team_model_load(TeamModel<NQ, T>& M, int tid, int nthreads,
                                const float* __restrict__ mf, const int* __restrict__ mi,
                                const StepConsts& c, bool implicit, const Sync& sync) {
  using MV = ModelView<NQ, T>;
  for (int e = tid; e < MV::N_FLOATS; e += nthreads) M.mf[e] = mf[e];
  for (int e = tid; e < MV::N_INTS; e += nthreads) M.mi[e] = mi[e];
  sync();
  const MV m{M.mf, M.mi};
  const int nu = m.nu();
  // each joint's depth in the tree and its number of ancestors
  for (int i = tid; i < NQ; i += nthreads) {
    int n = 0;
    for (int j = 0; j < NQ; ++j) n += m.anc(i, j) ? 1 : 0;
    M.depth[i] = joint_depth(m, i);
    M.pair_count[i] = n;
  }
  sync();
  // the (body, ancestor) pairs, body by body, ancestors in ascending order
  for (int i = tid; i < NQ; i += nthreads) {
    int np = 0;
    for (int b = 0; b < i; ++b) np += M.pair_count[b];
    for (int j = 0; j < NQ; ++j)
      if (m.anc(i, j)) {
        M.pair_body[np] = i;
        M.pair_joint[np] = j;
        ++np;
      }
  }
  if (tid == 0) {
    int md = 0, np = 0;
    for (int i = 0; i < NQ; ++i) {
      md = M.depth[i] > md ? M.depth[i] : md;
      np += M.pair_count[i];
    }
    M.max_depth = md;
    M.n_pairs = np;
  }
  for (int i = tid; i < NQ; i += nthreads) {
    double extra = (double)m.armature(i) + c.dt * JOINT_DAMPING;
    if (implicit && i < nu) extra += c.dt * c.dt * (double)m.kp(i);
    M.diag_extra[i] = (float)extra;
  }
  sync();
}

// What the tree recursion (FK, inertial loads, RNEA backward pass) reads
// of each lane's joints i = lane + r SIZE, kept in registers.
template <int NQ, int S>
struct TreeConsts {
  static constexpr int RPL = (NQ + S - 1) / S;
  int parent[RPL], depth[RPL], n_children[RPL];
  int child[RPL][NQ - 1];  // child joints in ascending order
  bool hinge[RPL];
  V3 jpos[RPL], com[RPL], inertia[RPL];
  Q4 jquat[RPL];
  float mass[RPL];
};

// The lane's tree constants from the model and the joints' depths.
template <int NQ, int T, int S>
__device__ __forceinline__ void load_tree_consts(TreeConsts<NQ, S>& k, const ModelView<NQ, T>& m,
                                                 const int* depth, int lane) {
#pragma unroll
  for (int r = 0; r < TreeConsts<NQ, S>::RPL; ++r) {
    const int i = lane + r * S < NQ ? lane + r * S : NQ - 1;
    k.parent[r] = m.parent(i);
    k.depth[r] = depth[i];
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
    k.jpos[r] = m.jnt_pos(i);
    k.jquat[r] = m.jnt_quat(i);
    k.com[r] = m.com(i);
    k.inertia[r] = m.inertia(i);
    k.mass[r] = m.mass(i);
  }
}

// Each lane's model constants: the tree's, and the rest of its joints'
// and its mass matrix entries e = lane + r SIZE, kept in registers.
template <int NQ, int T, int S>
struct LaneConsts : TreeConsts<NQ, S> {
  static constexpr int RPL = TreeConsts<NQ, S>::RPL;
  static constexpr int RPE = (NQ * (NQ + 1) / 2 + S - 1) / S;
  int nu;
  unsigned tips[RPL];  // bit mask: the fingertips below the joint
  float kp[RPL], kp_dt[RPL], flo[RPL], fhi[RPL], rlo[RPL], rhi[RPL], fl[RPL];
  float lo[RPL], hi[RPL];  // control range (the feedback rollout's clip)
  int ej[RPE], ek[RPE];
  unsigned ebodies[RPE];  // bodies i with anc(i, j) and anc(i, k)
  bool ehh[RPE];          // both joints hinges
};

// The lane's constants from the loaded model; the control range is left
// at zero.
template <int NQ, int T, int S>
__device__ __forceinline__ LaneConsts<NQ, T, S> lane_consts(const TeamModel<NQ, T>& M, int lane,
                                                            const StepConsts& c) {
  using LC = LaneConsts<NQ, T, S>;
  const ModelView<NQ, T> m{M.mf, M.mi};
  const int nu = m.nu();
  LC k;
  load_tree_consts<NQ, T, S>(k, m, M.depth, lane);
  k.nu = nu;
#pragma unroll
  for (int r = 0; r < LC::RPL; ++r) {
    const int i = lane + r * S < NQ ? lane + r * S : NQ - 1;
    k.tips[r] = 0u;
    for (int t = 0; t < T; ++t)
      if (m.anc(m.tip_parent(t), i)) k.tips[r] |= 1u << t;
    k.kp[r] = m.kp(i);
    k.kp_dt[r] = (float)(c.dt * (double)m.kp(i));
    k.flo[r] = m.force_lo(i);
    k.fhi[r] = m.force_hi(i);
    k.rlo[r] = m.range_lo(i);
    k.rhi[r] = m.range_hi(i);
    k.fl[r] = m.frictionloss(i);
    k.lo[r] = 0.f;
    k.hi[r] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < LC::RPE; ++r) {
    constexpr int NTRI = NQ * (NQ + 1) / 2;
    int e = lane + r * S, j = 0;
    while (e >= 0 && (j + 1) * (j + 2) / 2 <= e) ++j;  // packed index -> (j, k)
    const int kk = e < NTRI ? e - j * (j + 1) / 2 : 0;
    j = e < NTRI ? j : 0;
    k.ej[r] = j;
    k.ek[r] = kk;
    k.ehh[r] = m.hinge(j) && m.hinge(kk);
    k.ebodies[r] = 0u;
    for (int i = 0; i < NQ; ++i)
      if (m.anc(i, j) && m.anc(i, kk)) k.ebodies[r] |= 1u << i;
  }
  return k;
}

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

// chol_solve's two substitutions on b in registers: the factor's rows from
// L (packed), its diagonal from Ld with reciprocals Lr. L y = b:
template <int NQ>
__device__ __forceinline__ void solve_lower_regs(const float* L, const float* Ld, const float* Lr,
                                                 float (&b)[NQ]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * b[k];
    b[i] = div_by(s, Ld[i], Lr[i]);
  }
}

// L^T x = y:
template <int NQ>
__device__ __forceinline__ void solve_upper_regs(const float* L, const float* Ld, const float* Lr,
                                                 float (&b)[NQ]) {
#pragma unroll
  for (int i = NQ - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < NQ; ++k) s = s - L[tri(k, i)] * b[k];
    b[i] = div_by(s, Ld[i], Lr[i]);
  }
}

// Both: chol_solve on b in registers.
template <int NQ>
__device__ __forceinline__ void solve_regs(const float* L, const float* Ld, const float* Lr,
                                           float (&b)[NQ]) {
  solve_lower_regs<NQ>(L, Ld, Lr, b);
  solve_upper_regs<NQ>(L, Ld, Lr, b);
}

// The FK recursion level by level of the tree (rnea_rows' forward loop):
// all joints of one depth at once, a sync per level. Each lane leaves its
// joints' frame (x, qq), axis, velocities (w, vb) and accelerations
// (alpha, a) in s, from their positions q and velocities v. s is a working
// set with those arrays (TeamWork, or K5's TreeWork).
template <int NQ, int S, class Team, class W>
__device__ __forceinline__ void fk_team(const Team& team, const TreeConsts<NQ, S>& k,
                                        int max_depth,
                                        const float (&q)[TreeConsts<NQ, S>::RPL],
                                        const float (&v)[TreeConsts<NQ, S>::RPL], W& s) {
  constexpr int RPL = TreeConsts<NQ, S>::RPL;
  const int lane = team.lane;
  const V3 zero{0.f, 0.f, 0.f};
  const V3 ez{0.f, 0.f, 1.f};
  float cs[RPL], sn[RPL];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    cs[r] = sn[r] = 0.f;
    if (lane + r * S < NQ && k.hinge[r]) {
      float half = 0.5f * q[r];
      cs[r] = cosf(half);
      sn[r] = sinf(half);
    }
  }
  for (int d = 0; d <= max_depth; ++d) {
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
      const float qv = q[r], vv = v[r];
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
}

// The inertial loads at each COM (rnea_rows): each lane its joints' force
// F and moment Nt into s, and their COM offsets cb; reads the frames that
// fk_team left. Another lane may read them only after a sync (the backward
// pass's first level reads only each lane's own joints).
template <int NQ, int S, class W>
__device__ __forceinline__ void inertial_loads_team(int lane, const TreeConsts<NQ, S>& k, W& s,
                                                    V3 (&cb)[TreeConsts<NQ, S>::RPL]) {
#pragma unroll
  for (int r = 0; r < TreeConsts<NQ, S>::RPL; ++r) {
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
}

// The RNEA backward pass level by level: each joint's F and Nt gather its
// children's (in ascending order, as rnea_rows'), a sync per level. Leaves
// each lane's joints' bias force, axis and origin in bias, axr, xr.
template <int NQ, int S, class Team, class W>
__device__ __forceinline__ void rnea_backward_team(const Team& team, const TreeConsts<NQ, S>& k,
                                                   int max_depth,
                                                   const V3 (&cb)[TreeConsts<NQ, S>::RPL], W& s,
                                                   float (&bias)[TreeConsts<NQ, S>::RPL],
                                                   V3 (&axr)[TreeConsts<NQ, S>::RPL],
                                                   V3 (&xr)[TreeConsts<NQ, S>::RPL]) {
  const int lane = team.lane;
  for (int d = max_depth; d >= 0; --d) {
#pragma unroll
    for (int r = 0; r < TreeConsts<NQ, S>::RPL; ++r) {
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
}

// The Cholesky factor of an N x N SPD matrix, right-looking: lane i holds
// row i in row[i / SIZE] (its entries past the diagonal are never read);
// pivot j's d and each scaled entry L[k][j] are broadcast. Element (i, k)
// sees the same subtractions in the same order as chol_factor's
// left-looking sums, and the same scaling by 1 / d; a non-positive pivot
// gives a NaN, as sqrtf does. Leaves L[i][k] (k < i) in the row, and d_j and
// 1 / d_j in Ld[j] and Lr[j], written by row j's lane.
template <int N, class Team>
__device__ __forceinline__ void chol_factor_team(
    const Team& team, float (&row)[(N + Team::SIZE - 1) / Team::SIZE][N], float* Ld,
    float* Lr) {
  constexpr int S = Team::SIZE, RPL = (N + S - 1) / S;
  const int lane = team.lane;
#pragma unroll
  for (int j = 0; j < N; ++j) {
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
    for (int kk = j + 1; kk < N; ++kk) {
      const float lk = team.bcast(l[kk / S], kk % S);
#pragma unroll
      for (int r = 0; r < RPL; ++r)  // entries above the diagonal are never read
        row[r][kk] = row[r][kk] - l[r] * lk;
    }
    if (lane == j % S) {
      Ld[j] = dj;
      Lr[j] = 1.f / dj;
    }
  }
}

// The lane's registers of the rollout's state: its joints' q, v, u.
template <int RPL>
struct LaneState {
  float q[RPL], v[RPL], u[RPL];
};

// The lanes that own the cube's corners: corner c is on lane c + C0 (one
// corner per lane from the top of a team of 8 or more), or c % SIZE.
template <int S>
struct Corners {
  static constexpr int C0 = S >= 8 ? S - 8 : 0;
  static constexpr int PER_LANE = S >= 8 ? 1 : (8 + S - 1) / S;
  // the lane's r-th corner, or -1
  static __device__ __forceinline__ int of(int lane, int r) {
    const int c = lane - C0 + r * S;
    return c >= 0 && c < 8 ? c : -1;
  }
};

// ---- the contact model on a team (contact_rows' arithmetic) ----
// Each fingertip on a lane of its own (tip t on lane t % SIZE), each cube
// corner on a lane of its own (Corners), a sync, each corner's a0 and force
// on its lane, a sync, then one lane sums the tips' and the corners' forces
// in contact_rows' order. contacts_team runs the whole of it; the team
// substep runs the same pieces (tip_contact on its tip lanes,
// corner_lanes, corner_forces_team, contact_sums) where its other work
// overlaps them. The values that lanes pass to each other live in the
// caller's working set w: tip_fc, tip_tc, tip_f, touch (T each), and
// corner_pen, corner_fc, corner_tc (8 each).

// What a lane keeps of its corners between the two halves: corner
// Corners<S>::of(lane, r) in slot r.
template <int S>
struct CornerLanes {
  static constexpr int R = Corners<S>::PER_LANE;
  V3 arm[R], vc[R];
  float pen[R];
  bool over[R];
};

// Each of the lane's corners against the table (corner_state); its
// penetration into w.corner_pen for the other corners' count.
template <int S, class Work>
__device__ __forceinline__ void corner_lanes(int lane, const M3& R, const Cube& cube,
                                             CornerLanes<S>& cl, Work& w) {
#pragma unroll
  for (int r = 0; r < Corners<S>::PER_LANE; ++r) {
    const int c = Corners<S>::of(lane, r);
    if (c < 0) continue;
    corner_state(R, cube, c, cl.arm[r], cl.pen[r], cl.vc[r], cl.over[r]);
    w.corner_pen[c] = cl.pen[r];
  }
}

// After a sync that shows every tip's and corner's values: each of the
// lane's corners sums the tips' force and torque in tip order (the one
// Gauss-Seidel pass), then its a0 and its force into w.corner_fc,
// w.corner_tc. av is the cube's angular velocity.
template <int T, int S, class Work>
__device__ __forceinline__ void corner_forces_team(int lane, V3 av, const CornerLanes<S>& cl,
                                                   Work& w) {
  const V3 zero{0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < Corners<S>::PER_LANE; ++r) {
    const int c = Corners<S>::of(lane, r);
    if (c < 0) continue;
    V3 force = zero, torque = zero;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      force = force + w.tip_fc[t];
      torque = torque + w.tip_tc[t];
    }
    V3 acc_com, alpha;
    cube_acc(force, torque, acc_com, alpha);
    float n_act = 0.f;
#pragma unroll
    for (int c2 = 0; c2 < 8; ++c2) n_act += w.corner_pen[c2] > 0.f ? 1.f : 0.f;
    const float m_eff = (float)CUBE_MASS / fmaxf(n_act, 1.f);
    const float a0 = corner_a0(acc_com, alpha, av, cl.arm[r]);
    corner_force(cl.pen[r], cl.vc[r], a0, m_eff, cl.arm[r], w.corner_fc[c], w.corner_tc[c]);
  }
}

// After a sync that shows every corner's force: the force and torque on
// the cube, the tips' then the corners', in contact_rows' order.
template <int T, class Work>
__device__ __forceinline__ void contact_sums(const Work& w, V3& force, V3& torque) {
  force = V3{0.f, 0.f, 0.f};
  torque = V3{0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < T; ++t) {
    force = force + w.tip_fc[t];
    torque = torque + w.tip_tc[t];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    force = force + w.corner_fc[c];
    torque = torque + w.corner_tc[c];
  }
}

// contact_rows on a team: tip t's position, velocity and radius at
// tip_p[3t], tip_v[3t], radius[t]. w also has corner_table (8): each
// corner on the table, penetrating. Leaves every tip's force and flag in
// w.tip_f, w.touch (each written by the tip's own lane), and on lane
// SIZE - 1 only the cube's force and torque and whether a corner touches
// the table.
template <int T, class Team, class Work>
__device__ __forceinline__ void contacts_team(const Team& team, const Cube& cube,
                                              const float* tip_p, const float* tip_v,
                                              const float* radius, Work& w, V3& force,
                                              V3& torque, bool& touching) {
  constexpr int S = Team::SIZE;
  const int lane = team.lane;
  const M3 R = quat_to_mat(cube.quat);
  force = torque = V3{0.f, 0.f, 0.f};
  touching = false;
  for (int t = lane; t < T; t += S) {
    const V3 p{tip_p[3 * t], tip_p[3 * t + 1], tip_p[3 * t + 2]};
    const V3 v{tip_v[3 * t], tip_v[3 * t + 1], tip_v[3 * t + 2]};
    tip_contact(R, cube, p, v, radius[t], w.tip_fc[t], w.tip_tc[t], w.tip_f[t], w.touch[t]);
  }
  CornerLanes<S> cl;
  corner_lanes<S>(lane, R, cube, cl, w);
#pragma unroll
  for (int r = 0; r < Corners<S>::PER_LANE; ++r) {
    const int c = Corners<S>::of(lane, r);
    if (c >= 0) w.corner_table[c] = cl.pen[r] > 0.f && cl.over[r];
  }
  team.sync();
  KMANIP_PHASE(1);  // the tips and the corners' states
  corner_forces_team<T, S>(lane, cube.av, cl, w);
  team.sync();
  KMANIP_PHASE(2);  // the corners' forces
  if (lane == S - 1) {
    contact_sums<T>(w, force, torque);
#pragma unroll
    for (int c = 0; c < 8; ++c) touching = touching | w.corner_table[c];
  }
}

// One substep of the team's rollout, substep_core(m, c, CONTACT, IMPLICIT,
// ...) on the lanes' state st and the cube in s.cube. CUBE = false skips
// the cube's integration (the feedback rollout pins the cube, and a
// contact-free substep never reads it). Leaves the post-step q, v in s.q,
// s.v (and st), the PRE-step frames in s.x, s.qq, the touch flags in
// s.touch, the post-step cube in s.cube.
template <int NQ, int T, bool CONTACT, bool IMPLICIT, bool CUBE, class Team>
__device__ void substep_team(const Team& team, const ModelView<NQ, T>& m, const StepConsts& c,
                             const LaneConsts<NQ, T, Team::SIZE>& k,
                             LaneState<LaneConsts<NQ, T, Team::SIZE>::RPL>& st,
                             const TeamModel<NQ, T>& M, TeamWork<NQ, T>& s) {
  constexpr int S = Team::SIZE;
  constexpr int RPL = LaneConsts<NQ, T, S>::RPL, RPE = LaneConsts<NQ, T, S>::RPE;
  constexpr int NTRI = TeamWork<NQ, T>::NTRI;
  const int lane = team.lane;
  const V3 zero{0.f, 0.f, 0.f};
  fk_team<NQ, S>(team, k, M.max_depth, st.q, st.v, s);

  KMANIP_PHASE(1);  // FK
  // inertial loads (rnea_rows), fingertips with their cube contacts, the
  // corners' state, and the COM-Jacobian columns of every (body, ancestor)
  // pair (substep_core's mass matrix)
  V3 cb[RPL];
  inertial_loads_team<NQ, S>(lane, k, s, cb);
  for (int t = lane; t < T; t += S) {
    const int par = m.tip_parent(t);
    const V3 xp = s.x[par];
    const V3 p = xp + qrot(s.qq[par], m.tip_pos(t));
    s.tip_p[t] = p;
    if (CONTACT) {
      const Cube cube = s.cube;
      const V3 v = s.vb[par] + cross(s.w[par], p - xp);
      tip_contact(quat_to_mat(cube.quat), cube, p, v, m.tip_radius(t), s.tip_fc[t], s.tip_tc[t],
                  s.tip_f[t], s.touch[t]);
    } else if (CUBE) {  // no forces: the reactions below add zero (the feedback
      s.touch[t] = false;  // rollout, CUBE = false, never reads the flags)
    }
  }
  CornerLanes<S> cl;
  if (CONTACT) {
    const Cube cube = s.cube;
    corner_lanes<S>(lane, quat_to_mat(cube.quat), cube, cl, s);
  }
  for (int p = lane; p < M.n_pairs; p += S) {
    const int i = M.pair_body[p], j = M.pair_joint[p];
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
  // the corners' forces on the cube: the tips' force first (contact_rows'
  // sums, in tip order), then each corner's a0 and force
  if (CONTACT) corner_forces_team<T, S>(lane, s.cube.av, cl, s);
  KMANIP_PHASE(8);  // the corners' forces
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
    if (j == kk) acc = acc + M.diag_extra[j];
    s.L[e] = acc;
  }
  KMANIP_PHASE(3);  // mass matrix
  // the RNEA backward pass level by level
  float bias[RPL];
  V3 axr[RPL], xr[RPL];
  rnea_backward_team<NQ, S>(team, k, M.max_depth, cb, s, bias, axr, xr);
  // the cube: the contact force and torque summed in contact_rows' order
  // (tips, then corners), then its integration, by the last lane; nothing
  // reads s.cube again in this substep
  if (CUBE && lane == S - 1) {
    V3 force = zero, torque = zero;
    if (CONTACT) contact_sums<T>(s, force, torque);
    Cube cube = s.cube;
    integrate_cube(c, force, torque, cube);
    s.cube = cube;
  }
  KMANIP_PHASE(9);  // the cube's sums and integration
  // each joint's torque: clamped servo, damping, bias, stable-PD term, and
  // the contact reactions tau_j += jv_{t,j} . f_t
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
    if (IMPLICIT && i < k.nu) t_i = t_i - k.kp_dt[r] * st.v[r];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      if (!((k.tips[r] >> t) & 1u)) continue;
      V3 jv = k.hinge[r] ? cross(axr[r], s.tip_p[t] - xr[r]) : axr[r];
      t_i = t_i + dot(jv, CONTACT ? s.tip_f[t] : zero);
    }
    s.tau[i] = t_i;
  }

  KMANIP_PHASE(4);  // RNEA backward pass, torques
  // Cholesky factor (chol_factor_team): lane i holds row i
  float row[RPL][NQ];
#pragma unroll
  for (int r = 0; r < RPL; ++r) {
    const int i = lane + r * S;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) row[r][kk] = (i < NQ && kk <= i) ? s.L[tri(i, kk)] : 0.f;
    Mdiag[r] = i < NQ ? pick<NQ>(row[r], i) : 0.f;
  }
  chol_factor_team<NQ>(team, row, s.Ld, s.Lr);
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

// K1's body: row `row` of the caller's (K, n) tensors through one substep
// on a team; `valid` false runs the row without writing it (the idle team
// of a half-warp pair). M is loaded; every lane of the team calls this.
template <int NQ, int T, bool CONTACT, bool IMPLICIT, class Team>
__device__ void substep_team_row(const Team& team, const TeamModel<NQ, T>& M, TeamWork<NQ, T>& s,
                                 const StepConsts& c, int row, bool valid,
                                 const float* __restrict__ qpos, const float* __restrict__ qvel,
                                 const float* __restrict__ ctrl, const float* __restrict__ cube13,
                                 float* __restrict__ qpos_out, float* __restrict__ qvel_out,
                                 float* __restrict__ cube_out, bool* __restrict__ touch_out,
                                 float* __restrict__ xpos_out, float* __restrict__ xquat_out) {
  constexpr int S = Team::SIZE;
  using LC = LaneConsts<NQ, T, S>;
  const int lane = team.lane;
  const ModelView<NQ, T> m{M.mf, M.mi};
  const LC k = lane_consts<NQ, T, S>(M, lane, c);
  const int nu = k.nu;
  LaneState<LC::RPL> st;
#pragma unroll
  for (int r = 0; r < LC::RPL; ++r) {
    const int i = lane + r * S < NQ ? lane + r * S : NQ - 1;
    st.q[r] = qpos[(long)row * NQ + i];
    st.v[r] = qvel[(long)row * NQ + i];
    st.u[r] = i < nu ? ctrl[(long)row * nu + i] : 0.f;
  }
  if (lane == 0) s.cube = cube_from(cube13 + (long)row * 13);
  team.sync();
  KMANIP_PHASE(11);  // the model's load, the lane constants, the inputs
  substep_team<NQ, T, CONTACT, IMPLICIT, true>(team, m, c, k, st, M, s);
  team.sync();
  KMANIP_PHASE(7);  // integration
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < LC::RPL; ++r) {
    const int i = lane + r * S;
    if (i >= NQ) continue;
    const long o = (long)row * NQ + i;
    qpos_out[o] = st.q[r];
    qvel_out[o] = st.v[r];
    const V3 x = s.x[i];
    const Q4 qq = s.qq[i];
    float* xp = xpos_out + o * 3;
    xp[0] = x.x;
    xp[1] = x.y;
    xp[2] = x.z;
    float* xq = xquat_out + o * 4;
    xq[0] = qq.w;
    xq[1] = qq.x;
    xq[2] = qq.y;
    xq[3] = qq.z;
  }
  if (lane == 0) cube_to(s.cube, cube_out + (long)row * 13);
  for (int t = lane; t < T; t += S) touch_out[(long)row * T + t] = s.touch[t];
  KMANIP_PHASE(12);  // the outputs
}

}  // namespace kmanip
