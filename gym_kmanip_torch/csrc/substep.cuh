// Device functions of the physics substep: FK + RNEA (rnea_rows), the
// contact model (contact_rows, on per-tip and per-corner helpers) and the
// whole substep (substep_core), one rollout per thread. They follow the JAX
// package's Pallas row cores op for op:
// gym_kmanip_tpu/ops/pallas_dynamics.py::_rnea_rows,
// ops/pallas_contacts.py::_contact_rows and
// ops/pallas_substep.py::_substep_core. The staged kernels K5-K7
// (staged.cuh) run these per item; the team substep of K1, K2 and K3
// (substep_team.cuh) splits the same arithmetic over the lanes of a warp,
// calling the same helpers, and substep_core is its serial reference on the
// host build.
//
// Numerics: float32 throughout, like JAX with x64 off. Constants are
// written in double and rounded to float at use, which is what JAX does
// with a Python float against a float32 array. Built without
// --use_fast_math (sinf, cosf and sqrtf stay accurate) and with
// --fmad=false (see ops/_build.py).
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace kmanip {

// ---- constants (gym_kmanip_torch/constants.py) ----
constexpr double GRAV_Z = -9.81;
constexpr double CUBE_HALF = 0.02;
constexpr double CUBE_MASS = 0.05;
constexpr double CUBE_INERTIA = 0.002;
constexpr double CUBE_FRICTIONLOSS = 0.01;
constexpr double CUBE_MAX_LINVEL = 4.0;
constexpr double CUBE_MAX_ANGVEL = 50.0;
constexpr double TABLE_X = 0.0;
constexpr double TABLE_Y = 0.6;
constexpr double TABLE_TOP_Z = 0.6;
constexpr double TABLE_HALF_X = 0.6;
constexpr double TABLE_HALF_Y = 0.4;
constexpr double CONTACT_KAPPA = 1.0 / (0.01 * 0.01);
constexpr double CONTACT_BETA = 2.0 / 0.01;
constexpr double CONTACT_MU = 1.0;
constexpr double CONTACT_SLIP_VEL = 0.01;
constexpr double JOINT_DAMPING = 1.0;
constexpr double LIMIT_KAPPA = 1.0 / (0.02 * 0.02);
constexpr double LIMIT_BETA = 2.0 / 0.02;
constexpr double LIMIT_IMPEDANCE = 0.95;
constexpr double LIMIT_SAFETY_MARGIN = 0.5;
constexpr int CONSTRAINT_ITERS = 3;
constexpr double FRICTION_BETA = 2.0 / (0.95 * 0.02);
constexpr double FRICTION_IMPEDANCE = 0.9;
constexpr int HINGE = 0;

// ---- small vector algebra ----
struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};
struct M3 {
  float m[3][3];
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }
__device__ __forceinline__ float signf(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}

// v + 2 (w u x v + u x (u x v))
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 u{q.x, q.y, q.z};
  V3 uv = cross(u, v);
  V3 uuv = cross(u, uv);
  return {v.x + 2.f * (q.w * uv.x + uuv.x), v.y + 2.f * (q.w * uv.y + uuv.y),
          v.z + 2.f * (q.w * uv.z + uuv.z)};
}

__device__ __forceinline__ M3 quat_to_mat(Q4 q) {
  float w = q.w, x = q.x, y = q.y, z = q.z;
  return {{{1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)},
           {2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)},
           {2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)}}};
}

__device__ __forceinline__ V3 rmul(const M3& R, V3 v) {
  return {R.m[0][0] * v.x + R.m[0][1] * v.y + R.m[0][2] * v.z,
          R.m[1][0] * v.x + R.m[1][1] * v.y + R.m[1][2] * v.z,
          R.m[2][0] * v.x + R.m[2][1] * v.y + R.m[2][2] * v.z};
}

__device__ __forceinline__ V3 rtmul(const M3& R, V3 v) {
  return {R.m[0][0] * v.x + R.m[1][0] * v.y + R.m[2][0] * v.z,
          R.m[0][1] * v.x + R.m[1][1] * v.y + R.m[2][1] * v.z,
          R.m[0][2] * v.x + R.m[1][2] * v.y + R.m[2][2] * v.z};
}

// R diag(I) R^T y
__device__ __forceinline__ V3 iw_mul(const M3& R, V3 I, V3 y) {
  V3 r = rtmul(R, y);
  return rmul(R, V3{r.x * I.x, r.y * I.y, r.z * I.z});
}

// ---- the packed model (built by gym_kmanip_torch/ops/substep_cuda.py) ----
// floats: jnt_pos[3NQ] jnt_quat[4NQ] mass[NQ] com[3NQ] inertia[3NQ]
//         armature[NQ] kp[NQ] force_lo[NQ] force_hi[NQ] range_lo[NQ]
//         range_hi[NQ] frictionloss[NQ] tip_pos[3T] tip_radius[T]
//         (kp, force_lo/hi padded past nu)
// ints:   parent[NQ] jnt_type[NQ] ancestors[NQ*NQ] tip_parent[T] nu
template <int NQ, int T>
struct ModelView {
  const float* __restrict__ f;
  const int* __restrict__ i;

  static constexpr int F_JPOS = 0, F_JQUAT = 3 * NQ, F_MASS = 7 * NQ, F_COM = 8 * NQ,
                       F_INERTIA = 11 * NQ, F_ARMATURE = 14 * NQ, F_KP = 15 * NQ,
                       F_FLO = 16 * NQ, F_FHI = 17 * NQ, F_RLO = 18 * NQ, F_RHI = 19 * NQ,
                       F_FL = 20 * NQ, F_TIPPOS = 21 * NQ, F_TIPRAD = 21 * NQ + 3 * T,
                       N_FLOATS = 21 * NQ + 4 * T;
  static constexpr int I_PARENT = 0, I_TYPE = NQ, I_ANC = 2 * NQ, I_TIPPAR = 2 * NQ + NQ * NQ,
                       I_NU = 2 * NQ + NQ * NQ + T, N_INTS = I_NU + 1;

  __device__ __forceinline__ V3 v3(int off) const { return {f[off], f[off + 1], f[off + 2]}; }
  __device__ __forceinline__ V3 jnt_pos(int j) const { return v3(F_JPOS + 3 * j); }
  __device__ __forceinline__ Q4 jnt_quat(int j) const {
    int o = F_JQUAT + 4 * j;
    return {f[o], f[o + 1], f[o + 2], f[o + 3]};
  }
  __device__ __forceinline__ float mass(int j) const { return f[F_MASS + j]; }
  __device__ __forceinline__ V3 com(int j) const { return v3(F_COM + 3 * j); }
  __device__ __forceinline__ V3 inertia(int j) const { return v3(F_INERTIA + 3 * j); }
  __device__ __forceinline__ float armature(int j) const { return f[F_ARMATURE + j]; }
  __device__ __forceinline__ float kp(int j) const { return f[F_KP + j]; }
  __device__ __forceinline__ float force_lo(int j) const { return f[F_FLO + j]; }
  __device__ __forceinline__ float force_hi(int j) const { return f[F_FHI + j]; }
  __device__ __forceinline__ float range_lo(int j) const { return f[F_RLO + j]; }
  __device__ __forceinline__ float range_hi(int j) const { return f[F_RHI + j]; }
  __device__ __forceinline__ float frictionloss(int j) const { return f[F_FL + j]; }
  __device__ __forceinline__ V3 tip_pos(int t) const { return v3(F_TIPPOS + 3 * t); }
  __device__ __forceinline__ float tip_radius(int t) const { return f[F_TIPRAD + t]; }
  __device__ __forceinline__ int parent(int j) const { return i[I_PARENT + j]; }
  __device__ __forceinline__ bool hinge(int j) const { return i[I_TYPE + j] == HINGE; }
  __device__ __forceinline__ bool anc(int body, int j) const { return i[I_ANC + body * NQ + j] != 0; }
  __device__ __forceinline__ int tip_parent(int t) const { return i[I_TIPPAR + t]; }
  __device__ __forceinline__ int nu() const { return i[I_NU]; }
};

// Per-call scalars, derived from dt in double on the host (as the JAX
// package derives them from Python floats).
struct StepConsts {
  double dt;       // for dt * kp and the diagonal terms, rounded per joint
  float dt_f;      // dt
  float lv_scale;  // dt / cube mass
  float lv_grav;   // dt * g_z
  float av_scale;  // dt / cube inertia
  float cap_l;     // dt * frictionloss / cube mass
  float cap_a;     // dt * frictionloss / cube inertia
};

struct Cube {
  V3 pos;
  Q4 quat;
  V3 lv, av;
};

// ---- FK + RNEA (pallas_dynamics._rnea_rows) ----
// Outputs per joint: world origin x, orientation qq, axis, angular velocity
// w, origin velocity vb, rotation R, and bias = C(q,v)v + g(q).
template <int NQ, int T>
__device__ void rnea_rows(const ModelView<NQ, T>& m, const float* q, const float* v, V3* x,
                          Q4* qq, V3* axis, V3* w, V3* vb, M3* R, float* bias) {
  const V3 zero{0.f, 0.f, 0.f};
  const V3 ez{0.f, 0.f, 1.f};
  V3 alpha[NQ], a[NQ];
  for (int i = 0; i < NQ; ++i) {
    int par = m.parent(i);
    V3 xp, wp, vp, alp, ap;
    Q4 qp;
    if (par < 0) {
      xp = zero;
      qp = Q4{1.f, 0.f, 0.f, 0.f};
      wp = zero;
      vp = zero;
      alp = zero;
      ap = V3{0.f, 0.f, (float)(-GRAV_Z)};  // the base "accelerates" at -g
    } else {
      xp = x[par];
      qp = qq[par];
      wp = w[par];
      vp = vb[par];
      alp = alpha[par];
      ap = a[par];
    }
    V3 r = qrot(qp, m.jnt_pos(i));
    V3 xi = xp + r;
    Q4 qi = qmul(qp, m.jnt_quat(i));
    V3 wi, ali, vi, ai, ax;
    if (m.hinge(i)) {
      float half = 0.5f * q[i];
      qi = qmul(qi, Q4{cosf(half), 0.f, 0.f, sinf(half)});
      ax = qrot(qi, ez);
      wi = wp + ax * v[i];
      ali = alp + cross(wp, ax * v[i]);
      vi = vp + cross(wp, r);
      ai = ap + cross(alp, r) + cross(wp, cross(wp, r));
    } else {  // slide along local z: the joint origin rides the slide
      ax = qrot(qi, ez);
      xi = xi + ax * q[i];
      wi = wp;
      ali = alp;
      V3 r_eff = r + ax * q[i];
      vi = vp + cross(wp, r_eff) + ax * v[i];
      ai = ap + cross(alp, r_eff) + cross(wp, cross(wp, r_eff)) + cross(wp, ax * v[i]) * 2.f;
    }
    x[i] = xi;
    qq[i] = qi;
    axis[i] = ax;
    w[i] = wi;
    vb[i] = vi;
    alpha[i] = ali;
    a[i] = ai;
  }

  // inertial loads at each COM (world frame), then the backward pass
  V3 F[NQ], N[NQ], c[NQ];
  for (int i = 0; i < NQ; ++i) {
    c[i] = qrot(qq[i], m.com(i));
    V3 a_com = a[i] + cross(alpha[i], c[i]) + cross(w[i], cross(w[i], c[i]));
    R[i] = quat_to_mat(qq[i]);
    V3 I = m.inertia(i);
    F[i] = a_com * m.mass(i);
    N[i] = iw_mul(R[i], I, alpha[i]) + cross(w[i], iw_mul(R[i], I, w[i]));
  }
  for (int i = NQ - 1; i >= 0; --i) {
    V3 Fi = F[i];
    V3 Ni = N[i] + cross(c[i], F[i]);
    for (int ch = i + 1; ch < NQ; ++ch) {
      if (m.parent(ch) == i) {
        Fi = Fi + F[ch];
        Ni = Ni + N[ch] + cross(x[ch] - x[i], F[ch]);
      }
    }
    F[i] = Fi;
    N[i] = Ni;
    bias[i] = m.hinge(i) ? dot(axis[i], Ni) : dot(axis[i], Fi);
  }
}

// ---- contacts (pallas_contacts._contact_rows) ----
__device__ __forceinline__ float normal_force(float pen, float vn, float a0, float m_eff) {
  float aref = (float)CONTACT_KAPPA * pen - (float)CONTACT_BETA * vn;
  return pen > 0.f ? m_eff * fmaxf(aref - a0, 0.f) : 0.f;
}

__device__ __forceinline__ V3 friction(float fn, V3 vt) {
  float speed = sqrtf(vt.x * vt.x + vt.y * vt.y + vt.z * vt.z +
                      (float)(CONTACT_SLIP_VEL * CONTACT_SLIP_VEL));
  float s = -(float)CONTACT_MU * fn / speed;
  return vt * s;
}

// Fingertip sphere (position p, velocity v, radius r) against the cube box
// (rotation R): the force on the cube f_on_cube and its moment about the
// cube's centre arm_x_f, the force on the tip tip_f, and whether the tip
// touches.
__device__ __forceinline__ void tip_contact(const M3& R, const Cube& cube, V3 p, V3 v, float r,
                                            V3& f_on_cube, V3& arm_x_f, V3& tip_f,
                                            bool& touch) {
  const float h = (float)CUBE_HALF;
  V3 local = rtmul(R, p - cube.pos);
  V3 delta = local - V3{clampf(local.x, -h, h), clampf(local.y, -h, h), clampf(local.z, -h, h)};
  float sq = dot(delta, delta);
  bool outside = sq > 1e-18f;
  float dist = sqrtf(outside ? sq : 1.f);
  V3 n_out = delta * (1.f / dist);
  float pen_out = r - dist;
  // inside: exit through the nearest face (first one on a tie)
  V3 fd{h - fabsf(local.x), h - fabsf(local.y), h - fabsf(local.z)};
  bool m01 = fd.x <= fd.y;
  float fd01 = m01 ? fd.x : fd.y;
  bool ax0 = m01 && (fd.x <= fd.z);
  bool ax1 = (!m01) && (fd.y <= fd.z);
  bool ax2 = !(ax0 || ax1);
  V3 n_in{ax0 ? signf(local.x + 1e-12f) : 0.f, ax1 ? signf(local.y + 1e-12f) : 0.f,
          ax2 ? signf(local.z + 1e-12f) : 0.f};
  float pen_in = r + (fd01 <= fd.z ? fd01 : fd.z);
  float pen = outside ? pen_out : pen_in;
  V3 n = rmul(R, outside ? n_out : n_in);
  V3 cpoint = p - n * (r - fmaxf(pen, 0.f) * 0.5f);
  V3 arm = cpoint - cube.pos;
  V3 v_rel = v - (cube.lv + cross(cube.av, arm));
  float vn = dot(v_rel, n);
  float a0 = -(0.f * n.x + 0.f * n.y + (float)GRAV_Z * n.z);
  float fn = normal_force(pen, vn, a0, (float)CUBE_MASS);
  V3 fr = friction(fn, v_rel - n * vn);
  f_on_cube = (n * fn) * -1.f - fr;
  arm_x_f = cross(arm, f_on_cube);
  tip_f = n * fn + fr;
  touch = pen > 0.f;
}

// Cube corner c (bit 2: +x, bit 1: +y, bit 0: +z) against the table plane,
// or the floor off the table: its arm from the centre, penetration,
// velocity, and whether it is over the table.
__device__ __forceinline__ void corner_state(const M3& R, const Cube& cube, int c, V3& arm,
                                             float& pen, V3& vc, bool& over) {
  const float h = (float)CUBE_HALF;
  float sx = (c & 4) ? 1.f : -1.f, sy = (c & 2) ? 1.f : -1.f, sz = (c & 1) ? 1.f : -1.f;
  arm = rmul(R, V3{sx * h, sy * h, sz * h});
  V3 cw = cube.pos + arm;
  over = fabsf(cw.x - (float)TABLE_X) < (float)TABLE_HALF_X &&
         fabsf(cw.y - (float)TABLE_Y) < (float)TABLE_HALF_Y;
  pen = (over ? (float)TABLE_TOP_Z : 0.f) - cw.z;
  vc = cube.lv + cross(cube.av, arm);
}

// The cube's accelerations under the fingertips' force and torque alone
// (the one Gauss-Seidel pass: they feed the corners' a0).
__device__ __forceinline__ void cube_acc(V3 force, V3 torque, V3& acc_com, V3& alpha) {
  acc_com = V3{force.x + (float)(CUBE_MASS * 0.0), force.y + (float)(CUBE_MASS * 0.0),
               force.z + (float)(CUBE_MASS * GRAV_Z)} *
            (float)(1.0 / CUBE_MASS);
  alpha = torque * (float)(1.0 / CUBE_INERTIA);
}

// Corner's normal acceleration before its own contact force.
__device__ __forceinline__ float corner_a0(V3 acc_com, V3 alpha, V3 av, V3 arm) {
  V3 a_corner = acc_com + (cross(alpha, arm) + cross(av, cross(av, arm)));
  return a_corner.z;
}

// The corner's contact force f on the cube and its moment arm_x_f.
__device__ __forceinline__ void corner_force(float pen, V3 vc, float a0, float m_eff, V3 arm,
                                             V3& f, V3& arm_x_f) {
  float fn = normal_force(pen, vc.z, a0, m_eff);
  V3 ft = friction(fn, V3{vc.x, vc.y, 0.f});
  f = V3{ft.x, ft.y, ft.z + fn};
  arm_x_f = cross(arm, f);
}

// Fingertip spheres vs the cube box FIRST (their force on the cube feeds
// the table contact's a0: one Gauss-Seidel pass), then the 8 cube corners
// vs the table plane (or the floor off the table).
template <int T>
__device__ void contact_rows(const float* tip_radius, const V3* tip_p, const V3* tip_v,
                             const Cube& cube, V3& force, V3& torque, V3* tip_f, bool* touch,
                             bool& touching) {
  const M3 R = quat_to_mat(cube.quat);
  force = V3{0.f, 0.f, 0.f};
  torque = V3{0.f, 0.f, 0.f};
  for (int t = 0; t < T; ++t) {
    V3 f_on_cube, arm_x_f;
    tip_contact(R, cube, tip_p[t], tip_v[t], tip_radius[t], f_on_cube, arm_x_f, tip_f[t],
                touch[t]);
    force = force + f_on_cube;
    torque = torque + arm_x_f;
  }

  V3 acc_com, alpha;
  cube_acc(force, torque, acc_com, alpha);
  touching = false;
  float n_act = 0.f;
  float pens[8], a0s[8];
  V3 vcs[8], arms[8];
  for (int c = 0; c < 8; ++c) {
    bool over;
    corner_state(R, cube, c, arms[c], pens[c], vcs[c], over);
    a0s[c] = corner_a0(acc_com, alpha, cube.av, arms[c]);
    n_act += pens[c] > 0.f ? 1.f : 0.f;
    touching = touching || (pens[c] > 0.f && over);
  }
  float m_eff = (float)CUBE_MASS / fmaxf(n_act, 1.f);
  for (int c = 0; c < 8; ++c) {
    V3 f, arm_x_f;
    corner_force(pens[c], vcs[c], a0s[c], m_eff, arms[c], f, arm_x_f);
    force = force + f;
    torque = torque + arm_x_f;
  }
}

// The cube's free body over one substep: contact force + gravity, dry
// frictionloss, the energy cap, then the safe quaternion integration.
__device__ __forceinline__ void integrate_cube(const StepConsts& c, V3 force_c, V3 torque_c,
                                               Cube& cube) {
  V3 lv = cube.lv + force_c * c.lv_scale;
  lv.z = lv.z + c.lv_grav;
  V3 av = cube.av + torque_c * c.av_scale;
  lv = V3{lv.x + clampf(-lv.x, -c.cap_l, c.cap_l), lv.y + clampf(-lv.y, -c.cap_l, c.cap_l),
          lv.z + clampf(-lv.z, -c.cap_l, c.cap_l)};
  av = V3{av.x + clampf(-av.x, -c.cap_a, c.cap_a), av.y + clampf(-av.y, -c.cap_a, c.cap_a),
          av.z + clampf(-av.z, -c.cap_a, c.cap_a)};
  const float ml = (float)CUBE_MAX_LINVEL, ma = (float)CUBE_MAX_ANGVEL;
  lv = V3{clampf(lv.x, -ml, ml), clampf(lv.y, -ml, ml), clampf(lv.z, -ml, ml)};
  av = V3{clampf(av.x, -ma, ma), clampf(av.y, -ma, ma), clampf(av.z, -ma, ma)};
  cube.pos = cube.pos + lv * c.dt_f;
  // safe quaternion integrate (small-angle Taylor branch)
  V3 rv = av * c.dt_f;
  float sq = dot(rv, rv);
  bool small = sq < 1e-14f;
  float angle = sqrtf(small ? 1.f : sq);
  float half = 0.5f * angle;
  float scale = small ? 0.5f - sq / 48.f : sinf(half) / angle;
  float ws = small ? 1.f - sq / 8.f : cosf(half);
  Q4 quat = qmul(Q4{ws, scale * rv.x, scale * rv.y, scale * rv.z}, cube.quat);
  float qn = sqrtf(fmaxf(quat.w * quat.w + quat.x * quat.x + quat.y * quat.y + quat.z * quat.z,
                         1e-12f));
  cube.quat = Q4{quat.w / qn, quat.x / qn, quat.y / qn, quat.z / qn};
  cube.lv = lv;
  cube.av = av;
}

// The cube's 13 floats: pos, quat (w, x, y, z), linvel, angvel.
__device__ __forceinline__ Cube cube_from(const float* cb) {
  return Cube{{cb[0], cb[1], cb[2]}, {cb[3], cb[4], cb[5], cb[6]}, {cb[7], cb[8], cb[9]},
              {cb[10], cb[11], cb[12]}};
}
__device__ __forceinline__ void cube_to(const Cube& cube, float* co) {
  const float vals[13] = {cube.pos.x,  cube.pos.y,  cube.pos.z, cube.quat.w, cube.quat.x,
                          cube.quat.y, cube.quat.z, cube.lv.x,  cube.lv.y,   cube.lv.z,
                          cube.av.x,   cube.av.y,   cube.av.z};
  for (int j = 0; j < 13; ++j) co[j] = vals[j];
}

// ---- dense Cholesky on a packed lower triangle (row i starts at i(i+1)/2) ----
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <int NQ>
__device__ void chol_factor(float* L) {
  for (int j = 0; j < NQ; ++j) {
    float s = L[tri(j, j)];
    for (int k = 0; k < j; ++k) s = s - L[tri(j, k)] * L[tri(j, k)];
    float d = sqrtf(s);
    L[tri(j, j)] = d;
    float inv_d = 1.f / d;
    for (int i = j + 1; i < NQ; ++i) {
      float t = L[tri(i, j)];
      for (int k = 0; k < j; ++k) t = t - L[tri(i, k)] * L[tri(j, k)];
      L[tri(i, j)] = t * inv_d;
    }
  }
}

// x <- (L L^T)^-1 b, in place
template <int NQ>
__device__ void chol_solve(const float* L, float* b) {
  for (int i = 0; i < NQ; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[tri(i, k)] * b[k];
    b[i] = s / L[tri(i, i)];
  }
  for (int i = NQ - 1; i >= 0; --i) {
    float s = b[i];
    for (int k = i + 1; k < NQ; ++k) s = s - L[tri(k, i)] * b[k];
    b[i] = s / L[tri(i, i)];
  }
}

// ---- the whole substep (pallas_substep._substep_core) ----
// Advances (q, v, cube) in place for one rollout. touch, x and qq receive
// the per-tip touch flags and the PRE-step frames.
template <int NQ, int T>
__device__ void substep_core(const ModelView<NQ, T>& m, const StepConsts& c, bool contact,
                             bool implicit, float* q, float* v, const float* ctrl, Cube& cube,
                             bool* touch, V3* x, Q4* qq) {
  const int nu = m.nu();
  V3 axis[NQ], w[NQ], vb[NQ];
  M3 R[NQ];
  float bias[NQ];
  rnea_rows<NQ, T>(m, q, v, x, qq, axis, w, vb, R, bias);

  // fingertip kinematics from the body frames
  V3 tip_p[T], tip_v[T], tip_f[T];
  float tip_r[T];
  for (int t = 0; t < T; ++t) {
    int par = m.tip_parent(t);
    V3 p = x[par] + qrot(qq[par], m.tip_pos(t));
    tip_p[t] = p;
    tip_v[t] = vb[par] + cross(w[par], p - x[par]);
    tip_r[t] = m.tip_radius(t);
  }

  V3 force_c{0.f, 0.f, 0.f}, torque_c{0.f, 0.f, 0.f};
  if (contact) {
    bool touching_table;
    contact_rows<T>(tip_r, tip_p, tip_v, cube, force_c, torque_c, tip_f, touch, touching_table);
  } else {
    for (int t = 0; t < T; ++t) {
      tip_f[t] = V3{0.f, 0.f, 0.f};
      touch[t] = false;
    }
  }

  // joint torques: clamped servo, engine damping, bias, stable-PD term
  float tau[NQ];
  for (int i = 0; i < NQ; ++i) {
    float t_i = 0.f;
    if (i < nu && m.kp(i) != 0.f) {
      float raw = m.kp(i) * (ctrl[i] - q[i]);
      t_i = t_i + clampf(raw, m.force_lo(i), m.force_hi(i));
    }
    t_i = t_i - (float)JOINT_DAMPING * v[i];
    t_i = t_i - bias[i];
    if (implicit && i < nu) t_i = t_i - (float)(c.dt * (double)m.kp(i)) * v[i];
    tau[i] = t_i;
  }
  // contact reaction torques: tau_j += jv_{t,j} . f_t
  for (int t = 0; t < T; ++t) {
    int par = m.tip_parent(t);
    for (int j = 0; j < NQ; ++j) {
      if (!m.anc(par, j)) continue;
      V3 jv = m.hinge(j) ? cross(axis[j], tip_p[t] - x[j]) : axis[j];
      tau[j] = tau[j] + dot(jv, tip_f[t]);
    }
  }

  // mass matrix by COM-Jacobian contraction, body by body
  float L[NQ * (NQ + 1) / 2];
  for (int e = 0; e < NQ * (NQ + 1) / 2; ++e) L[e] = 0.f;
  for (int i = 0; i < NQ; ++i) {
    V3 com_w = x[i] + qrot(qq[i], m.com(i));
    V3 I = m.inertia(i);
    float mass = m.mass(i);
    V3 J[NQ], IA[NQ];
    for (int j = 0; j < NQ; ++j) {
      if (!m.anc(i, j)) continue;
      if (m.hinge(j)) {
        J[j] = cross(axis[j], com_w - x[j]);
        IA[j] = iw_mul(R[i], I, axis[j]);
      } else {
        J[j] = axis[j];
      }
    }
    for (int j = 0; j < NQ; ++j) {
      if (!m.anc(i, j)) continue;
      for (int k = 0; k <= j; ++k) {
        if (!m.anc(i, k)) continue;
        float s = L[tri(j, k)] + mass * dot(J[j], J[k]);
        if (m.hinge(j) && m.hinge(k)) s = s + dot(axis[j], IA[k]);
        L[tri(j, k)] = s;
      }
    }
  }
  float Mdiag[NQ];
  for (int i = 0; i < NQ; ++i) {
    double extra = (double)m.armature(i) + c.dt * JOINT_DAMPING;
    if (implicit && i < nu) extra += c.dt * c.dt * (double)m.kp(i);
    L[tri(i, i)] = L[tri(i, i)] + (float)extra;
    Mdiag[i] = L[tri(i, i)];
  }

  // solve, then limits + frictionloss as force-space dual Jacobi sweeps
  // reusing the factor (engine.constraint_qacc)
  chol_factor<NQ>(L);
  float qacc0[NQ], qacc[NQ], f_fric[NQ], f_lo[NQ], f_hi[NQ], df[NQ];
  for (int i = 0; i < NQ; ++i) {
    qacc0[i] = tau[i];
    f_fric[i] = f_lo[i] = f_hi[i] = 0.f;
  }
  chol_solve<NQ>(L, qacc0);
  for (int i = 0; i < NQ; ++i) qacc[i] = qacc0[i];
  const float d_imp = (float)LIMIT_IMPEDANCE, d_fr = (float)FRICTION_IMPEDANCE;
  for (int it = 0; it < CONSTRAINT_ITERS; ++it) {
    for (int i = 0; i < NQ; ++i) {
      float fl = m.frictionloss(i);
      if (fl != 0.f) {
        f_fric[i] = clampf(f_fric[i] + d_fr * Mdiag[i] * (-(float)FRICTION_BETA * v[i] - qacc[i]) -
                               (float)(1.0 - FRICTION_IMPEDANCE) * f_fric[i],
                           -fl, fl);
      }
      float viol_lo = m.range_lo(i) - q[i];
      float viol_hi = q[i] - m.range_hi(i);
      float aref_lo = (float)LIMIT_KAPPA * viol_lo - (float)LIMIT_BETA * v[i];
      float aref_hi = -(float)LIMIT_KAPPA * viol_hi - (float)LIMIT_BETA * v[i];
      f_lo[i] = viol_lo > 0.f ? fmaxf(f_lo[i] + d_imp * Mdiag[i] * (aref_lo - qacc[i]), 0.f) : 0.f;
      f_hi[i] = viol_hi > 0.f ? fminf(f_hi[i] + d_imp * Mdiag[i] * (aref_hi - qacc[i]), 0.f) : 0.f;
      df[i] = f_fric[i] + f_lo[i] + f_hi[i];
    }
    chol_solve<NQ>(L, df);
    for (int i = 0; i < NQ; ++i) qacc[i] = qacc0[i] + df[i];
  }

  // semi-implicit Euler with the wide safety clamp
  for (int i = 0; i < NQ; ++i) {
    float v_new = v[i] + c.dt_f * qacc[i];
    float q_new = q[i] + c.dt_f * v_new;
    float lo_s = m.range_lo(i) - (float)LIMIT_SAFETY_MARGIN;
    float hi_s = m.range_hi(i) + (float)LIMIT_SAFETY_MARGIN;
    bool stop = (q_new > hi_s && v_new > 0.f) || (q_new < lo_s && v_new < 0.f);
    q[i] = clampf(q_new, lo_s, hi_s);
    v[i] = stop ? 0.f : v_new;
  }

  // cube free body: contact force + gravity, dry frictionloss, energy cap
  integrate_cube(c, force_c, torque_c, cube);
}

// Rollout k of a batch: read its rows of the (K, n) inputs, run one
// substep, write its rows of the outputs. The serial reference of the team
// kernel K1 (substep_team.cuh): the host build holds the team substep to it
// bit for bit; no kernel launches it.
template <int NQ, int T>
__device__ void substep_rollout(int k, const ModelView<NQ, T>& m, const StepConsts& c,
                                bool contact, bool implicit, const float* __restrict__ qpos,
                                const float* __restrict__ qvel, const float* __restrict__ ctrl,
                                const float* __restrict__ cube13, float* __restrict__ qpos_out,
                                float* __restrict__ qvel_out, float* __restrict__ cube_out,
                                bool* __restrict__ touch_out, float* __restrict__ xpos_out,
                                float* __restrict__ xquat_out) {
  const int nu = m.nu();
  float q[NQ], v[NQ], u[NQ];
  for (int i = 0; i < NQ; ++i) {
    q[i] = qpos[k * NQ + i];
    v[i] = qvel[k * NQ + i];
    u[i] = i < nu ? ctrl[k * nu + i] : 0.f;
  }
  Cube cube = cube_from(cube13 + k * 13);

  bool touch[T];
  V3 x[NQ];
  Q4 qq[NQ];
  substep_core<NQ, T>(m, c, contact, implicit, q, v, u, cube, touch, x, qq);

  for (int i = 0; i < NQ; ++i) {
    qpos_out[k * NQ + i] = q[i];
    qvel_out[k * NQ + i] = v[i];
    float* xp = xpos_out + (k * NQ + i) * 3;
    xp[0] = x[i].x;
    xp[1] = x[i].y;
    xp[2] = x[i].z;
    float* xq = xquat_out + (k * NQ + i) * 4;
    xq[0] = qq[i].w;
    xq[1] = qq[i].x;
    xq[2] = qq[i].y;
    xq[3] = qq[i].z;
  }
  cube_to(cube, cube_out + k * 13);
  for (int t = 0; t < T; ++t) touch_out[k * T + t] = touch[t];
}

// The per-call scalars, derived from dt in double.
inline StepConsts make_consts(double dt) {
  StepConsts c;
  c.dt = dt;
  c.dt_f = (float)dt;
  c.lv_scale = (float)(dt * (1.0 / CUBE_MASS));
  c.lv_grav = (float)(dt * GRAV_Z);
  c.av_scale = (float)(dt * (1.0 / CUBE_INERTIA));
  c.cap_l = (float)(dt * CUBE_FRICTIONLOSS * (1.0 / CUBE_MASS));
  c.cap_a = (float)(dt * CUBE_FRICTIONLOSS * (1.0 / CUBE_INERTIA));
  return c;
}

}  // namespace kmanip
