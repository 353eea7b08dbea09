// Native (C++) float64 TRF IK for the env's host hot path.
//
// A copy of gym_kmanip_tpu/native/ik_native.cpp, the JAX package's native
// host IK, for the port (gym_kmanip_torch/native). The reference's
// per-step hot loop is its scipy least_squares TRF IK solve (the
// reference's ik_mujoco.py:129-135) -- tens of residual/Jacobian
// evaluations through native MuJoCo C per control step. This file is the
// native counterpart for the host side of the env's split pipeline
// (env/task.py make_task, cfg.ik_host64): the same f64 forward kinematics,
// the reference's analytic-Jacobian structure (quirks included), and the
// same STIR trust-region-reflective algorithm as solvers/ik_host.py -- a
// line-true C++ port of that module's numpy implementation.
//
// Differences vs the numpy twin are pure rounding: the trust-region
// subproblem here uses a one-sided Jacobi SVD instead of LAPACK gesdd, so
// singular vectors agree only to ~1e-14 -- solutions match the numpy path
// to <1e-9 rad in-distribution (tests/test_torch_env.py), and the
// golden-trace env-parity bands are asserted over this backend too.
//
// No external dependencies (no LAPACK/Eigen): matrices are tiny
// (m+n <= 6+3n <= 30-ish rows, n <= 8 columns), so unrolled loops and a
// Jacobi SVD are both simpler and faster than a BLAS round-trip. Built on
// demand by gym_kmanip_torch/native/__init__.py (g++ -O3 -shared), loaded
// via ctypes; the numpy path remains as the always-available fallback.

#include <cmath>
#include <cstring>
#include <algorithm>
#include <limits>

namespace {

constexpr int NQMAX = 32;   // max robot joints (torso has 22)
constexpr int NMAX = 12;    // max masked IK dofs (arms have 6-8)
constexpr int MMAX = 6 + 2 * NMAX;          // residual rows
constexpr int MAMAX = MMAX + NMAX;          // augmented rows
const double DEPS = std::numeric_limits<double>::epsilon();
const double INF = std::numeric_limits<double>::infinity();

// ---------------------------------------------------------------------
// quaternion utilities (wxyz, MuJoCo convention) — mirrors
// solvers/ik_host.py _qmul/_qconj/_qrot/_qmat/_qlog/_qsub
// ---------------------------------------------------------------------

inline void qmul(const double* a, const double* b, double* out) {
    const double w1 = a[0], x1 = a[1], y1 = a[2], z1 = a[3];
    const double w2 = b[0], x2 = b[1], y2 = b[2], z2 = b[3];
    out[0] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
    out[1] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
    out[2] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
    out[3] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
}

inline void qconj(const double* q, double* out) {
    out[0] = q[0]; out[1] = -q[1]; out[2] = -q[2]; out[3] = -q[3];
}

inline void cross3(const double* a, const double* b, double* out) {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
}

// v + 2 u x (u x v + w v), u = q.xyz
inline void qrot(const double* q, const double* v, double* out) {
    const double u[3] = {q[1], q[2], q[3]};
    double t[3], uxv[3];
    cross3(u, v, uxv);
    for (int i = 0; i < 3; ++i) t[i] = uxv[i] + q[0] * v[i];
    double uxt[3];
    cross3(u, t, uxt);
    for (int i = 0; i < 3; ++i) out[i] = v[i] + 2.0 * uxt[i];
}

inline void qmat(const double* q, double R[3][3]) {
    const double w = q[0], x = q[1], y = q[2], z = q[3];
    R[0][0] = 1 - 2 * (y * y + z * z); R[0][1] = 2 * (x * y - w * z); R[0][2] = 2 * (x * z + w * y);
    R[1][0] = 2 * (x * y + w * z); R[1][1] = 1 - 2 * (x * x + z * z); R[1][2] = 2 * (y * z - w * x);
    R[2][0] = 2 * (x * z - w * y); R[2][1] = 2 * (y * z + w * x); R[2][2] = 1 - 2 * (x * x + y * y);
}

// rotation vector of unit q, wrapped to (-pi, pi]
inline void qlog(const double* q, double* out) {
    const double w = q[0];
    const double vn = std::sqrt(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    if (vn < 1e-12) {
        const double s = 2.0 / std::max(w, DEPS);
        out[0] = q[1] * s; out[1] = q[2] * s; out[2] = q[3] * s;
        return;
    }
    double angle = 2.0 * std::atan2(vn, w);
    if (angle > M_PI) angle -= 2.0 * M_PI;
    const double s = angle / vn;
    out[0] = q[1] * s; out[1] = q[2] * s; out[2] = q[3] * s;
}

// mju_subQuat: v with qb (x) exp(v/2) = qa, in qb's local frame
inline void qsub(const double* qa, const double* qb, double* out) {
    double c[4], m[4];
    qconj(qb, c);
    qmul(c, qa, m);
    qlog(m, out);
}

// ---------------------------------------------------------------------
// model tables + forward kinematics (mirrors ik_host.fk_np)
// ---------------------------------------------------------------------

struct Model {
    int nq;
    const int* parent;     // (nq,)
    const int* jnt_type;   // (nq,) 0=hinge, 1=slide
    const double* jnt_pos;  // (nq,3)
    const double* jnt_quat; // (nq,4)
    int site_parent;
    const double* site_pos;  // (3,)
    const double* site_quat; // (4,)
    const unsigned char* anc_site; // (nq,) ancestors row of site_parent
};

struct FK {
    double xpos[NQMAX][3];
    double xquat[NQMAX][4];
    double axis_w[NQMAX][3];
};

void fk(const Model& M, const double* qpos, FK& out) {
    static const double QID[4] = {1.0, 0.0, 0.0, 0.0};
    static const double EZ[3] = {0.0, 0.0, 1.0};
    for (int i = 0; i < M.nq; ++i) {
        const int par = M.parent[i];
        const double* p_par;
        const double* q_par;
        double zero3[3] = {0, 0, 0};
        if (par < 0) { p_par = zero3; q_par = QID; }
        else { p_par = out.xpos[par]; q_par = out.xquat[par]; }
        double off[3];
        qrot(q_par, M.jnt_pos + 3 * i, off);
        double p[3] = {p_par[0] + off[0], p_par[1] + off[1], p_par[2] + off[2]};
        double q[4];
        qmul(q_par, M.jnt_quat + 4 * i, q);
        if (M.jnt_type[i] == 0) {  // hinge about local z
            const double half = 0.5 * qpos[i];
            const double rz[4] = {std::cos(half), 0.0, 0.0, std::sin(half)};
            double q2[4];
            qmul(q, rz, q2);
            std::memcpy(q, q2, sizeof q2);
        } else {  // slide along local z
            double dz[3], zq[3] = {0.0, 0.0, qpos[i]};
            qrot(q, zq, dz);
            for (int c = 0; c < 3; ++c) p[c] += dz[c];
        }
        std::memcpy(out.xpos[i], p, sizeof p);
        std::memcpy(out.xquat[i], q, sizeof q);
    }
    for (int i = 0; i < M.nq; ++i) qrot(out.xquat[i], EZ, out.axis_w[i]);
}

void site_pose(const Model& M, const FK& f, double* p, double* q) {
    double off[3];
    qrot(f.xquat[M.site_parent], M.site_pos, off);
    for (int c = 0; c < 3; ++c) p[c] = f.xpos[M.site_parent][c] + off[c];
    qmul(f.xquat[M.site_parent], M.site_quat, q);
}

// ---------------------------------------------------------------------
// residual / Jacobian (reference quirks; mirrors _residual_np/_jacobian_np)
// ---------------------------------------------------------------------

struct Problem {
    Model model;
    int n;                 // masked dofs
    const int* mask;       // (n,) joint indices
    const double* lb;      // (n,)
    const double* ub;      // (n,)
    const double* goal_pos; // (3,)
    const double* goal_orn; // (4,)
    const double* q_home;   // (n,)
    const double* q_prev;   // (n,)
    double qpos_full[NQMAX];
    // weights
    double res_rad, reg_prev, reg_home, jac_rad, jac_reg;
    int m() const { return 6 + 2 * n; }
};

void residual(const Problem& P, const double* x, double* res) {
    double qf[NQMAX];
    std::memcpy(qf, P.qpos_full, sizeof(double) * P.model.nq);
    for (int i = 0; i < P.n; ++i) qf[P.mask[i]] = x[i];
    FK f;
    fk(P.model, qf, f);
    double ee_pos[3], ee_quat[4];
    site_pose(P.model, f, ee_pos, ee_quat);
    for (int c = 0; c < 3; ++c) res[c] = ee_pos[c] - P.goal_pos[c];
    double dq[3];
    qsub(P.goal_orn, ee_quat, dq);
    for (int c = 0; c < 3; ++c) res[3 + c] = P.res_rad * dq[c];
    for (int i = 0; i < P.n; ++i) {
        res[6 + i] = P.reg_prev * (x[i] - P.q_prev[i]);
        res[6 + P.n + i] = P.reg_home * (x[i] - P.q_home[i]);
    }
}

// mjd_subQuat's Db via the same f64 central differences the numpy twin
// uses (h = 1e-7; ik_host._subquat_jac_b_np)
void subquat_jac_b(const double* qa, const double* qb, double D[3][3]) {
    const double h = 1e-7;
    for (int j = 0; j < 3; ++j) {
        double outp[3], outm[3];
        for (int sgn = 0; sgn < 2; ++sgn) {
            double ev[3] = {0, 0, 0};
            ev[j] = sgn == 0 ? h : -h;
            const double ang = std::abs(ev[j]);
            double dq[4];
            if (ang < 1e-300) { dq[0] = 1; dq[1] = dq[2] = dq[3] = 0; }
            else {
                dq[0] = std::cos(0.5 * ang);
                const double s = std::sin(0.5 * ang) / ang;
                dq[1] = s * ev[0]; dq[2] = s * ev[1]; dq[3] = s * ev[2];
            }
            double qbd[4];
            qmul(qb, dq, qbd);
            qsub(qa, qbd, sgn == 0 ? outp : outm);
        }
        for (int i = 0; i < 3; ++i) D[i][j] = (outp[i] - outm[i]) / (2 * h);
    }
}

// J rows: [jacp[:, mask]; jac_rad * (Db^T R^T) @ jacr[:, mask];
//          jac_reg * I; jac_reg * I]   (reference reg-row quirk included)
void jacobian(const Problem& P, const double* x, double J[MMAX][NMAX]) {
    const Model& M = P.model;
    double qf[NQMAX];
    std::memcpy(qf, P.qpos_full, sizeof(double) * M.nq);
    for (int i = 0; i < P.n; ++i) qf[P.mask[i]] = x[i];
    FK f;
    fk(M, qf, f);
    double ee_pos[3], ee_quat[4];
    site_pose(M, f, ee_pos, ee_quat);
    double R[3][3];
    qmat(ee_quat, R);
    double Db[3][3];
    subquat_jac_b(P.goal_orn, ee_quat, Db);
    // W = jac_rad * Db^T @ R^T  (3x3)
    double W[3][3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s = 0;
            for (int kk = 0; kk < 3; ++kk) s += Db[kk][i] * R[j][kk];
            W[i][j] = P.jac_rad * s;
        }
    for (int col = 0; col < P.n; ++col) {
        const int j = P.mask[col];
        double jacp[3] = {0, 0, 0}, jacr[3] = {0, 0, 0};
        if (M.anc_site[j]) {
            if (M.jnt_type[j] == 0) {  // hinge
                double lever[3] = {ee_pos[0] - f.xpos[j][0],
                                   ee_pos[1] - f.xpos[j][1],
                                   ee_pos[2] - f.xpos[j][2]};
                cross3(f.axis_w[j], lever, jacp);
                std::memcpy(jacr, f.axis_w[j], sizeof jacr);
            } else {  // slide: translation only
                std::memcpy(jacp, f.axis_w[j], sizeof jacp);
            }
        }
        for (int r = 0; r < 3; ++r) J[r][col] = jacp[r];
        for (int r = 0; r < 3; ++r) {
            double s = 0;
            for (int kk = 0; kk < 3; ++kk) s += W[r][kk] * jacr[kk];
            J[3 + r][col] = s;
        }
    }
    for (int r = 0; r < 2 * P.n; ++r)
        for (int col = 0; col < P.n; ++col)
            J[6 + r][col] = 0.0;
    for (int i = 0; i < P.n; ++i) {
        J[6 + i][i] = P.jac_reg;
        J[6 + P.n + i][i] = P.jac_reg;
    }
}

// ---------------------------------------------------------------------
// small-matrix SVD: one-sided Jacobi on A (ma x n), ma >= n.
// Produces A = U diag(s) V^T with s descending; U (ma x n), V (n x n).
// ---------------------------------------------------------------------

void svd_jacobi(int ma, int n, const double A_in[MAMAX][NMAX],
                double U[MAMAX][NMAX], double s[NMAX], double V[NMAX][NMAX]) {
    double A[MAMAX][NMAX];
    for (int i = 0; i < ma; ++i)
        for (int j = 0; j < n; ++j) A[i][j] = A_in[i][j];
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) V[i][j] = (i == j) ? 1.0 : 0.0;
    const double tol = 1e-15;
    for (int sweep = 0; sweep < 60; ++sweep) {
        double off = 0.0;
        for (int p = 0; p < n - 1; ++p) {
            for (int q = p + 1; q < n; ++q) {
                double app = 0, aqq = 0, apq = 0;
                for (int i = 0; i < ma; ++i) {
                    app += A[i][p] * A[i][p];
                    aqq += A[i][q] * A[i][q];
                    apq += A[i][p] * A[i][q];
                }
                off = std::max(off, std::abs(apq) / std::sqrt(std::max(app * aqq, 1e-300)));
                if (std::abs(apq) < tol * std::sqrt(std::max(app * aqq, 1e-300)))
                    continue;
                const double tau = (aqq - app) / (2.0 * apq);
                const double t = (tau >= 0 ? 1.0 : -1.0) /
                                 (std::abs(tau) + std::sqrt(1.0 + tau * tau));
                const double c = 1.0 / std::sqrt(1.0 + t * t);
                const double sn = c * t;
                for (int i = 0; i < ma; ++i) {
                    const double ap = A[i][p], aq = A[i][q];
                    A[i][p] = c * ap - sn * aq;
                    A[i][q] = sn * ap + c * aq;
                }
                for (int i = 0; i < n; ++i) {
                    const double vp = V[i][p], vq = V[i][q];
                    V[i][p] = c * vp - sn * vq;
                    V[i][q] = sn * vp + c * vq;
                }
            }
        }
        if (off < tol) break;
    }
    // column norms = singular values; normalize U
    int order[NMAX];
    double sv[NMAX];
    for (int j = 0; j < n; ++j) {
        double nrm = 0;
        for (int i = 0; i < ma; ++i) nrm += A[i][j] * A[i][j];
        sv[j] = std::sqrt(nrm);
        order[j] = j;
    }
    std::sort(order, order + n, [&](int a, int b) { return sv[a] > sv[b]; });
    for (int jj = 0; jj < n; ++jj) {
        const int j = order[jj];
        s[jj] = sv[j];
        const double inv = sv[j] > 1e-300 ? 1.0 / sv[j] : 0.0;
        for (int i = 0; i < ma; ++i) U[i][jj] = A[i][j] * inv;
    }
    // reorder V to match
    double Vt[NMAX][NMAX];
    for (int jj = 0; jj < n; ++jj)
        for (int i = 0; i < n; ++i) Vt[i][jj] = V[i][order[jj]];
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < n; ++j) V[i][j] = Vt[i][j];
}

// ---------------------------------------------------------------------
// TRF machinery (line-true ports of ik_host.py's scipy-replica helpers)
// ---------------------------------------------------------------------

inline double norm2(const double* v, int n) {
    double s = 0;
    for (int i = 0; i < n; ++i) s += v[i] * v[i];
    return std::sqrt(s);
}

inline double dot(const double* a, const double* b, int n) {
    double s = 0;
    for (int i = 0; i < n; ++i) s += a[i] * b[i];
    return s;
}

void cl_scaling_vector(int n, const double* x, const double* g,
                       const double* lb, const double* ub,
                       double* v, double* dv) {
    for (int i = 0; i < n; ++i) {
        v[i] = 1.0;
        dv[i] = 0.0;
        if (g[i] < 0 && std::isfinite(ub[i])) { v[i] = ub[i] - x[i]; dv[i] = -1; }
        else if (g[i] > 0 && std::isfinite(lb[i])) { v[i] = x[i] - lb[i]; dv[i] = 1; }
    }
}

bool in_bounds(int n, const double* x, const double* lb, const double* ub) {
    for (int i = 0; i < n; ++i)
        if (x[i] < lb[i] || x[i] > ub[i]) return false;
    return true;
}

double step_size_to_bound(int n, const double* x, const double* s,
                          const double* lb, const double* ub, int* hits) {
    double min_step = INF;
    double steps[NMAX];
    for (int i = 0; i < n; ++i) {
        steps[i] = INF;
        if (s[i] != 0.0)
            steps[i] = std::max((lb[i] - x[i]) / s[i], (ub[i] - x[i]) / s[i]);
        min_step = std::min(min_step, steps[i]);
    }
    for (int i = 0; i < n; ++i) {
        const int sgn = s[i] > 0 ? 1 : (s[i] < 0 ? -1 : 0);
        hits[i] = (steps[i] == min_step) ? sgn : 0;
    }
    return min_step;
}

void make_strictly_feasible(int n, double* x, const double* lb,
                            const double* ub, double rstep) {
    for (int i = 0; i < n; ++i) {
        if (x[i] <= lb[i] || x[i] >= ub[i]) {
            double xn;
            if (rstep == 0.0) {
                xn = std::nextafter(x[i], (lb[i] + ub[i]) / 2);
            } else {
                if (x[i] <= lb[i]) xn = lb[i] + rstep * std::max(1.0, std::abs(lb[i]));
                else xn = ub[i] - rstep * std::max(1.0, std::abs(ub[i]));
            }
            x[i] = std::min(std::max(xn, lb[i]), ub[i]);
        }
    }
}

// positive root of ||x + t s|| = Delta (returns both roots via out params)
void intersect_trust_region(int n, const double* x, const double* s,
                            double Delta, double* t_neg, double* t_pos) {
    const double a = dot(s, s, n);
    const double b = dot(x, s, n);
    const double c = dot(x, x, n) - Delta * Delta;
    const double d = std::sqrt(b * b - a * c);
    *t_neg = (-b - d) / a;
    *t_pos = (-b + d) / a;
}

// scipy _lsq.common.solve_lsq_trust_region (exact tr_solver), ported from
// ik_host._solve_lsq_trust_region. NB: `m_rows` is the UNaugmented residual
// count — trf_np passes J.shape's m (ik_host.py:425,453), not the augmented
// row count the SVD ran over; keep that to stay decision-identical.
void solve_lsq_trust_region(int n, int m_rows, const double* uf,
                            const double* s, const double V[NMAX][NMAX],
                            double Delta, double* alpha_io, double* p) {
    double suf[NMAX];
    for (int i = 0; i < n; ++i) suf[i] = s[i] * uf[i];
    bool full_rank = false;
    if (m_rows >= n) {
        const double threshold = DEPS * m_rows * s[0];
        full_rank = s[n - 1] > threshold;
    }
    if (full_rank) {
        double w[NMAX];
        for (int i = 0; i < n; ++i) w[i] = uf[i] / s[i];
        for (int i = 0; i < n; ++i) {
            double acc = 0;
            for (int j = 0; j < n; ++j) acc += V[i][j] * w[j];
            p[i] = -acc;
        }
        if (norm2(p, n) <= Delta) { *alpha_io = 0.0; return; }
    }
    const double alpha_upper0 = norm2(suf, n) / Delta;
    double alpha_upper = alpha_upper0;
    double alpha_lower = 0.0;
    auto phi_and_derivative = [&](double alpha, double* phi, double* dphi) {
        double pn = 0, dsum = 0;
        for (int i = 0; i < n; ++i) {
            const double denom = s[i] * s[i] + alpha;
            const double t = suf[i] / denom;
            pn += t * t;
            dsum += suf[i] * suf[i] / (denom * denom * denom);
        }
        pn = std::sqrt(pn);
        *phi = pn - Delta;
        *dphi = -dsum / pn;
    };
    if (full_rank) {
        double phi, dphi;
        phi_and_derivative(0.0, &phi, &dphi);
        alpha_lower = -phi / dphi;
    }
    // trf_np always passes a float initial_alpha (never None), so only the
    // `not full_rank and initial_alpha == 0` reseed branch applies
    double alpha = *alpha_io;
    if (!full_rank && alpha == 0.0)
        alpha = std::max(0.001 * alpha_upper,
                         std::sqrt(alpha_lower * alpha_upper));
    for (int it = 0; it < 10; ++it) {
        if (alpha < alpha_lower || alpha > alpha_upper)
            alpha = std::max(0.001 * alpha_upper,
                             std::sqrt(alpha_lower * alpha_upper));
        double phi, dphi;
        phi_and_derivative(alpha, &phi, &dphi);
        if (phi < 0) alpha_upper = alpha;
        const double ratio = phi / dphi;
        alpha_lower = std::max(alpha_lower, alpha - ratio);
        alpha -= (phi + Delta) * ratio / Delta;
        if (std::abs(phi) < 0.01 * Delta) break;
    }
    double w[NMAX];
    for (int i = 0; i < n; ++i) w[i] = suf[i] / (s[i] * s[i] + alpha);
    for (int i = 0; i < n; ++i) {
        double acc = 0;
        for (int j = 0; j < n; ++j) acc += V[i][j] * w[j];
        p[i] = -acc;
    }
    const double pn = norm2(p, n);
    for (int i = 0; i < n; ++i) p[i] *= Delta / pn;
    *alpha_io = alpha;
}

// quadratic along direction(s): 0.5 s^T (J^T J + diag) s terms
double evaluate_quadratic(int m, int n, const double J[MMAX][NMAX],
                          const double* g, const double* sdir,
                          const double* diag) {
    double Js[MMAX];
    for (int i = 0; i < m; ++i) {
        double acc = 0;
        for (int j = 0; j < n; ++j) acc += J[i][j] * sdir[j];
        Js[i] = acc;
    }
    double q = dot(Js, Js, m);
    if (diag) {
        for (int i = 0; i < n; ++i) q += sdir[i] * diag[i] * sdir[i];
    }
    return 0.5 * q + dot(sdir, g, n);
}

void build_quadratic_1d(int m, int n, const double J[MMAX][NMAX],
                        const double* g, const double* sdir,
                        const double* diag, const double* s0,
                        double* a, double* b, double* c) {
    double v[MMAX];
    for (int i = 0; i < m; ++i) {
        double acc = 0;
        for (int j = 0; j < n; ++j) acc += J[i][j] * sdir[j];
        v[i] = acc;
    }
    double aa = dot(v, v, m);
    if (diag)
        for (int i = 0; i < n; ++i) aa += sdir[i] * diag[i] * sdir[i];
    aa *= 0.5;
    double bb = dot(g, sdir, n);
    double cc = 0;
    if (s0) {
        double u[MMAX];
        for (int i = 0; i < m; ++i) {
            double acc = 0;
            for (int j = 0; j < n; ++j) acc += J[i][j] * s0[j];
            u[i] = acc;
        }
        bb += dot(u, v, m);
        cc = 0.5 * dot(u, u, m) + dot(g, s0, n);
        if (diag) {
            for (int i = 0; i < n; ++i) {
                bb += s0[i] * diag[i] * sdir[i];
                cc += 0.5 * s0[i] * diag[i] * s0[i];
            }
        }
    }
    *a = aa; *b = bb;
    if (c) *c = cc;
}

void minimize_quadratic_1d(double a, double b, double lb, double ub, double c,
                           double* t_out, double* y_out) {
    double ts[3] = {lb, ub, 0};
    int nt = 2;
    if (a != 0) {
        const double extremum = -0.5 * b / a;
        if (lb < extremum && extremum < ub) ts[nt++] = extremum;
    }
    double best_t = ts[0], best_y = INF;
    for (int i = 0; i < nt; ++i) {
        const double y = ts[i] * (a * ts[i] + b) + c;
        if (y < best_y) { best_y = y; best_t = ts[i]; }
    }
    *t_out = best_t;
    *y_out = best_y;
}

void update_tr_radius(double Delta, double actual, double predicted,
                      double step_norm, bool bound_hit,
                      double* Delta_out, double* ratio_out) {
    double ratio;
    if (predicted > 0) ratio = actual / predicted;
    else if (predicted == 0 && actual == 0) ratio = 1;
    else ratio = 0;
    if (ratio < 0.25) Delta = 0.25 * step_norm;
    else if (ratio > 0.75 && bound_hit) Delta *= 2.0;
    *Delta_out = Delta;
    *ratio_out = ratio;
}

int check_termination(double dF, double F, double dx_norm, double x_norm,
                      double ratio, double ftol, double xtol) {
    const bool ftol_ok = dF < ftol * F && ratio > 0.25;
    const bool xtol_ok = dx_norm < xtol * (xtol + x_norm);
    if (ftol_ok && xtol_ok) return 4;
    if (ftol_ok) return 2;
    if (xtol_ok) return 3;
    return 0;  // no termination
}

// scipy _lsq.trf.select_step, ported from ik_host._select_step
void select_step(int n, int m, const double* x, const double J_h[MMAX][NMAX],
                 const double* diag_h, const double* g_h, const double* p_in,
                 const double* p_h_in, const double* d, double Delta,
                 const double* lb, const double* ub, double theta,
                 double* step, double* step_h, double* pred_reduction) {
    double p[NMAX], p_h[NMAX];
    std::memcpy(p, p_in, sizeof(double) * n);
    std::memcpy(p_h, p_h_in, sizeof(double) * n);
    double xp[NMAX];
    for (int i = 0; i < n; ++i) xp[i] = x[i] + p[i];
    if (in_bounds(n, xp, lb, ub)) {
        const double p_value = evaluate_quadratic(m, n, J_h, g_h, p_h, diag_h);
        std::memcpy(step, p, sizeof(double) * n);
        std::memcpy(step_h, p_h, sizeof(double) * n);
        *pred_reduction = -p_value;
        return;
    }
    int hits[NMAX];
    const double p_stride = step_size_to_bound(n, x, p, lb, ub, hits);
    double r_h[NMAX], r[NMAX];
    for (int i = 0; i < n; ++i) {
        r_h[i] = hits[i] != 0 ? -p_h[i] : p_h[i];
        r[i] = d[i] * r_h[i];
    }
    for (int i = 0; i < n; ++i) { p[i] *= p_stride; p_h[i] *= p_stride; }
    double x_on_bound[NMAX];
    for (int i = 0; i < n; ++i) x_on_bound[i] = x[i] + p[i];
    double t_neg, to_tr;
    intersect_trust_region(n, p_h, r_h, Delta, &t_neg, &to_tr);
    int hits2[NMAX];
    const double to_bound = step_size_to_bound(n, x_on_bound, r, lb, ub, hits2);
    const double r_stride0 = std::min(to_bound, to_tr);
    double r_stride_l, r_stride_u;
    if (r_stride0 > 0) {
        r_stride_l = (1 - theta) * p_stride / r_stride0;
        r_stride_u = (r_stride0 == to_bound) ? theta * to_bound : to_tr;
    } else {
        r_stride_l = 0;
        r_stride_u = -1;
    }
    double r_value;
    if (r_stride_l <= r_stride_u) {
        double a, b, c;
        build_quadratic_1d(m, n, J_h, g_h, r_h, diag_h, p_h, &a, &b, &c);
        double r_stride;
        minimize_quadratic_1d(a, b, r_stride_l, r_stride_u, c, &r_stride, &r_value);
        for (int i = 0; i < n; ++i) {
            r_h[i] = r_h[i] * r_stride + p_h[i];
            r[i] = r_h[i] * d[i];
        }
    } else {
        r_value = INF;
    }
    for (int i = 0; i < n; ++i) { p[i] *= theta; p_h[i] *= theta; }
    const double p_value = evaluate_quadratic(m, n, J_h, g_h, p_h, diag_h);
    double ag_h[NMAX], ag[NMAX];
    for (int i = 0; i < n; ++i) { ag_h[i] = -g_h[i]; ag[i] = d[i] * ag_h[i]; }
    const double to_tr2 = Delta / norm2(ag_h, n);
    int hits3[NMAX];
    const double to_bound2 = step_size_to_bound(n, x, ag, lb, ub, hits3);
    const double ag_stride_max =
        to_bound2 < to_tr2 ? theta * to_bound2 : to_tr2;
    double a, b;
    build_quadratic_1d(m, n, J_h, g_h, ag_h, diag_h, nullptr, &a, &b, nullptr);
    double ag_stride, ag_value;
    minimize_quadratic_1d(a, b, 0, ag_stride_max, 0, &ag_stride, &ag_value);
    for (int i = 0; i < n; ++i) { ag_h[i] *= ag_stride; ag[i] *= ag_stride; }
    if (p_value < r_value && p_value < ag_value) {
        std::memcpy(step, p, sizeof(double) * n);
        std::memcpy(step_h, p_h, sizeof(double) * n);
        *pred_reduction = -p_value;
    } else if (r_value < p_value && r_value < ag_value) {
        std::memcpy(step, r, sizeof(double) * n);
        std::memcpy(step_h, r_h, sizeof(double) * n);
        *pred_reduction = -r_value;
    } else {
        std::memcpy(step, ag, sizeof(double) * n);
        std::memcpy(step_h, ag_h, sizeof(double) * n);
        *pred_reduction = -ag_value;
    }
}

}  // namespace

// ---------------------------------------------------------------------
// entry point
// ---------------------------------------------------------------------

extern "C" int kmanip_ik_solve(
    // model tables
    int nq, const int* parent, const int* jnt_type,
    const double* jnt_pos, const double* jnt_quat,
    int site_parent, const double* site_pos, const double* site_quat,
    const unsigned char* anc_site,
    // problem
    int n, const int* mask, const double* lb, const double* ub,
    const double* qpos_full, const double* goal_pos, const double* goal_orn,
    const double* q_home, const double* q_prev,
    // weights + tolerances
    double res_rad, double reg_prev, double reg_home,
    double jac_rad, double jac_reg,
    double ftol, double xtol, double gtol, int max_nfev,
    // outputs
    double* x_out, double* x_last_out) {
    if (nq > NQMAX || n > NMAX || n < 1) return -1;
    Problem P;
    P.model = Model{nq, parent, jnt_type, jnt_pos, jnt_quat,
                    site_parent, site_pos, site_quat, anc_site};
    P.n = n;
    P.mask = mask;
    P.lb = lb;
    P.ub = ub;
    P.goal_pos = goal_pos;
    P.goal_orn = goal_orn;
    P.q_home = q_home;
    P.q_prev = q_prev;
    std::memcpy(P.qpos_full, qpos_full, sizeof(double) * nq);
    P.res_rad = res_rad; P.reg_prev = reg_prev; P.reg_home = reg_home;
    P.jac_rad = jac_rad; P.jac_reg = jac_reg;
    const int m = P.m();

    // ---- trf_np (ik_host.py:415-488) ----
    double x[NMAX];
    for (int i = 0; i < n; ++i) x[i] = qpos_full[mask[i]];
    make_strictly_feasible(n, x, lb, ub, 1e-10);
    double f[MMAX];
    residual(P, x, f);
    double x_last[NMAX];
    std::memcpy(x_last, x, sizeof(double) * n);
    int nfev = 1;
    double J[MMAX][NMAX];
    jacobian(P, x, J);
    double cost = 0.5 * dot(f, f, m);
    double g[NMAX];
    for (int j = 0; j < n; ++j) {
        double acc = 0;
        for (int i = 0; i < m; ++i) acc += J[i][j] * f[i];
        g[j] = acc;
    }
    double v[NMAX], dv[NMAX];
    cl_scaling_vector(n, x, g, lb, ub, v, dv);
    double Delta = 0;
    for (int i = 0; i < n; ++i) Delta += x[i] * x[i] / v[i];
    Delta = std::sqrt(Delta);
    if (Delta == 0) Delta = 1.0;
    if (max_nfev <= 0) max_nfev = n * 100;
    double alpha = 0.0;
    int termination = 0;

    while (true) {
        cl_scaling_vector(n, x, g, lb, ub, v, dv);
        double g_norm = 0;
        for (int i = 0; i < n; ++i) g_norm = std::max(g_norm, std::abs(g[i] * v[i]));
        if (g_norm < gtol) termination = 1;
        if (termination != 0 || nfev == max_nfev) break;
        double d[NMAX], diag_h[NMAX], g_h[NMAX];
        for (int i = 0; i < n; ++i) {
            d[i] = std::sqrt(v[i]);
            diag_h[i] = g[i] * dv[i];
            g_h[i] = d[i] * g[i];
        }
        // J_augmented = [J * d; diag(sqrt(diag_h))], f_augmented = [f; 0]
        const int ma = m + n;
        double Ja[MAMAX][NMAX];
        for (int i = 0; i < m; ++i)
            for (int j = 0; j < n; ++j) Ja[i][j] = J[i][j] * d[j];
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j)
                Ja[m + i][j] = (i == j) ? std::sqrt(diag_h[i]) : 0.0;
        // J_h = first m rows of Ja
        double J_h[MMAX][NMAX];
        for (int i = 0; i < m; ++i)
            for (int j = 0; j < n; ++j) J_h[i][j] = Ja[i][j];
        double U[MAMAX][NMAX], sv[NMAX], V[NMAX][NMAX];
        svd_jacobi(ma, n, Ja, U, sv, V);
        double uf[NMAX];
        for (int j = 0; j < n; ++j) {
            double acc = 0;
            for (int i = 0; i < m; ++i) acc += U[i][j] * f[i];  // f_aug tail is 0
            uf[j] = acc;
        }
        const double theta = std::max(0.995, 1 - g_norm);
        double actual_reduction = -1;
        double x_new[NMAX], f_new[MMAX], cost_new = 0;
        while (actual_reduction <= 0 && nfev < max_nfev) {
            double p_h[NMAX], p[NMAX];
            solve_lsq_trust_region(n, m, uf, sv, V, Delta, &alpha, p_h);
            for (int i = 0; i < n; ++i) p[i] = d[i] * p_h[i];
            double step[NMAX], step_h[NMAX], predicted_reduction;
            select_step(n, m, x, J_h, diag_h, g_h, p, p_h, d, Delta, lb, ub,
                        theta, step, step_h, &predicted_reduction);
            for (int i = 0; i < n; ++i) x_new[i] = x[i] + step[i];
            make_strictly_feasible(n, x_new, lb, ub, 0.0);
            residual(P, x_new, f_new);
            std::memcpy(x_last, x_new, sizeof(double) * n);
            nfev += 1;
            const double step_h_norm = norm2(step_h, n);
            bool finite = true;
            for (int i = 0; i < m; ++i)
                if (!std::isfinite(f_new[i])) { finite = false; break; }
            if (!finite) { Delta = 0.25 * step_h_norm; continue; }
            cost_new = 0.5 * dot(f_new, f_new, m);
            actual_reduction = cost - cost_new;
            double Delta_new, ratio;
            update_tr_radius(Delta, actual_reduction, predicted_reduction,
                             step_h_norm, step_h_norm > 0.95 * Delta,
                             &Delta_new, &ratio);
            const double step_norm = norm2(step, n);
            termination = check_termination(actual_reduction, cost, step_norm,
                                            norm2(x, n), ratio, ftol, xtol);
            if (termination != 0) break;
            alpha *= Delta / Delta_new;
            Delta = Delta_new;
        }
        if (actual_reduction > 0) {
            std::memcpy(x, x_new, sizeof(double) * n);
            std::memcpy(f, f_new, sizeof(double) * m);
            cost = cost_new;
            jacobian(P, x, J);
            for (int j = 0; j < n; ++j) {
                double acc = 0;
                for (int i = 0; i < m; ++i) acc += J[i][j] * f[i];
                g[j] = acc;
            }
        }
    }
    std::memcpy(x_out, x, sizeof(double) * n);
    std::memcpy(x_last_out, x_last, sizeof(double) * n);
    return termination;
}

// version tag so the ctypes loader can detect stale cached builds
extern "C" int kmanip_ik_abi_version() { return 1; }
