"""Float64 host-precision TRF IK for the env.

Port of `gym_kmanip_tpu/solvers/ik_host.py`, copied line for line: the
reference solves IK with scipy's float64 TRF, whose ftol/xtol = 1e-8 sit
BELOW the float32 epsilon, so a float32 solver cannot reproduce its
termination decisions. The single env (a 50 Hz control loop, whose
reference does this exact solve on the host) solves on the host in
float64:

  * numpy f64 forward kinematics / site pose / site Jacobian over the
    port's RobotModel tables (float64 at rest in the model);
  * the reference's analytic-Jacobian structure, quirks included;
  * a float64 STIR trust-region-reflective solver with scipy
    least_squares(method='trf', tr_solver='exact') semantics, extended with
    the last-evaluation tracking the qpos-scribble side effect needs.

`solve_host` runs the same pipeline compiled (gym_kmanip_torch/native)
when it is built, and this numpy twin otherwise. The JAX package's
`ik_trf_host` (a `jax.pure_callback` wrapper) has no counterpart: the
port's env calls `solve_host` between its device steps.
"""

from functools import partial

import numpy as np

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models.spec import HINGE, RobotModel

EPS = np.finfo(np.float64).eps

# ---------------------------------------------------------------------------
# numpy f64 quaternion / kinematics (wxyz, MuJoCo convention — mirrors
# utils/rotations.py and ops/kinematics.py)
# ---------------------------------------------------------------------------


def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _qconj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _qrot(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def _qmat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _qlog(q):
    """rotation vector of unit q, wrapped to (-pi, pi] (utils.rotations.quat_log)."""
    w, v = q[0], q[1:]
    vn = np.linalg.norm(v)
    if vn < 1e-12:
        return v * (2.0 / max(w, EPS))
    angle = 2.0 * np.arctan2(vn, w)
    if angle > np.pi:
        angle -= 2.0 * np.pi
    return v * (angle / vn)


def _qsub(qa, qb):
    """mju_subQuat: v with qb ⊗ exp(v/2) = qa, in qb's local frame."""
    return _qlog(_qmul(_qconj(qb), qa))


def fk_np(model: RobotModel, qpos: np.ndarray):
    """f64 forward kinematics (ops/kinematics.fk, numpy)."""
    nq = model.nq
    xpos = np.zeros((nq, 3))
    xquat = np.zeros((nq, 4))
    jp = np.asarray(model.jnt_pos, np.float64)
    jq = np.asarray(model.jnt_quat, np.float64)
    for i in range(nq):
        par = int(model.parent[i])
        if par < 0:
            p_par = np.zeros(3)
            q_par = np.array([1.0, 0, 0, 0])
        else:
            p_par, q_par = xpos[par], xquat[par]
        p = p_par + _qrot(q_par, jp[i])
        q = _qmul(q_par, jq[i])
        if int(model.jnt_type[i]) == HINGE:
            half = 0.5 * qpos[i]
            q = _qmul(q, np.array([np.cos(half), 0.0, 0.0, np.sin(half)]))
        else:  # slide along local z
            p = p + _qrot(q, np.array([0.0, 0.0, qpos[i]]))
        xpos[i] = p
        xquat[i] = q
    axis_w = np.stack([_qrot(xquat[i], np.array([0.0, 0, 1.0])) for i in range(nq)])
    return xpos, xquat, axis_w


def site_pose_np(model: RobotModel, xpos, xquat, site_name: str):
    s = model.site(site_name)
    p = xpos[s.parent] + _qrot(xquat[s.parent], np.asarray(s.pos, np.float64))
    q = _qmul(xquat[s.parent], np.asarray(s.quat, np.float64))
    return p, q


def point_jacobian_np(model: RobotModel, xpos, axis_w, point, attach_joint: int):
    """mj_jacSite equivalent (ops/kinematics.point_jacobian, numpy f64)."""
    anc = np.asarray(model.ancestors[attach_joint], np.float64)
    is_slide = (np.asarray(model.jnt_type) != HINGE).astype(np.float64)[:, None]
    lever = np.cross(axis_w, point[None, :] - xpos)
    jacp = anc[:, None] * np.where(is_slide > 0, axis_w, lever)
    jacr = anc[:, None] * (1.0 - is_slide) * axis_w
    return jacp.T, jacr.T


# ---------------------------------------------------------------------------
# reference residual / Jacobian in f64 (solvers/ik._residual /
# reference_jacobian, quirks included)
# ---------------------------------------------------------------------------


def _residual_np(model, q_masked, qpos_full, goal_pos, goal_orn, q_home,
                 q_prev, mask, site_name):
    q_full = qpos_full.copy()
    q_full[mask] = q_masked
    xpos, xquat, _ = fk_np(model, q_full)
    ee_pos, ee_quat = site_pose_np(model, xpos, xquat, site_name)
    res_pos = ee_pos - goal_pos
    res_quat = k.IK_RES_RAD * _qsub(goal_orn, ee_quat)
    res_prev = k.IK_RES_REG_PREV * (q_masked - q_prev)
    res_home = k.IK_RES_REG_HOME * (q_masked - q_home)
    return np.concatenate([res_pos, res_quat, res_prev, res_home])


def _subquat_jac_b_np(qa, qb):
    """mjd_subQuat's Db via f64 central differences (h=1e-7 -> ~1e-9 error,
    well below the solver's ftol; the jnp twin uses jacfwd)."""
    h = 1e-7
    D = np.zeros((3, 3))
    for j in range(3):
        e = np.zeros(3)
        e[j] = h
        def f(ev):
            ang = np.linalg.norm(ev)
            if ang < 1e-300:
                dq = np.array([1.0, 0, 0, 0])
            else:
                ax = ev / ang
                dq = np.concatenate([[np.cos(0.5 * ang)], np.sin(0.5 * ang) * ax])
            return _qsub(qa, _qmul(qb, dq))
        D[:, j] = (f(e) - f(-e)) / (2 * h)
    return D


def _jacobian_np(model, q_masked, qpos_full, goal_orn, mask, site_name):
    q_full = qpos_full.copy()
    q_full[mask] = q_masked
    xpos, xquat, axis_w = fk_np(model, q_full)
    s = model.site(site_name)
    ee_pos, ee_quat = site_pose_np(model, xpos, xquat, site_name)
    jacp, jacr = point_jacobian_np(model, xpos, axis_w, ee_pos, s.parent)
    R = _qmat(ee_quat)
    Db = _subquat_jac_b_np(goal_orn, ee_quat)
    jac_quat = (k.IK_JAC_RAD * Db.T @ R.T) @ jacr
    n = len(mask)
    jac_reg = k.IK_JAC_REG * np.eye(n)
    return np.vstack([jacp[:, mask], jac_quat[:, mask], jac_reg, jac_reg])


# ---------------------------------------------------------------------------
# STIR trust-region-reflective solver, scipy least_squares(method='trf',
# tr_solver='exact', x_scale=1) semantics. Promoted from
# tools/exp_trf_replica.py (verified bit-exact vs scipy on the reference IK
# problem) + x_last_eval tracking for the qpos-scribble side effect.
# ---------------------------------------------------------------------------


def _cl_scaling_vector(x, g, lb, ub):
    v = np.ones_like(x)
    dv = np.zeros_like(x)
    m1 = (g < 0) & np.isfinite(ub)
    v[m1] = ub[m1] - x[m1]
    dv[m1] = -1
    m2 = (g > 0) & np.isfinite(lb)
    v[m2] = x[m2] - lb[m2]
    dv[m2] = 1
    return v, dv


def _in_bounds(x, lb, ub):
    return np.all((x >= lb) & (x <= ub))


def _step_size_to_bound(x, s, lb, ub):
    non_zero = np.nonzero(s)
    s_non_zero = s[non_zero]
    steps = np.empty_like(x)
    steps.fill(np.inf)
    with np.errstate(over="ignore"):
        steps[non_zero] = np.maximum(
            (lb - x)[non_zero] / s_non_zero, (ub - x)[non_zero] / s_non_zero
        )
    min_step = np.min(steps)
    return min_step, np.equal(steps, min_step) * np.sign(s).astype(int)


def _make_strictly_feasible(x, lb, ub, rstep=1e-10):
    x_new = np.copy(x)
    active = ((x <= lb) | (x >= ub)).nonzero()[0]
    for i in active:
        if rstep == 0:
            x_new[i] = np.nextafter(x[i], (lb[i] + ub[i]) / 2)
        else:
            if x[i] <= lb[i]:
                x_new[i] = lb[i] + rstep * max(1, abs(lb[i]))
            else:
                x_new[i] = ub[i] - rstep * max(1, abs(ub[i]))
        x_new[i] = min(max(x_new[i], lb[i]), ub[i])
    return x_new


def _intersect_trust_region(x, s, Delta):
    a = np.dot(s, s)
    if a == 0:
        raise ValueError("`s` is zero.")
    b = np.dot(x, s)
    c = np.dot(x, x) - Delta**2
    d = np.sqrt(b * b - a * c)
    return (-b - d) / a, (-b + d) / a


def _solve_lsq_trust_region(n, m, uf, s, V, Delta, initial_alpha=None,
                            rtol=0.01, max_iter=10):
    def phi_and_derivative(alpha, suf, s, Delta):
        denom = s**2 + alpha
        p_norm = np.linalg.norm(suf / denom)
        phi = p_norm - Delta
        phi_prime = -np.sum(suf**2 / denom**3) / p_norm
        return phi, phi_prime

    suf = s * uf
    if m >= n:
        threshold = EPS * m * s[0]
        full_rank = s[-1] > threshold
    else:
        full_rank = False
    if full_rank:
        p = -V.dot(uf / s)
        if np.linalg.norm(p) <= Delta:
            return p, 0.0, 0
    alpha_upper = np.linalg.norm(suf) / Delta
    if full_rank:
        phi, phi_prime = phi_and_derivative(0.0, suf, s, Delta)
        alpha_lower = -phi / phi_prime
    else:
        alpha_lower = 0.0
    if initial_alpha is None or not full_rank and initial_alpha == 0:
        alpha = max(0.001 * alpha_upper, (alpha_lower * alpha_upper) ** 0.5)
    else:
        alpha = initial_alpha
    for it in range(max_iter):
        if alpha < alpha_lower or alpha > alpha_upper:
            alpha = max(0.001 * alpha_upper, (alpha_lower * alpha_upper) ** 0.5)
        phi, phi_prime = phi_and_derivative(alpha, suf, s, Delta)
        if phi < 0:
            alpha_upper = alpha
        ratio = phi / phi_prime
        alpha_lower = max(alpha_lower, alpha - ratio)
        alpha -= (phi + Delta) * ratio / Delta
        if np.abs(phi) < rtol * Delta:
            break
    p = -V.dot(suf / (s**2 + alpha))
    p *= Delta / np.linalg.norm(p)
    return p, alpha, it + 1


def _build_quadratic_1d(J, g, s, diag=None, s0=None):
    v = J.dot(s)
    a = np.dot(v, v)
    if diag is not None:
        a += np.dot(s * diag, s)
    a *= 0.5
    b = np.dot(g, s)
    if s0 is not None:
        u = J.dot(s0)
        b += np.dot(u, v)
        c = 0.5 * np.dot(u, u) + np.dot(g, s0)
        if diag is not None:
            b += np.dot(s0 * diag, s)
            c += 0.5 * np.dot(s0 * diag, s0)
        return a, b, c
    return a, b


def _minimize_quadratic_1d(a, b, lb, ub, c=0):
    t = [lb, ub]
    if a != 0:
        extremum = -0.5 * b / a
        if lb < extremum < ub:
            t.append(extremum)
    t = np.asarray(t)
    y = t * (a * t + b) + c
    min_index = np.argmin(y)
    return t[min_index], y[min_index]


def _evaluate_quadratic(J, g, s, diag=None):
    Js = J.dot(s)
    q = np.dot(Js, Js)
    if diag is not None:
        q += np.dot(s * diag, s)
    l = np.dot(s, g)
    return 0.5 * q + l


def _update_tr_radius(Delta, actual, predicted, step_norm, bound_hit):
    if predicted > 0:
        ratio = actual / predicted
    elif predicted == actual == 0:
        ratio = 1
    else:
        ratio = 0
    if ratio < 0.25:
        Delta = 0.25 * step_norm
    elif ratio > 0.75 and bound_hit:
        Delta *= 2.0
    return Delta, ratio


def _check_termination(dF, F, dx_norm, x_norm, ratio, ftol, xtol):
    ftol_ok = dF < ftol * F and ratio > 0.25
    xtol_ok = dx_norm < xtol * (xtol + x_norm)
    if ftol_ok and xtol_ok:
        return 4
    if ftol_ok:
        return 2
    if xtol_ok:
        return 3
    return None


def _select_step(x, J_h, diag_h, g_h, p, p_h, d, Delta, lb, ub, theta):
    if _in_bounds(x + p, lb, ub):
        p_value = _evaluate_quadratic(J_h, g_h, p_h, diag=diag_h)
        return p, p_h, -p_value
    p_stride, hits = _step_size_to_bound(x, p, lb, ub)
    r_h = np.copy(p_h)
    r_h[hits.astype(bool)] *= -1
    r = d * r_h
    p = p * p_stride
    p_h = p_h * p_stride
    x_on_bound = x + p
    _, to_tr = _intersect_trust_region(p_h, r_h, Delta)
    to_bound, _ = _step_size_to_bound(x_on_bound, r, lb, ub)
    r_stride = min(to_bound, to_tr)
    if r_stride > 0:
        r_stride_l = (1 - theta) * p_stride / r_stride
        r_stride_u = theta * to_bound if r_stride == to_bound else to_tr
    else:
        r_stride_l = 0
        r_stride_u = -1
    if r_stride_l <= r_stride_u:
        a, b, c = _build_quadratic_1d(J_h, g_h, r_h, s0=p_h, diag=diag_h)
        r_stride, r_value = _minimize_quadratic_1d(a, b, r_stride_l, r_stride_u, c=c)
        r_h = r_h * r_stride + p_h
        r = r_h * d
    else:
        r_value = np.inf
    p = p * theta
    p_h = p_h * theta
    p_value = _evaluate_quadratic(J_h, g_h, p_h, diag=diag_h)
    ag_h = -g_h
    ag = d * ag_h
    to_tr = Delta / np.linalg.norm(ag_h)
    to_bound, _ = _step_size_to_bound(x, ag, lb, ub)
    ag_stride_max = theta * to_bound if to_bound < to_tr else to_tr
    a, b = _build_quadratic_1d(J_h, g_h, ag_h, diag=diag_h)
    ag_stride, ag_value = _minimize_quadratic_1d(a, b, 0, ag_stride_max)
    ag_h = ag_h * ag_stride
    ag = ag * ag_stride
    if p_value < r_value and p_value < ag_value:
        return p, p_h, -p_value
    if r_value < p_value and r_value < ag_value:
        return r, r_h, -r_value
    return ag, ag_h, -ag_value


def trf_np(fun, jac, x0, lb, ub, ftol=1e-8, xtol=1e-8, gtol=1e-8,
           max_nfev=None):
    """Returns (x, x_last_eval, status). x_last_eval is the argument of the
    LAST residual evaluation (the reference's qpos-scribble point)."""
    x = _make_strictly_feasible(np.asarray(x0, np.float64), lb, ub, rstep=1e-10)
    f = fun(x)
    x_last = x.copy()
    nfev = 1
    J = jac(x)
    m, n = J.shape
    cost = 0.5 * np.dot(f, f)
    g = J.T.dot(f)
    v, dv = _cl_scaling_vector(x, g, lb, ub)
    Delta = np.linalg.norm(x / v**0.5)
    if Delta == 0:
        Delta = 1.0
    if max_nfev is None:
        max_nfev = x.size * 100
    alpha = 0.0
    termination_status = None
    while True:
        v, dv = _cl_scaling_vector(x, g, lb, ub)
        g_norm = np.linalg.norm(g * v, ord=np.inf)
        if g_norm < gtol:
            termination_status = 1
        if termination_status is not None or nfev == max_nfev:
            break
        d = v**0.5
        diag_h = g * dv
        g_h = d * g
        f_augmented = np.concatenate([f, np.zeros(n)])
        J_augmented = np.vstack([J * d, np.diag(diag_h**0.5)])
        J_h = J_augmented[:m]
        U, s, V_svd = np.linalg.svd(J_augmented, full_matrices=False)
        V_svd = V_svd.T
        uf = U.T.dot(f_augmented)
        theta = max(0.995, 1 - g_norm)
        actual_reduction = -1
        while actual_reduction <= 0 and nfev < max_nfev:
            p_h, alpha, _ = _solve_lsq_trust_region(
                n, m, uf, s, V_svd, Delta, initial_alpha=alpha)
            p = d * p_h
            step, step_h, predicted_reduction = _select_step(
                x, J_h, diag_h, g_h, p, p_h, d, Delta, lb, ub, theta)
            x_new = _make_strictly_feasible(x + step, lb, ub, rstep=0)
            f_new = fun(x_new)
            x_last = x_new.copy()
            nfev += 1
            step_h_norm = np.linalg.norm(step_h)
            if not np.all(np.isfinite(f_new)):
                Delta = 0.25 * step_h_norm
                continue
            cost_new = 0.5 * np.dot(f_new, f_new)
            actual_reduction = cost - cost_new
            Delta_new, ratio = _update_tr_radius(
                Delta, actual_reduction, predicted_reduction,
                step_h_norm, step_h_norm > 0.95 * Delta)
            step_norm = np.linalg.norm(step)
            termination_status = _check_termination(
                actual_reduction, cost, step_norm, np.linalg.norm(x), ratio,
                ftol, xtol)
            if termination_status is not None:
                break
            alpha *= Delta / Delta_new
            Delta = Delta_new
        if actual_reduction > 0:
            x = x_new
            f = f_new
            cost = cost_new
            J = jac(x)
            g = J.T.dot(f)
    if termination_status is None:
        termination_status = 0
    return x, x_last, termination_status


# ---------------------------------------------------------------------------
# one solve: native C++ when built, the numpy twin otherwise
# ---------------------------------------------------------------------------


def solve_host(qpos_full, goal_pos, goal_orn, q_home_full, q_prev_full, *,
               model, q_mask, site_name):
    """One f64 host IK solve — native C++ when available, numpy otherwise.

    The C++ backend (gym_kmanip_torch/csrc/ik_native.cpp) is the same
    pipeline compiled: FK -> reference residual/analytic Jacobian -> the
    scipy-semantics TRF below. ~100x faster per solve than the numpy
    interpreter path (the env's host hot loop, exactly as the reference's
    scipy+MuJoCo-C solve is its hot loop); falls back to numpy if g++ or
    the build is unavailable (native.available()) or the model exceeds
    the compiled capacity (native.fits: nq<=32, masked dofs<=12 — gated
    per-problem here so an oversized robot gets the still-correct numpy
    solver, not the C++ entry's status<0 no-op). Solutions agree to
    <1e-9 rad in-distribution (tests/test_torch_env.py) and the golden
    env-parity traces are asserted over the backend this picks."""
    from gym_kmanip_torch import native

    if native.available() and native.fits(model, q_mask):
        return native.solve_ik_native(
            qpos_full, goal_pos, goal_orn, q_home_full, q_prev_full,
            model=model, q_mask=q_mask, site_name=site_name,
        )
    return _solve_np(
        qpos_full, goal_pos, goal_orn, q_home_full, q_prev_full,
        model=model, q_mask=q_mask, site_name=site_name,
    )


def _solve_np(qpos_full, goal_pos, goal_orn, q_home_full, q_prev_full, *,
              model, q_mask, site_name):
    """One f64 IK solve; mirrors solvers/ik.ik_trf's post-solve contract
    (NaN fallback, out-of-bounds raise semantics, joint-range clip,
    scribble)."""
    qpos_full = np.asarray(qpos_full, np.float64)
    mask = list(q_mask)
    lo = np.asarray(model.jnt_range[mask, 0], np.float64)
    hi = np.asarray(model.jnt_range[mask, 1], np.float64)
    q0 = qpos_full[mask]
    if np.any((q0 < lo) | (q0 > hi)):
        # scipy raises before evaluating anything; the reference keeps the
        # warm start and the final clip projects it into range
        return (np.clip(q0, lo, hi).astype(np.float32),
                q0.astype(np.float32))
    goal_pos = np.asarray(goal_pos, np.float64)
    goal_orn = np.asarray(goal_orn, np.float64)
    q_home = np.asarray(q_home_full, np.float64)[mask]
    q_prev = np.asarray(q_prev_full, np.float64)[mask]
    res = partial(_residual_np, model, qpos_full=qpos_full, goal_pos=goal_pos,
                  goal_orn=goal_orn, q_home=q_home, q_prev=q_prev, mask=mask,
                  site_name=site_name)
    jac = partial(_jacobian_np, model, qpos_full=qpos_full, goal_orn=goal_orn,
                  mask=mask, site_name=site_name)
    x, x_last, _status = trf_np(
        lambda q: res(q_masked=q), lambda q: jac(q_masked=q), q0, lo, hi
    )
    if np.any(~np.isfinite(x)):
        x = q0
    if np.any(~np.isfinite(x_last)):
        x_last = q0
    return (np.clip(x, lo, hi).astype(np.float32),
            x_last.astype(np.float32))
