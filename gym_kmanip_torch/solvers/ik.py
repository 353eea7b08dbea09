"""Batched IK on the device: the reference's residual, its analytic
Jacobian, the TRF solve and a fixed-budget Levenberg-Marquardt.

Port of `gym_kmanip_tpu/solvers/ik.py`. The residual is the stack the
reference builds:

    r(q) = [ ee_pos(q) - goal_pos                      (3,)
             IK_RES_RAD * subQuat(goal_orn, ee_orn(q)) (3,)
             IK_RES_REG_PREV * (q - q_prev)            (n,)
             IK_RES_REG_HOME * (q - q_home)            (n,) ]

- `ik_trf` (the vec env's and `make_task(ik_host64=False)`'s solver):
  scipy's TRF (solvers/trf.py) driven by the reference's ANALYTIC
  Jacobian, quirks included (regularization rows at IK_JAC_REG = 9e-3
  while the residual weighs 6e-3 / 2e-6, and Db transposed), which pins
  the solution to the point on the redundant arm's solution manifold that
  the reference lands on.
- `ik` (the MPC inner loop): a fixed-budget Levenberg-Marquardt with bound
  projection and the residual's exact Jacobian.

Every function takes any leading batch dimensions on its per-problem
inputs; the joint mask and the site are static.
"""

import functools
from typing import Tuple

import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.utils import rotations as rot


@functools.lru_cache(maxsize=None)
def mask_index(q_mask: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The mask as an index tensor on `device`, made once: indexing with a
    Python list copies it to the card on every call, and torch waits for
    the card at each such copy."""
    return torch.as_tensor(q_mask, dtype=torch.long, device=device)


def _take(x, q_mask):
    """x[..., q_mask] on the last dimension."""
    return torch.index_select(x, -1, mask_index(tuple(q_mask), x.device))


def _masked_full(qpos_full, q_masked, q_mask):
    q_full = qpos_full.expand(q_masked.shape[:-1] + qpos_full.shape[-1:]).clone()
    return q_full.index_copy_(-1, mask_index(tuple(q_mask), q_full.device), q_masked)


def _ee_frames(model: RobotModel, q_masked, qpos_full, q_mask, site_name):
    """(xpos, axis_w, ee_pos, ee_quat) with the masked joints at q_masked."""
    xpos, xquat, axis_w = kin.fk(model, _masked_full(qpos_full, q_masked, q_mask))
    ee_pos, ee_quat = kin.site_pose(model, xpos, xquat, site_name)
    return xpos, axis_w, ee_pos, ee_quat


def _residual_from_pose(q_masked, ee_pos, ee_quat, goal_pos, goal_orn, q_home, q_prev):
    q_home, q_prev = (a.expand_as(q_masked) for a in (q_home, q_prev))
    return torch.cat([
        ee_pos - goal_pos,
        k.IK_RES_RAD * rot.quat_sub(goal_orn, ee_quat),
        k.IK_RES_REG_PREV * (q_masked - q_prev),
        k.IK_RES_REG_HOME * (q_masked - q_home),
    ], dim=-1)


def _residual(model: RobotModel, q_masked, qpos_full, goal_pos, goal_orn, q_home, q_prev,
              q_mask: Tuple[int, ...], site_name: str) -> torch.Tensor:
    """The reference's IK residual (..., 6 + 2n) at the masked joints
    q_masked (..., n)."""
    _, _, ee_pos, ee_quat = _ee_frames(model, q_masked, qpos_full, q_mask, site_name)
    return _residual_from_pose(q_masked, ee_pos, ee_quat, goal_pos, goal_orn, q_home, q_prev)


def _quat_from_tangent(e: torch.Tensor) -> torch.Tensor:
    """MuJoCo's local tangent convention: q' = q * exp([0, e/2])."""
    angle = torch.sqrt(torch.sum(e * e, dim=-1, keepdim=True) + 1e-24)
    half = 0.5 * angle
    return torch.cat([torch.cos(half), torch.sin(half) * (e / angle)], dim=-1)


def _subquat_jac_b(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Db = d subQuat(qa, qb * exp(e/2)) / de at e = 0 (..., 3, 3): MuJoCo's
    mjd_subQuat Db, in closed form. The JAX version takes jacfwd of
    subQuat(qa, qb * _quat_from_tangent(e)); at e = 0 the tangent map's
    derivative is [0; I/2], so with r = conj(qb) qa = (w, v) the argument
    of the log moves by dw = v/2, dv = (v x e - w e)/2, and the log's
    derivative follows `rot.quat_log`'s branches."""
    r = rot.quat_mul(rot.quat_conj(qb), qa)
    w, v = r[..., 0], r[..., 1:]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    zero = torch.zeros_like(w)
    # [v]x, so that [v]x e_j = v x e_j
    vx = torch.stack([torch.stack([zero, -v[..., 2], v[..., 1]], -1),
                      torch.stack([v[..., 2], zero, -v[..., 0]], -1),
                      torch.stack([-v[..., 1], v[..., 0], zero], -1)], -2)
    dw = 0.5 * v  # (..., 3): column j is d w / d e_j
    dV = 0.5 * (vx - w[..., None, None] * eye)  # (..., 3, 3): [component, j]
    sq = torch.sum(v * v, dim=-1)
    small = sq < 1e-14
    vn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    angle = 2.0 * torch.atan2(vn, w)
    angle = torch.where(angle > torch.pi, angle - 2 * torch.pi, angle)
    # the non-small branch: scale = angle / |v|
    dvn = torch.sum(v[..., :, None] * dV, dim=-2) / vn[..., None]
    dangle = 2.0 * (w[..., None] * dvn - vn[..., None] * dw) / (w * w + vn * vn)[..., None]
    scale_big = angle / vn
    dscale_big = dangle / vn[..., None] - scale_big[..., None] * dvn / vn[..., None]
    # the small branch: scale = 2 / max(w, eps)
    w_pos = w > 1e-12
    wc = torch.clamp(w, min=1e-12)
    scale_small = 2.0 / wc
    dscale_small = torch.where(w_pos[..., None], -2.0 / (wc * wc)[..., None] * dw,
                               torch.zeros_like(dw))
    scale = torch.where(small, scale_small, scale_big)
    dscale = torch.where(small[..., None], dscale_small, dscale_big)
    return dV * scale[..., None, None] + v[..., :, None] * dscale[..., None, :]


def _jacobian_from_frames(model: RobotModel, xpos, axis_w, ee_pos, ee_quat, goal_orn,
                          q_mask, site_name):
    """The reference's analytic Jacobian (..., 6 + 2n, n) from the frames."""
    jacp, jacr = kin.point_jacobian(model, xpos, axis_w, ee_pos, model.site(site_name).parent)
    R = rot.quat_to_mat(ee_quat)
    Db = _subquat_jac_b(goal_orn, ee_quat)
    jac_quat = (k.IK_JAC_RAD * Db.mT @ R.mT) @ jacr
    n = len(q_mask)
    reg = k.IK_JAC_REG * torch.eye(n, dtype=xpos.dtype, device=xpos.device)
    reg = reg.expand(jacp.shape[:-2] + (n, n))
    return torch.cat([_take(jacp, q_mask), _take(jac_quat, q_mask), reg, reg], dim=-2)


def reference_jacobian(model: RobotModel, q_masked, qpos_full, goal_orn,
                       q_mask: Tuple[int, ...], site_name: str) -> torch.Tensor:
    """The reference's analytic IK Jacobian, quirks included: position rows
    from the site Jacobian, quaternion rows IK_JAC_RAD * Db^T R^T jacr (Db
    transposed), and both regularization blocks at IK_JAC_REG * I,
    inconsistent with the residual's weights. The inconsistency moves the
    solver's stationary point; the reference's joint trajectories are
    defined by it."""
    xpos, axis_w, ee_pos, ee_quat = _ee_frames(model, q_masked, qpos_full, q_mask, site_name)
    return _jacobian_from_frames(model, xpos, axis_w, ee_pos, ee_quat, goal_orn, q_mask,
                                 site_name)


def _exact_jacobian(model: RobotModel, q_masked, qpos_full, goal_pos, goal_orn, q_home, q_prev,
                    q_mask, site_name):
    """(residual, its exact Jacobian (..., 6 + 2n, n)), the JAX version's
    jacfwd of `_residual`: the EE's local tangent moves by R^T jacr dq, so
    the orientation rows are IK_RES_RAD * Db R^T jacr."""
    n = len(q_mask)
    xpos, axis_w, ee_pos, ee_quat = _ee_frames(model, q_masked, qpos_full, q_mask, site_name)
    r = _residual_from_pose(q_masked, ee_pos, ee_quat, goal_pos, goal_orn, q_home, q_prev)
    jacp, jacr = kin.point_jacobian(model, xpos, axis_w, ee_pos, model.site(site_name).parent)
    R = rot.quat_to_mat(ee_quat)
    jac_quat = (k.IK_RES_RAD * _subquat_jac_b(goal_orn, ee_quat) @ R.mT) @ jacr
    eye = torch.eye(n, dtype=xpos.dtype, device=xpos.device).expand(jacp.shape[:-2] + (n, n))
    return r, torch.cat([_take(jacp, q_mask), _take(jac_quat, q_mask), k.IK_RES_REG_PREV * eye,
                         k.IK_RES_REG_HOME * eye], dim=-2)


def _bounds(model: RobotModel, q_mask, like: torch.Tensor):
    """The masked joints' ranges (lo, hi) in like's dtype on its device,
    made once per (mask, dtype, device) and cached on the model."""
    key = ("ik_bounds", tuple(q_mask), like.dtype, str(like.device))
    if key not in model.cache:
        rng = torch.as_tensor(model.jnt_range[list(q_mask)], dtype=like.dtype, device=like.device)
        model.cache[key] = (rng[:, 0], rng[:, 1])
    return model.cache[key]


def _flat(a, batch, width):
    return a.expand(batch + (width,)).reshape(-1, width)


def ik_trf(model: RobotModel, qpos_full, goal_pos, goal_orn, q_pos_home_full, q_pos_prev_full,
           *, q_mask: Tuple[int, ...], site_name: str):
    """Reference-parity IK: scipy's TRF with the reference's analytic
    Jacobian and default tolerances, over any leading batch dimensions.

    Returns (q_sol, q_scribble), each (..., n). q_sol is the solution
    clipped to the joint range, which the reference writes into ctrl; a
    non-finite solution falls back to the warm start (its try/except keeps
    the previous solution). q_scribble is the last point the solver
    evaluated, which the reference's residual leaves in the live qpos: the
    solution after a normal exit, the rejected trial after a trust-radius
    collapse. A warm start outside the joint range makes scipy raise
    before any evaluation, so there the warm start is kept for both (and
    the clip projects q_sol into range)."""
    from gym_kmanip_torch.solvers.trf import least_squares_trf

    n, nq = len(q_mask), qpos_full.shape[-1]
    batch = torch.broadcast_shapes(qpos_full.shape[:-1], goal_pos.shape[:-1],
                                   goal_orn.shape[:-1], q_pos_prev_full.shape[:-1])
    qpos = _flat(qpos_full, batch, nq)
    gp, go = _flat(goal_pos, batch, 3), _flat(goal_orn, batch, 4)
    q_home = _flat(_take(q_pos_home_full, q_mask), batch, n)
    q_prev = _flat(_take(q_pos_prev_full, q_mask), batch, n)
    lo, hi = _bounds(model, q_mask, qpos)
    q0 = _take(qpos, q_mask)

    def res_jac(x):
        xpos, axis_w, ee_pos, ee_quat = _ee_frames(model, x, qpos, q_mask, site_name)
        f = _residual_from_pose(x, ee_pos, ee_quat, gp, go, q_home, q_prev)
        return f, _jacobian_from_frames(model, xpos, axis_w, ee_pos, ee_quat, go, q_mask,
                                        site_name)

    # a warm start out of range keeps q0 whatever the solve gives, so it is
    # not solved: in float32 its start sits on the bound, where the scaled
    # trust region degenerates into a crawl to max_nfev (the torso's home
    # pose is such a start) that would hold up the whole batch
    out_of_bounds = torch.any((q0 < lo) | (q0 > hi), dim=-1, keepdim=True)
    out = least_squares_trf(None, None, q0, lo, hi, res_jac_fn=res_jac,
                            active=~out_of_bounds[:, 0])
    nan = torch.isnan(out.x).any(dim=-1, keepdim=True)
    q = torch.where(nan, q0, out.x)
    scribble = torch.where(nan | torch.isnan(out.x_last_eval).any(dim=-1, keepdim=True), q0,
                           out.x_last_eval)
    q = torch.where(out_of_bounds, q0, q)
    scribble = torch.where(out_of_bounds, q0, scribble)
    q = torch.minimum(torch.maximum(q, lo), hi)
    return q.reshape(batch + (n,)), scribble.reshape(batch + (n,))


def ik(model: RobotModel, qpos_full, goal_pos, goal_orn, q_pos_home_full, q_pos_prev_full,
       *, q_mask: Tuple[int, ...], site_name: str, iters: int = k.IK_MAX_ITERS) -> torch.Tensor:
    """Fixed-budget Levenberg-Marquardt IK for the masked joints (..., n):
    `iters` damped Gauss-Newton steps with the exact Jacobian, each
    projected onto the joint range and kept only if it lowers the cost
    (the damping halves on success, quadruples otherwise). A non-finite
    result keeps the warm start; the result is clipped to the joint
    range."""
    n, nq = len(q_mask), qpos_full.shape[-1]
    batch = torch.broadcast_shapes(qpos_full.shape[:-1], goal_pos.shape[:-1],
                                   goal_orn.shape[:-1], q_pos_prev_full.shape[:-1])
    qpos = _flat(qpos_full, batch, nq)
    gp, go = _flat(goal_pos, batch, 3), _flat(goal_orn, batch, 4)
    q_home = _flat(_take(q_pos_home_full, q_mask), batch, n)
    q_prev = _flat(_take(q_pos_prev_full, q_mask), batch, n)
    lo, hi = _bounds(model, q_mask, qpos)
    q0 = _take(qpos, q_mask)
    eye = torch.eye(n, dtype=qpos.dtype, device=qpos.device)

    def res(x):
        return _residual(model, x, qpos, gp, go, q_home, q_prev, q_mask, site_name)

    q = q0
    lam = torch.full(q0.shape[:-1], 1e-4, dtype=qpos.dtype, device=qpos.device)
    for _ in range(iters):
        r, J = _exact_jacobian(model, q, qpos, gp, go, q_home, q_prev, q_mask, site_name)
        H = J.mT @ J + lam[:, None, None] * eye
        g = (J.mT @ r[..., None])[..., 0]
        # a factor that fails leaves NaN, which the guard below catches
        L, _ = torch.linalg.cholesky_ex(H)
        dq = -torch.cholesky_solve(g[..., None], L)[..., 0]
        q_new = torch.minimum(torch.maximum(q + dq, lo), hi)
        r_new = res(q_new)
        improved = torch.sum(r_new * r_new, dim=-1) < torch.sum(r * r, dim=-1)
        q = torch.where(improved[:, None], q_new, q)
        lam = torch.where(improved, torch.clamp(lam * 0.5, min=1e-8), lam * 4.0)
    q = torch.where(torch.isnan(q).any(dim=-1, keepdim=True), q0, q)
    return torch.minimum(torch.maximum(q, lo), hi).reshape(batch + (n,))
