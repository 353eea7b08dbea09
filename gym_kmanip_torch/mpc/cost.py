"""Running costs for MPC.

Port of `gym_kmanip_tpu/mpc/cost.py`. `cube_pick_cost` (:21-78) is the
negated shaped reward of the reference task (velocity penalty,
inverse-distance gripper shaping, touch and lift bonuses) plus a
control-effort term and an optional EE goal that a NaN goal disables.
`ee_tracking_cost` and `make_ee_tracking_cost_ilqr` (:81-154) are the EE
goal-reaching costs, the latter with its Gauss-Newton quadratization for
iLQR. All work on any leading batch dimensions.
"""

from typing import NamedTuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.state import SimState, StepAux
from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import kinematics as kin


class CostParams(NamedTuple):
    """Weights for the cube-pick running cost (host values)."""

    w_vel: float = k.REWARD_VEL_PENALTY
    w_grip_dist: float = k.REWARD_GRIP_DIST
    w_touch: float = k.REWARD_TOUCH_CUBE
    w_lift: float = k.REWARD_LIFT_CUBE
    w_ctrl: float = 1e-3  # smooth control-effort term
    # optional EE goal (for tracking-style tasks); NaN disables
    ee_goal: np.ndarray = np.full((3,), np.nan, dtype=np.float32)
    w_ee_goal: float = 10.0


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """Norm over the last axis, floored at 1e-8 (finite derivative at 0)."""
    sq = torch.sum(x * x, dim=-1)
    return torch.sqrt(torch.clamp(sq, min=1e-16))


def cube_pick_cost(model: RobotModel, state: SimState, aux: StepAux,
                   ctrl: torch.Tensor, params: CostParams,
                   use_right: bool = True, use_left: bool = False) -> torch.Tensor:
    """Per-step cost = -reward(reference shape) + control regularization."""
    qvel_full = torch.cat([state.qvel, state.cube_linvel, state.cube_angvel], dim=-1)
    c = params.w_vel * _safe_norm(qvel_full)
    for use, site in ((use_right, "eer_site"), (use_left, "eel_site")):
        if use:
            i = model.site_index(site)
            dist = torch.linalg.vector_norm(state.cube_pos - aux.site_pos[..., i, :], dim=-1)
            c = c - params.w_grip_dist / (dist + k.EPSILON)
    touched = aux.touch_r | aux.touch_l
    c = c - torch.where(touched, params.w_touch, 0.0)
    c = c - torch.where(touched & ~aux.touch_table, params.w_lift, 0.0)
    c = c + params.w_ctrl * torch.sum((ctrl - state.qpos[..., : model.nu]) ** 2, dim=-1)

    # EE goal: a host goal is decided on the host (NaN adds nothing, as the
    # JAX package's where(False, ., 0) does); a tensor goal on the device
    goal = params.ee_goal
    if isinstance(goal, torch.Tensor) or not np.isnan(np.asarray(goal)[0]):
        goal = torch.as_tensor(goal, dtype=c.dtype, device=c.device)
        i = model.site_index("eer_site")
        ee_err = torch.sum((aux.site_pos[..., i, :] - torch.nan_to_num(goal)) ** 2, dim=-1)
        c = c + torch.where(~torch.isnan(goal[0]), params.w_ee_goal * ee_err, 0.0)
    return c


def ee_tracking_cost(model: RobotModel, state: SimState, aux: StepAux,
                     ctrl: torch.Tensor, goal_pos: torch.Tensor,
                     w_pos: float = 100.0, w_vel: float = 0.01,
                     w_ctrl: float = 1e-3) -> torch.Tensor:
    """Pure EE goal-reaching cost (for BASELINE's EE tracking metric)."""
    i = model.site_index("eer_site")
    c = w_pos * torch.sum((aux.site_pos[..., i, :] - goal_pos) ** 2, dim=-1)
    c = c + w_vel * torch.sum(state.qvel ** 2, dim=-1)
    c = c + w_ctrl * torch.sum((ctrl - state.qpos[..., : model.nu]) ** 2, dim=-1)
    return c


def make_ee_tracking_cost_ilqr(model: RobotModel, goal_pos, site: str = "eer_site",
                               w_pos: float = 50.0, w_vel: float = 0.01,
                               w_ctrl: float = 1e-3):
    """(cost_xu, quad_xu) for iLQR EE tracking on the flat state
    x = [qpos, qvel, (cube...)] (solvers/ilqr layout; cube dims, if
    present, carry zero cost rows). Both take batched x (..., n) and
    u (..., nu).

    quad_xu is the Gauss-Newton quadratization: cxx's FK block is
    2 w_pos J^T J with J the (3, nq) site Jacobian, here the analytic
    `kinematics.point_jacobian` (the JAX package takes it from
    `jax.jacrev`; the two agree to float32 rounding)."""
    nq, nu = model.nq, model.nu
    goal_host = torch.as_tensor(np.asarray(goal_pos, dtype=np.float32))
    goals = {}
    parent = model.sites[model.site_index(site)].parent

    def goal_on(device):
        device = canonical_device(device)
        g = goals.get(device)
        if g is None:  # copied to each device once, never inside a solve
            g = goals[device] = goal_host.to(device)
        return g

    def ee_frames(q):
        xpos, xquat, axis = kin.fk(model, q)
        p, _ = kin.site_pose(model, xpos, xquat, site)
        return p, xpos, axis

    def cost_xu(x, u):
        q, v = x[..., :nq], x[..., nq: 2 * nq]
        p, _, _ = ee_frames(q)
        return (w_pos * torch.sum((p - goal_on(x.device)) ** 2, dim=-1)
                + w_vel * torch.sum(v ** 2, dim=-1)
                + w_ctrl * torch.sum(u ** 2, dim=-1))

    def quad_xu(x, u):
        n = x.shape[-1]
        batch = x.shape[:-1]
        q, v = x[..., :nq], x[..., nq: 2 * nq]
        p, xpos, axis = ee_frames(q)
        r = p - goal_on(x.device)
        J, _ = kin.point_jacobian(model, xpos, axis, p, parent)  # (..., 3, nq)
        Jt = J.transpose(-1, -2)
        cx = x.new_zeros(batch + (n,))
        cx[..., :nq] = 2.0 * w_pos * (Jt @ r[..., None])[..., 0]
        cx[..., nq: 2 * nq] = 2.0 * w_vel * v
        cu = 2.0 * w_ctrl * u
        cxx = x.new_zeros(batch + (n, n))
        cxx[..., :nq, :nq] = 2.0 * w_pos * (Jt @ J)
        torch.diagonal(cxx[..., nq: 2 * nq, nq: 2 * nq], dim1=-2, dim2=-1).fill_(2.0 * w_vel)
        cuu = (2.0 * w_ctrl * torch.eye(nu, dtype=x.dtype, device=x.device)).expand(
            batch + (nu, nu)).clone()
        cux = x.new_zeros(batch + (nu, n))
        return cx, cu, cxx, cuu, cux

    return cost_xu, quad_xu
