"""The cube-pick running cost for sampling MPC.

Port of `gym_kmanip_tpu/mpc/cost.py:21-78`: the negated shaped reward of
the reference task (velocity penalty, inverse-distance gripper shaping,
touch and lift bonuses) plus a control-effort term and an optional EE goal
that a NaN goal disables. Works on any leading batch dimensions.
"""

from typing import NamedTuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.state import SimState, StepAux
from gym_kmanip_torch.models.spec import RobotModel


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
