"""Batched horizon rollouts, the compute core of sampling MPC.

Port of `gym_kmanip_tpu/mpc/rollout.py`. The rollout batch K is the
leading dimension of every state field (not `vmap`), the horizon a Python
loop (not `scan`). Rollouts integrate at the control rate by default
(n_substeps=1 at dt=0.02, with implicit actuation); the plant
(`engine.control_step`) stays the high-fidelity evaluator.
"""

from typing import Callable, Tuple

import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics import contacts
from gym_kmanip_torch.dynamics.engine import _tips_from_frames, substep
from gym_kmanip_torch.dynamics.state import SimState, StepAux
from gym_kmanip_torch.models import model_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import kinematics as kin


def mpc_step(model: RobotModel, state: SimState, ctrl: torch.Tensor,
             n_substeps: int, dt: float, contact: bool = True,
             implicit_actuation: bool = True, substep_fn: Callable = substep
             ) -> Tuple[SimState, StepAux]:
    """Control step variant for rollouts.

    Site poses, fingertip positions and touch flags come from the LAST
    substep's forward pass, i.e. from the frames BEFORE that substep, while
    the table touch is read at the post-step cube state: a one-substep
    shift that saves an extra FK per step and is the same for every
    candidate."""
    state = state._replace(ctrl=ctrl)
    for _ in range(n_substeps):
        state, (touch, xpos, xquat) = substep_fn(
            model, state, dt, contact, implicit_actuation
        )
    t = model_tensors(model, state.qpos.device)
    site_pos, site_quat = kin.all_site_poses(model, xpos, xquat)
    if contact:
        _, _, touch_table = contacts.cube_table(
            state.cube_pos, state.cube_quat, state.cube_linvel, state.cube_angvel
        )
    else:
        touch_table = torch.zeros(state.qpos.shape[:-1], dtype=torch.bool,
                                  device=state.qpos.device)
    aux = StepAux(
        touch_r=torch.any(touch & t.tip_right, dim=-1),
        touch_l=torch.any(touch & t.tip_left, dim=-1),
        touch_table=touch_table,
        site_pos=site_pos,
        site_quat=site_quat,
        qfrc_contact=torch.zeros_like(state.qvel),
        tip_pos=_tips_from_frames(model, xpos, xquat),
    )
    return state, aux


def broadcast_state(state: SimState, n: int) -> SimState:
    """An unbatched state repeated into a contiguous batch of `n`."""
    return SimState(*(x.expand((n,) + tuple(x.shape)).contiguous() for x in state))


def rollout(model: RobotModel, state0: SimState, ctrl_seq: torch.Tensor,
            cost_fn: Callable, n_substeps: int = 1,
            dt: float = k.CONTROL_TIMESTEP, contact: bool = True,
            implicit_actuation: bool = True, substep_fn: Callable = substep
            ) -> Tuple[torch.Tensor, SimState]:
    """Roll K control sequences (K, H, nu) from one unbatched state;
    returns (total cost (K,), final states (K, ...)).

    `cost_fn(state, aux, ctrl) -> (K,)` is the running cost of a step."""
    state = broadcast_state(state0, ctrl_seq.shape[0])
    steps = ctrl_seq.transpose(0, 1).contiguous()  # (H, K, nu): each step contiguous
    total = None
    for ctrl in steps:
        state, aux = mpc_step(
            model, state, ctrl, n_substeps, dt, contact=contact,
            implicit_actuation=implicit_actuation, substep_fn=substep_fn,
        )
        c = cost_fn(state, aux, ctrl)
        total = c if total is None else total + c
    return total, state
