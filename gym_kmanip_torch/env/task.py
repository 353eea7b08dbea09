"""The env's task core: action decode -> host IK -> physics -> obs -> reward.

Port of `gym_kmanip_tpu/env/task.py` (the reference's KManipTask: action
decoding in before_step, get_observation, get_reward). `make_task(cfg)`
returns plain Python `(reset_fn, step_fn, model)` over tensors on one
device; the Gym shell (env/env_base.py) and the backend (env/env_sim.py)
own the RNG and the host copies.

The JAX package's split pipeline is kept exactly: the EE goals are
computed on the device in float32 and copied to the host once, solved in
float64 on the host by `solvers/ik_host.solve_host` (the native C++ solver
when it is built), and the solutions are injected into the step core,
which runs `engine.control_step(..., qpos_force=qpos_pre)`. On the card the
control step is ten launches of the substep kernel. A config with
`ik_host64=False` solves the IK inside the decode instead, with the
float32 device TRF (`solvers/ik.ik_trf`), as the vec env does.

`_ee_goal`, `_decode_action`, `_observe` and `_reward` take any leading
batch dimensions on the state and the action: the single env runs them
unbatched, the vec env (env/vec_env.py) on (N, ...).
"""

from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.engine import _tips_from_frames, control_step
from gym_kmanip_torch.dynamics.state import SimState, StepAux, init_state
from gym_kmanip_torch.models import canonical_device, get_model, model_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.solvers.ik import ik_trf, mask_index
from gym_kmanip_torch.solvers.ik_host import solve_host
from gym_kmanip_torch.utils import rotations as rot

# The reference's touch/lift reward scans for geoms named
# left/right_gripper_finger, which its shipped XMLs lack, so those terms
# never fire there. This env's fingertip geoms exist, so the terms work as
# written; set False for the reference's observable reward (the velocity
# penalty and the distance shaping only).
CONTACT_REWARD_ENABLED: bool = True


class TaskOut(NamedTuple):
    state: SimState
    obs: Dict[str, torch.Tensor]
    reward: torch.Tensor  # (...)
    mocap_pos: torch.Tensor  # (..., n_mocap, 3) decoded EE goals
    mocap_quat: torch.Tensor  # (..., n_mocap, 4)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _site_euler(model: RobotModel, qpos, site_name: str):
    xpos, xquat, _ = kin.fk(model, qpos)
    p, q = kin.site_pose(model, xpos, xquat, site_name)
    return p, q, rot.quat_to_euler_xyz(q)


def _ee_goal(model: RobotModel, cfg, state: SimState, action, side: str):
    """Decoded EE goal (pos, wxyz quat) of one arm: the IK's inputs."""
    p, _, eul = _site_euler(model, state.qpos, f"ee{side}_site")
    dev = state.qpos.device
    goal_pos = action[f"ee{side}_pos"] * _f32(k.EE_POS_DELTA, dev) + p
    goal_orn = rot.euler_xyz_to_quat(action[f"ee{side}_orn"] * _f32(k.EE_ORN_DELTA, dev) + eul)
    return goal_pos, goal_orn


def _decode_action(model: RobotModel, cfg, state: SimState, action: Dict[str, torch.Tensor],
                   ik_solutions: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
                   goals: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None):
    """before_step: action dict -> (ctrl, the post-IK qpos, mocap_pos,
    mocap_quat).

    `ik_solutions` {"r"/"l": (q_sol, q_scribble)} are the host IK's
    solutions (make_task's split pipeline), and `goals` {"r"/"l":
    (goal_pos, goal_orn)} the device goals they were solved for, which the
    decode then does not compute again (None: computed here). Without
    `ik_solutions` the float32 device TRF solves each arm here, over the
    state's batch. The returned
    qpos is the reference's behaviour: its IK scribbles every candidate q
    into the live qpos and never restores it, so its physics integrates
    from the last IK evaluation; the masked arm joints are TELEPORTED to it each control
    step and the kp=1000 servos mop up the residual. Callers integrate from
    this qpos with the pre-step qvel."""
    qpos = state.qpos
    dev = qpos.device
    batch = qpos.shape[:-1]
    qpos_out = qpos.clone()
    ctrl = state.ctrl.clone()
    mocap_pos = _f32(model.mocap_pos0, dev).expand(batch + model.mocap_pos0.shape).clone()
    mocap_quat = _f32(model.mocap_quat0, dev).expand(batch + model.mocap_quat0.shape).clone()

    for side in ("r", "l"):
        if f"grip_{side}" in cfg.act_list:
            gid = [int(i) for i in getattr(cfg, f"ctrl_id_{side}_grip")]
            # quirk parity: the reference indexes qpos with the *ctrl* id
            # (actuator i drives joint i, so the two agree)
            grip = action[f"grip_{side}"][..., 0] * k.EE_S_DELTA + qpos[..., gid[0]]
            grip = torch.clamp(grip, k.EE_S_MIN, k.EE_S_MAX)[..., None]
            ctrl.index_copy_(-1, mask_index(tuple(gid), dev), grip.expand(batch + (len(gid),)))

    for side, mocap_id, mask_ids in (("r", k.MOCAP_ID_R, cfg.q_id_r_mask),
                                     ("l", k.MOCAP_ID_L, cfg.q_id_l_mask)):
        if f"ee{side}_pos" not in cfg.act_list:
            continue
        goal_pos, goal_orn = (goals[side] if goals is not None
                              else _ee_goal(model, cfg, state, action, side))
        mocap_pos[..., mocap_id, :] = goal_pos
        mocap_quat[..., mocap_id, :] = goal_orn
        mask = tuple(int(i) for i in mask_ids)
        if ik_solutions is None:
            q_sol, q_scrib = ik_trf(model, qpos, goal_pos, goal_orn,
                                    _f32(cfg.q_pos_home, dev), qpos, q_mask=mask,
                                    site_name=f"ee{side}_site")
        else:
            q_sol, q_scrib = ik_solutions[side]
        idx = mask_index(mask, dev)
        ctrl.index_copy_(-1, idx, q_sol)
        qpos_out.index_copy_(-1, idx, q_scrib)

    for side in ("r", "l"):
        if f"q_pos_{side}" in cfg.act_list:
            idx = mask_index(tuple(int(i) for i in getattr(cfg, f"q_id_{side}_mask")), dev)
            ctrl.index_copy_(-1, idx, torch.index_select(qpos, -1, idx)
                             + action[f"q_pos_{side}"] * k.Q_POS_DELTA)

    # exponential ctrl filter (CTRL_ALPHA = 1: passthrough)
    ctrl = k.CTRL_ALPHA * ctrl + (1 - k.CTRL_ALPHA) * state.ctrl
    return ctrl, qpos_out, mocap_pos, mocap_quat


def _observe(model: RobotModel, cfg, state: SimState) -> Dict[str, torch.Tensor]:
    """get_observation, the state part (the vision slice adds cameras)."""
    obs = {}
    t = model_tensors(model, state.qpos.device)
    if "q_pos" in cfg.obs_list:
        q = (state.qpos - t.jnt_lo) / (t.jnt_hi - t.jnt_lo)
        obs["q_pos"] = torch.clamp(q, -1.0, 1.0)
    if "q_vel" in cfg.obs_list:
        obs["q_vel"] = torch.clamp(state.qvel / k.MAX_Q_VEL, -1.0, 1.0)
    if "cube_pos" in cfg.obs_list:
        rng = _f32(k.CUBE_SPAWN_RANGE, state.qpos.device)
        c = (state.cube_pos - rng[:, 0]) / (rng[:, 1] - rng[:, 0])
        obs["cube_pos"] = torch.clamp(c, -1.0, 1.0)
    if "cube_orn" in cfg.obs_list:
        obs["cube_orn"] = state.cube_quat
    return obs


def _reward(model: RobotModel, cfg, state: SimState, aux: StepAux) -> torch.Tensor:
    """get_reward."""
    qvel_full = torch.cat([state.qvel, state.cube_linvel, state.cube_angvel], dim=-1)
    r = -k.REWARD_VEL_PENALTY * torch.linalg.vector_norm(qvel_full, dim=-1)
    for side in ("l", "r"):
        if f"grip_{side}" in cfg.act_list:
            i = model.site_index(f"ee{side}_site")
            dist = torch.linalg.vector_norm(state.cube_pos - aux.site_pos[..., i, :], dim=-1)
            r = r + k.REWARD_GRIP_DIST / (dist + k.EPSILON)
    if CONTACT_REWARD_ENABLED:
        touched = aux.touch_r | aux.touch_l
        r = r + torch.where(touched, k.REWARD_TOUCH_CUBE, 0.0)
        r = r + torch.where(touched & ~aux.touch_table, k.REWARD_LIFT_CUBE, 0.0)
    return r


def make_task(cfg, device="cuda"):
    """(reset_fn, step_fn, model) for one env config, on `device` (the card
    unless the caller passes another).

    reset_fn(cube_pos) -> TaskOut at the home state with the cube at
    `cube_pos` (host floats; the backend samples it). step_fn(state,
    action) -> TaskOut, `action` a dict of float32 tensors on the device.
    `step_fn.parts` holds the pipeline's stages (goals, ik, core) for
    callers that time them; with no host IK (the *QPos ids, and
    `ik_host64=False`, whose device TRF runs inside the core) goals and ik
    are None."""
    device = canonical_device(device)
    model = get_model(cfg.mjcf_filename)
    ee_sides = [s for s in ("r", "l") if f"ee{s}_pos" in cfg.act_list]

    def reset_fn(cube_pos) -> TaskOut:
        state = init_state(model, cube_pos=np.asarray(cube_pos), device=device)
        xpos, xquat, _ = kin.fk(model, state.qpos)
        site_pos, site_quat = kin.all_site_poses(model, xpos, xquat)
        false = torch.zeros((), dtype=torch.bool, device=device)
        aux = StepAux(touch_r=false, touch_l=false, touch_table=~false, site_pos=site_pos,
                      site_quat=site_quat, qfrc_contact=torch.zeros_like(state.qvel),
                      tip_pos=_tips_from_frames(model, xpos, xquat))
        return TaskOut(state=state, obs=_observe(model, cfg, state),
                       reward=_reward(model, cfg, state, aux),
                       mocap_pos=_f32(model.mocap_pos0, device),
                       mocap_quat=_f32(model.mocap_quat0, device))

    def step_core(state: SimState, action, ik_solutions=None, goals=None) -> TaskOut:
        ctrl, qpos_ik, mocap_pos, mocap_quat = _decode_action(model, cfg, state, action,
                                                             ik_solutions, goals)
        qpos_pre = state.qpos
        state, aux = control_step(model, state._replace(qpos=qpos_ik), ctrl,
                                  qpos_force=qpos_pre)
        return TaskOut(state, _observe(model, cfg, state), _reward(model, cfg, state, aux),
                       mocap_pos, mocap_quat)

    if not (ee_sides and cfg.ik_host64):  # one pass on the device
        def step_fn(state: SimState, action) -> TaskOut:
            return step_core(state, action)

        step_fn.parts = SimpleNamespace(goals=None, ik=None, core=step_core)
        return reset_fn, step_fn, model

    # the float32 round trip first: the JAX package's callback handed the
    # host solver the float32 device value of q_home
    q_home_np = np.asarray(cfg.q_pos_home, np.float32).astype(np.float64)
    masks = {side: tuple(int(i) for i in getattr(cfg, f"q_id_{side}_mask"))
             for side in ee_sides}

    def goals(state: SimState, action):
        """qpos and every arm's goal on the host in float64, in one copy;
        and the goals on the device, for the decode."""
        dev = {side: _ee_goal(model, cfg, state, action, side) for side in ee_sides}
        flat = torch.cat([state.qpos] + [g for side in ee_sides for g in dev[side]])
        flat = flat.cpu().numpy().astype(np.float64)
        nq = model.nq
        out = {side: (flat[nq + 7 * i: nq + 7 * i + 3], flat[nq + 7 * i + 3: nq + 7 * i + 7])
               for i, side in enumerate(ee_sides)}
        return flat[:nq], out, dev

    def ik(qpos_np, goals_np):
        """Each arm's float64 host solve; the solutions back on the device
        in one copy."""
        sols = [solve_host(qpos_np, *goals_np[side], q_home_np, qpos_np, model=model,
                           q_mask=masks[side], site_name=f"ee{side}_site")
                for side in ee_sides]
        flat = torch.as_tensor(np.concatenate([a for pair in sols for a in pair]),
                               device=device)
        out, off = {}, 0
        for side in ee_sides:
            n = len(masks[side])
            out[side] = (flat[off: off + n], flat[off + n: off + 2 * n])
            off += 2 * n
        return out

    def step_fn(state: SimState, action) -> TaskOut:
        qpos_np, goals_np, goals_dev = goals(state, action)
        return step_core(state, action, ik(qpos_np, goals_np), goals_dev)

    step_fn.parts = SimpleNamespace(goals=goals, ik=ik, core=step_core)
    return reset_fn, step_fn, model
