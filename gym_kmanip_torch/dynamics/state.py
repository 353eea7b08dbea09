"""Simulation state: NamedTuples of float32 tensors.

Port of `gym_kmanip_tpu/dynamics/state.py`. A batch of states carries the
batch as an explicit leading dimension on every field (`qpos` (K, nq),
`time` (K,)); an unbatched state has none.
"""

from typing import NamedTuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.models.spec import RobotModel


class SimState(NamedTuple):
    qpos: torch.Tensor  # (..., nq) robot joint positions
    qvel: torch.Tensor  # (..., nq) robot joint velocities
    ctrl: torch.Tensor  # (..., nu) last applied actuator targets
    cube_pos: torch.Tensor  # (..., 3) world
    cube_quat: torch.Tensor  # (..., 4) wxyz
    cube_linvel: torch.Tensor  # (..., 3) world
    cube_angvel: torch.Tensor  # (..., 3) world
    time: torch.Tensor  # (...) seconds


class StepAux(NamedTuple):
    """Per-control-step diagnostics, evaluated at the final substep."""

    touch_r: torch.Tensor  # (...) bool: any right fingertip touching the cube
    touch_l: torch.Tensor  # (...) bool: any left fingertip touching the cube
    touch_table: torch.Tensor  # (...) bool: cube touching the table
    site_pos: torch.Tensor  # (..., n_sites, 3) world EE-site positions
    site_quat: torch.Tensor  # (..., n_sites, 4)
    qfrc_contact: torch.Tensor  # (..., nq) contact torques on the robot
    tip_pos: torch.Tensor  # (..., T, 3) world fingertip sphere centers


def init_state(model: RobotModel, cube_pos=None, cube_quat=None,
               device="cuda") -> SimState:
    """Home-pose state: qpos/ctrl <- home, qvel <- 0, cube at its spawn pose,
    on the card unless `device` says otherwise."""
    device = canonical_device(device)
    if cube_pos is None:
        cube_pos = k.CUBE_INIT_POS
    if cube_quat is None:
        cube_quat = np.array([1.0, 0, 0, 0])

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return SimState(
        qpos=f32(model.home_qpos),
        qvel=torch.zeros(model.nq, device=device),
        ctrl=f32(model.home_qpos[: model.nu]),
        cube_pos=f32(cube_pos),
        cube_quat=f32(cube_quat),
        cube_linvel=torch.zeros(3, device=device),
        cube_angvel=torch.zeros(3, device=device),
        time=torch.zeros((), device=device),
    )


def state_from_numpy(s, device="cuda") -> SimState:
    """SimState from any object with SimState's fields (e.g. the JAX
    package's SimState), as float32 tensors on `device` (the card unless
    the caller passes another)."""
    device = canonical_device(device)
    return SimState(*(
        torch.as_tensor(np.array(getattr(s, f), dtype=np.float32), device=device)
        for f in SimState._fields
    ))


def state_to_numpy(s: SimState) -> SimState:
    """The same state with every field a numpy array on the host."""
    return SimState(*(x.detach().cpu().numpy() for x in s))
