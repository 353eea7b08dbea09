"""Constants the port reads.

A copy of the values in `gym_kmanip_tpu/constants.py` (physics, contact,
limit, cube, table and reward constants, robot home poses, and the env's
action scales, masks, spawn range and IK weights, the camera specs, and
the HDF5 logger's chunk cache and data directory),
so the port needs neither JAX nor the JAX package at run time.
`tests/test_torch_models.py` holds every value here equal to the JAX
package's.
"""

import os
from collections import OrderedDict as ODict
from dataclasses import dataclass
from typing import List, OrderedDict, Tuple

import numpy as np
from numpy.typing import NDArray

# the port reads the JAX package's MJCF files as data, by path
ASSETS_DIR: str = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "gym_kmanip_tpu",
    "assets",
)

# recorded episodes (env/env_base.py's log directories): the JAX package's
# data directory, so that the two packages' examples read each other's
# episode files
DATA_DIR: str = os.path.join(os.path.dirname(ASSETS_DIR), "data")
DATE_FORMAT: str = "%mm%dd%Yy_%Hh%Mm"

SOLO_ARM_MJCF: str = "_env_solo_arm.xml"
DUAL_ARM_MJCF: str = "_env_dual_arm.xml"
TORSO_MJCF: str = "_env_torso.xml"

SOLO_ARM_URDF: str = "stompy_tiny_solo_arm_glb.urdf"
DUAL_ARM_URDF: str = "stompy_dual_arm_tiny_glb.urdf"
TORSO_URDF: str = "stompy_tiny_glb/robot.urdf"

# episode
MAX_EPISODE_STEPS: int = 64
FPS: int = 30
MAX_Q_VEL: float = np.pi  # rad/s, the q_vel observation's scale

# timing
CONTROL_TIMESTEP: float = 0.02  # seconds per control step
PHYSICS_TIMESTEP: float = 0.002  # 10 substeps per control step
N_SUBSTEPS: int = int(round(CONTROL_TIMESTEP / PHYSICS_TIMESTEP))
GRAVITY: Tuple[float, float, float] = (0.0, 0.0, -9.81)

EPSILON: float = 1e-6

# exponential filter of the control signal (1 = passthrough)
CTRL_ALPHA: float = 1.0

# host IK residual and Jacobian weights
IK_RES_RAD: float = 0.02
IK_RES_REG_PREV: float = 6e-3
IK_RES_REG_HOME: float = 2e-6
IK_JAC_RAD: float = 0.02
IK_JAC_REG: float = 9e-3
# iterations of the fixed-budget Levenberg-Marquardt IK (solvers/ik.ik)
IK_MAX_ITERS: int = 12

# HDF5 episode files (log/log_h5py.py): the chunk cache of an open file
H5PY_CHUNK_SIZE_BYTES: int = 1024**2 * 2

# Gym space dtypes
OBS_DTYPE: np.dtype = np.float64



@dataclass
class Cam:
    """Camera spec: note the order, width before height."""

    w: int  # image width
    h: int  # image height
    c: int  # image channels
    fl: int  # focal length
    pp: Tuple[int, int]  # principal point
    name: str
    log_name: str
    low: int = 0
    high: int = 255
    dtype = np.uint8
    device_id: int = 0
    fps: int = 30


CAMERAS: OrderedDict[str, Cam] = ODict()
CAMERAS["head"] = Cam(640, 480, 3, 448, (320, 240), "head", "camera/head")
CAMERAS["top"] = Cam(640, 480, 3, 448, (320, 240), "top", "camera/top")
CAMERAS["grip_r"] = Cam(60, 40, 3, 45, (30, 20), "grip_r", "camera/grip_r")
CAMERAS["grip_l"] = Cam(60, 40, 3, 45, (30, 20), "grip_l", "camera/grip_l")

# cube spawn bounds (x, y, z rows of [lo, hi])
CUBE_SPAWN_RANGE: NDArray = np.array(
    [
        [0.1, 0.3],
        [0.5, 0.7],
        [0.6, 0.7],
    ]
)

# action scales: EE deltas, joint deltas, gripper slider range and step
EE_POS_DELTA: NDArray = np.array([0.01, 0.01, 0.01])
EE_ORN_DELTA: NDArray = np.array([0.1, 0.1, 0.1])
Q_POS_DELTA: float = 0.1  # radians
EE_S_MIN: float = -0.029  # closed
EE_S_MAX: float = 0.005  # open
EE_S_DELTA: float = 0.0001

# reward shaping (the cube-pick cost is its negation)
REWARD_SUCCESS_THRESHOLD: float = 2.0
REWARD_VEL_PENALTY: float = 0.01
REWARD_GRIP_DIST: float = 0.01
REWARD_TOUCH_CUBE: float = 1.0
REWARD_LIFT_CUBE: float = 1.0

# scene: tabletop box and the free cube
TABLE_POS: NDArray = np.array([0.0, 0.6, 0.5])
TABLE_TOP_Z: float = 0.6
TABLE_HALF_X: float = 0.6
TABLE_HALF_Y: float = 0.4
CUBE_HALF_SIZE: float = 0.02
CUBE_MASS: float = 0.05
CUBE_DIAG_INERTIA: float = 0.002
CUBE_FRICTIONLOSS: float = 0.01
CUBE_INIT_POS: NDArray = np.array([0.2, 0.5, 0.65])

# impedance-space contacts (solref 0.01, 1): critically damped, tau = 10 ms
CONTACT_TIMECONST: float = 0.01
CONTACT_KAPPA: float = 1.0 / CONTACT_TIMECONST**2
CONTACT_BETA: float = 2.0 / CONTACT_TIMECONST
CONTACT_FRICTION_MU: float = 1.0
CONTACT_SLIP_VEL: float = 0.01

# engine regularization damping
JOINT_DAMPING: float = 1.0

# joint limits (solref 0.02, 1; solimp dmax 0.95) and the wide safety clamp
LIMIT_TIMECONST: float = 0.02
LIMIT_KAPPA: float = 1.0 / LIMIT_TIMECONST**2
LIMIT_BETA: float = 2.0 / LIMIT_TIMECONST
LIMIT_IMPEDANCE: float = 0.95
LIMIT_SAFETY_MARGIN: float = 0.5
CONSTRAINT_ITERS: int = 3

# soft dof frictionloss (solreffriction 0.02, 1; solimp d0 0.9)
FRICTION_BETA: float = 2.0 / (0.95 * LIMIT_TIMECONST)
FRICTION_IMPEDANCE: float = 0.9

# cube velocity caps for coarse-dt rollouts
CUBE_MAX_LINVEL: float = 4.0
CUBE_MAX_ANGVEL: float = 50.0

# home poses, keyed by the MJCF joint names in qpos order (the shipped
# assets' "home" keyframes)
ACT_DTYPE = np.float32
Q_SOLO_ARM_HOME_DICT: OrderedDict[str, float] = ODict()
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x8_1_dof_x8"] = 0.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x8_2_dof_x8"] = 0.75
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x6_1_dof_x6"] = 1.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x6_2_dof_x6"] = 1.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_x4_1_dof_x4"] = 2.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_3_dof_x4"] = -2.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_1_dof_x4"] = 0.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_2_dof_x4"] = 0.0
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_3"] = 0.005
Q_SOLO_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_1"] = 0.005
Q_SOLO_ARM_HOME: NDArray = np.array(list(Q_SOLO_ARM_HOME_DICT.values()), dtype=ACT_DTYPE)
Q_SOLO_ARM_KEYS: List[str] = list(Q_SOLO_ARM_HOME_DICT.keys())

Q_DUAL_ARM_HOME_DICT: OrderedDict[str, float] = ODict()
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x8_1_dof_x8"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x8_2_dof_x8"] = 0.75
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x6_1_dof_x6"] = 1.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x6_2_dof_x6"] = 1.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_x4_1_dof_x4"] = 2.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_3_dof_x4"] = -2.7
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_1_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_x4_2_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_3"] = 0.005
Q_DUAL_ARM_HOME_DICT["joint_right_arm_1_hand_right_1_slider_1"] = 0.005
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x8_1_dof_x8"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x8_2_dof_x8"] = -0.75
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x6_1_dof_x6"] = -1.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x6_2_dof_x6"] = -1.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_x4_1_dof_x4"] = 2.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_x4_3_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_x4_1_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_x4_2_dof_x4"] = 0.0
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_slider_3"] = 0.005
Q_DUAL_ARM_HOME_DICT["joint_left_arm_1_hand_left_1_slider_1"] = 0.005
Q_DUAL_ARM_HOME: NDArray = np.array(list(Q_DUAL_ARM_HOME_DICT.values()), dtype=ACT_DTYPE)
Q_DUAL_ARM_KEYS: List[str] = list(Q_DUAL_ARM_HOME_DICT.keys())

Q_TORSO_HOME_DICT: OrderedDict[str, float] = ODict()
Q_TORSO_HOME_DICT["joint_head_1_x4_1_dof_x4"] = -1.0
Q_TORSO_HOME_DICT["joint_head_1_x4_2_dof_x4"] = 0.0
Q_TORSO_HOME_DICT["joint_right_arm_1_x8_1_dof_x8"] = 1.7
Q_TORSO_HOME_DICT["joint_right_arm_1_x8_2_dof_x8"] = 1.6
Q_TORSO_HOME_DICT["joint_right_arm_1_x6_1_dof_x6"] = 0.34
Q_TORSO_HOME_DICT["joint_right_arm_1_x6_2_dof_x6"] = 1.6
Q_TORSO_HOME_DICT["joint_right_arm_1_x4_1_dof_x4"] = 1.4
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_x4_1_dof_x4"] = -0.26
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_slider_1"] = 0.0
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_slider_2"] = 0.0
Q_TORSO_HOME_DICT["joint_right_arm_1_hand_1_x4_2_dof_x4"] = 0.0
Q_TORSO_HOME_DICT["joint_left_arm_2_x8_1_dof_x8"] = -1.7
Q_TORSO_HOME_DICT["joint_left_arm_2_x8_2_dof_x8"] = -1.6
Q_TORSO_HOME_DICT["joint_left_arm_2_x6_1_dof_x6"] = -0.34
Q_TORSO_HOME_DICT["joint_left_arm_2_x6_2_dof_x6"] = -1.6
Q_TORSO_HOME_DICT["joint_left_arm_2_x4_1_dof_x4"] = -1.4
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_x4_1_dof_x4"] = -1.7
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_slider_1"] = 0.0
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_slider_2"] = 0.0
Q_TORSO_HOME_DICT["joint_left_arm_2_hand_1_x4_2_dof_x4"] = 0.0
Q_TORSO_HOME: NDArray = np.array(list(Q_TORSO_HOME_DICT.values()), dtype=ACT_DTYPE)
Q_TORSO_KEYS: List[str] = list(Q_TORSO_HOME_DICT.keys())

# the env's joint masks (IK-controlled arm joints) and gripper ctrl ids
Q_ID_R_MASK_SOLO: NDArray = np.array([0, 1, 2, 3, 4, 5, 6])
CTRL_ID_R_GRIP_SOLO: NDArray = np.array([8, 9])

Q_ID_R_MASK_DUAL: NDArray = np.array([0, 1, 2, 3, 4, 5, 6])
Q_ID_L_MASK_DUAL: NDArray = np.array([10, 11, 12, 13, 14, 15, 16])
CTRL_ID_R_GRIP_DUAL: NDArray = np.array([8, 9])
CTRL_ID_L_GRIP_DUAL: NDArray = np.array([18, 19])

Q_ID_R_MASK_TORSO: NDArray = np.array([2, 3, 4, 5, 6, 7])
Q_ID_L_MASK_TORSO: NDArray = np.array([11, 12, 13, 14, 15, 16])
CTRL_ID_R_GRIP_TORSO: NDArray = np.array([8, 9])
CTRL_ID_L_GRIP_TORSO: NDArray = np.array([17, 18])

# mocap objects set by the decoded EE goals
MOCAP_ID_R: int = 0
MOCAP_ID_L: int = 1
