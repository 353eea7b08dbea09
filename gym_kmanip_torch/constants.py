"""Constants the port reads.

A copy of the values in `gym_kmanip_tpu/constants.py` (physics, contact,
limit, cube, table and reward constants, robot home poses, and the env's
action scales, masks, spawn range and IK weights, the camera specs, the
HDF5 logger's chunk cache and data directory, the real robot's camera
capture, and the MuJoCo <-> Vuer frame converters of VR teleop),
so the port needs neither JAX nor the JAX package at run time.
`tests/test_torch_models.py` holds every value here equal to the JAX
package's, but `ASSETS_DIR`: the port ships its own copies of the assets.
"""

import os
from collections import OrderedDict as ODict
from dataclasses import dataclass
from typing import List, OrderedDict, Tuple

import numpy as np
from numpy.typing import NDArray

# the port's MJCF assets (tools/gen_assets.py writes them from the
# models/_chains.py tables)
ASSETS_DIR: str = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# recorded episodes (env/env_base.py's log directories): the JAX package's
# data directory, so that the two packages' examples read each other's
# episode files
DATA_DIR: str = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "gym_kmanip_tpu", "data"
)
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

# the real robot's camera capture (env/env_real.py): frame rate, and cv2's
# BGR channels to RGB
CAMERA_FPS: int = 30
BGR_TO_RGB: NDArray = np.array([2, 1, 0], dtype=np.uint8)

# quaternion component orders
XYZW_2_WXYZ: NDArray = np.array([3, 0, 1, 2])
WXYZ_2_XYZW: NDArray = np.array([1, 2, 3, 0])

# MuJoCo <-> Vuer frames for VR teleop (teleop.py): host numpy, equal to
# scipy's Rotation formulation including the quaternion's sign
# (tests/test_torch_sidecars.py)
VUER_IMG_QUALITY: int = 20
# Rz(pi) @ Rx(pi/2)
MJ_TO_VUER_MAT: NDArray = np.array([[-1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
VUER_TO_MJ_MAT: NDArray = MJ_TO_VUER_MAT.T
# scipy's quaternion of VUER_TO_MJ: the Hamilton product with it reproduces
# Rotation.__mul__'s output, sign included
_VUER_TO_MJ_QUAT_XYZW: NDArray = np.array([0.0, -np.sqrt(0.5), -np.sqrt(0.5), 0.0])


def _np_quat_xyzw_to_mat(q: NDArray) -> NDArray:
    x, y, z, w = np.asarray(q, dtype=np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _np_mat_to_quat_xyzw(m: NDArray) -> NDArray:
    """Shepperd's method with scipy's sign rule: the component picked by
    argmax([m00, m11, m22, trace]) takes the positive square root."""
    t = float(np.trace(m))
    choice = int(np.argmax([m[0, 0], m[1, 1], m[2, 2], t]))
    if choice == 3:
        w = 0.5 * np.sqrt(1.0 + t)
        s = 0.25 / w
        return np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                         (m[1, 0] - m[0, 1]) * s, w])
    i = choice
    j, kk = (i + 1) % 3, (i + 2) % 3
    xi = 0.5 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[kk, kk], 0.0))
    s = 0.25 / xi
    q = np.zeros(4)
    q[i] = xi
    q[j] = (m[j, i] + m[i, j]) * s
    q[kk] = (m[kk, i] + m[i, kk]) * s
    q[3] = (m[kk, j] - m[j, kk]) * s
    return q


def mat_to_euler_xyz(m: NDArray) -> NDArray:
    """Extrinsic-xyz euler angles of M = Rz(c) @ Ry(b) @ Rx(a), as scipy's
    `as_euler("xyz")`."""
    b = float(np.arcsin(np.clip(-m[2, 0], -1.0, 1.0)))
    a = float(np.arctan2(m[2, 1], m[2, 2]))
    c = float(np.arctan2(m[1, 0], m[0, 0]))
    return np.array([a, b, c])


def _np_quat_mul_xyzw(p: NDArray, q: NDArray) -> NDArray:
    px, py, pz, pw = p
    qx, qy, qz, qw = q
    return np.array([
        pw * qx + qw * px + py * qz - pz * qy,
        pw * qy + qw * py + pz * qx - px * qz,
        pw * qz + qw * pz + px * qy - py * qx,
        pw * qw - px * qx - py * qy - pz * qz,
    ])


def mj2vuer_pos(pos: NDArray) -> NDArray:
    return MJ_TO_VUER_MAT @ np.asarray(pos, dtype=np.float64)


def mj2vuer_orn(orn: NDArray, offset: NDArray = None) -> NDArray:
    """wxyz quat (and an optional wxyz offset quat) -> Vuer xyz euler."""
    m = _np_quat_xyzw_to_mat(np.asarray(orn)[XYZW_2_WXYZ]) @ MJ_TO_VUER_MAT
    if offset is not None:
        m = _np_quat_xyzw_to_mat(np.asarray(offset)[XYZW_2_WXYZ]) @ m
    return mat_to_euler_xyz(m)


def vuer2mj_pos(pos: NDArray) -> NDArray:
    return VUER_TO_MJ_MAT @ np.asarray(pos, dtype=np.float64)


def vuer2mj_orn(orn) -> NDArray:
    """Vuer rotation -> quat reordered by WXYZ_2_XYZW, sign included. Takes
    a scipy Rotation, a 3 x 3 matrix or an xyzw quat."""
    if hasattr(orn, "as_quat"):
        q_in = np.asarray(orn.as_quat(), dtype=np.float64)
    else:
        arr = np.asarray(orn, dtype=np.float64)
        q_in = _np_mat_to_quat_xyzw(arr) if arr.shape == (3, 3) else arr
    return _np_quat_mul_xyzw(q_in, _VUER_TO_MJ_QUAT_XYZW)[WXYZ_2_XYZW]


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
CUBE_FRICTION: Tuple[float, float, float] = (1.0, 0.005, 0.0001)  # the assets' cube geom
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
