"""Constants the solo-arm MPPI slice reads.

A copy of the values in `gym_kmanip_tpu/constants.py` (physics, contact,
limit, cube, table and reward constants, robot home poses), so the port
needs neither JAX nor the JAX package at run time.
`tests/test_torch_models.py` holds every value here equal to the JAX
package's.
"""

import os
from typing import Tuple

import numpy as np
from numpy.typing import NDArray

# the port reads the JAX package's MJCF files as data, by path
ASSETS_DIR: str = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "gym_kmanip_tpu",
    "assets",
)

SOLO_ARM_MJCF: str = "_env_solo_arm.xml"
DUAL_ARM_MJCF: str = "_env_dual_arm.xml"
TORSO_MJCF: str = "_env_torso.xml"

# timing
CONTROL_TIMESTEP: float = 0.02  # seconds per control step
PHYSICS_TIMESTEP: float = 0.002  # 10 substeps per control step
N_SUBSTEPS: int = int(round(CONTROL_TIMESTEP / PHYSICS_TIMESTEP))
GRAVITY: Tuple[float, float, float] = (0.0, 0.0, -9.81)

EPSILON: float = 1e-6

# reward shaping (the cube-pick cost is its negation)
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

# home poses, in MJCF qpos order (the shipped assets' "home" keyframes)
ACT_DTYPE = np.float32
Q_SOLO_ARM_HOME: NDArray = np.array(
    [0.0, 0.75, 1.0, 1.0, 2.0, -2.0, 0.0, 0.0, 0.005, 0.005], dtype=ACT_DTYPE
)
Q_DUAL_ARM_HOME: NDArray = np.array(
    [0.0, 0.75, 1.0, 1.0, 2.0, -2.7, 0.0, 0.0, 0.005, 0.005,
     0.0, -0.75, -1.0, -1.0, 2.0, 0.0, 0.0, 0.0, 0.005, 0.005],
    dtype=ACT_DTYPE,
)
Q_TORSO_HOME: NDArray = np.array(
    [-1.0, 0.0, 1.7, 1.6, 0.34, 1.6, 1.4, -0.26, 0.0, 0.0, 0.0,
     -1.7, -1.6, -0.34, -1.6, -1.4, -1.7, 0.0, 0.0, 0.0],
    dtype=ACT_DTYPE,
)
