"""Typed env configuration registry.

Port of `gym_kmanip_tpu/env/config.py`: the same eight env ids with the
same obs/act lists, home poses and masks. The three `*Vision` ids observe
camera frames beside the joint state.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from numpy.typing import NDArray

from gym_kmanip_torch import constants as k


@dataclass(frozen=True)
class EnvConfig:
    env_id: str
    mjcf_filename: str
    urdf_filename: str
    obs_list: Tuple[str, ...]
    act_list: Tuple[str, ...]
    q_pos_home: NDArray
    q_keys: Tuple[str, ...]
    q_id_r_mask: Optional[NDArray] = None
    q_id_l_mask: Optional[NDArray] = None
    ctrl_id_r_grip: Optional[NDArray] = None
    ctrl_id_l_grip: Optional[NDArray] = None
    max_episode_steps: int = k.MAX_EPISODE_STEPS
    # EE-delta IK precision. True (every KManip* env): the float64 host TRF
    # (solvers/ik_host), whose scipy tolerances sit below the float32
    # epsilon. False: the float32 device TRF (solvers/ik.ik_trf) inside the
    # step, as the vec env (env/vec_env.py) runs it.
    ik_host64: bool = True


_STATE_OBS = ("q_pos", "q_vel", "cube_pos", "cube_orn")

_SOLO = dict(
    mjcf_filename=k.SOLO_ARM_MJCF,
    urdf_filename=k.SOLO_ARM_URDF,
    q_pos_home=k.Q_SOLO_ARM_HOME,
    q_keys=tuple(k.Q_SOLO_ARM_KEYS),
    q_id_r_mask=k.Q_ID_R_MASK_SOLO,
    ctrl_id_r_grip=k.CTRL_ID_R_GRIP_SOLO,
)
_DUAL = dict(
    mjcf_filename=k.DUAL_ARM_MJCF,
    urdf_filename=k.DUAL_ARM_URDF,
    q_pos_home=k.Q_DUAL_ARM_HOME,
    q_keys=tuple(k.Q_DUAL_ARM_KEYS),
    q_id_r_mask=k.Q_ID_R_MASK_DUAL,
    q_id_l_mask=k.Q_ID_L_MASK_DUAL,
    ctrl_id_r_grip=k.CTRL_ID_R_GRIP_DUAL,
    ctrl_id_l_grip=k.CTRL_ID_L_GRIP_DUAL,
)
_TORSO = dict(
    mjcf_filename=k.TORSO_MJCF,
    urdf_filename=k.TORSO_URDF,
    q_pos_home=k.Q_TORSO_HOME,
    q_keys=tuple(k.Q_TORSO_KEYS),
    q_id_r_mask=k.Q_ID_R_MASK_TORSO,
    q_id_l_mask=k.Q_ID_L_MASK_TORSO,
    ctrl_id_r_grip=k.CTRL_ID_R_GRIP_TORSO,
    ctrl_id_l_grip=k.CTRL_ID_L_GRIP_TORSO,
)

_DUAL_EE_ACTS = ("eel_pos", "eel_orn", "eer_pos", "eer_orn", "grip_l", "grip_r")

CONFIGS: Dict[str, EnvConfig] = {
    c.env_id: c
    for c in [
        EnvConfig(env_id="KManipSoloArm", obs_list=_STATE_OBS,
                  act_list=("eer_pos", "eer_orn", "grip_r"), **_SOLO),
        EnvConfig(env_id="KManipSoloArmQPos", obs_list=_STATE_OBS,
                  act_list=("q_pos_r", "grip_r"), **_SOLO),
        EnvConfig(env_id="KManipSoloArmVision",
                  obs_list=("q_pos", "q_vel", "camera/head", "camera/grip_r"),
                  act_list=("eer_pos", "eer_orn", "grip_r"), **_SOLO),
        EnvConfig(env_id="KManipDualArm", obs_list=_STATE_OBS, act_list=_DUAL_EE_ACTS,
                  **_DUAL),
        EnvConfig(env_id="KManipDualArmQPos", obs_list=_STATE_OBS,
                  act_list=("q_pos_r", "q_pos_l", "grip_l", "grip_r"), **_DUAL),
        EnvConfig(env_id="KManipDualArmVision",
                  obs_list=("q_pos", "q_vel", "camera/head", "camera/grip_l", "camera/grip_r"),
                  act_list=_DUAL_EE_ACTS, **_DUAL),
        EnvConfig(env_id="KManipTorso", obs_list=_STATE_OBS, act_list=_DUAL_EE_ACTS,
                  **_TORSO),
        EnvConfig(env_id="KManipTorsoVision",
                  obs_list=("q_pos", "q_vel", "camera/head", "camera/grip_l", "camera/grip_r"),
                  act_list=_DUAL_EE_ACTS, **_TORSO),
    ]
}

# the ids without and with camera observations
STATE_ENV_IDS: Tuple[str, ...] = tuple(
    i for i, c in CONFIGS.items() if not any("camera" in o for o in c.obs_list))
VISION_ENV_IDS: Tuple[str, ...] = tuple(i for i in CONFIGS if i not in STATE_ENV_IDS)
