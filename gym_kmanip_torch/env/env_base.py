"""Gym API layer: KManipEnv.

Port of `gym_kmanip_tpu/env/env_base.py` (the reference's env wrapper):
the same constructor surface, Dict spaces, info-dict keys and
reset/step/close, over the backend of env/env_sim.py on one device (the
card unless `device` says otherwise).

gymnasium is imported lazily: `KManipEnv` is built on first access of the
name (`from gym_kmanip_torch.env.env_base import KManipEnv`, or gymnasium's
entry point), so importing this module needs no gymnasium, as on a GPU host
that has none. `log_h5py=True` records each episode as an ACT-layout HDF5
file (log/log_h5py.py) and `log_rerun=True` as rerun streams
(log/log_rerun.py; a JSON-lines file without the rerun SDK), both under
`constants.DATA_DIR/<log_prefix>.<uuid>.<date>`, the directory read from
the constants module when the env is made; the loggers get the host numpy
observations of the backend's one copy a step. `sim=False` selects the
real-robot backend (env/env_real.py: camera capture, a command stub),
which runs on the host and ignores `device`. Camera observations are
`Box(0, 255, (h, w, 3), uint8)` at the Cam spec's size, and `render()`
returns the top camera's frame.
"""

import functools
import os
import time
import uuid
from collections import OrderedDict as ODict
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
from numpy.typing import NDArray

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.env.config import EnvConfig
from gym_kmanip_torch.log import log_h5py, log_rerun


def __getattr__(name):
    if name == "KManipEnv":
        return _env_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@functools.lru_cache(maxsize=None)
def _env_class():
    import gymnasium as gym
    from gymnasium import spaces

    class KManipEnv(gym.Env):
        metadata = {"render_modes": ["rgb_array"], "render_fps": k.FPS}

        def __init__(
            self,
            seed: int = 0,
            render_mode: str = "rgb_array",
            obs_list: Optional[List[str]] = None,
            act_list: Optional[List[str]] = None,
            sim: bool = True,
            mjcf_filename: str = k.SOLO_ARM_MJCF,
            urdf_filename: str = k.SOLO_ARM_URDF,
            q_pos_home: Optional[NDArray] = None,
            q_dict: Optional[Dict[str, float]] = None,
            q_keys: Optional[List[str]] = None,
            q_id_r_mask: Optional[NDArray] = None,
            q_id_l_mask: Optional[NDArray] = None,
            ctrl_id_r_grip: Optional[NDArray] = None,
            ctrl_id_l_grip: Optional[NDArray] = None,
            log_prefix: str = "test",
            log_rerun: bool = False,
            log_h5py: bool = False,
            device: str = "cuda",
        ):
            super().__init__()
            if obs_list is None:
                obs_list = ["q_pos", "q_vel", "cube_pos", "cube_orn", "camera/top",
                            "camera/head", "camera/grip_l", "camera/grip_r"]
            if act_list is None:
                act_list = ["eel_pos", "eel_orn", "eer_pos", "eer_orn", "grip_l", "grip_r",
                            "q_pos"]
            self.render_mode: str = render_mode
            self.seed: int = seed
            self.step_idx: int = 0
            self.episode_idx: int = 0
            self.q_pos_home: NDArray = np.asarray(q_pos_home)
            self.q_len: int = len(q_pos_home)
            self.q_dict = q_dict
            self.q_keys: List[str] = list(q_keys)
            assert len(q_keys) == self.q_len, "q parameters do not match"
            self.q_id_r_mask = q_id_r_mask
            self.q_id_l_mask = q_id_l_mask
            self.ctrl_id_r_grip = ctrl_id_r_grip
            self.ctrl_id_l_grip = ctrl_id_l_grip
            self.cameras: List[k.Cam] = [k.CAMERAS[o.split("/")[-1]]
                                         for o in obs_list if "camera" in o]
            self.log_rerun: bool = log_rerun
            self.log_h5py: bool = log_h5py
            self.h5py_f = None
            if log_h5py or log_rerun:
                name = "{}.{}.{}".format(log_prefix, str(uuid.uuid4())[:6],
                                         datetime.now().strftime(k.DATE_FORMAT))
                self.log_dir = os.path.join(k.DATA_DIR, name)
                os.makedirs(self.log_dir, exist_ok=True)
            self.mjcf_filename: str = mjcf_filename
            self.urdf_filename: str = urdf_filename

            # observation space
            self.obs_list = list(obs_list)
            _obs: "ODict[str, spaces.Space]" = ODict()
            if "q_pos" in obs_list:
                _obs["q_pos"] = spaces.Box(-1, 1, shape=(self.q_len,), dtype=k.OBS_DTYPE)
            if "q_vel" in obs_list:
                _obs["q_vel"] = spaces.Box(-1, 1, shape=(self.q_len,), dtype=k.OBS_DTYPE)
            if "cube_pos" in obs_list:
                _obs["cube_pos"] = spaces.Box(-1, 1, shape=(3,), dtype=k.OBS_DTYPE)
            if "cube_orn" in obs_list:
                _obs["cube_orn"] = spaces.Box(-1, 1, shape=(4,), dtype=k.OBS_DTYPE)
            for cam in self.cameras:
                _obs[cam.log_name] = spaces.Box(low=cam.low, high=cam.high,
                                                shape=(cam.h, cam.w, 3), dtype=cam.dtype)
            self.observation_space = spaces.Dict(_obs)

            # action space
            self.act_list = list(act_list)
            _act: "ODict[str, spaces.Space]" = ODict()
            for name in ("eel_pos", "eel_orn", "eer_pos", "eer_orn"):
                if name in act_list:
                    _act[name] = spaces.Box(-1, 1, shape=(3,), dtype=k.ACT_DTYPE)
            for name in ("grip_l", "grip_r"):
                if name in act_list:
                    _act[name] = spaces.Box(-1, 1, shape=(1,), dtype=k.ACT_DTYPE)
            if "q_pos_r" in act_list:
                _act["q_pos_r"] = spaces.Box(-1, 1, shape=(len(self.q_id_r_mask),),
                                             dtype=k.ACT_DTYPE)
            if "q_pos_l" in act_list:
                _act["q_pos_l"] = spaces.Box(-1, 1, shape=(len(self.q_id_l_mask),),
                                             dtype=k.ACT_DTYPE)
            self.action_space = spaces.Dict(_act)
            self.action_len: int = len(self.action_space.spaces)

            # the task core's config record
            self.cfg = EnvConfig(
                env_id="custom", mjcf_filename=mjcf_filename, urdf_filename=urdf_filename,
                obs_list=tuple(self.obs_list), act_list=tuple(self.act_list),
                q_pos_home=self.q_pos_home, q_keys=tuple(self.q_keys),
                q_id_r_mask=q_id_r_mask, q_id_l_mask=q_id_l_mask,
                ctrl_id_r_grip=ctrl_id_r_grip, ctrl_id_l_grip=ctrl_id_l_grip,
            )

            self.sim: bool = sim
            if sim:
                from gym_kmanip_torch.env.env_sim import new

                self.env = new(self, device=device)
            else:
                from gym_kmanip_torch.env.env_real import new

                self.env = new(self)

            self.info: Dict[str, Any] = {
                "step": self.step_idx,
                "episode": self.episode_idx,
                "is_success": False,
                "q_keys": self.q_keys,
                "q_len": self.q_len,
                "a_len": self.action_len,
                "obs_list": self.obs_list,
                "act_list": self.act_list,
                "cameras": self.cameras,
                "sim": self.sim,
                # per-key action dims (not in the reference's info dict)
                "act_dims": {name: int(np.prod(sp.shape))
                             for name, sp in self.action_space.spaces.items()},
            }

        def render(self):
            return self.env.k_render(k.CAMERAS["top"])

        def reset(self, seed=None, options=None):
            super().reset(seed=seed)
            terminated, reward, _, observation, sim_time = self.env.k_reset()
            self.step_idx = 0
            self.episode_idx += 1
            self.info["step"] = self.step_idx
            self.info["episode"] = self.episode_idx
            self.info["sim_time"] = sim_time
            self.info["cpu_time"] = time.time()
            self.info["reward"] = reward
            self.info["is_success"] = False
            self.info["terminated"] = terminated
            if self.log_h5py:
                log_h5py.end(self.h5py_f)  # an episode left open by a reset
                self.h5py_f = log_h5py.new(self.log_dir, self.info)
                for cam in self.cameras:
                    log_h5py.cam(self.h5py_f, cam)
            if self.log_rerun:
                log_rerun.end()  # an episode left open by a reset
                log_rerun.new(self.log_dir, self.info)
                for cam in self.cameras:
                    log_rerun.cam(cam)
            return observation, self.info

        def step(self, action):
            terminated, reward, _, observation, sim_time = self.env.k_step(action)
            self.step_idx += 1
            self.info["step"] = self.step_idx
            self.info["episode"] = self.episode_idx
            self.info["sim_time"] = sim_time
            self.info["cpu_time"] = time.time()
            self.info["reward"] = reward
            self.info["is_success"] = bool(reward > k.REWARD_SUCCESS_THRESHOLD)
            self.info["terminated"] = terminated
            if self.log_rerun:
                log_rerun.step(action, observation, self.info)
            if self.log_h5py:
                log_h5py.step(self.h5py_f, action, observation, self.info)
            return observation, reward, terminated, False, self.info

        def close(self):
            if self.log_h5py:
                log_h5py.end(self.h5py_f)
                self.h5py_f = None
            if self.log_rerun:
                log_rerun.end()
            self.env.k_close()
            super().close()

    KManipEnv.__module__ = __name__
    return KManipEnv
