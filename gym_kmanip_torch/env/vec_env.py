"""Vectorized env: N independent KManip envs stepped as one batch.

Port of `gym_kmanip_tpu/env/vec_env.py`, the RL-training counterpart of
the MPC rollout fan-out: the task core of env/task.py (decode with the
float32 device TRF, physics, reward, observation) runs once over an
(N, ...) state batch, so on the card each of the ten substeps of a control
step is one launch of the substep kernel at K = N. The order is the JAX
version's: decode -> `control_step(qpos_force=qpos_pre)` -> reward from the
pre-reset state -> autoreset at `max_episode_steps` with fresh cube spawns
-> the observation of the post-reset state.

The API follows gymnasium 0.29's VectorEnv conventions (autoreset on
truncation, `info["final_observation"]` and its mask) without depending on
its classes. Observations and rewards stay on the env's device as tensors;
`terminated` and `truncated` are numpy bool arrays, known on the host
without reading the device (every env steps together). Cube spawns are
drawn from the env's own `torch.Generator` (on the CPU, so a seed gives the
same spawns on every device); `reset` and `step` also take injected spawns.

The `*Vision` ids render each camera once per step for the whole batch
(render/raycast.py: one call, (N, h, w, 3) uint8 on the device), after the
autoreset, so the frames are of the fresh states as the rest of the
observation is; at `render_hw` = (h, w) or else at the Cam spec's size.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.engine import control_step
from gym_kmanip_torch.dynamics.state import SimState, init_state
from gym_kmanip_torch.env.config import CONFIGS, EnvConfig
from gym_kmanip_torch.env.task import _decode_action, _observe, _reward
from gym_kmanip_torch.models import canonical_device, get_model
from gym_kmanip_torch.render.raycast import render_camera


class KManipVecEnv:
    def __init__(self, env_id: str, num_envs: int, seed: int = 0, device="cuda",
                 render_hw: Optional[Tuple[int, int]] = None):
        if env_id not in CONFIGS:
            raise KeyError(f"unknown env id {env_id}; one of {list(CONFIGS)}")
        # the batch keeps its IK on the device (the float32 TRF), as the
        # JAX version does; the single env's parity path is the float64
        # host solver (EnvConfig.ik_host64)
        self.cfg: EnvConfig = dataclasses.replace(CONFIGS[env_id], ik_host64=False)
        self.num_envs = num_envs
        self.device = canonical_device(device)
        self.model = get_model(self.cfg.mjcf_filename)
        self.cameras = [k.CAMERAS[o.split("/")[-1]] for o in self.cfg.obs_list if "camera" in o]
        self.render_hw = render_hw
        self.generator = torch.Generator()
        self.generator.manual_seed(seed)
        self._home = init_state(self.model, device=self.device)
        self._spawn = torch.as_tensor(np.asarray(k.CUBE_SPAWN_RANGE, np.float32))
        self._states: Optional[SimState] = None
        self._steps = np.zeros(num_envs, dtype=np.int64)

    # -- helpers -------------------------------------------------------------
    def sample_spawns(self) -> torch.Tensor:
        """(N, 3) cube spawns, uniform over CUBE_SPAWN_RANGE, from the env's
        generator, on the env's device."""
        lo, hi = self._spawn[:, 0], self._spawn[:, 1]
        u = torch.rand((self.num_envs, 3), generator=self.generator)
        return (lo + u * (hi - lo)).to(self.device)

    def _fresh(self, spawns) -> SimState:
        """The home state of every env with its cube at `spawns` (N, 3)."""
        n = self.num_envs
        s = SimState(*(x.expand((n,) + x.shape).clone() for x in self._home))
        return s._replace(cube_pos=torch.as_tensor(spawns, dtype=torch.float32,
                                                   device=self.device).reshape(n, 3))

    def _observation(self, states: SimState) -> Dict[str, torch.Tensor]:
        """The observation of a state batch, camera frames included."""
        obs = _observe(self.model, self.cfg, states)
        for cam in self.cameras:
            h, w = self.render_hw if self.render_hw is not None else (cam.h, cam.w)
            obs[cam.log_name] = render_camera(self.model, cam.name, states.qpos,
                                              states.cube_pos, states.cube_quat, h, w)
        return obs

    def _device_actions(self, actions) -> Dict[str, torch.Tensor]:
        return {name: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                .reshape(self.num_envs, -1) for name, v in actions.items()}

    # -- API -----------------------------------------------------------------
    def reset(self, seed: Optional[int] = None, spawns=None) -> Dict[str, torch.Tensor]:
        """Fresh episodes for every env: the cubes at `spawns` (N, 3), or
        drawn from the generator (reseeded with `seed` if given)."""
        if seed is not None:
            self.generator.manual_seed(seed)
        self._states = self._fresh(self.sample_spawns() if spawns is None else spawns)
        self._steps[:] = 0
        return self._observation(self._states)

    def step(self, actions, spawns=None):
        """actions: a dict of (N, dim) arrays or tensors in the env's action
        space. `spawns` (N, 3) are the cubes of the envs this step resets
        (drawn from the generator when absent). Returns (obs, reward,
        terminated, truncated, info)."""
        assert self._states is not None, "call reset() first"
        model, cfg = self.model, self.cfg
        ctrl, qpos_ik, _, _ = _decode_action(model, cfg, self._states,
                                             self._device_actions(actions))
        states, aux = control_step(model, self._states._replace(qpos=qpos_ik), ctrl,
                                   qpos_force=self._states.qpos)
        reward = _reward(model, cfg, states, aux)
        self._steps += 1
        truncated = self._steps >= cfg.max_episode_steps
        info: Dict = {}
        if truncated.any():
            # gymnasium 0.29: the ending episodes' last observations ride in
            # info["final_observation"], masked by "_final_observation"
            final = self._observation(states)
            fresh = self._fresh(self.sample_spawns() if spawns is None else spawns)
            mask = torch.as_tensor(truncated, device=self.device)
            states = SimState(*(
                torch.where(mask.view((-1,) + (1,) * (f.dim() - 1)), f, s)
                for f, s in zip(fresh, states)))
            self._steps[truncated] = 0
            final_obs = np.full(self.num_envs, None, dtype=object)
            final_info = np.full(self.num_envs, None, dtype=object)
            for i in np.flatnonzero(truncated):
                final_obs[i] = {n: v[i] for n, v in final.items()}
                final_info[i] = {}
            info = {"final_observation": final_obs, "_final_observation": truncated.copy(),
                    "final_info": final_info, "_final_info": truncated.copy()}
        self._states = states
        # TimeLimit only, like the reference
        terminated = np.zeros(self.num_envs, dtype=bool)
        return self._observation(states), reward, terminated, truncated, info

    def close(self):
        self._states = None
