"""Simulation backend: the `k_reset/k_step/k_render/k_close` protocol.

Port of `gym_kmanip_tpu/env/env_sim.py` (the reference's KManipEnvSim).
It wraps the task core (env/task.py) on one device and owns the host side:
the episode's cube spawn, drawn from the Gym shell's
`numpy.random.Generator`, and the copies between host and device. Each
step copies the action to the device in one transfer and its obs, reward
and time to the host in one transfer.

`gym_env` is duck-typed: it needs only `cfg`, `obs_list`, `cameras` (the
`constants.Cam` specs of its camera observations) and `np_random`, so the
backend runs without gymnasium (on a GPU host that has none). Each camera
is rendered by the raycaster (render/raycast.py) at its Cam spec's size
after every reset and step, on the device, and copied to the host as
uint8 in one transfer per camera.

The k_* return tuple mirrors the reference's dm_control TimeStep:
(terminated, reward, discount, observation, sim_time).
"""

from collections import OrderedDict as ODict
from typing import Dict

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.env.task import make_task
from gym_kmanip_torch.render.raycast import make_render_fn


class KManipEnvSim:
    def __init__(self, gym_env, device="cuda"):
        self.gym_env = gym_env
        self.cfg = gym_env.cfg
        self.reset_fn, self.step_fn, self.model = make_task(self.cfg, device=device)
        self.device = torch.device(device)
        self.state = None
        self.step_count = 0
        self._layout = None  # the obs fields' names, shapes and sizes
        self.render_fns = {cam.name: make_render_fn(self.model, cam.name, cam.h, cam.w)
                           for cam in gym_env.cameras}

    # -- protocol ----------------------------------------------------------
    def k_reset(self):
        cube_pos = self.gym_env.np_random.uniform(
            k.CUBE_SPAWN_RANGE[:, 0], k.CUBE_SPAWN_RANGE[:, 1])
        out = self.reset_fn(cube_pos.astype(np.float32))
        self.state = out.state
        self.step_count = 0
        obs, reward, t = self._host_out(out)
        return False, reward, 1.0, obs, t

    def k_step(self, action: Dict[str, np.ndarray]):
        out = self.step_fn(self.state, self._device_action(action))
        self.state = out.state
        self.step_count += 1
        obs, reward, t = self._host_out(out)
        # termination only through the gym TimeLimit wrapper, like the
        # reference (its dm_control StepType trips on the time limit only)
        return False, reward, 1.0, obs, t

    def k_render(self, cam: k.Cam) -> np.ndarray:
        """The (h, w, 3) uint8 frame of camera `cam` at the current state."""
        fn = self.render_fns.get(cam.name)
        if fn is None:
            fn = self.render_fns[cam.name] = make_render_fn(self.model, cam.name, cam.h, cam.w)
        s = self.state
        return fn(s.qpos, s.cube_pos, s.cube_quat).cpu().numpy()

    def k_close(self):
        self.state = None

    # -- helpers -----------------------------------------------------------
    def _device_action(self, action: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The action's fields as float32 device tensors, in one copy."""
        parts = [np.asarray(v, dtype=np.float32).reshape(-1) for v in action.values()]
        flat = torch.as_tensor(np.concatenate(parts), device=self.device)
        out, off = {}, 0
        for key, p in zip(action, parts):
            out[key] = flat[off: off + p.size]
            off += p.size
        return out

    def _host_out(self, out):
        """(obs, reward, time) on the host with ONE device-to-host copy of
        [obs fields..., reward, time] as one flat float32 vector."""
        if self._layout is None:
            names = [n for n in self.gym_env.obs_list if n in out.obs]
            shapes = [tuple(out.obs[n].shape) for n in names]
            self._layout = (names, shapes, [int(np.prod(s)) for s in shapes])
        names, shapes, sizes = self._layout
        parts = [out.obs[n].reshape(-1).float() for n in names]
        parts.append(torch.stack([out.reward.float(), out.state.time.float()]))
        flat = torch.cat(parts).cpu().numpy()
        obs = ODict()
        off = 0
        for n, shape, size in zip(names, shapes, sizes):
            obs[n] = flat[off: off + size].reshape(shape).astype(k.OBS_DTYPE)
            off += size
        for cam in self.gym_env.cameras:
            obs[cam.log_name] = self.k_render(cam)
        return obs, float(flat[-2]), float(flat[-1])


def new(gym_env, device="cuda") -> KManipEnvSim:
    return KManipEnvSim(gym_env, device=device)
