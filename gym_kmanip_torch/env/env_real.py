"""Real-robot backend: camera capture and the command stub.

Port of `gym_kmanip_tpu/env/env_real.py`, duck-typed to the sim backend's
k_* protocol: one cv2 capture thread per camera of the Gym shell, camera
observations from the latest frames, and `q_command` a stub until a robot
transport exists (as in the reference). The backend holds no tensor: it
runs on the host.

cv2 is imported when a camera starts. Without it, as in the JAX module,
the readers start no capture and every frame stays black.
"""

import threading
import time
from collections import OrderedDict as ODict
from typing import Dict, Optional

import numpy as np

from gym_kmanip_torch import constants as k


def _cv2():
    """The cv2 module, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


class _CamReader:
    def __init__(self, cam: k.Cam):
        self.cam = cam
        self.frame = np.zeros((cam.h, cam.w, cam.c), dtype=cam.dtype)
        self._stop = False
        self._cap = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        cv2 = _cv2()
        if cv2 is None:
            return
        self._cap = cv2.VideoCapture(self.cam.device_id)
        self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.cam.w)
        self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.cam.h)
        self._cap.set(cv2.CAP_PROP_FPS, self.cam.fps)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        period = 1.0 / max(self.cam.fps, 1)
        while not self._stop:
            ok, frame = self._cap.read()
            if ok:
                self.frame = frame[..., k.BGR_TO_RGB]
            time.sleep(period)

    def stop(self):
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        if self._cap is not None:
            self._cap.release()


class KManipEnvReal:
    def __init__(self, gym_env):
        self.gym_env = gym_env
        self.readers: Dict[str, _CamReader] = {}
        for cam in gym_env.cameras:
            r = _CamReader(cam)
            r.start()
            self.readers[cam.name] = r
        self.t0 = time.time()

    def q_command(self, q_pos: np.ndarray) -> None:
        """Send a joint command to the robot: a stub, as in the reference."""

    def get_image(self, cam: k.Cam) -> np.ndarray:
        r = self.readers.get(cam.name)
        return r.frame if r is not None else np.zeros((cam.h, cam.w, cam.c), cam.dtype)

    # -- protocol ----------------------------------------------------------
    def k_reset(self):
        return False, 0.0, 1.0, self._obs(), time.time() - self.t0

    def k_step(self, action):
        # decode and send the command when a transport exists
        self.q_command(np.zeros(self.gym_env.q_len))
        return False, 0.0, 1.0, self._obs(), time.time() - self.t0

    def k_render(self, cam: k.Cam):
        return self.get_image(cam)

    def k_close(self):
        for r in self.readers.values():
            r.stop()

    def _obs(self):
        obs = ODict()
        for cam in self.gym_env.cameras:
            obs[cam.log_name] = self.get_image(cam)
        return obs


def new(gym_env) -> KManipEnvReal:
    return KManipEnvReal(gym_env)
