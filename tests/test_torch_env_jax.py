"""The port's env step against the JAX package's: `make_task("KManipSoloArm")`
on both sides for 3 steps from the solo golden trace's start, with its
actions. This holds the slice as a whole: the goals, the host IK (the
same native solver on both sides), the decode with its qpos scribble, and
`control_step(..., qpos_force=...)`. It is the one JAX program of the
port's env tests that holds a substep (the JAX step core).

Tolerances of tests/test_torch_plant.py: qpos 1e-5, qvel and cube 1e-4;
the touch flags exact, through the reward (a flag adds 1.0 to it), held at
1e-4; the decoded goals (mocap) 1e-5; each observation at the band of the
state it scales, over its scale (q_pos: qpos's over the narrowest joint
range; q_vel: qvel's over MAX_Q_VEL; cube_pos: the cube's over the spawn
range's narrowest side; cube_orn: the cube's).
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from gym_kmanip_tpu.dynamics.state import init_state as jinit_state
from gym_kmanip_tpu.env import config as jconfig
from gym_kmanip_tpu.env import task as jtask

from gym_kmanip_torch import constants as tk
from gym_kmanip_torch.dynamics.state import state_from_numpy, state_to_numpy
from gym_kmanip_torch.env import config
from gym_kmanip_torch.env.task import make_task

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "solo_arm_env_trace.npz")


def _close(got, want, atol, msg):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0, err_msg=msg)


def test_make_task_matches_jax():
    data = np.load(GOLDEN)
    _, jstep, jm = jtask.make_task(jconfig.CONFIGS["KManipSoloArm"])
    reset_fn, step_fn, _ = make_task(config.CONFIGS["KManipSoloArm"], device="cpu")
    js = jinit_state(jm, cube_pos=jnp.asarray(data["cube_spawn"], dtype=jnp.float32))
    qh = jnp.asarray(config.CONFIGS["KManipSoloArm"].q_pos_home, dtype=jnp.float32)
    js = js._replace(qpos=qh, ctrl=qh[: jm.nu])
    s = state_from_numpy(js, device="cpu")
    obs_tol = {"q_pos": 1e-5 / np.min(np.diff(jm.jnt_range, axis=1)),
               "q_vel": 1e-4 / tk.MAX_Q_VEL,
               "cube_pos": 1e-4 / np.min(np.diff(tk.CUBE_SPAWN_RANGE, axis=1)),
               "cube_orn": 1e-4}
    out0 = reset_fn(np.asarray(data["cube_spawn"], np.float32))
    _close(out0.state.cube_pos, js.cube_pos, 0.0, "reset cube")
    for t in range(3):
        a = data["actions"][t]
        action = {"eer_pos": a[:3].astype(np.float32), "eer_orn": np.zeros(3, np.float32),
                  "grip_r": np.zeros(1, np.float32)}
        jout = jstep(js, {key: jnp.asarray(v) for key, v in action.items()})
        out = step_fn(s, {key: torch.as_tensor(v) for key, v in action.items()})
        js, s = jout.state, out.state
        want = state_to_numpy(state_from_numpy(js, device="cpu"))
        _close(s.qpos, want.qpos, 1e-5, f"step {t}: qpos")
        _close(s.qvel, want.qvel, 1e-4, f"step {t}: qvel")
        for f in ("cube_pos", "cube_quat", "cube_linvel", "cube_angvel"):
            _close(getattr(s, f), getattr(want, f), 1e-4, f"step {t}: {f}")
        _close(s.time, want.time, 1e-6, f"step {t}: time")
        for key, v in jout.obs.items():
            _close(out.obs[key], v, obs_tol[key], f"step {t}: obs {key}")
        _close(out.reward, jout.reward, 1e-4, f"step {t}: reward")
        _close(out.mocap_pos, jout.mocap_pos, 1e-5, f"step {t}: mocap_pos")
        _close(out.mocap_quat, jout.mocap_quat, 1e-5, f"step {t}: mocap_quat")
    # the trace moved the arm: the test is not a fixed point
    assert np.abs(s.qpos.numpy() - np.asarray(qh)).max() > 1e-3
