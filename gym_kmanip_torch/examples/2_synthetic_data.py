"""Record heuristic-policy episodes with both loggers.

Port of `gym_kmanip_tpu/examples/2_synthetic_data.py` and its reach
heuristic: the right EE moves toward the cube, the normalized (cube_pos -
eer_pos) gap as the position action, the EE position from the port's FK
on the sim backend's state; the gripper opens until the EE is within 5 cm.
Episodes of `gym_kmanip_torch/<env_name>` (needs gymnasium and h5py) under
`constants.DATA_DIR`.

    python -m gym_kmanip_torch.examples.2_synthetic_data
"""

import importlib

import numpy as np

from gym_kmanip_torch import constants as k
from gym_kmanip_torch import env as kenv
from gym_kmanip_torch.ops import kinematics as kin

ENV_NAME: str = "KManipSoloArm"
NUM_EPISODES: int = 2

_h5py_example = importlib.import_module("gym_kmanip_torch.examples.2_log_with_h5py")


def heuristic_action(env, obs) -> dict:
    backend = env.unwrapped.env  # the sim backend
    state = backend.state
    xpos, xquat, _ = kin.fk(backend.model, state.qpos)
    eer_pos, _ = kin.site_pose(backend.model, xpos, xquat, "eer_site")
    gap = (state.cube_pos - eer_pos).cpu().numpy()
    dist = np.linalg.norm(gap)
    return {
        "eer_pos": np.clip(gap / (dist + 1e-6), -1, 1).astype(np.float32),
        "eer_orn": np.zeros(3, dtype=np.float32),
        "grip_r": np.asarray([1.0 if dist > 0.05 else -1.0], dtype=np.float32),
    }


def main(env_name: str = ENV_NAME, num_episodes: int = NUM_EPISODES,
         max_steps: int = k.MAX_EPISODE_STEPS, device="cuda"):
    """(the episodes' log directory, the last reward)."""
    env = kenv.make(env_name, log_h5py=True, log_rerun=True, log_prefix="synthetic",
                    device=device)
    reward = _h5py_example.record(env, num_episodes, max_steps, policy=heuristic_action)
    env.close()
    print(f"final reward {reward:.3f}; episodes written under {env.unwrapped.log_dir}")
    return env.unwrapped.log_dir, reward


if __name__ == "__main__":
    main()
