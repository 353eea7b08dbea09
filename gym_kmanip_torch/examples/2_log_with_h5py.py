"""Record random-action episodes to HDF5 (the ACT / LeRobot layout).

Port of `gym_kmanip_tpu/examples/2_log_with_h5py.py`: episodes of
`gym_kmanip_torch/<env_name>` (needs gymnasium and h5py) under
`constants.DATA_DIR`.

    python -m gym_kmanip_torch.examples.2_log_with_h5py
"""

from gym_kmanip_torch import constants as k
from gym_kmanip_torch import env as kenv

ENV_NAME: str = "KManipSoloArm"
NUM_EPISODES: int = 2


def record(env, num_episodes: int, max_steps: int, policy=None):
    """`num_episodes` episodes of up to `max_steps` steps of `policy(env,
    obs)` (random actions where None); returns the last reward."""
    reward = None
    for _ in range(num_episodes):
        obs, info = env.reset()
        for _ in range(max_steps):
            action = env.action_space.sample() if policy is None else policy(env, obs)
            obs, reward, terminated, truncated, info = env.step(action)
            if terminated or truncated:
                break
    return reward


def main(env_name: str = ENV_NAME, num_episodes: int = NUM_EPISODES,
         max_steps: int = k.MAX_EPISODE_STEPS, device="cuda"):
    """The episodes' log directory."""
    env = kenv.make(env_name, log_h5py=True, log_prefix="h5py_test", device=device)
    record(env, num_episodes, max_steps)
    env.close()
    print(f"episodes written under {env.unwrapped.log_dir}")
    return env.unwrapped.log_dir


if __name__ == "__main__":
    main()
