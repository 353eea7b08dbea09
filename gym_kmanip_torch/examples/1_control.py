"""Sinusoidal control sweep.

Port of `gym_kmanip_tpu/examples/1_control.py`: a policy that drives every
action channel with a phase-shifted sine wave, in
`gym_kmanip_torch/<env_name>` (needs gymnasium).

    python -m gym_kmanip_torch.examples.1_control
"""

import numpy as np

from gym_kmanip_torch import env as kenv

ENV_NAME: str = "KManipSoloArmQPos"
# ENV_NAME: str = "KManipDualArmQPos"
NUM_STEPS: int = 64


def policy(t: float, action_space) -> dict:
    action = {}
    for i, (name, space) in enumerate(action_space.spaces.items()):
        phase = t * 2 * np.pi + i * np.pi / 4
        action[name] = (np.sin(phase) * np.ones(space.shape)).astype(space.dtype)
    return action


def main(env_name: str = ENV_NAME, num_steps: int = NUM_STEPS, device="cuda"):
    """The rewards of the steps taken."""
    env = kenv.make(env_name, device=device)
    env.reset(seed=0)
    rewards = []
    for i in range(num_steps):
        obs, reward, terminated, truncated, info = env.step(
            policy(i / num_steps, env.action_space))
        rewards.append(reward)
        print(f"step {i}: reward={reward:.4f} sim_time={info['sim_time']:.2f}")
        if terminated or truncated:
            break
    env.close()
    return rewards


if __name__ == "__main__":
    main()
