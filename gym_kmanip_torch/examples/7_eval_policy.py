"""Evaluate a policy in the env.

Port of `gym_kmanip_tpu/examples/7_eval_policy.py`: evaluates the BC
policy of example 6's flat checkpoint or, where there is none, the reach
heuristic (the EE moves toward the cube, through the port's FK), in the
port's registered Gym env (`gym_kmanip_torch/<ENV_NAME>`; needs
gymnasium), and reports each episode's return.

    python -m gym_kmanip_torch.examples.7_eval_policy
"""

import importlib
import os

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.ops import kinematics as kin

ENV_NAME: str = "KManipSoloArm"
NUM_EPISODES: int = 3

_ex6 = importlib.import_module("gym_kmanip_torch.examples.6_train_from_dataset")
CKPT_PATH: str = _ex6.CKPT_PATH


def make_policy(env, ckpt_path: str = None, device="cuda"):
    """obs -> action dict: example 6's checkpoint where `ckpt_path` exists,
    else the reach heuristic."""
    ckpt_path = ckpt_path or CKPT_PATH
    if os.path.exists(ckpt_path):
        with np.load(ckpt_path) as ckpt:
            net = _ex6.policy_mlp_from_flat(ckpt["flat"], int(ckpt["obs_dim"]),
                                            int(ckpt["act_dim"]), device=device)
        dev = next(net.parameters()).device

        @torch.no_grad()
        def policy(obs):
            x = torch.as_tensor(np.concatenate([obs["q_pos"], obs["q_vel"]])[None],
                                dtype=torch.float32, device=dev)
            flat_act = net(x)[0].cpu().numpy()
            action, i = {}, 0
            for name, sp in env.action_space.spaces.items():
                d = int(np.prod(sp.shape))
                action[name] = flat_act[i:i + d].astype(sp.dtype)
                i += d
            return action

        print("evaluating BC policy from", ckpt_path)
        return policy

    def heuristic(obs):
        backend = env.unwrapped.env
        state = backend.state
        xpos, xquat, _ = kin.fk(backend.model, state.qpos)
        eer_pos, _ = kin.site_pose(backend.model, xpos, xquat, "eer_site")
        gap = (state.cube_pos - eer_pos).cpu().numpy()
        return {
            "eer_pos": np.clip(gap / (np.linalg.norm(gap) + 1e-6), -1, 1).astype(np.float32),
            "eer_orn": np.zeros(3, dtype=np.float32),
            "grip_r": np.asarray([1.0], dtype=np.float32),
        }

    print("no checkpoint found; evaluating reach heuristic")
    return heuristic


def main(env_name: str = ENV_NAME, num_episodes: int = NUM_EPISODES,
         max_steps: int = k.MAX_EPISODE_STEPS, ckpt_path: str = None, device="cuda"):
    """Each episode's (return, success) as a list."""
    from gym_kmanip_torch import env as kenv

    env = kenv.make(env_name, device=device)
    policy = make_policy(env, ckpt_path, device=device)
    results = []
    for ep in range(num_episodes):
        obs, info = env.reset(seed=ep)
        total = 0.0
        for _ in range(max_steps):
            obs, reward, terminated, truncated, info = env.step(policy(obs))
            total += reward
            if terminated or truncated:
                break
        results.append((total, bool(info["is_success"])))
        print(f"episode {ep}: return {total:.3f} success={info['is_success']}")
    print(f"mean return over {num_episodes} episodes: {np.mean([r for r, _ in results]):.3f}")
    env.close()
    return results


if __name__ == "__main__":
    main()
