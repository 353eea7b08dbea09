"""The single env: config, task core, simulation backend and Gym shell.

`register()` registers the eight env ids with gymnasium under the
namespace `gym_kmanip_torch/` (`gym.make("gym_kmanip_torch/KManipSoloArm",
device="cpu")`), beside the JAX package's bare ids. It imports gymnasium,
and raises ImportError where there is none; nothing else in the package
needs it (`env_sim.KManipEnvSim` drives the task without it). `make(env_id,
**kwargs)` registers the ids and makes `gym_kmanip_torch/<env_id>`.
"""

from gym_kmanip_torch.env.config import CONFIGS

NAMESPACE = "gym_kmanip_torch"


def register():
    """Register `gym_kmanip_torch/<id>` for each env id (once)."""
    from gymnasium.envs.registration import register as gym_register
    from gymnasium.envs.registration import registry

    for env_id, cfg in CONFIGS.items():
        name = f"{NAMESPACE}/{env_id}"
        if name in registry:
            continue
        gym_register(
            id=name,
            entry_point="gym_kmanip_torch.env.env_base:KManipEnv",
            max_episode_steps=cfg.max_episode_steps,
            nondeterministic=True,
            kwargs={
                "mjcf_filename": cfg.mjcf_filename,
                "urdf_filename": cfg.urdf_filename,
                "obs_list": list(cfg.obs_list),
                "act_list": list(cfg.act_list),
                "q_pos_home": cfg.q_pos_home,
                "q_dict": {key: float(v) for key, v in zip(cfg.q_keys, cfg.q_pos_home)},
                "q_keys": list(cfg.q_keys),
                "q_id_r_mask": cfg.q_id_r_mask,
                "q_id_l_mask": cfg.q_id_l_mask,
                "ctrl_id_r_grip": cfg.ctrl_id_r_grip,
                "ctrl_id_l_grip": cfg.ctrl_id_l_grip,
            },
        )


def make(env_id: str, **kwargs):
    """`gym.make("gym_kmanip_torch/<env_id>", **kwargs)` after `register()`."""
    import gymnasium as gym

    register()
    return gym.make(f"{NAMESPACE}/{env_id}", **kwargs)
