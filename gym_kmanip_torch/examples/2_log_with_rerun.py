"""Record random-action episodes with the visualization logger.

Port of `gym_kmanip_tpu/examples/2_log_with_rerun.py`: `.rrd` files where
the rerun SDK is installed, `.rrd.jsonl` otherwise, under
`constants.DATA_DIR` (the env is `gym_kmanip_torch/<env_name>`; needs
gymnasium).

    python -m gym_kmanip_torch.examples.2_log_with_rerun
"""

import importlib

from gym_kmanip_torch import constants as k
from gym_kmanip_torch import env as kenv

ENV_NAME: str = "KManipSoloArm"
NUM_EPISODES: int = 1

_h5py_example = importlib.import_module("gym_kmanip_torch.examples.2_log_with_h5py")


def main(env_name: str = ENV_NAME, num_episodes: int = NUM_EPISODES,
         max_steps: int = k.MAX_EPISODE_STEPS, device="cuda"):
    """The episodes' log directory."""
    env = kenv.make(env_name, log_rerun=True, log_prefix="rerun_test", device=device)
    _h5py_example.record(env, num_episodes, max_steps)
    env.close()
    print(f"episodes written under {env.unwrapped.log_dir}")
    return env.unwrapped.log_dir


if __name__ == "__main__":
    main()
