"""Render the top camera each step and save an mp4.

Port of `gym_kmanip_tpu/examples/3_save_to_video.py`: a random-action
episode of `gym_kmanip_torch/<env_name>` (needs gymnasium), its frames
written with imageio (a GIF where imageio has no ffmpeg backend).

    python -m gym_kmanip_torch.examples.3_save_to_video
"""

import os
import tempfile

from gym_kmanip_torch import constants as k
from gym_kmanip_torch import env as kenv

ENV_NAME: str = "KManipSoloArm"
VIDEO_PATH: str = os.path.join(tempfile.gettempdir(), "kmanip_top.mp4")


def main(env_name: str = ENV_NAME, max_steps: int = k.MAX_EPISODE_STEPS,
         video_path: str = VIDEO_PATH, device="cuda"):
    """The path written."""
    import imageio

    env = kenv.make(env_name, device=device)
    env.reset(seed=0)
    frames = []
    for _ in range(max_steps):
        obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
        frames.append(env.render())
        if terminated or truncated:
            break
    env.close()
    try:
        imageio.mimsave(video_path, frames, fps=k.FPS)
    except Exception:  # no ffmpeg backend: imageio's GIF writer needs none
        video_path = video_path.rsplit(".", 1)[0] + ".gif"
        imageio.mimsave(video_path, frames, fps=min(k.FPS, 25), loop=0)
    print(f"wrote {video_path}")
    return video_path


if __name__ == "__main__":
    main()
