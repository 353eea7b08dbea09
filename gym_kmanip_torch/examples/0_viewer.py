"""Viewer: the live interactive browser viewer, or frames written offline.

Port of `gym_kmanip_tpu/examples/0_viewer.py` (the reference launches
dm_control's GUI viewer, which needs a display):

  * `python -m gym_kmanip_torch.examples.0_viewer --live` serves the live
    viewer over HTTP (gym_kmanip_torch/viewer.py): the env's frames in any
    browser, keyboard teleop (WASD/QE moves the EE, space grips, R resets);
  * without --live it rolls a random policy and writes the top camera's
    frames as an mp4 (a GIF where imageio has no ffmpeg backend, .npy
    frames without imageio).

The env is `gym_kmanip_torch/<env_name>` (needs gymnasium).
"""

import os
import sys
import tempfile

import numpy as np

from gym_kmanip_torch import env as kenv

ENV_NAME: str = "KManipSoloArm"
# ENV_NAME: str = "KManipSoloArmQPos"
# ENV_NAME: str = "KManipDualArm"
# ENV_NAME: str = "KManipDualArmQPos"
# ENV_NAME: str = "KManipTorso"
NUM_STEPS: int = 16
OUT_DIR: str = os.path.join(tempfile.gettempdir(), "kmanip_viewer")


def write_frames(frames, out_dir: str, fps: int = 30) -> str:
    """The frames as viewer.mp4, else viewer.gif, else frame_*.npy under
    `out_dir`; returns what was written."""
    os.makedirs(out_dir, exist_ok=True)
    try:
        import imageio
    except ImportError:
        for i, f in enumerate(frames):
            np.save(os.path.join(out_dir, f"frame_{i:03d}.npy"), f)
        print(f"imageio unavailable; wrote npy frames to {out_dir}")
        return out_dir
    path = os.path.join(out_dir, "viewer.mp4")
    try:
        imageio.mimsave(path, frames, fps=fps)
    except Exception:  # no ffmpeg backend: imageio's GIF writer needs none
        path = os.path.join(out_dir, "viewer.gif")
        imageio.mimsave(path, frames, fps=min(fps, 25), loop=0)
    print(f"wrote {path}")
    return path


def main(env_name: str = ENV_NAME, num_steps: int = NUM_STEPS, out_dir: str = OUT_DIR,
         live: bool = False, device="cuda"):
    """With `live`, serve the viewer until Ctrl-C; else the path written."""
    env = kenv.make(env_name, device=device)
    if live:
        from gym_kmanip_torch.viewer import LiveViewer

        LiveViewer(env).run()
        env.close()
        return None
    env.reset(seed=0)
    frames = []
    for i in range(num_steps):
        obs, reward, terminated, truncated, info = env.step(env.action_space.sample())
        frames.append(env.render())
        print(f"step {i}: reward={reward:.4f}")
    env.close()
    return write_frames(frames, out_dir)


if __name__ == "__main__":
    main(live="--live" in sys.argv)
