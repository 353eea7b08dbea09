"""The port's cube-position estimator against the bar of
tests/test_pick_from_pixels.py, without the episodes.

    PYTHONPATH=. python tools/port_estimator_bar.py [--seeds 0 1] [--samples 256]
        [--steps 800] [--episodes 2] [--device cuda|cpu] [--threads 4]

For each seed: `fit_cube_pos_estimator(model, seed, n_samples, n_steps,
64, 96, "top")` (gym_kmanip_torch/mpc/vision_cost.py) on the torch
generator's draws, then the initial estimate error at example 14's first
`episodes` spawns, drawn and measured as its run() and run_episode do:
the mean is what the test holds under 0.02 m. The counterpart of
tools/jax_estimator_bar.py. Prints one JSON object per seed, with the
loss every n_steps / 8 steps.
"""

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from gym_kmanip_torch import constants as k  # noqa: E402
from gym_kmanip_torch.dynamics.state import init_state  # noqa: E402
from gym_kmanip_torch.models import get_model  # noqa: E402
from gym_kmanip_torch.mpc import vision_cost  # noqa: E402
from gym_kmanip_torch.render import raycast  # noqa: E402

ex14 = importlib.import_module("gym_kmanip_torch.examples.14_pick_from_pixels")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    model = get_model("solo_arm")
    for seed in args.seeds:
        losses, t0 = [], time.time()
        _, estimate = vision_cost.fit_cube_pos_estimator(
            model, seed=seed, n_samples=args.samples, n_steps=args.steps, height=ex14.H_PX,
            width=ex14.W_PX, cam_name=ex14.CAM, device=args.device, losses=losses)
        rng, errs = np.random.RandomState(seed + 1), []
        for _ in range(args.episodes):
            spawn = np.clip(np.array([0.15, 0.58, 0.62]) + rng.uniform(-1, 1, 3)
                            * np.array([0.02, 0.02, 0.0]), k.CUBE_SPAWN_RANGE[:, 0],
                            k.CUBE_SPAWN_RANGE[:, 1])
            s = init_state(model, cube_pos=spawn, device=args.device)
            img = raycast.render_camera(model, ex14.CAM, s.qpos, s.cube_pos, s.cube_quat,
                                        ex14.H_PX, ex14.W_PX).float() / 255.0
            errs.append(float(torch.linalg.vector_norm(estimate(img) - s.cube_pos)))
        every = max(args.steps // 8, 1)
        print(json.dumps(dict(seed=seed, samples=args.samples, steps=args.steps,
                              loss=[round(x, 4) for x in losses[::every]] + [losses[-1]],
                              errs=errs, mean=float(np.mean(errs)),
                              bar_met=bool(np.mean(errs) < 0.02), seconds=time.time() - t0,
                              device=str(args.device))), flush=True)

if __name__ == "__main__":
    main()
