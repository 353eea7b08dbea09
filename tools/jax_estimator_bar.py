"""The JAX package's own cube-position estimator against the bar of
tests/test_pick_from_pixels.py, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_estimator_bar.py [--seeds 0 1]
        [--samples 256] [--steps 800] [--episodes 2]

For each seed: `fit_cube_pos_estimator(model, PRNGKey(seed), n_samples,
n_steps, 64, 96, "top")` (gym_kmanip_tpu/mpc/vision_cost.py:164-236), then
the initial estimate error at example 14's first `episodes` spawns, drawn
and measured as its run() and run_episode do
(gym_kmanip_tpu/examples/14_pick_from_pixels.py): the mean is what the
test holds under 0.02 m. Runs no episode. Prints one JSON object per seed.
"""

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="*", default=[0])
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--episodes", type=int, default=2)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu import constants as k
    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.vision_cost import fit_cube_pos_estimator
    from gym_kmanip_tpu.render.raycast import render_camera

    ex14 = importlib.import_module("gym_kmanip_tpu.examples.14_pick_from_pixels")
    model = get_model("solo_arm")
    frame = jax.jit(lambda q, c, cq: render_camera(model, ex14.CAM, q, c, cq, ex14.H_PX,
                                                   ex14.W_PX).astype(jnp.float32) / 255.0)
    for seed in args.seeds:
        t0 = time.time()
        _, estimate = fit_cube_pos_estimator(
            model, jax.random.PRNGKey(seed), n_samples=args.samples, n_steps=args.steps,
            height=ex14.H_PX, width=ex14.W_PX, cam_name=ex14.CAM)
        rng, errs = np.random.RandomState(seed + 1), []
        for _ in range(args.episodes):
            spawn = np.array([0.15, 0.58, 0.62]) + rng.uniform(-1, 1, 3) * np.array(
                [0.02, 0.02, 0.0])
            spawn = np.clip(spawn, k.CUBE_SPAWN_RANGE[:, 0], k.CUBE_SPAWN_RANGE[:, 1])
            s = init_state(model, cube_pos=spawn)
            est = estimate(frame(s.qpos, s.cube_pos, s.cube_quat))
            errs.append(float(jnp.linalg.norm(est - s.cube_pos)))
        print(json.dumps(dict(seed=seed, samples=args.samples, steps=args.steps, errs=errs,
                              mean=float(np.mean(errs)), bar_met=bool(np.mean(errs) < 0.02),
                              seconds=time.time() - t0, platform=jax.default_backend())),
              flush=True)


if __name__ == "__main__":
    main()
