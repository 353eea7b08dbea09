"""Write the JAX package's draws for the cube-position estimator fit of
tests/test_pick_from_pixels.py (seed 0) to tests/golden/.

`fit_cube_pos_estimator(model, jax.random.PRNGKey(0), n_samples=256,
n_steps=800, height=64, width=96, cam_name="top")` draws its arm poses, cube
spawns, initial weights and minibatch indices from one PRNG key
(gym_kmanip_tpu/mpc/vision_cost.py:164-236). The port draws from torch
generators, a different stream; whether 800 steps leave the fit's
constant-mean plateau depends on the draws, in both packages. The
port's on-card run of that test (chip_smoke.py) fits on the port's own
draws of seed 0 and, beside it as a diagnostic, on these draws, so that
the card's fit can be set beside the JAX test's at the JAX test's own
seed (tools/trace_pixels_episodes.py --golden). Only jax.random and
flax's init run here (no render, no training): the same lines as the
fit, in the same order.

    python tools/make_golden_learning.py

tests/test_torch_learning.py checks the file against these draws.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                   "pixels_estimator_draws.npz")
SEED, N_SAMPLES, N_STEPS, HEIGHT, WIDTH, AROUND_HOME, BATCH = 0, 256, 800, 64, 96, 0.4, 128


def draws(seed=SEED, n_samples=N_SAMPLES, n_steps=N_STEPS, height=HEIGHT, width=WIDTH,
          around_home=AROUND_HOME, batch=BATCH):
    """{name: array} of the fit's draws: qs, cubes, idx (n_steps, batch) and
    the initial flax parameters under `p:` key paths."""
    import jax
    import jax.numpy as jnp

    from gym_kmanip_tpu import constants as k
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.vision_cost import CubePosCNN

    model = get_model("solo_arm")
    lo = jnp.asarray(model.jnt_range[:, 0].clip(-3.14), dtype=jnp.float32)
    hi = jnp.asarray(model.jnt_range[:, 1].clip(max=3.14), dtype=jnp.float32)
    home = jnp.asarray(model.home_qpos, dtype=jnp.float32)
    lo = jnp.maximum(lo, home - around_home)
    hi = jnp.minimum(hi, home + around_home)
    spawn = jnp.asarray(k.CUBE_SPAWN_RANGE, dtype=jnp.float32)
    rng, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 4)
    out = dict(
        qs=np.asarray(jax.random.uniform(k1, (n_samples, model.nq), minval=lo, maxval=hi)),
        cubes=np.asarray(jax.random.uniform(k2, (n_samples, 3), minval=spawn[:, 0],
                                            maxval=spawn[:, 1])))
    # jitted: the same values as the fit's eager init, in a third of the time
    params = jax.jit(CubePosCNN().init)(k3, jnp.zeros((height, width, 3), jnp.float32))
    for layer, leaves in params["params"].items():
        for leaf, v in leaves.items():
            out[f"p:params/{layer}/{leaf}"] = np.asarray(v)
    idx, key = [], rng
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        idx.append(np.asarray(jax.random.randint(sub, (batch,), 0, n_samples)))
    out["idx"] = np.stack(idx).astype(np.uint8 if n_samples <= 256 else np.int64)
    return out


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    np.savez_compressed(OUT, **draws())
    print("wrote", os.path.abspath(OUT))


if __name__ == "__main__":
    main()
