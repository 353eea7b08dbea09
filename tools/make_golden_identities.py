"""Write the JAX package's dynamics identities on seeded states to
tests/golden/dynamics_identities.npz.

For each robot (solo_arm, dual_arm, torso): three states drawn as
tests/test_dynamics.py:73-86 draws them (numpy RandomState(0) over the
robots in that order; q uniform inside jnt_range clipped to +-3, v =
0.5 N(0, 1); float32), and JAX's `ops/kinematics.py` functions on each,
run eagerly on the CPU: `mass_matrix`, `gravity_potential`, `bias_forces`
(RNEA) and `bias_forces_ad` (the Lagrangian autodiff oracle). The autodiff
oracle takes 14-20 s a robot eagerly here, with its op compiles, so
tests/test_torch_kinematics.py holds the port to this file, and runs the
cheap JAX functions live on one state beside it.

    JAX_PLATFORMS=cpu python tools/make_golden_identities.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden",
                   "dynamics_identities.npz")
NAMES = ("solo_arm", "dual_arm", "torso")
N_STATES = 3


def draws(models):
    """{name: (q (N, nq), v (N, nq))} float32, tests/test_dynamics.py's
    draws in its order."""
    rng = np.random.RandomState(0)
    out = {}
    for name in NAMES:
        m = models[name]
        lo = np.maximum(m.jnt_range[:, 0], -3)
        hi = np.minimum(m.jnt_range[:, 1], 3)
        qs, vs = [], []
        for _ in range(N_STATES):
            qs.append(np.asarray(rng.uniform(lo, hi), np.float32))
            vs.append(np.asarray(rng.randn(m.nq) * 0.5, np.float32))
        out[name] = (np.stack(qs), np.stack(vs))
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.ops import kinematics as kin

    models = {name: get_model(name) for name in NAMES}
    arrays = {}
    for name, (qs, vs) in draws(models).items():
        m = models[name]
        rows = {"M": [], "U": [], "bias": [], "bias_ad": []}
        for q, v in zip(qs, vs):
            q, v = jnp.asarray(q), jnp.asarray(v)
            rows["M"].append(np.asarray(kin.mass_matrix(m, q)))
            rows["U"].append(np.asarray(kin.gravity_potential(m, q)))
            rows["bias"].append(np.asarray(kin.bias_forces(m, q, v)))
            rows["bias_ad"].append(np.asarray(kin.bias_forces_ad(m, q, v)))
        arrays[f"{name}/q"], arrays[f"{name}/v"] = qs, vs
        for key, vals in rows.items():
            arrays[f"{name}/{key}"] = np.stack(vals)
        print(f"{name}: {len(qs)} states", flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.abspath(OUT)}")


if __name__ == "__main__":
    main()
