"""Write the JAX scan forward that tests/test_torch_ilqr_parts.py holds the
feedback rollout's plain version to, to tests/golden/feedback_refs.npz.

tests/test_pallas.py:346-366's forward on the solo arm: the reduced-layout
iLQR state of `init_state` (the cube from the template), H = 3, seeded
nominal controls, states, feed-forward and gain terms (numpy
RandomState(5)), step sizes {0, 0.3, 1}; each step a contact-free
`mpc_step` at dt = 0.02 with the unrolled solve, under one jitted vmap
over the step sizes (~14 s of XLA compile on an 8-core x86 host, so the
test reads this file). The file holds the inputs too; the test checks
them against its own.

    JAX_PLATFORMS=cpu python tools/make_golden_feedback.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "feedback_refs.npz")
H, SEED = 3, 5


def inputs(jm, x0):
    """(us_nom, xs_nom, ks, Ks, alphas) of the test, in its draw order."""
    n, nu = 2 * jm.nq, jm.nu
    rng = np.random.RandomState(SEED)
    us_nom = (jm.home_qpos[:nu] + 0.05 * rng.randn(H, nu)).astype(np.float32)
    xs_nom = (x0[None] + 0.02 * rng.randn(H, n)).astype(np.float32)
    ks = (0.03 * rng.randn(H, nu)).astype(np.float32)
    Ks = (0.05 * rng.randn(H, nu, n)).astype(np.float32)
    return us_nom, xs_nom, ks, Ks, np.array([0.0, 0.3, 1.0], np.float32)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from gym_kmanip_tpu.dynamics.state import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.rollout import mpc_step
    from gym_kmanip_tpu.solvers import ilqr

    jm = get_model("solo_arm")
    js0 = init_state(jm)
    x0 = np.array(ilqr.flatten_state(js0, reduced=True))
    us_nom, xs_nom, ks, Ks, alphas = inputs(jm, x0)
    lo = jnp.asarray(jm.ctrl_range[:, 0], jnp.float32)
    hi = jnp.asarray(jm.ctrl_range[:, 1], jnp.float32)

    def f_fast(x, u):
        s = ilqr.unflatten_state(jm, x, js0)
        s2, _ = mpc_step(jm, s, u, 1, 0.02, contact=False, unrolled_solve=True)
        return ilqr.flatten_state(s2, reduced=True)

    def forward(alpha):
        def body(x, inp):
            x_nom, u_nom, kff, K = inp
            u = jnp.clip(u_nom + alpha * kff + K @ (x - x_nom), lo, hi)
            x2 = jax.vmap(f_fast)(x[None], u[None])[0]
            return x2, (x2, u)

        _, (xs_t, us_t) = jax.lax.scan(body, jnp.asarray(x0), (xs_nom, us_nom, ks, Ks))
        return xs_t, us_t

    xs_ref, us_ref = jax.jit(jax.vmap(forward))(alphas)
    np.savez_compressed(OUT, x0=x0, us_nom=us_nom, xs_nom=xs_nom, ks=ks, Ks=Ks, alphas=alphas,
                        xs=np.asarray(xs_ref), us=np.asarray(us_ref))
    print(f"wrote {os.path.abspath(OUT)}")


if __name__ == "__main__":
    main()
