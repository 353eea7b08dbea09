"""Write the JAX package's rollout and MPPI references of
tests/test_torch_mppi.py to tests/golden/mppi_refs.npz.

On the solo arm with the default CostParams, at K = 8 rollouts of H = 3
steps from `init_state`: `rollout_with_traj` on seeded control sequences
(numpy RandomState(3): home + 0.1 N(0, 1)) at the MPC rate (dt = 0.02, one
substep) and at env fidelity (dt = 0.002, two substeps), and the MPPI
solve of `make_mppi_solver` at H = 3 with one iteration and with two, all
in ONE jitted program, as the test's fixture compiled it; beside them the
noise draws each solve made (its key split, then `sample_noise`), which
the test injects into the port's solve. The program takes ~56 s of XLA
compile on an 8-core x86 host, so the test reads this file instead.

    JAX_PLATFORMS=cpu python tools/make_golden_mppi.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "mppi_refs.npz")
K, H, SEED = 8, 3, 3
STATE_FIELDS = ("qpos", "qvel", "ctrl", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel",
                "time")


def controls(home_qpos, nu):
    rng = np.random.RandomState(SEED)
    return (home_qpos[:nu] + 0.1 * rng.randn(K, H, nu)).astype(np.float32)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from gym_kmanip_tpu.dynamics.state import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc import mppi
    from gym_kmanip_tpu.mpc.cost import CostParams, cube_pick_cost
    from gym_kmanip_tpu.mpc.rollout import rollout_with_traj

    jm = get_model("solo_arm")
    params = CostParams()
    cost = lambda s, aux, u: cube_pick_cost(jm, s, aux, u, params)  # noqa: E731
    U = controls(jm.home_qpos, jm.nu)
    s0 = init_state(jm)
    cfg = mppi.MPPIConfig(horizon=H, n_samples=K)
    ms = mppi.init_mppi(jm, cfg)
    solver = mppi.make_mppi_solver(jm, cfg, cost)
    cfg2 = mppi.MPPIConfig(horizon=H, n_samples=K, n_iters=2)
    solver2 = mppi.make_mppi_solver(jm, cfg2, cost)

    def refs(U):
        totals = {}
        for dt, n_substeps in ((0.02, 1), (0.002, 2)):
            total, _, steps = jax.vmap(lambda u: rollout_with_traj(
                jm, s0, u, cost, n_substeps=n_substeps, dt=dt))(U)
            totals[dt] = (steps, total)
        return totals, solver(ms, s0), solver2(ms, s0)

    totals, out1, out2 = jax.jit(refs)(U)
    arrays = dict(U=U)
    for f in STATE_FIELDS:
        arrays[f"s0/{f}"] = np.asarray(getattr(s0, f))
    for dt, (steps, total) in totals.items():
        arrays[f"steps/{dt}"], arrays[f"total/{dt}"] = np.asarray(steps), np.asarray(total)
    for tag, (ms_j, u0, J) in (("mppi1", out1), ("mppi2", out2)):
        arrays[f"{tag}/nominal"] = np.asarray(ms_j.nominal)
        arrays[f"{tag}/u0"], arrays[f"{tag}/J"] = np.asarray(u0), np.asarray(J)
    # the draws the solves made: their key split each iteration, then
    # sample_noise
    for tag, c in (("mppi1", cfg), ("mppi2", cfg2)):
        rng, draws = ms.rng, []
        for _ in range(c.n_iters):
            rng, sub = jax.random.split(rng)
            draws.append(np.asarray(mppi.sample_noise(
                sub, K, H, jm.nu, mppi.sigma_per_actuator(jm, c.sigma), c.noise_beta)))
        arrays[f"{tag}/eps"] = np.stack(draws)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {os.path.abspath(OUT)}")


if __name__ == "__main__":
    main()
