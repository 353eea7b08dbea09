"""Write the JAX package's sharded solvers' results on a two-device mesh to
tests/golden/parallel_sharded.npz.

On `make_mesh(2)` of two virtual CPU devices
(`--xla_force_host_platform_device_count=2`), at the shapes of
tests/test_parallel.py:

  * `global_elite` on tied costs, local_k = 3: the test's pattern
    (:60-88; at two devices both tied candidates sit on device 1) and a tie
    across the two devices;
  * `make_sharded_mppi_solver` at H = 4, K = 4 (local_k = 2), sigma 0.08,
    contact off, the EE-tracking cost of a goal 3 cm off the home EE
    (:91-145), at 1 and at 2 iterations, with the per-device draws rebuilt
    as the test rebuilds them (the solve's key split, `sample_noise` per
    device, device-major concatenation) for each iteration;
  * `make_sharded_ilqr_solver` at B = 4, H = 6, 1 iteration, reduced
    state, contact off, the Gauss-Newton EE cost, with the problems drawn
    from `RandomState(0)` (:156-238).

The port's tests (tests/test_torch_parallel.py) inject these draws and hold
the port's sharded solvers to these results, so no JAX sharded solver is
compiled in their run. Compiling the two sharded programs takes minutes on
a CPU host.

    python tools/make_golden_parallel.py
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden", "parallel_sharded.npz")
N_DEV = 2
ELITE_LOCAL_K = 3
MPPI = dict(horizon=4, n_samples=4, sigma=0.08, contact=False)
ILQR_B, ILQR_H = 4, 6
GOAL_OFFSET = np.array([0.0, 0.03, -0.03], np.float32)


def elite_cases():
    """(costs (2, 6), cand (6, 4)): the test's tie pattern and a tie across
    devices."""
    k = N_DEV * ELITE_LOCAL_K
    costs = np.ones((2, k), np.float32)
    costs[0, 1 * ELITE_LOCAL_K + 2] = costs[0, (N_DEV - 1) * ELITE_LOCAL_K] = 0.5
    costs[1, ELITE_LOCAL_K - 1] = costs[1, ELITE_LOCAL_K] = 0.5
    cand = np.arange(k * 4, dtype=np.float32).reshape(k, 4)
    return costs, cand


def main():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from gym_kmanip_tpu.dynamics import init_state
    from gym_kmanip_tpu.models import get_model
    from gym_kmanip_tpu.mpc.cost import ee_tracking_cost, make_ee_tracking_cost_ilqr
    from gym_kmanip_tpu.mpc.mppi import (
        MPPIConfig, init_mppi, sample_noise, sigma_per_actuator)
    from gym_kmanip_tpu.ops import kinematics as kin
    from gym_kmanip_tpu.parallel.mesh import (
        global_elite, make_mesh, make_sharded_ilqr_solver, make_sharded_mppi_solver)
    from gym_kmanip_tpu.solvers.ilqr import ILQRConfig, flatten_state

    mesh = make_mesh(N_DEV)
    assert mesh.devices.size == N_DEV, mesh
    out = {}

    costs, cand = elite_cases()
    elite = jax.jit(jax.shard_map(
        lambda c, x: global_elite(c, x, ELITE_LOCAL_K), mesh=mesh,
        in_specs=(P("rollout"), P("rollout")), out_specs=(P(), P()), check_vma=False))
    bests, gmins = zip(*(elite(jnp.asarray(c), jnp.asarray(cand)) for c in costs))
    out.update(elite_costs=costs, elite_cand=cand,
               elite_best=np.stack([np.asarray(b) for b in bests]),
               elite_gmin=np.asarray([float(g) for g in gmins], np.float32))

    solo = get_model("solo_arm")
    sim0 = init_state(solo)
    xpos, xquat, _ = kin.fk(solo, sim0.qpos)
    p, _ = kin.site_pose(solo, xpos, xquat, "eer_site")
    goal = p + jnp.asarray(GOAL_OFFSET)
    out["goal"] = np.asarray(goal)

    def cost_fn(s, aux, u):
        return ee_tracking_cost(solo, s, aux, u, goal)

    local_k = MPPI["n_samples"] // N_DEV
    for n_iters in (1, 2):
        cfg = MPPIConfig(n_iters=n_iters, **MPPI)
        st = init_mppi(solo, cfg)
        st2, u0, J = make_sharded_mppi_solver(solo, cfg, cost_fn, mesh)(st, sim0)
        # the draws of each iteration, as mesh.py's solve makes them
        sigma = sigma_per_actuator(solo, cfg.sigma)
        rng, eps = st.rng, []
        for _ in range(n_iters):
            rng, sub = jax.random.split(rng)
            keys = jax.random.split(sub, N_DEV)
            eps.append(np.concatenate([np.asarray(sample_noise(
                keys[d], local_k, cfg.horizon, solo.nu, sigma, cfg.noise_beta))
                for d in range(N_DEV)]))
        out.update({f"mppi{n_iters}_eps": np.stack(eps),
                    f"mppi{n_iters}_nominal0": np.asarray(st.nominal),
                    f"mppi{n_iters}_nominal": np.asarray(st2.nominal),
                    f"mppi{n_iters}_u0": np.asarray(u0),
                    f"mppi{n_iters}_J": np.asarray(J)})

    cost_xu, quad_xu = make_ee_tracking_cost_ilqr(solo, goal)
    cfg = ILQRConfig(horizon=ILQR_H, n_iters=1, contact=False, reduced_state=True)
    x0 = np.asarray(flatten_state(sim0, reduced=True))
    rng = np.random.RandomState(0)
    x0s = (x0[None] + 0.01 * rng.randn(ILQR_B, x0.shape[0])).astype(np.float32)
    uss = (np.tile(np.asarray(solo.home_qpos[: solo.nu], np.float32), (ILQR_B, ILQR_H, 1))
           + 0.01 * rng.randn(ILQR_B, ILQR_H, solo.nu).astype(np.float32))
    solver = make_sharded_ilqr_solver(solo, cfg, cost_xu, mesh, sim0, ILQR_B, quad_xu=quad_xu)
    us, costs_out, traces = solver(jnp.asarray(x0s), jnp.asarray(uss))
    out.update(ilqr_x0s=x0s, ilqr_uss=uss, ilqr_us=np.asarray(us),
               ilqr_costs=np.asarray(costs_out), ilqr_traces=np.asarray(traces))

    np.savez_compressed(OUT, **out)
    print("wrote", os.path.abspath(OUT), {k_: v.shape for k_, v in out.items()})


if __name__ == "__main__":
    main()
