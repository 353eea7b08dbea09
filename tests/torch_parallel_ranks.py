"""One rank of the CPU gloo group that tests/test_torch_parallel.py spawns.

    python tests/torch_parallel_ranks.py RANK WORLD PORT OUT_DIR

Joins the group through 127.0.0.1:PORT, runs every distributed check of the
test file on the port's mesh and writes its results to OUT_DIR/rank{RANK}.npz:
a psum and the elite tie-break as tests/test_multihost.py's child makes
them, `global_elite` on the golden's tied costs, the sharded MPPI at 1 and 2
iterations on the golden's injected draws and on its own generator's draws,
and the sharded iLQR on the golden's problems (on the JAX package's CPU
route and on the card's route).
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "parallel_sharded.npz")
ELITE_LOCAL_K = 3
MPPI = dict(horizon=4, n_samples=4, sigma=0.08, contact=False)
OWN_NOISE_SEED = 3


def mppi_setup(g):
    """(model, sim0, cost_fn) of the golden's MPPI: the EE-tracking cost of
    the golden's goal."""
    from gym_kmanip_torch.dynamics.state import init_state
    from gym_kmanip_torch.models import get_model
    from gym_kmanip_torch.mpc.cost import ee_tracking_cost

    model = get_model("solo_arm")
    goal = torch.as_tensor(g["goal"])
    return (model, init_state(model, device="cpu"),
            lambda s, aux, u: ee_tracking_cost(model, s, aux, u, goal))


def ilqr_setup(g, model, pallas_backward):
    """(cfg, cost_xu, quad_xu) of the golden's iLQR problems. The JAX
    package runs its serial linalg.solve backward on the CPU
    (pallas_backward=False here); True is the card's route, the Riccati
    sweep with its Gershgorin lift."""
    from gym_kmanip_torch.mpc.cost import make_ee_tracking_cost_ilqr
    from gym_kmanip_torch.solvers.ilqr import ILQRConfig

    cost_xu, quad_xu = make_ee_tracking_cost_ilqr(model, g["goal"])
    cfg = ILQRConfig(horizon=g["ilqr_uss"].shape[1], n_iters=g["ilqr_traces"].shape[1],
                     contact=False, reduced_state=True, pallas_backward=pallas_backward)
    return cfg, cost_xu, quad_xu


def run(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi
    from gym_kmanip_torch.parallel import mesh as pm

    pm.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=60.0)
    mesh = pm.make_mesh()
    assert mesh.size == world and mesh.rank == rank, mesh
    g = dict(np.load(GOLDEN))
    out = dict(size=mesh.size, axis_names=np.array(mesh.axis_names))

    # tests/test_multihost.py's pattern: the winner on rank 1, a tie on
    # rank 1's first slot
    k = world * ELITE_LOCAL_K
    costs = np.ones(k, np.float32)
    costs[ELITE_LOCAL_K + 1] = costs[(world - 1) * ELITE_LOCAL_K] = 0.5
    cand = np.arange(k * 4, dtype=np.float32).reshape(k, 4)
    mine = slice(rank * ELITE_LOCAL_K, (rank + 1) * ELITE_LOCAL_K)
    out["psum"] = pm.psum(torch.as_tensor(costs[mine]).sum(), mesh).numpy()
    best, gmin = pm.global_elite(torch.as_tensor(costs[mine]), torch.as_tensor(cand[mine]),
                                 ELITE_LOCAL_K, mesh)
    out.update(multihost_best=best.numpy(), multihost_gmin=gmin.numpy())
    for i, c in enumerate(g["elite_costs"]):
        best, gmin = pm.global_elite(torch.as_tensor(c[mine]),
                                     torch.as_tensor(g["elite_cand"][mine]), ELITE_LOCAL_K, mesh)
        out.update({f"elite{i}_best": best.numpy(), f"elite{i}_gmin": gmin.numpy()})

    model, sim0, cost_fn = mppi_setup(g)
    for n_iters in (1, 2):
        cfg = MPPIConfig(n_iters=n_iters, **MPPI)
        seen = []

        def recording(s, aux, u):
            seen.append(u[1])
            return cost_fn(s, aux, u)

        solve = pm.make_sharded_mppi_solver(model, cfg, recording, mesh)
        st = init_mppi(model, cfg, device="cpu")
        st = st._replace(nominal=torch.as_tensor(g[f"mppi{n_iters}_nominal0"]))
        st2, u0, J = solve(st, sim0, eps=torch.as_tensor(g[f"mppi{n_iters}_eps"]))
        out.update({f"mppi{n_iters}_u0": u0.numpy(), f"mppi{n_iters}_J": J.numpy(),
                    f"mppi{n_iters}_nominal": st2.nominal.numpy()})
        # the last iteration's proposal: rank 0's slot 1, as the cost sees it
        proposal = torch.stack(seen[-cfg.horizon:])
        out[f"mppi{n_iters}_proposal"] = pm.psum(
            proposal if rank == 0 else torch.zeros_like(proposal), mesh).numpy()
        # the replicated generator's own draws, sliced on each rank
        st2, u0, J = solve(init_mppi(model, cfg, seed=OWN_NOISE_SEED, device="cpu"), sim0)
        out.update({f"own{n_iters}_u0": u0.numpy(), f"own{n_iters}_J": J.numpy(),
                    f"own{n_iters}_nominal": st2.nominal.numpy(),
                    f"own{n_iters}_generator": st2.generator.get_state().numpy()})

    batch = g["ilqr_x0s"].shape[0]
    for name, pallas_backward in (("ilqr", False), ("ilqr_card", True)):
        cfg, cost_xu, quad_xu = ilqr_setup(g, model, pallas_backward)
        solve = pm.make_sharded_ilqr_solver(model, cfg, cost_xu, mesh, sim0, batch,
                                            quad_xu=quad_xu)
        us, costs_out, traces = solve(torch.as_tensor(g["ilqr_x0s"]),
                                      torch.as_tensor(g["ilqr_uss"]))
        out.update({f"{name}_us": us.numpy(), f"{name}_costs": costs_out.numpy(),
                    f"{name}_traces": traces.numpy()})

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    run(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
