"""Sampling MPC (MPPI) on the cube-pick task.

Port of `gym_kmanip_tpu/examples/8_mpc_mppi.py`: receding-horizon MPPI
with K=256 full-fidelity rollouts per solve (the plant's 10 x 2 ms
integration), AR(1)-correlated exploration noise, and a grasp-geometry
cost (fingertip-to-cube distance, touch and lift bonuses), each solve's
first control executed on the plant.

`sharded=True` splits the samples over the ranks of the ("rollout",) mesh
(parallel/mesh.py): one rank with no launcher, N under torchrun, one card
each. Every rank steps the same plant state with the same replicated
control, so the state stays in step; rank 0 prints.

    python -m gym_kmanip_torch.examples.8_mpc_mppi
    torchrun --nproc-per-node N -m gym_kmanip_torch.examples.8_mpc_mppi --sharded
"""

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.engine import make_control_step
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
from gym_kmanip_torch.parallel.mesh import (
    init_distributed, make_mesh, make_sharded_mppi_solver)

HORIZON = 20
N_SAMPLES = 256
N_CONTROL_STEPS = 120
CUBE_SPAWN = np.array([0.15, 0.58, 0.62])


def make_cost(model):
    def cost_fn(s, aux, u):
        # fingertips bracket the cube when grasping: drive their mean
        # squared distance to the cube center, bonus for touch and lift
        d2 = torch.sum((aux.tip_pos - s.cube_pos[..., None, :]) ** 2, dim=-1)
        touched = aux.touch_r | aux.touch_l
        return (
            50.0 * d2.mean(dim=-1)
            + 0.01 * torch.sum(s.qvel ** 2, dim=-1)
            - torch.where(touched, 5.0, 0.0)
            - torch.where(touched & ~aux.touch_table, 10.0, 0.0)
        )

    return cost_fn


def main(horizon: int = HORIZON, n_samples: int = N_SAMPLES,
         n_control_steps: int = N_CONTROL_STEPS, sharded: bool = False, device="cuda"):
    model = get_model("solo_arm")
    cost_fn = make_cost(model)
    # full-fidelity rollouts: contact at 20 ms substeps is numerically
    # explosive (dt*sqrt(k/m) ~ 9), so 10 substeps of 2 ms
    cfg = MPPIConfig(horizon=horizon, n_samples=n_samples, n_iters=2, sigma=0.15,
                     n_substeps=10, dt=k.PHYSICS_TIMESTEP, noise_beta=0.9)
    say = print
    if sharded:
        device = init_distributed(device=device)
        mesh = make_mesh()
        if mesh.rank > 0:
            say = lambda *a, **kw: None  # noqa: E731
        say(f"sharding {n_samples} rollouts over {mesh.size} ranks")
        solver = make_sharded_mppi_solver(model, cfg, cost_fn, mesh)
    else:
        solver = make_mppi_solver(model, cfg, cost_fn)

    plant_step = make_control_step(model)
    mppi_state = init_mppi(model, cfg, device=device)
    sim_state = init_state(model, cube_pos=CUBE_SPAWN, device=device)

    mppi_state, u0, J = solver(mppi_state, sim_state)  # builds the cached tensors

    t0 = time.time()
    touch_steps, lifted, dmin = 0, False, float("inf")
    for i in range(n_control_steps):
        mppi_state, u0, J = solver(mppi_state, sim_state)
        sim_state, aux = plant_step(sim_state, u0)
        touch, table = bool(aux.touch_r), bool(aux.touch_table)
        touch_steps += int(touch)
        lifted = lifted or (touch and not table)
        dmin = float(torch.linalg.vector_norm(aux.tip_pos - sim_state.cube_pos[None, :],
                                              dim=-1).min())
        if i % 15 == 0:
            say(f"step {i}: J={float(J):.2f} tip-cube dist={dmin:.3f} m "
                f"touch={touch} cube_z={float(sim_state.cube_pos[2]):.3f}")
    wall = time.time() - t0
    say(f"{n_control_steps} MPC solves + plant steps in {wall:.2f}s "
        f"({n_control_steps / wall:.1f} Hz closed loop); "
        f"touch steps={touch_steps}, lifted={lifted}")
    return dict(hz=n_control_steps / wall, touch_steps=touch_steps, lifted=lifted,
                tip_cube_m=dmin, finite=bool(torch.isfinite(sim_state.qpos).all()))


if __name__ == "__main__":
    main(sharded="--sharded" in sys.argv)
    if dist.is_initialized():
        dist.destroy_process_group()
