"""Vision MPC: rendered frames feeding a learned-cost MPPI solve.

Port of `gym_kmanip_tpu/examples/10_vision_mpc.py`. The cost CNN is first
fit to regress the true EE-cube distance from rendered top-camera frames
(self-supervised, `fit_distance_cost`), then scores MPPI rollouts: every
rollout step renders the top camera at the K rollout states and runs the
network on the batch. The closed loop steps the plant (full-fidelity
contact step) with the solver's controls and reports the TRUE
fingertip-cube distance: the learned cost must move the physical arm.

    python -m gym_kmanip_torch.examples.10_vision_mpc
"""

import time

import numpy as np
import torch

from gym_kmanip_torch.dynamics.engine import make_control_step
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import canonical_device, get_model
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
from gym_kmanip_torch.mpc.vision_cost import fit_distance_cost, make_vision_cost

HORIZON = 10
N_SAMPLES = 64
N_SOLVES = 5
N_CLOSED_LOOP = 40
# the top camera: the grip camera's narrow view loses the cube once the
# arm is displaced; the overhead view keeps both in frame
CAM, H_PX, W_PX = "top", 48, 64


def true_tip_cube_dist(aux, state) -> float:
    return float(torch.linalg.vector_norm(aux.tip_pos - state.cube_pos[None, :], dim=-1).min())


def main(horizon=HORIZON, n_samples=N_SAMPLES, n_solves=N_SOLVES,
         n_closed_loop=N_CLOSED_LOOP, fit_samples=256, fit_steps=1200, device="cuda"):
    device = canonical_device(device)
    model = get_model("solo_arm")
    print("fitting the distance cost CNN on rendered frames...")
    net = fit_distance_cost(model, seed=0, n_samples=fit_samples, n_steps=fit_steps,
                            cam_name=CAM, height=H_PX, width=W_PX, device=device)
    cost_fn = make_vision_cost(model, net, cam_name=CAM, height=H_PX, width=W_PX)

    cfg = MPPIConfig(horizon=horizon, n_samples=n_samples, n_iters=1, noise_beta=0.9)
    solver = make_mppi_solver(model, cfg, cost_fn)
    mppi_state = init_mppi(model, cfg, device=device)
    sim_state = init_state(model, cube_pos=np.array([0.15, 0.58, 0.62]), device=device)

    mppi_state, u0, J = solver(mppi_state, sim_state)  # builds the cached tensors
    t0 = time.time()
    for i in range(n_solves):
        mppi_state, u0, J = solver(mppi_state, sim_state)
        print(f"solve {i}: learned cost {float(J):.4f}")
    per = (time.time() - t0) / max(n_solves, 1)
    renders = n_samples * horizon
    print(f"{per * 1000:.0f} ms/solve with {renders} renders + CNN evaluations per solve "
          f"({renders / per:.0f} renders/s)")

    # ---- closed loop against the plant ----
    plant_step = make_control_step(model)
    _, aux0 = plant_step(sim_state, u0)
    d0 = true_tip_cube_dist(aux0, sim_state)
    dist, dists = d0, []
    for i in range(n_closed_loop):
        mppi_state, u0, J = solver(mppi_state, sim_state)
        sim_state, aux = plant_step(sim_state, u0)
        dist = true_tip_cube_dist(aux, sim_state)
        dists.append(dist)
        if i % 10 == 0:
            print(f"closed-loop step {i}: TRUE tip-cube dist {dist:.3f} m")
    print(f"closed loop: true tip-cube distance {d0:.3f} -> {dist:.3f} m "
          f"({'REDUCED' if dist < d0 else 'NOT reduced'})")
    return dict(d0=d0, dists=np.asarray(dists), ms_per_solve=1e3 * per, J=float(J))


if __name__ == "__main__":
    main()
