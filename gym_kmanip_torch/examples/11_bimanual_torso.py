"""BASELINE configs 3+4: DualArm bimanual reach MPC and Torso full-body iLQR.

Port of `gym_kmanip_tpu/examples/11_bimanual_torso.py`.

- DualArm: coordinated two-goal EE reach via MPPI with the box joint-limit
  constraints enforced by ctrlrange projection inside the solver.
- Torso (2dof head + two 6dof arms + grippers, 20 dof, 53-dim state):
  full-body iLQR at H=100 with a contact-aware smooth cost.

    python -m gym_kmanip_torch.examples.11_bimanual_torso
"""

import time

import numpy as np
import torch

from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.solvers.ilqr import ILQRConfig, make_ilqr_solver, unflatten_state


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dual_arm_bimanual(horizon: int = 20, n_samples: int = 128, n_solves: int = 10,
                      device="cuda"):
    model = get_model("dual_arm")
    s0 = init_state(model, device=device)
    xp, xq, _ = kin.fk(model, s0.qpos)
    eer, _ = kin.site_pose(model, xp, xq, "eer_site")
    eel, _ = kin.site_pose(model, xp, xq, "eel_site")
    offset = torch.tensor([0.0, 0.03, -0.03], device=eer.device)
    goal_r = eer + offset
    goal_l = eel + offset
    ir = model.site_index("eer_site")
    il = model.site_index("eel_site")

    def cost_fn(s, aux, u):
        return (
            100.0 * torch.sum((aux.site_pos[..., ir, :] - goal_r) ** 2, dim=-1)
            + 100.0 * torch.sum((aux.site_pos[..., il, :] - goal_l) ** 2, dim=-1)
            + 0.01 * torch.sum(s.qvel ** 2, dim=-1)
        )

    cfg = MPPIConfig(horizon=horizon, n_samples=n_samples, n_iters=1, contact=False)
    solver = make_mppi_solver(model, cfg, cost_fn)
    st = init_mppi(model, cfg, device=device)
    st, u0, J = solver(st, s0)
    _sync(device)
    t0 = time.time()
    for _ in range(n_solves):
        st, u0, J = solver(st, s0)
    _sync(device)
    ms = (time.time() - t0) / n_solves * 1000
    print(f"dual-arm bimanual MPPI: {ms:.0f} ms/solve, J={float(J):.3f}")
    lo, hi = model.ctrl_range[:, 0], model.ctrl_range[:, 1]
    u = u0.cpu().numpy()
    assert np.all(u >= lo - 1e-6) and np.all(u <= hi + 1e-6)
    print("joint-limit box constraints satisfied on u0")
    return dict(ms_per_solve=ms, J=float(J))


def torso_ilqr(horizon: int = 100, n_iters: int = 5, device="cuda"):
    model = get_model("torso")
    s0 = init_state(model, device=device)
    xp, xq, _ = kin.fk(model, s0.qpos)
    eer, _ = kin.site_pose(model, xp, xq, "eer_site")
    goal = eer + torch.tensor([0.0, 0.04, -0.03], device=eer.device)
    nu = model.nu

    def cost_xu(x, u):
        s = unflatten_state(model, x, s0)
        xp2, xq2, _ = kin.fk(model, s.qpos)
        ee, _ = kin.site_pose(model, xp2, xq2, "eer_site")
        # contact-aware smooth term: keep the cube undisturbed
        cube_pen = torch.sum((s.cube_pos - s0.cube_pos) ** 2, dim=-1)
        return (
            100.0 * torch.sum((ee - goal) ** 2, dim=-1)
            + 10.0 * cube_pen
            + 0.01 * torch.sum(s.qvel ** 2, dim=-1)
            + 1e-3 * torch.sum((u - s.qpos[..., :nu]) ** 2, dim=-1)
        )

    cfg = ILQRConfig(horizon=horizon, n_iters=n_iters)
    solver = make_ilqr_solver(model, cfg, cost_xu)
    u_init = torch.as_tensor(model.home_qpos[:nu], dtype=torch.float32,
                             device=s0.qpos.device).repeat(horizon, 1)
    t0 = time.time()
    res = solver(s0, u_init)
    trace = res.cost_trace.cpu().numpy()
    seconds = time.time() - t0
    print(f"torso iLQR H={horizon} (20 dof, 53-dim state): solve {seconds:.1f}s, "
          f"cost {trace.round(2)}")
    return dict(solve_s=seconds, cost_trace=trace)


def main(device="cuda", **sizes):
    """Both parts; `sizes` may set dual_horizon, n_samples, n_solves,
    torso_horizon and n_iters."""
    dual = dual_arm_bimanual(horizon=sizes.get("dual_horizon", 20),
                             n_samples=sizes.get("n_samples", 128),
                             n_solves=sizes.get("n_solves", 10), device=device)
    torso = torso_ilqr(horizon=sizes.get("torso_horizon", 100),
                       n_iters=sizes.get("n_iters", 5), device=device)
    return dict(dual=dual, torso=torso)


if __name__ == "__main__":
    main()
