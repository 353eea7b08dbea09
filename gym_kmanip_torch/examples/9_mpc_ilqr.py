"""iLQR trajectory optimization for EE goal reaching.

Port of `gym_kmanip_tpu/examples/9_mpc_ilqr.py`. Solves a horizon-H EE
tracking problem with the full articulated dynamics, then executes the
plan open loop on the full-fidelity plant and reports the tracking error
(the BASELINE "EE tracking error" metric). The cost has no final term, so
the state after the last control is unscored: the error is reported both
at the last scored state and after the last control.

    python -m gym_kmanip_torch.examples.9_mpc_ilqr
"""

import time

import numpy as np
import torch

from gym_kmanip_torch.dynamics.engine import make_control_step
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.solvers.ilqr import ILQRConfig, make_ilqr_solver, unflatten_state

HORIZON = 40


def main(horizon: int = HORIZON, n_iters: int = 8, device="cuda"):
    model = get_model("solo_arm")
    state0 = init_state(model, device=device)

    # goal: 6 cm toward the cube spawn center from the home EE pose
    xpos, xquat, _ = kin.fk(model, state0.qpos)
    ee0, _ = kin.site_pose(model, xpos, xquat, "eer_site")
    goal = ee0 + torch.tensor([0.0, 0.04, -0.04], device=ee0.device)

    nu = model.nu

    def cost_xu(x, u):
        s = unflatten_state(model, x, state0)
        xp, xq, _ = kin.fk(model, s.qpos)
        ee, _ = kin.site_pose(model, xp, xq, "eer_site")
        return (
            100.0 * torch.sum((ee - goal) ** 2, dim=-1)
            + 0.01 * torch.sum(s.qvel ** 2, dim=-1)
            + 1e-3 * torch.sum((u - s.qpos[..., :nu]) ** 2, dim=-1)
        )

    cfg = ILQRConfig(horizon=horizon, n_iters=n_iters)
    solver = make_ilqr_solver(model, cfg, cost_xu)
    u_init = torch.as_tensor(model.home_qpos[:nu], dtype=torch.float32,
                             device=state0.qpos.device).repeat(horizon, 1)

    t0 = time.time()
    result = solver(state0, u_init)
    trace = result.cost_trace.cpu().numpy()
    solve_s = time.time() - t0
    print(f"iLQR solve: {solve_s:.2f}s")
    print("cost trace:", trace.round(3))

    # execute on the full-fidelity plant
    plant_step = make_control_step(model)
    i = model.site_index("eer_site")
    s, errs = state0, []
    for t in range(horizon):
        s, aux = plant_step(s, result.us[t])
        errs.append(torch.linalg.vector_norm(aux.site_pos[i] - goal))
    errs = 1e3 * torch.stack(errs).cpu().numpy()
    print(f"EE tracking error on plant: {errs[-2]:.1f} mm at the last scored state, "
          f"{errs[-1]:.1f} mm after the last control")
    return dict(solve_s=solve_s, cost_trace=trace, ee_err_mm_scored=float(errs[-2]),
                ee_err_mm_final=float(errs[-1]), ee_err_mm=errs,
                finite=bool(np.all(np.isfinite(errs))))


if __name__ == "__main__":
    main()
