"""The plain reference against the port's plain CPU route: the same robot
constants, the same rollout totals and the same solve."""

import numpy as np
import pytest
import torch

from reference import dynamics as rd
from reference import model as rmodel
from reference import mppi as rmppi


@pytest.mark.parametrize("name,left", [("solo_arm", False), ("torso", True)])
def test_robot_constants_match_the_port(name, left):
    from gym_kmanip_torch.models import get_model

    m, r = get_model(name), rmodel.load(name)
    assert (m.nq, m.nu) == (r.nq, r.nu)
    for f in ("jnt_pos", "jnt_quat", "jnt_range", "armature", "body_mass", "body_com",
              "body_inertia", "home_qpos", "ancestors", "ctrl_range", "force_range"):
        assert np.array_equal(np.asarray(getattr(m, f), np.float64),
                              np.asarray(getattr(r, f), np.float64)), f
    assert np.array_equal(m.jnt_frictionloss, r.frictionloss)
    assert np.array_equal(m.actuator_kp, r.kp)
    assert [s.name for s in m.sites] == list(r.site_names)
    assert [t.side for t in m.fingertips] == list(r.tip_side)


@pytest.mark.parametrize("name,left", [("solo_arm", False), ("torso", True)])
def test_rollout_and_pick_cost_match_the_port_plain_route(name, left):
    from gym_kmanip_torch.dynamics.state import init_state
    from gym_kmanip_torch.models import get_model
    from gym_kmanip_torch.ops.rollout_pick_cuda import PickCostSpec, rollout_pick_costs

    m, r = get_model(name), rmodel.load(name)
    gen = torch.Generator().manual_seed(4)
    K, H = 5, 6
    s0 = init_state(m, cube_pos=np.array([0.24, 0.52, 0.64]), device="cpu")
    lo = torch.as_tensor(m.ctrl_range[:, 0], dtype=torch.float32)
    hi = torch.as_tensor(m.ctrl_range[:, 1], dtype=torch.float32)
    home = torch.as_tensor(m.home_qpos[:m.nu], dtype=torch.float32)
    U = torch.clamp(home + 0.2 * torch.randn((K, H, m.nu), generator=gen), lo, hi)
    want = rollout_pick_costs(m, U, s0, PickCostSpec(use_left=left))
    start = rd.State(s0.qpos, s0.qvel, s0.cube_pos, s0.cube_quat, s0.cube_linvel, s0.cube_angvel)
    batch = rd.State(*(x.expand((K,) + tuple(x.shape)) for x in start))
    got = rd.Plain(r, "cpu").rollout_costs(batch, U, rd.PickWeights(use_left=left), 1, 0.02)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    tf32 = rd.Plain(r, "cpu", "tf32").rollout_costs(batch, U, rd.PickWeights(use_left=left), 1,
                                                     0.02)
    assert float(torch.max(torch.abs(tf32 - want))) > 1e-5  # the control computes otherwise


def test_solve_matches_the_port_solver_on_the_cpu():
    from gym_kmanip_torch.dynamics.state import init_state
    from gym_kmanip_torch.models import get_model
    from gym_kmanip_torch.mpc import mppi

    m, r = get_model("solo_arm"), rmodel.load("solo_arm")
    cfg = rmppi.SolveConfig(horizon=5, n_samples=6, temperature=0.1, sigma=0.05, n_iters=2,
                            n_substeps=1, dt=0.02, contact=True, noise_beta=0.85)
    pcfg = mppi.MPPIConfig(horizon=5, n_samples=6, n_iters=2)
    state = mppi.init_mppi(m, pcfg, seed=0, device="cpu")
    state.generator.manual_seed(77)
    s0 = init_state(m, device="cpu")
    new, u0, J = mppi.make_fused_pick_solver(m, pcfg)(state, s0)
    sigma = torch.as_tensor(rmppi.sigma_per_actuator(r.ctrl_range, cfg.sigma))
    noise = [n[None] for n in rmppi.draw_noise(77, cfg, r.nu, sigma, "cpu")]
    home = torch.as_tensor(r.home_qpos[:r.nu], dtype=torch.float32).repeat(cfg.horizon, 1)
    start = rd.State(*(x[None] for x in (s0.qpos, s0.qvel, s0.cube_pos, s0.cube_quat,
                                           s0.cube_linvel, s0.cube_angvel)))
    iters, nominal = rmppi.solve(rd.Plain(r, "cpu"), cfg, rd.PickWeights(), home[None], start,
                                 noise)
    torch.testing.assert_close(u0, nominal[0, 0], rtol=0, atol=0)
    torch.testing.assert_close(new.nominal, rmppi.shift(nominal[0]), rtol=0, atol=0)
    torch.testing.assert_close(J, iters[-1].costs[0].min(), rtol=1e-6, atol=1e-6)
