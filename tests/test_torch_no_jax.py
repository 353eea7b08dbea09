"""The port runs with JAX, gymnasium, the JAX package and the repository's
`tools/` unimportable, as on a GPU host that has none of them."""

import os
import subprocess
import sys
import textwrap

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "gymnasium", "gym_kmanip_tpu", "tools")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Block())

    import torch
    torch.set_num_threads(1)
    import gym_kmanip_torch

    names = [m.name for m in pkgutil.walk_packages(
        gym_kmanip_torch.__path__, "gym_kmanip_torch.")]
    for name in names:
        importlib.import_module(name)

    from gym_kmanip_torch.dynamics import init_state, substep
    from gym_kmanip_torch.models import get_model
    from gym_kmanip_torch.mpc.cost import CostParams, cube_pick_cost
    from gym_kmanip_torch.mpc.cost import make_ee_tracking_cost_ilqr
    from gym_kmanip_torch.mpc.mppi import (
        MPPIConfig, init_mppi, make_fused_pick_solver, make_mppi_solver)
    from gym_kmanip_torch.solvers.ilqr import ILQRConfig, make_ilqr_solver

    m = get_model("solo_arm")
    s = init_state(m, device="cpu")
    s2, (touch, xpos, xquat) = substep(m, s, 0.002)
    assert s2.qpos.shape == (m.nq,) and bool(torch.isfinite(s2.qvel).all())

    cfg = MPPIConfig(horizon=2, n_samples=4)
    params = CostParams()
    solve = make_mppi_solver(m, cfg, lambda st, aux, u: cube_pick_cost(m, st, aux, u, params))
    ms, u0, J = solve(init_mppi(m, cfg, seed=0, device="cpu"), s)
    assert u0.shape == (m.nu,) and bool(torch.isfinite(J))
    ms, u0, J = make_fused_pick_solver(m, cfg)(init_mppi(m, cfg, seed=0, device="cpu"), s)
    assert u0.shape == (m.nu,) and bool(torch.isfinite(J))

    cost_xu, quad_xu = make_ee_tracking_cost_ilqr(m, [0.25, 0.55, 0.6])
    icfg = ILQRConfig(horizon=2, n_iters=1, contact=False, reduced_state=True)
    r = make_ilqr_solver(m, icfg, cost_xu, quad_xu=quad_xu)(s, s.ctrl.repeat(2, 1))
    assert r.us.shape == (2, m.nu) and bool(torch.isfinite(r.cost_trace).all())

    # the staged route and its three kernels' plain versions
    from gym_kmanip_torch.dynamics import engine
    from gym_kmanip_torch.ops import linalg, sweep_floor_cuda
    from gym_kmanip_torch.tools import exp_sweep_floor
    b = s._replace(qpos=s.qpos.repeat(3, 1), qvel=s.qvel.repeat(3, 1),
                   cube_pos=s.cube_pos.repeat(3, 1), cube_quat=s.cube_quat.repeat(3, 1),
                   cube_linvel=s.cube_linvel.repeat(3, 1), cube_angvel=s.cube_angvel.repeat(3, 1))
    s3, _ = engine.substep_staged(m, b, 0.02, True, True)
    assert s3.qpos.shape == (3, m.nq) and bool(torch.isfinite(s3.qvel).all())
    ms, u0, J = make_mppi_solver(m, cfg, lambda st, aux, u: cube_pick_cost(m, st, aux, u, params),
                                 substep_fn=engine.substep_staged)(
        init_mppi(m, cfg, seed=0, device="cpu"), s)
    assert u0.shape == (m.nu,) and bool(torch.isfinite(J))
    x = linalg.batch_aware_cholesky_solve(torch.eye(4) * 2.0, torch.ones(4))
    assert torch.equal(x, torch.full((4,), 0.5))
    inputs = [torch.as_tensor(a) for a in sweep_floor_cuda.random_inputs(2, 4, 2)]
    for v in sweep_floor_cuda.VARIANTS:
        ks, Ks = sweep_floor_cuda.sweep(v, *inputs)
        assert Ks.shape == (2, 2, 4) and bool(torch.isfinite(ks).all())
    try:
        exp_sweep_floor.main(["gersh"])
        raise AssertionError("the floor tool ran without a CUDA device")
    except SystemExit as e:
        assert e.code != 0
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK", len(names))
    """
)


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT], capture_output=True, text=True,
        timeout=240, cwd=_REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    ok, n_modules = proc.stdout.split()[-2:]
    assert ok == "OK" and int(n_modules) >= 20
