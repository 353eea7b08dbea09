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
    # the env without gymnasium: one solo step of the task core (host IK)
    # and the backend driven by a duck-typed shell; register() needs gymnasium
    import types
    import numpy as np
    from gym_kmanip_torch import env as kenv
    from gym_kmanip_torch.env.config import CONFIGS
    from gym_kmanip_torch.env.env_sim import KManipEnvSim
    from gym_kmanip_torch.env.task import make_task
    from gym_kmanip_torch.solvers.parallel_lqr import backward_associative
    cfg = CONFIGS["KManipSoloArm"]
    reset_fn, step_fn, m = make_task(cfg, device="cpu")
    out = step_fn(reset_fn(np.array([0.2, 0.6, 0.62], np.float32)).state,
                  {"eer_pos": torch.tensor([1.0, 0.0, -1.0]), "eer_orn": torch.zeros(3),
                   "grip_r": torch.zeros(1)})
    assert out.state.qpos.shape == (m.nq,) and bool(torch.isfinite(out.reward))
    shell = types.SimpleNamespace(cfg=cfg, obs_list=list(cfg.obs_list), cameras=[],
                                  np_random=np.random.default_rng(0))
    sim = KManipEnvSim(shell, device="cpu")
    sim.k_reset()
    _, r, _, obs, t = sim.k_step({"eer_pos": np.zeros(3), "eer_orn": np.zeros(3),
                                  "grip_r": np.zeros(1)})
    assert sorted(obs) == sorted(cfg.obs_list) and abs(t - 0.02) < 1e-6
    # the vision slice: a frame, the vision cost, the zoo, a camera shell
    from gym_kmanip_torch import zoo
    from gym_kmanip_torch.constants import CAMERAS
    from gym_kmanip_torch.mpc.vision_cost import init_cost_params, make_vision_cost
    from gym_kmanip_torch.render.raycast import render_camera
    img = render_camera(m, "top", b.qpos, b.cube_pos, b.cube_quat, 8, 10)
    assert img.shape == (3, 8, 10, 3) and img.dtype == torch.uint8
    c = make_vision_cost(m, init_cost_params(0, 8, 10, device="cpu"), "top", 8, 10)(b, None, None)
    assert c.shape == (3,) and bool(torch.isfinite(c).all())
    policy, meta = zoo.load_policy("bc_pixels_solo", device="cpu")
    assert policy(s).shape == (m.nu,) and meta["arch"] == "bc_pixels_cnn"
    vcfg = CONFIGS["KManipSoloArmVision"]
    vshell = types.SimpleNamespace(cfg=vcfg, obs_list=list(vcfg.obs_list),
                                   cameras=[CAMERAS["grip_r"]], np_random=np.random.default_rng(0))
    _, _, _, obs, _ = KManipEnvSim(vshell, device="cpu").k_reset()
    assert obs["camera/grip_r"].shape == (40, 60, 3)
    # the learning slice: a step of each fit, an episode of the HDF5 logger
    import os, tempfile
    from gym_kmanip_torch.log import log_h5py
    from gym_kmanip_torch.mpc.vision_cost import fit_cube_pos_estimator, fit_distance_cost
    net = fit_distance_cost(m, 0, n_samples=2, n_steps=1, height=8, width=10, cam_name="top",
                            device="cpu")
    _, estimate = fit_cube_pos_estimator(m, 0, n_samples=2, n_steps=1, height=8, width=10,
                                         batch=2, device="cpu")
    assert estimate(img[:2].float() / 255.0).shape == (2, 3)
    d = tempfile.mkdtemp()
    info = dict(sim=True, episode=0, q_len=m.nq, act_list=("ctrl",), act_dims={"ctrl": m.nu},
                step=1)
    f = log_h5py.new(d, info)
    log_h5py.step(f, {"ctrl": s.ctrl}, {"q_pos": s.qpos, "q_vel": s.qvel}, info)
    log_h5py.end(f)
    assert os.path.exists(os.path.join(d, "episode_0.hdf5"))
    # the multi-device slice and the side-cars: a sharded MPPI solve on a
    # mesh of one rank, a checkpoint round trip with the generator, an
    # episode of the rerun logger's fallback
    from gym_kmanip_torch.log import log_rerun
    from gym_kmanip_torch.parallel import mesh as pm
    from gym_kmanip_torch.utils import checkpoint
    mcfg = MPPIConfig(horizon=2, n_samples=4)
    ms, u0, J = pm.make_sharded_mppi_solver(
        m, mcfg, lambda st, aux, u: cube_pick_cost(m, st, aux, u, params), pm.make_mesh())(
        init_mppi(m, mcfg, seed=0, device="cpu"), s)
    assert u0.shape == (m.nu,) and bool(torch.isfinite(J))
    path = os.path.join(d, "mppi.npz")
    checkpoint.save(path, ms)
    ms2 = checkpoint.restore(path, init_mppi(m, mcfg, seed=1, device="cpu"))
    assert torch.equal(ms2.nominal, ms.nominal)
    assert torch.equal(ms2.generator.get_state(), ms.generator.get_state())
    log_rerun.new(d, dict(obs_list=["q_pos"], act_list=["ctrl"], cameras=[], episode=3))
    log_rerun.step({"ctrl": s.ctrl}, {"q_pos": s.qpos},
                   dict(sim_time=0.0, cpu_time=0.0, episode=3, step=1, q_keys=[], cameras=[]))
    log_rerun.end()
    assert len(open(os.path.join(d, "episode_3.rrd.jsonl")).readlines()) == 2
    # the robots' tables and asset generator, the dynamics identities, the
    # rotation helpers, rollout_with_traj, and the zoo tools' shipping
    from gym_kmanip_torch.constants import ASSETS_DIR
    from gym_kmanip_torch.models import _table_models
    from gym_kmanip_torch.mpc.rollout import rollout_with_traj
    from gym_kmanip_torch.ops import kinematics as kin
    from gym_kmanip_torch.tools import gen_assets, train_zoo
    from gym_kmanip_torch.utils import rotations as rot
    xml = gen_assets.build_asset_xml(_table_models()["solo_arm"]())
    assert xml == open(os.path.join(ASSETS_DIR, "solo_arm.xml")).read()
    bias = kin.bias_forces(m, b.qpos, b.qvel + 0.1)
    assert torch.allclose(kin.bias_forces_ad(m, b.qpos, b.qvel + 0.1), bias, atol=1e-4, rtol=1e-4)
    q4 = rot.mat_to_quat(rot.quat_to_mat(s.cube_quat))
    assert torch.allclose(q4, s.cube_quat) and torch.equal(rot.quat_inv(q4), rot.quat_conj(q4))
    total, _, costs = rollout_with_traj(m, s, s.ctrl.repeat(2, 2, 1),
                                        lambda st, aux, u: cube_pick_cost(m, st, aux, u, params))
    assert costs.shape == (2, 2) and torch.equal(total, costs.sum(-1))
    net = zoo.bc_mlp(m.nu, 8, 1, in_dim=2 * m.nq + 7, device="cpu")
    stats = dict(mu=np.zeros(2 * m.nq + 7, np.float32), sd=np.ones(2 * m.nq + 7, np.float32),
                 mid=np.zeros(m.nu), half=np.ones(m.nu))
    art = os.path.join(d, "bc_pick_solo.npz")
    assert train_zoo.ship(art, net, stats, dict(arch="bc_mlp", model="solo_arm",
                                                eval_success_rate=0.5))
    assert zoo.load_policy(art, device="cpu")[0](s).shape == (m.nu,)
    try:
        kenv.register()
        raise AssertionError("register() ran without gymnasium")
    except ImportError as e:
        assert "gymnasium" in str(e), e
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
    assert ok == "OK" and int(n_modules) >= 83
