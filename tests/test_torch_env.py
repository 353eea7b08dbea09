"""The port's single env against the MuJoCo goldens and the JAX package's
numpy pieces, on the CPU, with no JAX compile.

- The four env traces of tools/make_golden_env.py replayed through the
  port's `make_task`, at the bands of tests/test_env_parity.py: the
  IK-controlled arm joints 0.002, all joints 0.06, the settled cube 0.002,
  the cube 0.02, the reward 0.02 (:47-50, :120-127); teacher-forced from the
  reference's own pre-step states: decode 1e-4, dynamics 4.5e-4 (:139-145).
- The plant `control_step` against the MuJoCo dynamics goldens at the
  bands of tests/test_dynamics_parity.py (:30, :82).
- The float64 host IK: the port's `_solve_np` against the JAX package's (a
  numpy call) on the goldens' pre-states and decoded goals, 1e-12; the
  native solver against the numpy twin, 1e-9 (tests/test_native_ik.py).
- `constants` and `CONFIGS` value for value against the JAX package's.
- The Gym shell: gymnasium's `check_env` on the five namespaced ids, reset
  determinism, truncation at 64 steps, the info keys (tests/test_env.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gym_kmanip_tpu import constants as jk
from gym_kmanip_tpu.env import config as jconfig
from gym_kmanip_tpu.solvers import ik_host as jik_host

from gym_kmanip_torch import constants as tk
from gym_kmanip_torch import native
from gym_kmanip_torch.dynamics import engine
from gym_kmanip_torch.dynamics.state import SimState, init_state
from gym_kmanip_torch.env import config
from gym_kmanip_torch.env.task import _decode_action, _ee_goal, make_task
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.solvers import ik_host

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = [
    ("solo_arm_env_trace.npz", "KManipSoloArm", ("eer",)),
    ("dual_arm_env_trace.npz", "KManipDualArm", ("eer", "eel")),
    ("torso_env_trace.npz", "KManipTorso", ("eer", "eel")),
    ("torso_inrange_env_trace.npz", "KManipTorso", ("eer", "eel")),
]


def _trace(trace, env_id):
    """(data, cfg honouring the trace's recorded home, task, start state)."""
    data = np.load(os.path.join(GOLDEN, trace))
    cfg = config.CONFIGS[env_id]
    if "q_pos_home" in data.files:
        cfg = dataclasses.replace(cfg, q_pos_home=np.asarray(data["q_pos_home"], np.float64))
    task = make_task(cfg, device="cpu")
    out = task[0](np.asarray(data["cube_spawn"], np.float32))
    qh = torch.as_tensor(np.asarray(cfg.q_pos_home, np.float32))
    state = out.state._replace(qpos=qh, ctrl=qh[: task[2].nu])
    return data, cfg, task, state


def _action(data, t, arms):
    a = data["actions"][t]
    action = {}
    for i, side in enumerate(arms):
        action[f"{side}_pos"] = torch.as_tensor(a[3 * i: 3 * i + 3], dtype=torch.float32)
        action[f"{side}_orn"] = torch.zeros(3)
        action[f"grip_{side[-1]}"] = torch.zeros(1)
    return action


def _arm_idx(env_id):
    cfg = config.CONFIGS[env_id]
    return list(cfg.q_id_r_mask) + (list(cfg.q_id_l_mask) if cfg.q_id_l_mask is not None
                                    else [])


def _pre_state(data, t, model, cfg):
    """The reference's own state before step t."""
    nq = model.nq
    qpos, qvel = data["raw_qpos_pre"][t], data["raw_qvel_pre"][t]
    prev = data["raw_ctrl"][t - 1] if t > 0 else cfg.q_pos_home[: model.nu]

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    return SimState(qpos=f(qpos[:nq]), qvel=f(qvel[:nq]), ctrl=f(prev),
                    cube_pos=f(qpos[nq: nq + 3]), cube_quat=f(qpos[nq + 3: nq + 7]),
                    cube_linvel=f(qvel[nq: nq + 3]), cube_angvel=f(qvel[nq + 3: nq + 6]),
                    time=torch.zeros(()))


@pytest.mark.parametrize("trace,env_id,arms", CASES)
def test_env_trace_matches_reference(trace, env_id, arms):
    data, _, (_, step_fn, _), state = _trace(trace, env_id)
    q_dev, cube_dev, reward_dev = [], [], []
    for t in range(data["actions"].shape[0]):
        out = step_fn(state, _action(data, t, arms))
        state = out.state
        q_dev.append(np.abs(out.obs["q_pos"].numpy() - data["q_pos"][t]))
        cube_dev.append(np.abs(out.obs["cube_pos"].numpy() - data["cube_pos"][t]))
        reward_dev.append(abs(float(out.reward) - float(data["reward"][t])))
    q_dev, cube_dev = np.stack(q_dev), np.stack(cube_dev)
    print(f"{env_id}[{trace}]: arm q_pos dev {q_dev[:, _arm_idx(env_id)].max():.2e} "
          f"(all {q_dev.max():.4f}), settled cube {cube_dev[-1].max():.2e}, cube "
          f"{cube_dev.max():.4f}, reward {max(reward_dev):.2e}")
    assert q_dev[:, _arm_idx(env_id)].max() < 0.002
    assert q_dev.max() < 0.06
    assert cube_dev[-1].max() < 0.002, "settled cube position diverged"
    assert cube_dev.max() < 0.02
    assert max(reward_dev) < 0.02


@pytest.mark.parametrize("trace,env_id,arms", CASES)
def test_per_step_teacher_forced_parity(trace, env_id, arms):
    """From the reference's own pre-step state each step: the decode
    (goals, host IK, ctrl) against its recorded ctrl, and `control_step`
    driven by its ctrl (with the scribbled qpos and qpos_force) against its
    recorded post-step qpos, on the IK-controlled arm joints."""
    data, cfg, (_, step_fn, model), _ = _trace(trace, env_id)
    parts = step_fn.parts
    arm = _arm_idx(env_id)
    dev_ctrl, dev_dyn = [], []
    for t in range(data["actions"].shape[0]):
        state = _pre_state(data, t, model, cfg)
        action = _action(data, t, arms)
        qpos_np, goals_np, goals_dev = parts.goals(state, action)
        sols = parts.ik(qpos_np, goals_np)
        ctrl, qpos_ik, _, _ = _decode_action(model, cfg, state, action, sols, goals_dev)
        dev_ctrl.append(np.abs(ctrl.double().numpy() - data["raw_ctrl"][t])[arm].max())
        post, _ = engine.control_step(
            model, state._replace(qpos=qpos_ik),
            torch.as_tensor(data["raw_ctrl"][t], dtype=torch.float32), qpos_force=state.qpos)
        dev_dyn.append(np.abs(post.qpos.double().numpy()
                              - data["raw_qpos_post"][t][: model.nq])[arm].max())
    print(f"{env_id}[{trace}]: decode {max(dev_ctrl):.2e}, dynamics {max(dev_dyn):.2e}")
    assert max(dev_ctrl) < 1.0e-4, "per-step IK/decode parity regressed"
    assert max(dev_dyn) < 4.5e-4, "per-step dynamics parity regressed"


def test_control_deviation_vs_mujoco():
    """tests/test_dynamics_parity.py:30 through the port's control_step: the
    golden targets over 1 s, arm joints within 1e-3 rad of MuJoCo (the
    golden model has no frictionloss and no joint limits)."""
    data = np.load(os.path.join(GOLDEN, "solo_arm_dynamics.npz"))
    model = get_model("solo_arm")
    model = dataclasses.replace(
        model, jnt_frictionloss=np.zeros_like(model.jnt_frictionloss),
        jnt_range=np.tile(np.array([-1e6, 1e6]), (model.nq, 1)))
    assert int(data["n_sub"]) == tk.N_SUBSTEPS and float(data["timestep"]) == tk.PHYSICS_TIMESTEP
    f = torch.float32
    state = SimState(
        qpos=torch.as_tensor(data["home"], dtype=f), qvel=torch.zeros(model.nq),
        ctrl=torch.as_tensor(data["home"][: model.nu], dtype=f),
        cube_pos=torch.tensor([2.0, 2.0, 0.02]),  # far from the robot and the table
        cube_quat=torch.tensor([1.0, 0, 0, 0]), cube_linvel=torch.zeros(3),
        cube_angvel=torch.zeros(3), time=torch.zeros(()))
    step = engine.make_control_step(model)
    qs = []
    for target in torch.as_tensor(data["targets"], dtype=f):
        state, _ = step(state, target)
        qs.append(state.qpos.numpy())
    dev = np.abs(np.stack(qs)[:, :7] - data["qpos"][:, :7]).max()
    print(f"max arm-joint deviation vs MuJoCo over 1 s: {dev:.2e} rad")
    assert dev < 1e-3, dev


def test_slider_friction_creep_matches_mujoco():
    """tests/test_dynamics_parity.py:82 through the port's control_step: the
    gripper sliders creep closed under frictionloss as MuJoCo's do, within
    1.5e-3 at substeps 50, 150 and 500, and close past -0.028 / -0.024."""
    model = get_model("solo_arm")
    g = np.load(os.path.join(GOLDEN, "slider_friction_trace.npz"))
    state = init_state(model, cube_pos=np.array([0.4, 0.9, 0.62]), device="cpu")
    q0 = torch.zeros(model.nq)
    q0[8:10] = 0.005
    ctrl = q0.clone()
    ctrl[8:10] = -0.029
    state = state._replace(qpos=q0, ctrl=ctrl)
    qs = []
    for _ in range(50):  # 500 substeps of 2 ms
        state, _ = engine.control_step(model, state, ctrl)
        qs.append(state.qpos.numpy())
    for t in (49, 149, 499):
        np.testing.assert_allclose(qs[t // 10][8:10], g["qpos"][t][g["qadr"]], atol=1.5e-3,
                                   err_msg=f"slider creep diverged from MuJoCo at step {t}")
    assert qs[-1][8] < -0.028 and qs[-1][9] < -0.024


def _ik_problems():
    """(model, mask, site, the solver's float64 inputs) from every fifth
    step of each trace: the reference's pre-step state and the port's
    decoded goal, as the env hands them to the host IK."""
    problems = []
    for trace, env_id, arms in CASES:
        data, cfg, (_, step_fn, model), _ = _trace(trace, env_id)
        q_home = np.asarray(cfg.q_pos_home, np.float32).astype(np.float64)
        for t in range(0, data["actions"].shape[0], 5):
            state = _pre_state(data, t, model, cfg)
            qpos = state.qpos.double().numpy()
            for arm in arms:
                side = arm[-1]
                gp, gq = _ee_goal(model, cfg, state, _action(data, t, arms), side)
                mask = tuple(int(i) for i in getattr(cfg, f"q_id_{side}_mask"))
                problems.append((model, mask, f"ee{side}_site", (
                    qpos, gp.double().numpy(), gq.double().numpy(), q_home, qpos)))
    return problems


def test_host_ik_matches_jax_twin_and_native():
    problems = _ik_problems()
    assert len(problems) == 28
    worst_jax, worst_native, skipped = 0.0, 0.0, 0
    for model, mask, site, args in problems:
        kw = dict(model=model, q_mask=mask, site_name=site)
        q, scrib = ik_host._solve_np(*args, **kw)
        jq, jscrib = jik_host._solve_np(*args, **kw)
        worst_jax = max(worst_jax, np.abs(q - jq).max(), np.abs(scrib - jscrib).max())
        nq_, nscrib = native.solve_ik_native(*args, **kw)
        worst_native = max(worst_native, np.abs(q - nq_).max(), np.abs(scrib - nscrib).max())
        # solve_host picks the native solver where it is built
        hq, _ = ik_host.solve_host(*args, **kw)
        assert np.array_equal(hq, nq_)
        lo, hi = model.jnt_range[list(mask), 0], model.jnt_range[list(mask), 1]
        skipped += bool(np.any((args[0][list(mask)] < lo) | (args[0][list(mask)] > hi)))
    print(f"IK: port vs JAX numpy {worst_jax:.2e}, native vs numpy {worst_native:.2e}, "
          f"{skipped} of {len(problems)} warm starts out of range")
    assert worst_jax <= 1e-12
    assert worst_native <= 1e-9
    assert native.available(), native.load_error()


def test_out_of_bounds_warm_start_short_circuits():
    """The torso's home parks joints outside their range: both backends
    return the clipped warm start and the warm start, unsolved."""
    model = get_model("torso")
    mask = tuple(int(i) for i in tk.Q_ID_L_MASK_TORSO)
    qpos = np.asarray(model.home_qpos, np.float64)
    lo, hi = model.jnt_range[list(mask), 0], model.jnt_range[list(mask), 1]
    assert np.any(qpos[list(mask)] < lo)
    args = (qpos, np.zeros(3), np.array([1.0, 0, 0, 0]), model.home_qpos, qpos)
    kw = dict(model=model, q_mask=mask, site_name="eel_site")
    for q, scrib in (ik_host._solve_np(*args, **kw), native.solve_ik_native(*args, **kw)):
        np.testing.assert_array_equal(q, np.clip(qpos[list(mask)], lo, hi).astype(np.float32))
        np.testing.assert_array_equal(scrib, qpos[list(mask)].astype(np.float32))


def test_constants_and_configs_match_jax():
    names = [n for n in dir(tk) if n.isupper() and n != "ASSETS_DIR"]
    for n in ("EE_POS_DELTA", "Q_POS_DELTA", "CTRL_ALPHA", "CUBE_SPAWN_RANGE", "MAX_Q_VEL",
              "IK_JAC_REG", "MOCAP_ID_L", "Q_TORSO_KEYS", "TORSO_URDF", "H5PY_CHUNK_SIZE_BYTES",
              "DATE_FORMAT", "DATA_DIR"):
        assert n in names, n
    for n in names:
        want, got = getattr(jk, n), getattr(tk, n)
        if n == "CAMERAS":  # the port's own Cam class: compared field by field
            assert list(got) == list(want)
            for name, cam in want.items():
                assert dataclasses.asdict(got[name]) == dataclasses.asdict(cam), name
                assert got[name].dtype == cam.dtype, name
            continue
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, n
            np.testing.assert_array_equal(got, want, err_msg=n)
        else:
            assert got == want and type(got) is type(want), n
    assert list(config.CONFIGS) == list(jconfig.CONFIGS)
    for env_id, want in jconfig.CONFIGS.items():
        got = config.CONFIGS[env_id]
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f"{env_id}.{f.name}")
            else:
                assert a == b, f"{env_id}.{f.name}"
    assert config.STATE_ENV_IDS == ("KManipSoloArm", "KManipSoloArmQPos", "KManipDualArm",
                                    "KManipDualArmQPos", "KManipTorso")


def test_unported_options_raise():
    """Camera observations and k_render no longer raise: the backend renders
    a duck-typed shell's cameras and renders any camera on request. Nor do
    the vision fits (a fit of one step each here) or ik_host64=False; nor
    do the rerun logger and the real robot
    (test_reset_determinism_truncation_and_info)."""
    import types

    from gym_kmanip_torch.env.env_sim import KManipEnvSim
    from gym_kmanip_torch.mpc import vision_cost

    cfg = config.CONFIGS["KManipSoloArmVision"]
    shell = types.SimpleNamespace(cfg=cfg, obs_list=list(cfg.obs_list),
                                  cameras=[tk.CAMERAS["grip_r"]],
                                  np_random=np.random.default_rng(0))
    sim = KManipEnvSim(shell, device="cpu")
    _, _, _, obs, _ = sim.k_reset()
    assert obs["camera/grip_r"].shape == (40, 60, 3) and obs["camera/grip_r"].dtype == np.uint8
    shell = types.SimpleNamespace(cfg=config.CONFIGS["KManipSoloArm"], cameras=[],
                                  obs_list=list(config.CONFIGS["KManipSoloArm"].obs_list),
                                  np_random=np.random.default_rng(0))
    sim = KManipEnvSim(shell, device="cpu")
    _, _, _, obs, _ = sim.k_reset()
    assert not any("camera" in key for key in obs)
    small = dataclasses.replace(tk.CAMERAS["head"], w=20, h=16)
    frame = sim.k_render(small)
    assert frame.shape == (16, 20, 3) and frame.dtype == np.uint8 and frame.std() > 0
    m = get_model("solo_arm")
    net = vision_cost.fit_distance_cost(m, 0, n_samples=2, n_steps=1, height=8, width=10,
                                        cam_name="top", device="cpu")
    assert isinstance(net, vision_cost.CostCNN)
    net, estimate = vision_cost.fit_cube_pos_estimator(m, 0, n_samples=2, n_steps=1, height=8,
                                                       width=10, batch=2, device="cpu")
    assert estimate(torch.zeros(8, 10, 3)).shape == (3,)
    for env_id in ("KManipSoloArm", "KManipSoloArmQPos"):
        make_task(dataclasses.replace(config.CONFIGS[env_id], ik_host64=False), device="cpu")


@pytest.mark.parametrize("env_id", ["KManipSoloArm", "KManipDualArm", "KManipTorso"])
def test_ee_ids_step_with_the_device_trf(env_id, monkeypatch):
    """make_task(ik_host64=False) on the EE ids: the decode solves each arm
    with the float32 device TRF. One step from the home state: finite, the
    host solver never called, and the arm's ctrl within 1e-3 rad of the
    float64 host solve of the same problem (tests/test_ik.py:200), or the
    clipped warm start where that is out of range (the torso's home)."""
    cfg = dataclasses.replace(config.CONFIGS[env_id], ik_host64=False)
    reset_fn, step_fn, m = make_task(cfg, device="cpu")
    assert step_fn.parts.goals is None and step_fn.parts.ik is None
    state = reset_fn(np.array([0.2, 0.6, 0.62], np.float32)).state
    sizes = {"eel_pos": 3, "eel_orn": 3, "eer_pos": 3, "eer_orn": 3, "grip_l": 1, "grip_r": 1}
    rng = np.random.default_rng(0)
    action = {a: torch.as_tensor(rng.uniform(-1, 1, sizes[a]).astype(np.float32))
              for a in cfg.act_list}
    from gym_kmanip_torch.env import task

    calls = []
    monkeypatch.setattr(task, "solve_host", lambda *a, **kw: calls.append(1))
    out = step_fn(state, action)
    monkeypatch.undo()
    assert not calls
    assert bool(torch.isfinite(out.reward)) and bool(torch.isfinite(out.state.qpos).all())
    q_home = np.asarray(cfg.q_pos_home, np.float32).astype(np.float64)
    qpos = state.qpos.double().numpy()
    for side in ("r", "l"):
        if f"ee{side}_pos" not in cfg.act_list:
            continue
        mask = tuple(int(i) for i in getattr(cfg, f"q_id_{side}_mask"))
        gp, go = _ee_goal(m, cfg, state, action, side)
        want, _ = ik_host.solve_host(qpos, gp.double().numpy(), go.double().numpy(), q_home,
                                     qpos, model=m, q_mask=mask, site_name=f"ee{side}_site")
        np.testing.assert_allclose(out.state.ctrl[list(mask)].numpy(), want, atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def gym():
    gym = pytest.importorskip("gymnasium")
    from gym_kmanip_torch import env

    env.register()
    env.register()  # a second call registers nothing
    return gym


@pytest.mark.parametrize("env_id", config.STATE_ENV_IDS)
def test_env_checker(gym, env_id):
    from gymnasium.utils.env_checker import check_env

    env = gym.make(f"gym_kmanip_torch/{env_id}", device="cpu")
    check_env(env.unwrapped, skip_render_check=True)
    obs, _ = env.reset(seed=3)
    for key in ("q_pos", "q_vel", "cube_pos", "cube_orn"):
        assert np.all(obs[key] >= -1.0) and np.all(obs[key] <= 1.0), key
    env.close()


def test_reset_determinism_truncation_and_info(gym, tmp_path, monkeypatch):
    from gym_kmanip_torch.env.env_base import KManipEnv

    obs = []
    for _ in range(2):
        env = gym.make("gym_kmanip_torch/KManipSoloArm", device="cpu")
        assert isinstance(env.unwrapped, KManipEnv)
        o, info = env.reset(seed=42)
        obs.append(o)
        for key in ("step", "episode", "is_success", "q_keys", "q_len", "a_len", "obs_list",
                    "act_list", "cameras", "sim", "sim_time", "cpu_time", "reward",
                    "terminated"):
            assert key in info, key
        env.close()
    for key in obs[0]:
        np.testing.assert_allclose(obs[0][key], obs[1][key], atol=1e-7)

    env = gym.make("gym_kmanip_torch/KManipSoloArmQPos", device="cpu")
    env.reset(seed=0)
    action = {name: np.zeros(sp.shape, dtype=sp.dtype)
              for name, sp in env.action_space.spaces.items()}
    truncated = False
    for i in range(tk.MAX_EPISODE_STEPS + 1):
        _, _, terminated, truncated, info = env.step(action)
        if truncated or terminated:
            break
    assert truncated and i == tk.MAX_EPISODE_STEPS - 1
    assert info["step"] == tk.MAX_EPISODE_STEPS
    assert abs(info["sim_time"] - tk.MAX_EPISODE_STEPS * tk.CONTROL_TIMESTEP) < 1e-4
    env.close()
    # log_h5py: a log directory under DATA_DIR, read when the env is made
    monkeypatch.setattr(tk, "DATA_DIR", str(tmp_path))
    env = gym.make("gym_kmanip_torch/KManipSoloArm", device="cpu", log_h5py=True,
                   log_prefix="p")
    assert os.path.dirname(env.unwrapped.log_dir) == str(tmp_path)
    assert os.path.basename(env.unwrapped.log_dir).startswith("p.")
    assert env.unwrapped.info["act_dims"] == {"eer_pos": 3, "eer_orn": 3, "grip_r": 1}
    env.close()
    # log_rerun: the same log directory; sim=False: the real-robot backend
    env = gym.make("gym_kmanip_torch/KManipSoloArm", device="cpu", log_rerun=True,
                   log_prefix="r")
    assert os.path.basename(env.unwrapped.log_dir).startswith("r.")
    env.close()
    env = gym.make("gym_kmanip_torch/KManipSoloArm", device="cpu", sim=False,
                   obs_list=["camera/grip_r"])
    assert type(env.unwrapped.env).__name__ == "KManipEnvReal" and not env.unwrapped.info["sim"]
    env.close()
    # a camera in obs_list: a uint8 Box at the Cam spec's size
    env = gym.make("gym_kmanip_torch/KManipSoloArm", device="cpu",
                   obs_list=["q_pos", "camera/head"])
    space = env.observation_space["camera/head"]
    assert space.shape == (480, 640, 3) and space.dtype == np.uint8 and space.high.max() == 255
    assert env.unwrapped.cameras == [tk.CAMERAS["head"]]
    env.close()


@pytest.mark.parametrize("env_id", config.VISION_ENV_IDS)
def test_vision_ids_reset_and_step(gym, env_id):
    """The *Vision ids through gym.make: reset and one step give in-space
    uint8 camera frames at the Cam spec sizes (head 480 x 640, grip 40 x
    60) that are real renders (std > 0); render() is the top camera."""
    env = gym.make(f"gym_kmanip_torch/{env_id}", device="cpu")
    obs, _ = env.reset(seed=0)
    assert env.observation_space.contains(obs)
    obs, reward, _, _, _ = env.step(env.action_space.sample())
    assert env.observation_space.contains(obs) and np.isfinite(reward)
    cams = [n for n in env.observation_space.spaces if "camera" in n]
    assert cams == [n for n in config.CONFIGS[env_id].obs_list if "camera" in n]
    for name in cams:
        cam = tk.CAMERAS[name.split("/")[-1]]
        img = obs[name]
        assert img.dtype == np.uint8 and img.shape == (cam.h, cam.w, 3)
        assert img.std() > 0, name
    if env_id == "KManipSoloArmVision":
        top = env.render()
        assert top.shape == (480, 640, 3) and top.dtype == np.uint8 and top.std() > 0
    env.close()
