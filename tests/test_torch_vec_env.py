"""The port's vectorized env (env/vec_env.py) and example 12's state-mode
PPO trainer, on the CPU. No JAX.

The batch semantics of tests/test_vec_env.py:18-70 (shapes and bounds,
independent spawns, autoreset with gymnasium 0.29's final observation), a
vec env of N envs against N single-env steps of
`make_task(ik_host64=False)` on the same spawns and actions (the batched
TRF's solutions equal: it solves each item as it would alone), every
non-vision id, the vision ids' camera frames at render_hw, and tiny PPO
updates in state and vision mode.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.env import config
from gym_kmanip_torch.env.task import make_task
from gym_kmanip_torch.env.vec_env import KManipVecEnv

torch.set_num_threads(1)

SIZES = {"eel_pos": 3, "eel_orn": 3, "eer_pos": 3, "eer_orn": 3, "grip_l": 1, "grip_r": 1}


def _actions(cfg, n, rng=None):
    sizes = dict(SIZES, q_pos_r=len(cfg.q_id_r_mask),
                 q_pos_l=0 if cfg.q_id_l_mask is None else len(cfg.q_id_l_mask))
    return {a: (np.zeros((n, sizes[a]), np.float32) if rng is None
                else rng.uniform(-1, 1, (n, sizes[a])).astype(np.float32))
            for a in cfg.act_list}


def test_vec_env_shapes_and_bounds():
    env = KManipVecEnv("KManipSoloArmQPos", num_envs=4, seed=0, device="cpu")
    obs = env.reset()
    assert obs["q_pos"].shape == (4, 10)
    assert obs["cube_pos"].shape == (4, 3)
    obs, r, term, trunc, _ = env.step(_actions(env.cfg, 4))
    assert r.shape == (4,)
    assert not trunc.any() and not term.any()
    for key in ("q_pos", "q_vel", "cube_pos", "cube_orn"):
        assert torch.all(obs[key] >= -1.0) and torch.all(obs[key] <= 1.0), key
    env.close()


def test_vec_env_independent_spawns():
    env = KManipVecEnv("KManipSoloArmQPos", num_envs=4, seed=1, device="cpu")
    obs = env.reset()
    assert float(obs["cube_pos"].std(dim=0).max()) > 1e-3
    # a seed gives the same spawns again; injected spawns are used as given
    again = KManipVecEnv("KManipSoloArmQPos", num_envs=4, seed=1, device="cpu").reset()
    assert torch.equal(again["cube_pos"], obs["cube_pos"])
    spawns = torch.tensor([[0.2, 0.6, 0.62]] * 4)
    env.reset(spawns=spawns)
    assert torch.equal(env._states.cube_pos, spawns)


def test_vec_env_autoreset():
    env = KManipVecEnv("KManipSoloArmQPos", num_envs=2, seed=2, device="cpu")
    env.reset()
    acts = _actions(env.cfg, 2)
    for _ in range(k.MAX_EPISODE_STEPS - 1):
        obs_pre, r, term, trunc, info = env.step(acts)
        assert not trunc.any() and info == {}
    obs, r, term, trunc, info = env.step(acts)
    assert trunc.all() and not term.any()
    assert set(info) == {"final_observation", "_final_observation", "final_info", "_final_info"}
    assert info["_final_observation"].all() and info["_final_info"].all()
    for i in range(2):
        fo = info["final_observation"][i]
        assert set(fo) == set(obs)
        # the final obs continues the quasi-static trajectory; the returned
        # obs is a fresh episode's
        assert float((fo["q_pos"] - obs_pre["q_pos"][i]).abs().max()) < 0.05
        assert info["final_info"][i] == {}
    final_cubes = torch.stack([info["final_observation"][i]["cube_pos"] for i in range(2)])
    assert float((final_cubes - obs["cube_pos"]).abs().max()) > 1e-4
    assert torch.equal(env._states.time, torch.zeros(2))
    obs, r, term, trunc, info = env.step(acts)
    assert not trunc.any()
    env.close()


@pytest.mark.parametrize("env_id", ["KManipSoloArm", "KManipDualArm"])
def test_vec_env_equals_single_env_steps(env_id):
    """N envs in one batch against N single envs of make_task(ik_host64=
    False), on the same spawns and seeded actions. The TRF's solutions (the
    arms' ctrl) are equal: it solves each item as it would alone. The
    physics may round differently in a batch (the plain substep's batched
    products at nq = 20), so the rest is held at 1e-5 (measured: equal on
    the solo arm, 1.5e-6 in qvel on the dual arm after 3 steps)."""
    n = 3 if env_id == "KManipSoloArm" else 2
    env = KManipVecEnv(env_id, num_envs=n, seed=4, device="cpu")
    obs = env.reset()
    cfg = dataclasses.replace(config.CONFIGS[env_id], ik_host64=False)
    reset_fn, step_fn, _ = make_task(cfg, device="cpu")
    singles = [SimState(*(x[i] for x in env._states)) for i in range(n)]
    for i in range(n):
        for key, v in reset_fn(env._states.cube_pos[i].numpy()).obs.items():
            assert torch.equal(v, obs[key][i]), key
    rng = np.random.default_rng(5)
    for _ in range(2):
        acts = _actions(env.cfg, n, rng)
        obs, reward, _, _, _ = env.step(acts)
        for i in range(n):
            out = step_fn(singles[i], {a: torch.as_tensor(v[i]) for a, v in acts.items()})
            singles[i] = out.state
            assert torch.equal(out.state.ctrl, env._states.ctrl[i])
            for name in SimState._fields:
                torch.testing.assert_close(getattr(out.state, name), getattr(env._states, name)[i],
                                           atol=1e-5, rtol=0, msg=name)
            torch.testing.assert_close(out.reward, reward[i], atol=1e-5, rtol=0)
            for key, v in out.obs.items():
                torch.testing.assert_close(v, obs[key][i], atol=1e-5, rtol=0, msg=key)


@pytest.mark.parametrize("env_id", config.STATE_ENV_IDS)
def test_vec_env_steps_every_state_id(env_id):
    env = KManipVecEnv(env_id, num_envs=2, seed=0, device="cpu")
    env.reset()
    obs, r, term, trunc, _ = env.step(_actions(env.cfg, 2, np.random.default_rng(0)))
    assert r.shape == (2,) and bool(torch.isfinite(r).all())
    assert sorted(obs) == sorted(env.cfg.obs_list)
    assert all(bool(torch.isfinite(v).all()) for v in obs.values())
    assert env.cfg.ik_host64 is False


def test_vision_ids_raise():
    """The *Vision ids no longer raise (Queue 1 item 6a): each builds,
    resets and steps with its cameras at render_hw; render_hw on a state
    id renders nothing; an unknown id still raises."""
    for env_id in config.VISION_ENV_IDS:
        env = KManipVecEnv(env_id, num_envs=2, device="cpu", render_hw=(8, 10))
        env.reset()
        obs, r, _, _, _ = env.step(_actions(env.cfg, 2, np.random.default_rng(1)))
        cams = [o for o in env.cfg.obs_list if "camera" in o]
        assert [c.log_name for c in env.cameras] == cams and len(cams) >= 2
        for name in cams:
            assert obs[name].shape == (2, 8, 10, 3) and obs[name].dtype == torch.uint8
        assert bool(torch.isfinite(r).all())
    obs = KManipVecEnv("KManipSoloArm", num_envs=2, device="cpu", render_hw=(16, 16)).reset()
    assert sorted(obs) == sorted(config.CONFIGS["KManipSoloArm"].obs_list)
    with pytest.raises(KeyError):
        KManipVecEnv("KManipNoSuchEnv", num_envs=2, device="cpu")


def test_vec_env_vision_renders_batch():
    """KManipSoloArmVision at render_hw = (16, 20) (tests/test_vec_env.py:
    73-95): the frames of every env, after the reset, a step and the
    autoreset, equal the raycaster's render of the returned states, and
    the final observation carries the ended episode's frames."""
    from gym_kmanip_torch.render.raycast import render_camera

    env = KManipVecEnv("KManipSoloArmVision", num_envs=3, seed=0, device="cpu",
                       render_hw=(16, 20))

    def check(obs, states):
        for cam in env.cameras:
            img = obs[cam.log_name]
            assert img.shape == (3, 16, 20, 3) and img.dtype == torch.uint8
            assert float(img.float().std()) > 0
            want = render_camera(env.model, cam.name, states.qpos, states.cube_pos,
                                 states.cube_quat, 16, 20)
            assert torch.equal(img, want), cam.name

    check(env.reset(), env._states)
    acts = _actions(env.cfg, 3)
    obs, _, _, trunc, _ = env.step(acts)
    check(obs, env._states)
    env._steps[:] = k.MAX_EPISODE_STEPS - 1  # the next step truncates every env
    pre = env._states
    obs, _, _, trunc, info = env.step(acts)
    assert trunc.all()
    check(obs, env._states)
    assert float((env._states.cube_pos - pre.cube_pos).abs().max()) > 1e-4  # fresh spawns
    final = info["final_observation"][0]
    assert final["camera/grip_r"].shape == (16, 20, 3)
    assert not torch.equal(final["camera/head"], obs["camera/head"][0])
    env.close()


def test_ppo_vision_update_runs():
    """Example 12 --vision: CNNPolicy on KManipSoloArmVision's grip-camera
    frames at VISION_HW, one PPO update (tiny N and T) with finite losses
    and every parameter moved."""
    mod = importlib.import_module("gym_kmanip_torch.examples.12_train_vec_rl")
    lines = []
    policy, mrs = mod.train(env_id=mod.VISION_ENV, vision=True, n_updates=1, n_envs=2,
                            t_rollout=2, seed=0, log=lines.append, device="cpu")
    assert isinstance(policy, mod.CNNPolicy)
    assert len(mrs) == 1 and np.isfinite(mrs[0])
    assert np.isfinite(float(lines[0].split("loss")[-1]))
    torch.manual_seed(0)
    init = mod.CNNPolicy(policy.mean.out_features)
    assert all(float((a - b).detach().abs().max()) > 0
               for a, b in zip(policy.parameters(), init.parameters()))


def test_ppo_training_runs():
    """Example 12's state-mode loop at a tiny size: finite losses and
    rewards, and parameters moved from their seeded initialization."""
    mod = importlib.import_module("gym_kmanip_torch.examples.12_train_vec_rl")
    lines = []
    policy, mrs = mod.train(env_id="KManipSoloArmQPos", n_updates=2, n_envs=4, t_rollout=2,
                            seed=0, log=lines.append, device="cpu")
    assert len(mrs) == 2 and all(np.isfinite(m) for m in mrs)
    loss = float(lines[0].split("loss")[-1])
    assert np.isfinite(loss)
    torch.manual_seed(0)
    init = mod.MLPPolicy(policy.hidden0.in_features, policy.mean.out_features)
    moved = [float((a - b).abs().max()) for a, b in zip(policy.parameters(), init.parameters())]
    assert all(bool(torch.isfinite(p).all()) for p in policy.parameters())
    assert all(m > 0 for m in moved), moved
