"""The port's vec env and example 12's PPO update against the JAX package.

Two module-scoped JAX programs, each jitted once:
- JAX's `KManipVecEnv("KManipSoloArm", 2)`: its `_reset_all` and 3 seeded
  steps of its `_step_all` (the vmapped decode with the float32 TRF,
  `control_step` and reward), whose spawns and pre-step states are fed to
  the port's `KManipVecEnv` (teacher-forced: each port step starts from
  JAX's state before it). This fixture is most of the file's time: JAX's
  vmapped step compiles in ~40 s and runs ~5 s a step at N = 2 on the CPU
  (N = 2, not 4, to keep the tier-1 run inside its time limit).
- One `ppo_update` of example 12 on a seeded batch, from flax weights that
  `mlp_policy_from_flax` carries over.

Bands (measured: my CPU runs, cold JAX cache). Both TRFs run in float32
on the CPU, whose floor is ~1.5e-5 rad (JAX's own eager and jitted-vmapped
solves of one problem differ by that much). Over the 3 teacher-forced
steps the port's q_sol (the arm's ctrl) sits at most 4.5e-5 rad from
JAX's, held at 1e-4; qpos 3.7e-5, held at 1e-4; qvel, which carries
qpos's difference over 2 ms into the servos, 2.5e-3, held at 1e-2 (the
q_vel observation, qvel / MAX_Q_VEL, 8.0e-4 at 5e-3); the reward 2.4e-5 at
1e-4; the cube and the other observations 6e-8, at 1e-6 and 1e-4. The
flax forward pass on the carried weights 5.4e-7, held at 2e-6; the PPO
loss 7e-8 relative, held at 1e-6; the updated parameters 6.6e-7, held at
5e-6 (Adam's first step moves each by ~lr = 3e-4, and lr g / (|g| + eps)
rounds apart where a gradient is near zero).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_kmanip_tpu.env.vec_env import KManipVecEnv as JVecEnv

from gym_kmanip_torch.dynamics.state import SimState, state_from_numpy
from gym_kmanip_torch.env.vec_env import KManipVecEnv

torch.set_num_threads(1)

N, STEPS = 2, 3
SIZES = {"eer_pos": 3, "eer_orn": 3, "grip_r": 1}


@pytest.fixture(scope="module")
def jax_env():
    env = JVecEnv("KManipSoloArm", N, seed=0)
    states, obs = env._reset_all(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    steps = jnp.zeros((N,), jnp.int32)
    trace = [dict(state=states, obs=obs)]
    for t in range(STEPS):
        acts = {a: rng.uniform(-1, 1, (N, d)).astype(np.float32) for a, d in SIZES.items()}
        states, _, obs, reward, _, steps = env._step_all(
            states, {a: jnp.asarray(v) for a, v in acts.items()}, steps, jax.random.PRNGKey(t))
        trace[-1]["actions"] = acts
        trace.append(dict(state=states, obs=obs, reward=reward))
    mask = [int(i) for i in env.cfg.q_id_r_mask]
    return jax.tree.map(np.asarray, trace), mask


def _close(got, want, atol, msg):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0, err_msg=msg)


def test_reset_matches_jax(jax_env):
    trace, _ = jax_env
    env = KManipVecEnv("KManipSoloArm", N, device="cpu")
    obs = env.reset(spawns=torch.as_tensor(trace[0]["state"].cube_pos))
    for name in SimState._fields:
        _close(getattr(env._states, name), getattr(trace[0]["state"], name), 1e-7, name)
    for key, v in trace[0]["obs"].items():
        _close(obs[key], v, 1e-6, key)


def test_steps_match_jax(jax_env):
    trace, mask = jax_env
    env = KManipVecEnv("KManipSoloArm", N, device="cpu")
    env.reset(spawns=torch.as_tensor(trace[0]["state"].cube_pos))
    bands = dict(qpos=1e-4, qvel=1e-2, cube_pos=1e-6, cube_quat=1e-6, cube_linvel=1e-6,
                 cube_angvel=1e-6, time=1e-6)
    for t in range(STEPS):
        env._states = state_from_numpy(trace[t]["state"], device="cpu")
        obs, reward, term, trunc, _ = env.step(trace[t]["actions"])
        want = trace[t + 1]
        msg = f"step {t}"
        _close(env._states.ctrl[:, mask], want["state"].ctrl[:, mask], 1e-4, f"{msg} q_sol")
        _close(env._states.ctrl, want["state"].ctrl, 1e-4, f"{msg} ctrl")
        for name, tol in bands.items():
            _close(getattr(env._states, name), getattr(want["state"], name), tol,
                   f"{msg} {name}")
        for key, v in want["obs"].items():
            _close(obs[key], v, 5e-3 if key == "q_vel" else 1e-4, f"{msg} obs {key}")
        _close(reward, want["reward"], 1e-4, f"{msg} reward")
        assert not trunc.any() and not term.any()


@pytest.fixture(scope="module")
def jax_ppo():
    """One JAX ppo_update from flax's init on a seeded batch."""
    mod = importlib.import_module("gym_kmanip_tpu.examples.12_train_vec_rl")
    obs_dim, act_dim, batch = 27, 7, 32
    net = mod.MLPPolicy(act_dim)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (batch, obs_dim)).astype(np.float32)
    data = dict(obs=x, acts=rng.uniform(-0.95, 0.95, (batch, act_dim)).astype(np.float32),
                logp_old=rng.normal(-5, 1, batch).astype(np.float32),
                advs=rng.normal(0, 1, batch).astype(np.float32),
                returns=rng.normal(0, 1, batch).astype(np.float32))
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tx, _, _, ppo_update = mod.make_train(net, act_dim)
    forward = net.apply(params, jnp.asarray(x))
    new_params, _, loss = ppo_update(params, tx.init(params), *(jnp.asarray(data[n]) for n in (
        "obs", "acts", "logp_old", "advs", "returns")))
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, new_params), float(loss),
            tuple(np.asarray(a) for a in forward), data)


def test_flax_weights_carry_over(jax_ppo):
    mod = importlib.import_module("gym_kmanip_torch.examples.12_train_vec_rl")
    params, _, _, forward, data = jax_ppo
    policy = mod.mlp_policy_from_flax(params)
    with torch.no_grad():
        got = policy(torch.as_tensor(data["obs"]))
    for name, g, w in zip(("mean", "log_std", "value"), got, forward):
        _close(g, w, 2e-6, name)


def test_ppo_update_matches_jax(jax_ppo):
    mod = importlib.import_module("gym_kmanip_torch.examples.12_train_vec_rl")
    params, new_params, loss, _, data = jax_ppo
    policy = mod.mlp_policy_from_flax(params)
    got_loss = mod.ppo_update(policy, mod.make_optimizer(policy),
                              *(torch.as_tensor(data[n]) for n in (
                                  "obs", "acts", "logp_old", "advs", "returns")))
    np.testing.assert_allclose(float(got_loss), loss, rtol=1e-6)
    want = mod.mlp_policy_from_flax(new_params)
    for (name, g), w in zip(policy.named_parameters(), want.parameters()):
        _close(g, w.detach(), 5e-6, name)
