"""RL on the device: PPO over a batch of vectorized KManip envs.

Port of `gym_kmanip_tpu/examples/12_train_vec_rl.py`: N envs stepped as
one batch (env/vec_env.KManipVecEnv: the float32 device TRF and one
substep kernel launch per substep for all N envs), and PPO updates with
Adam. Observations, actions and the rollout buffer stay on the device.
Two modes:
  * state (default): an MLP policy on the observation vector;
  * --vision: a CNN policy on the grip camera's frames of
    KManipSoloArmVision, which the vec env renders for the whole batch at
    VISION_HW.

    python -m gym_kmanip_torch.examples.12_train_vec_rl [--vision]
"""

import math
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gym_kmanip_torch.env.vec_env import KManipVecEnv
from gym_kmanip_torch.utils.flax_layers import (
    SameConv, flatten_hwc, flax_init_, images_nchw, inner, load_conv, load_dense, same_side)

N_ENVS = 64
T_ROLLOUT = 16
N_UPDATES = 30
PPO_EPOCHS = 4
CLIP = 0.2
GAMMA = 0.97
LAM = 0.95
LR = 3e-4
VISION_HW = (32, 32)
VISION_ENV = "KManipSoloArmVision"

_LOG_2PI = math.log(2 * math.pi)


class MLPPolicy(nn.Module):
    """The JAX example's flax MLPPolicy: two tanh layers of 128, a linear
    mean head, a value head through a tanh layer of 64, and a learned
    state-independent log_std (initialized at -0.7)."""

    def __init__(self, obs_dim: int, act_dim: int):
        super().__init__()
        self.hidden0 = nn.Linear(obs_dim, 128)
        self.hidden1 = nn.Linear(128, 128)
        self.mean = nn.Linear(128, act_dim)
        self.value_hidden = nn.Linear(128, 64)
        self.value = nn.Linear(64, 1)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.7))
        flax_init_(self)

    def forward(self, x):
        x = torch.tanh(self.hidden0(x))
        x = torch.tanh(self.hidden1(x))
        value = self.value(torch.tanh(self.value_hidden(x)))[..., 0]
        return self.mean(x), self.log_std, value


def mlp_policy_from_flax(params, device="cpu") -> MLPPolicy:
    """An MLPPolicy holding the weights of the JAX example's flax params
    ({"params": {...}} or the inner dict; numpy arrays). flax names the
    Dense submodules in construction order, and in `MLPPolicy.__call__`
    the value head `nn.Dense(1)` is built before the `nn.Dense(64)` in its
    argument: Dense_3 is the (64 -> 1) value head, Dense_4 the (128 -> 64)
    hidden layer. A flax kernel is (in, out), a torch weight (out, in)."""
    p = inner(params)
    policy = MLPPolicy(np.shape(p["Dense_0"]["kernel"])[0], np.shape(p["Dense_2"]["kernel"])[1])
    names = {"Dense_0": "hidden0", "Dense_1": "hidden1", "Dense_2": "mean",
             "Dense_3": "value", "Dense_4": "value_hidden"}
    return _load_policy(policy, p, names, device)


class CNNPolicy(nn.Module):
    """The JAX example's flax CNNPolicy on (..., h, w, 3) uint8 frames: two
    SAME convs of stride 2 (16, 32), a tanh layer of 128, a linear mean
    head, a value head through a tanh layer of 64, and log_std."""

    def __init__(self, act_dim: int, hw=VISION_HW):
        super().__init__()
        self.conv0 = SameConv(3, 16)
        self.conv1 = SameConv(16, 32)
        self.hidden = nn.Linear(same_side(same_side(hw[0])) * same_side(same_side(hw[1])) * 32,
                                128)
        self.mean = nn.Linear(128, act_dim)
        self.value_hidden = nn.Linear(128, 64)
        self.value = nn.Linear(64, 1)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.7))
        flax_init_(self)

    def forward(self, img):
        x, lead = images_nchw(img.float() / 255.0)
        x = torch.relu(self.conv1(torch.relu(self.conv0(x))))
        x = torch.tanh(self.hidden(flatten_hwc(x)))
        value = self.value(torch.tanh(self.value_hidden(x)))[..., 0]
        return self.mean(x).reshape(lead + (-1,)), self.log_std, value.reshape(lead)


def cnn_policy_from_flax(params, hw=VISION_HW, device="cpu") -> CNNPolicy:
    """A CNNPolicy holding the weights of the JAX example's flax CNNPolicy
    for (h, w) frames. flax names Dense_2 the (64 -> 1) value head and
    Dense_3 the (128 -> 64) layer in its argument, as in MLPPolicy."""
    p = inner(params)
    policy = CNNPolicy(np.shape(p["Dense_1"]["kernel"])[1], hw)
    load_conv(policy.conv0, p["Conv_0"])
    load_conv(policy.conv1, p["Conv_1"])
    names = {"Dense_0": "hidden", "Dense_1": "mean", "Dense_2": "value", "Dense_3": "value_hidden"}
    return _load_policy(policy, p, names, device)


def _load_policy(policy, p, names, device):
    """The flax Dense layers `names` ({flax name: attribute}) and log_std
    of p into `policy`, on `device`."""
    for flax_name, attr in names.items():
        load_dense(getattr(policy, attr), p[flax_name])
    with torch.no_grad():
        policy.log_std.copy_(torch.as_tensor(np.asarray(p["log_std"], np.float32)))
    return policy.to(device)


def obs_to_net_input(obs: Dict[str, torch.Tensor], vision: bool = False) -> torch.Tensor:
    if vision:
        return obs["camera/grip_r"]
    return torch.cat([obs[n] for n in ("q_pos", "q_vel", "cube_pos", "cube_orn") if n in obs],
                     dim=-1)


def split_action(flat: torch.Tensor, act_spec) -> Dict[str, torch.Tensor]:
    out, i = {}, 0
    for name, dim in act_spec:
        out[name] = flat[:, i: i + dim]
        i += dim
    return out


def _log_prob(noise, log_std):
    """Log-prob of the pre-tanh gaussian (the tanh correction is left out,
    as in the JAX example: the PPO ratio only needs consistency)."""
    return -0.5 * torch.sum(noise ** 2 + 2 * log_std + _LOG_2PI, dim=-1)


@torch.no_grad()
def policy_step(policy: MLPPolicy, obs: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
    """(action in [-1, 1], log-prob, value) for a batch of net inputs, with
    gaussian noise from `generator` or injected as `noise`."""
    mean, log_std, value = policy(obs)
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    act = torch.tanh(mean + noise * torch.exp(log_std))
    return act, _log_prob(noise, log_std), value


@torch.no_grad()
def gae(rewards: torch.Tensor, values: torch.Tensor, last_value: torch.Tensor):
    """Generalized advantage estimates over (T, N) rewards and values,
    normalized (population std), and the returns."""
    advs = torch.empty_like(rewards)
    adv_next, v_next = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + GAMMA * v_next - values[t]
        adv_next = delta + GAMMA * LAM * adv_next
        advs[t] = adv_next
        v_next = values[t]
    returns = advs + values
    return (advs - advs.mean()) / (advs.std(correction=0) + 1e-6), returns


def ppo_loss(policy: MLPPolicy, obs, acts, logp_old, advs, returns):
    mean, log_std, value = policy(obs)
    pre = torch.atanh(torch.clamp(acts, -0.999, 0.999))
    ratio = torch.exp(_log_prob((pre - mean) / torch.exp(log_std), log_std) - logp_old)
    pg = -torch.minimum(ratio * advs, torch.clamp(ratio, 1 - CLIP, 1 + CLIP) * advs).mean()
    vloss = torch.mean((value - returns) ** 2)
    return pg + 0.5 * vloss - 1e-3 * torch.sum(log_std)


def ppo_update(policy: MLPPolicy, opt: torch.optim.Optimizer, obs, acts, logp_old, advs,
               returns) -> torch.Tensor:
    """One clipped-PPO gradient step on the whole batch; returns the loss
    (before the step)."""
    opt.zero_grad()
    loss = ppo_loss(policy, obs, acts, logp_old, advs, returns)
    loss.backward()
    opt.step()
    return loss.detach()


def make_optimizer(policy: MLPPolicy) -> torch.optim.Optimizer:
    # optax.adam's defaults: b1 0.9, b2 0.999, eps 1e-8
    return torch.optim.Adam(policy.parameters(), lr=LR)


def act_spec_of(cfg):
    dims = {"eer_pos": 3, "eer_orn": 3, "eel_pos": 3, "eel_orn": 3, "grip_r": 1, "grip_l": 1,
            "q_pos_r": 0 if cfg.q_id_r_mask is None else len(cfg.q_id_r_mask),
            "q_pos_l": 0 if cfg.q_id_l_mask is None else len(cfg.q_id_l_mask)}
    return [(n, dims[n]) for n in cfg.act_list if dims.get(n)]


def train(env_id="KManipSoloArm", vision=False, n_updates=N_UPDATES, n_envs=N_ENVS, seed=0,
          t_rollout=T_ROLLOUT, log=print, device="cuda"):
    """PPO on `n_envs` envs of `env_id` (with `vision`, the CNN policy on
    the grip camera at VISION_HW; `env_id` must have that camera, as
    KManipSoloArmVision has): `n_updates` rounds of a `t_rollout`-step
    rollout, GAE and PPO_EPOCHS updates. Returns (policy, mean reward of
    each rollout)."""
    env = KManipVecEnv(env_id, n_envs, seed=seed, device=device,
                       render_hw=VISION_HW if vision else None)
    obs = env.reset(seed=seed)
    act_spec = act_spec_of(env.cfg)
    act_dim = sum(d for _, d in act_spec)
    torch.manual_seed(seed)
    x = obs_to_net_input(obs, vision)
    policy = (CNNPolicy(act_dim) if vision else MLPPolicy(x.shape[-1], act_dim)).to(env.device)
    opt = make_optimizer(policy)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)

    mean_rewards = []
    for upd in range(n_updates):
        O, A, LP, V, R = [], [], [], [], []
        for _ in range(t_rollout):
            x = obs_to_net_input(obs, vision)
            act, logp, value = policy_step(policy, x, gen)
            obs, reward, _, _, _ = env.step(split_action(act, act_spec))
            O.append(x)
            A.append(act)
            LP.append(logp)
            V.append(value)
            R.append(reward)
        _, _, last_v = policy_step(policy, obs_to_net_input(obs, vision), gen)
        advs, returns = gae(torch.stack(R), torch.stack(V), last_v)
        flat = [torch.cat(t) for t in (O, A, LP)]
        for _ in range(PPO_EPOCHS):
            loss = ppo_update(policy, opt, *flat, advs.reshape(-1), returns.reshape(-1))
        mean_rewards.append(float(torch.stack(R).mean()))
        if upd % 5 == 0:
            log(f"update {upd}: mean reward {mean_rewards[-1]:.4f} loss {float(loss):.4f}")
    return policy, mean_rewards


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    vision = "--vision" in argv
    t0 = time.time()
    _, mrs = train(env_id=VISION_ENV if vision else "KManipSoloArm", vision=vision, device=device)
    print(f"trained {N_UPDATES} PPO updates x {N_ENVS} envs ({'vision' if vision else 'state'}) in "
          f"{time.time() - t0:.1f}s; mean reward {mrs[0]:.4f} -> {mrs[-1]:.4f}")
    return mrs


if __name__ == "__main__":
    main()
