"""RL on the device: PPO over a batch of vectorized KManip envs.

Port of `gym_kmanip_tpu/examples/12_train_vec_rl.py`, state mode: an MLP
policy on the observation vector, N envs stepped as one batch
(env/vec_env.KManipVecEnv: the float32 device TRF and one substep kernel
launch per substep for all N envs), and PPO updates with Adam. Observations,
actions and the rollout buffer stay on the device.

    python -m gym_kmanip_torch.examples.12_train_vec_rl

`--vision` (the CNN policy on rendered grip-camera frames) needs the
raycaster (ROADMAP.md Queue 1 item 6) and raises.
"""

import math
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from gym_kmanip_torch.env.vec_env import KManipVecEnv

N_ENVS = 64
T_ROLLOUT = 16
N_UPDATES = 30
PPO_EPOCHS = 4
CLIP = 0.2
GAMMA = 0.97
LAM = 0.95
LR = 3e-4

_LOG_2PI = math.log(2 * math.pi)


def _vision_not_ported():
    return NotImplementedError(
        "--vision (CNNPolicy on rendered grip-camera frames) needs the raycaster, which "
        "is not ported yet: ROADMAP.md Queue 1 item 6")


def _lecun_normal_(w: torch.Tensor):
    """flax's default Dense kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


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
        for layer in (self.hidden0, self.hidden1, self.mean, self.value_hidden, self.value):
            _lecun_normal_(layer.weight)
            nn.init.zeros_(layer.bias)

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
    p = params.get("params", params)
    names = {"Dense_0": "hidden0", "Dense_1": "hidden1", "Dense_2": "mean",
             "Dense_3": "value", "Dense_4": "value_hidden"}
    kernel = lambda name: np.asarray(p[name]["kernel"], np.float32)  # noqa: E731
    policy = MLPPolicy(kernel("Dense_0").shape[0], kernel("Dense_2").shape[1])
    with torch.no_grad():
        for flax_name, attr in names.items():
            layer = getattr(policy, attr)
            layer.weight.copy_(torch.as_tensor(kernel(flax_name).T))
            layer.bias.copy_(torch.as_tensor(np.asarray(p[flax_name]["bias"], np.float32)))
        policy.log_std.copy_(torch.as_tensor(np.asarray(p["log_std"], np.float32)))
    return policy.to(device)


def obs_to_net_input(obs: Dict[str, torch.Tensor]) -> torch.Tensor:
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
    """PPO on `n_envs` envs of `env_id`: `n_updates` rounds of a
    `t_rollout`-step rollout, GAE and PPO_EPOCHS updates. Returns (policy,
    mean reward of each rollout)."""
    if vision:
        raise _vision_not_ported()
    env = KManipVecEnv(env_id, n_envs, seed=seed, device=device)
    obs = env.reset(seed=seed)
    act_spec = act_spec_of(env.cfg)
    torch.manual_seed(seed)
    x = obs_to_net_input(obs)
    policy = MLPPolicy(x.shape[-1], sum(d for _, d in act_spec)).to(env.device)
    opt = make_optimizer(policy)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed)

    mean_rewards = []
    for upd in range(n_updates):
        O, A, LP, V, R = [], [], [], [], []
        for _ in range(t_rollout):
            x = obs_to_net_input(obs)
            act, logp, value = policy_step(policy, x, gen)
            obs, reward, _, _, _ = env.step(split_action(act, act_spec))
            O.append(x)
            A.append(act)
            LP.append(logp)
            V.append(value)
            R.append(reward)
        _, _, last_v = policy_step(policy, obs_to_net_input(obs), gen)
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
    _, mrs = train(vision=vision, device=device)
    print(f"trained {N_UPDATES} PPO updates x {N_ENVS} envs (state) in "
          f"{time.time() - t0:.1f}s; mean reward {mrs[0]:.4f} -> {mrs[-1]:.4f}")
    return mrs


if __name__ == "__main__":
    main()
