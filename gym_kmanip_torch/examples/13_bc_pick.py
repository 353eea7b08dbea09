"""Data -> train -> eval: behavior cloning of the MPPI pick expert.

Port of `gym_kmanip_tpu/examples/13_bc_pick.py`:

  1. `record` runs the MPPI pick expert (example 8's recipe: AR(1)
     exploration, grasp-geometry cost, 10 x 2 ms rollouts) from random
     cube spawns and writes each episode as ACT-layout HDF5 through
     log/log_h5py, plus `observations/cube_pose` (the pick policy needs the
     cube, which ACT's qpos and qvel lack) and the `ep_len` and
     `expert_lifted` attrs; optional DART kicks of the plant's qvel;
  2. `train` clones the expert with a `bc_mlp` on the normalized (qpos,
     qvel, cube_pose), output normalized to the ctrl range, Adam on a
     cosine decay; `dagger_collect` labels the learner's own states with
     the expert's actions;
  3. `evaluate` runs a policy closed loop on the plant from fresh spawns
     (success: the cube ends LIFT_DZ above its settled height).

Every entry point runs on the card unless `device` says otherwise. The
spawns come from numpy RandomStates seeded as in the JAX example, so the
port visits the same spawns; the expert's noise, the initial weights and
the minibatches come from torch generators. Each expert episode starts
from the same nominal and the same generator state (`mppi.rewinder`), as
the JAX example restarts from one immutable MPPIState. `evaluate` runs
its episodes as one batch of states: a policy maps (N, ...) states to
(N, nu) controls, and each control step is one batch of K1 launches.

    python -m gym_kmanip_torch.examples.13_bc_pick
"""

import glob
import json
import os
import tempfile
import time
from typing import Callable, Tuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch import zoo
from gym_kmanip_torch.dynamics.engine import make_control_step
from gym_kmanip_torch.dynamics.state import SimState, init_state
from gym_kmanip_torch.log import log_h5py
from gym_kmanip_torch.models import canonical_device, get_model
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver, rewinder
from gym_kmanip_torch.utils.optim import adam, cosine_decay_schedule, mse_step

# the env's full spawn randomization (20 x 20 cm, 10 cm of drop height);
# the cube may spawn airborne, so success is judged against its settled
# height
SPAWN_RANGE = np.asarray(k.CUBE_SPAWN_RANGE, np.float64)
# the narrow box of the quick runs
SPAWN_CENTER = np.array([0.15, 0.58, 0.62])
SPAWN_HALF = np.array([0.02, 0.02, 0.0])
LIFT_DZ = 0.04  # success: the cube >= 4 cm above its settled height


def _sample_spawn(rng, spawn_range=None):
    if spawn_range is None:
        return SPAWN_CENTER + rng.uniform(-1, 1, 3) * SPAWN_HALF
    r = np.asarray(spawn_range, np.float64)
    return rng.uniform(r[:, 0], r[:, 1])


def _settle(model, state: SimState, plant_step, n=5):
    """Hold the home pose for n control steps so an airborne cube lands;
    returns (state, the settled cube height (...))."""
    hold = torch.as_tensor(model.home_qpos[: model.nu], dtype=torch.float32,
                           device=state.qpos.device)
    hold = hold.expand(state.ctrl.shape)
    for _ in range(n):
        state, _ = plant_step(state, hold)
    return state, state.cube_pos[..., 2].clone()


def _stack(states) -> SimState:
    return SimState(*(torch.stack(x) for x in zip(*states)))


def _features(state: SimState) -> torch.Tensor:
    """(qpos, qvel, cube_pos, cube_quat) along the last dim."""
    return torch.cat([state.qpos, state.qvel, state.cube_pos, state.cube_quat], dim=-1)


def make_expert(model, n_samples=256, horizon=20, n_iters=2, device="cuda"):
    """Example 8's MPPI pick expert: (solver, its initial MPPIState).

    On the dual-arm and torso models the tip distance is each arm's mean
    and then the least over arms: the mean over all tips lets the far arm's
    unreachable tips halve the near arm's pull; the least over arms sends
    the closer arm."""
    device = canonical_device(device)
    sides = [torch.as_tensor([i for i, t in enumerate(model.fingertips) if t.side == s],
                             dtype=torch.long, device=device) for s in ("r", "l")]
    two_arms = all(len(s) for s in sides)

    def cost_fn(s, aux, u):
        d2 = torch.sum((aux.tip_pos - s.cube_pos[..., None, :]) ** 2, dim=-1)
        if two_arms:
            d2arm = torch.minimum(d2.index_select(-1, sides[0]).mean(dim=-1),
                                  d2.index_select(-1, sides[1]).mean(dim=-1))
        else:
            d2arm = d2.mean(dim=-1)
        touched = aux.touch_r | aux.touch_l
        return (
            50.0 * d2arm
            + 0.01 * torch.sum(s.qvel ** 2, dim=-1)
            - torch.where(touched, 5.0, 0.0)
            - torch.where(touched & ~aux.touch_table, 10.0, 0.0)
        )

    cfg = MPPIConfig(horizon=horizon, n_samples=n_samples, n_iters=n_iters, sigma=0.15,
                     n_substeps=10, dt=k.PHYSICS_TIMESTEP, noise_beta=0.9)
    return make_mppi_solver(model, cfg, cost_fn), init_mppi(model, cfg, device=device)


def record(data_dir, n_episodes=8, ep_len=100, n_samples=256, seed=0, noise_p=0.0,
           noise_scale=0.15, log=print, model_name="solo_arm", spawn_range=None, ep0=0,
           horizon=20, device="cuda"):
    """Expert episodes as ACT HDF5 files (+ observations/cube_pose); returns
    the expert's success rate.

    `noise_p`: with this probability per step, kick the plant's qvel by
    N(0, noise_scale) after logging the (obs, expert action) pair (DART):
    the re-planning expert recovers, so later pairs show recovery from
    states off the expert's path."""
    device = canonical_device(device)
    model = get_model(model_name)
    solver, mppi_state0 = make_expert(model, n_samples=n_samples, horizon=horizon, device=device)
    start = rewinder(mppi_state0)
    plant_step = make_control_step(model)
    rng = np.random.RandomState(seed)
    os.makedirs(data_dir, exist_ok=True)
    n_success = 0
    for ep in range(ep0, ep0 + n_episodes):
        spawn = _sample_spawn(rng, spawn_range)
        state = init_state(model, cube_pos=spawn, device=device)
        state, z0 = _settle(model, state, plant_step)
        mppi_state = start()
        info = dict(sim=True, episode=ep, q_len=model.nq, act_list=("ctrl",),
                    act_dims={"ctrl": model.nu}, step=0)
        f = log_h5py.new(data_dir, info)
        f.create_dataset("observations/cube_pose", (k.MAX_EPISODE_STEPS * 2, 7))
        t0 = time.time()
        z_top = z0
        for t in range(ep_len):
            mppi_state, u0, J = solver(mppi_state, state)
            info["step"] = t + 1
            # one copy to the host: qpos, qvel, cube pose and the control
            row = torch.cat([_features(state), u0]).cpu().numpy()
            qpos, qvel = row[: model.nq], row[model.nq: 2 * model.nq]
            if t < k.MAX_EPISODE_STEPS:  # the ACT datasets hold the env's episode cap;
                # a longer expert run keeps cube_pose only
                log_h5py.step(f, {"ctrl": row[2 * model.nq + 7:]},
                              {"q_pos": qpos, "q_vel": qvel}, info)
            f["observations/cube_pose"][t] = row[2 * model.nq: 2 * model.nq + 7]
            state, aux = plant_step(state, u0)
            if noise_p > 0.0 and rng.rand() < noise_p:
                kick = torch.as_tensor(noise_scale * rng.randn(model.nq), dtype=torch.float32,
                                       device=device)
                state = state._replace(qvel=state.qvel + kick)
            z_top = torch.maximum(z_top, state.cube_pos[2])
        lifted = bool(z_top > z0 + LIFT_DZ)
        f.attrs["ep_len"] = min(ep_len, k.MAX_EPISODE_STEPS)
        f.attrs["expert_lifted"] = lifted
        log_h5py.end(f)
        n_success += int(lifted)
        log(f"episode {ep}: expert lifted={lifted} ({time.time() - t0:.1f}s, "
            f"spawn {spawn.round(3)})")
    log(f"expert success: {n_success}/{n_episodes}")
    return n_success / n_episodes


def _load(data_dir, success_only=True) -> Tuple[np.ndarray, np.ndarray]:
    """(X (N, 2 nq + 7), Y (N, nu)) from the episode files. `success_only`
    drops the episodes whose expert did not lift (cloning failed
    demonstrations poisons the policy), unless none lifted."""
    import h5py

    xs, ys, xs_all, ys_all = [], [], [], []
    for path in sorted(glob.glob(os.path.join(data_dir, "episode_*.hdf5"))):
        with h5py.File(path, "r") as f:
            n = int(f.attrs.get("ep_len", f["action"].shape[0]))
            x = np.concatenate([f["observations/qpos"][:n], f["observations/qvel"][:n],
                                f["observations/cube_pose"][:n]], axis=1)
            act = f["action"][:n]
            xs_all.append(x)
            ys_all.append(act)
            if not success_only or bool(f.attrs.get("expert_lifted", True)):
                xs.append(x)
                ys.append(act)
    if not xs:
        xs, ys = xs_all, ys_all
    return np.concatenate(xs), np.concatenate(ys)


def dagger_collect(policy: Callable, n_episodes=16, ep_len=100, n_samples=256, seed=1000,
                   log=print, model_name="solo_arm", spawn_range=None, horizon=20,
                   device="cuda"):
    """A DAgger round: the plant runs under the learner's `policy`, and the
    expert labels every state it visits. Returns (X, Y) as `_load` does."""
    device = canonical_device(device)
    model = get_model(model_name)
    solver, mppi0 = make_expert(model, n_samples=n_samples, horizon=horizon, device=device)
    start = rewinder(mppi0)
    plant_step = make_control_step(model)
    rng = np.random.RandomState(seed)
    rows = []
    for ep in range(n_episodes):
        spawn = _sample_spawn(rng, spawn_range)
        state = init_state(model, cube_pos=spawn, device=device)
        state, _ = _settle(model, state, plant_step)
        ms = start()
        for t in range(ep_len):
            ms, u_star, _ = solver(ms, state)  # the expert's label, warm-started
            rows.append(torch.cat([_features(state), u_star]))
            state, _ = plant_step(state, policy(state))  # the learner drives the plant
        log(f"dagger ep {ep}: {ep_len} labels (spawn {spawn.round(3)})")
    rows = torch.stack(rows).cpu().numpy()
    n_x = 2 * model.nq + 7
    return rows[:, :n_x], rows[:, n_x:]


def normalizers(X: np.ndarray, model):
    """mu and sd of the inputs (numpy's population std, + 1e-6), and the
    ctrl range's mid and half."""
    lo, hi = model.ctrl_range[:, 0], model.ctrl_range[:, 1]
    return dict(mu=X.mean(0), sd=X.std(0) + 1e-6, mid=(lo + hi) / 2, half=(hi - lo) / 2)


def train(data_dir, n_steps=3000, batch=256, lr=1e-3, seed=0, log=print, model_name="solo_arm",
          extra_data=None, hidden=256, depth=2, device="cuda"):
    """Clone the expert: (policy(SimState) -> ctrl, net, stats). Adam on
    cosine_decay_schedule(lr, n_steps) over minibatches of `batch` indices
    drawn with replacement."""
    device = canonical_device(device)
    model = get_model(model_name)
    X, Y = _load(data_dir)
    if extra_data is not None:
        Xe, Ye = extra_data
        X = np.concatenate([X, np.asarray(Xe)], axis=0)
        Y = np.concatenate([Y, np.asarray(Ye)], axis=0)
    stats = normalizers(X, model)
    Xn = (X - stats["mu"]) / stats["sd"]
    Yn = np.clip((Y - stats["mid"]) / stats["half"], -1, 1)

    gen = torch.Generator()
    gen.manual_seed(seed)
    net = zoo.bc_mlp(Yn.shape[1], hidden, depth, in_dim=Xn.shape[1], seed=seed, device=device)
    idx = torch.randint(0, Xn.shape[0], (n_steps, batch), generator=gen).to(device)
    opt, sched = adam(net.parameters(), cosine_decay_schedule(lr, n_steps))
    Xd = torch.as_tensor(Xn, dtype=torch.float32, device=device)
    Yd = torch.as_tensor(Yn, dtype=torch.float32, device=device)
    for i in range(n_steps):
        loss = mse_step(net, opt, sched, Yd[idx[i]], Xd[idx[i]])
        if i % max(1, n_steps // 5) == 0:
            log(f"bc step {i}: loss {float(loss):.5f}")

    mu, sd, mid, half = (torch.as_tensor(np.asarray(stats[n], np.float32), device=device)
                         for n in ("mu", "sd", "mid", "half"))

    @torch.no_grad()
    def policy(state: SimState) -> torch.Tensor:
        return net((_features(state) - mu) / sd) * half + mid

    return policy, net, stats


def evaluate(policy: Callable, n_evals=10, ep_len=120, seed=100, log=print,
             model_name="solo_arm", spawn_range=None, device="cuda"):
    """The success rate of `policy` over n_evals episodes closed loop on the
    plant, run as one batch of n_evals states; the spawns are drawn in
    order from RandomState(seed)."""
    device = canonical_device(device)
    model = get_model(model_name)
    plant_step = make_control_step(model)
    rng = np.random.RandomState(seed)
    spawns = [_sample_spawn(rng, spawn_range) for _ in range(n_evals)]
    state = _stack([init_state(model, cube_pos=s, device=device) for s in spawns])
    state, z0 = _settle(model, state, plant_step)
    z_top = z0
    for t in range(ep_len):
        state, _ = plant_step(state, policy(state))
        z_top = torch.maximum(z_top, state.cube_pos[:, 2])
    lifted = (z_top > z0 + LIFT_DZ).cpu().numpy()
    for i, spawn in enumerate(spawns):
        log(f"eval {i}: lifted={bool(lifted[i])} (spawn {spawn.round(3)})")
    return float(lifted.sum()) / n_evals


def run_pipeline(n_episodes=8, ep_len=100, n_samples=256, n_train=3000, n_evals=10,
                 data_dir=None, log=print, horizon=20, device="cuda"):
    data_dir = data_dir or tempfile.mkdtemp(prefix="kmanip_bc_")
    expert_rate = record(data_dir, n_episodes=n_episodes, ep_len=ep_len, n_samples=n_samples,
                         log=log, horizon=horizon, device=device)
    policy, _net, _stats = train(data_dir, n_steps=n_train, log=log, device=device)
    rate = evaluate(policy, n_evals=n_evals, ep_len=int(ep_len * 1.2), log=log, device=device)
    return expert_rate, rate


def main(device="cuda"):
    expert_rate, rate = run_pipeline(device=device)
    print(json.dumps({"metric": "mppi_expert_pick_success_rate", "value": expert_rate,
                      "unit": "fraction", "vs_baseline": expert_rate}))
    print(json.dumps({"metric": "bc_pick_success_rate", "value": rate, "unit": "fraction",
                      "vs_baseline": rate}))
    return expert_rate, rate


if __name__ == "__main__":
    main()
