"""Pixels-to-control BC: clone the MPPI pick expert from rendered frames.

Port of `gym_kmanip_tpu/examples/15_bc_pixels.py`: a `bc_pixels_cnn`
policy whose only cube information is the top camera's frame:
proprioception (qpos, qvel) and pixels in, ctrl out. Example 13's expert
episodes (and any saved DAgger labels) hold (qpos, qvel, cube_pose,
expert ctrl) per step, and the raycaster is a function of exactly those
states, so the frames are rendered again offline, in chunks, and kept on
the device as uint8; each minibatch is normalized to [0, 1] as it is
drawn. The policy renders its own frame, so it drops into the same
closed loop as the state policies (example 13's `evaluate`).

    python -m gym_kmanip_torch.examples.15_bc_pixels <data_dir>
"""

import glob
import importlib
import json
import os
import sys
import time

import numpy as np
import torch

from gym_kmanip_torch import zoo
from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.models import canonical_device, get_model
from gym_kmanip_torch.render.raycast import render_camera, render_chunked
from gym_kmanip_torch.utils.optim import adam, mse_step

H_PX, W_PX, CAM = 64, 96, "top"

_bc = importlib.import_module("gym_kmanip_torch.examples.13_bc_pick")


def load_states(data_dir, model):
    """(qpos, qvel, cube_pose, action) float32 arrays from example 13's
    dataset: the episodes whose expert lifted, and `dagger_labels.npz`
    (X, Y) where there is one."""
    import h5py

    nq = model.nq
    xs, ys = [], []
    for path in sorted(glob.glob(os.path.join(data_dir, "episode_*.hdf5"))):
        with h5py.File(path, "r") as f:
            if not bool(f.attrs.get("expert_lifted", True)):
                continue
            n = int(f.attrs.get("ep_len", f["action"].shape[0]))
            xs.append(np.concatenate([f["observations/qpos"][:n], f["observations/qvel"][:n],
                                      f["observations/cube_pose"][:n]], axis=1))
            ys.append(f["action"][:n])
    dag = os.path.join(data_dir, "dagger_labels.npz")
    if os.path.exists(dag):
        with np.load(dag) as d:
            xs.append(d["X"])
            ys.append(d["Y"])
    X = np.concatenate(xs).astype(np.float32)
    Y = np.concatenate(ys).astype(np.float32)
    return X[:, :nq], X[:, nq:2 * nq], X[:, 2 * nq:], Y


def render_frames(model, qpos, cube_pose, batch=128, log=print, device="cuda"):
    """The top-camera frames of recorded states, rendered in chunks of
    `batch`: (N, H_PX, W_PX, 3) uint8 on the device."""
    device = canonical_device(device)
    t0 = time.time()
    q = torch.as_tensor(qpos, dtype=torch.float32, device=device)
    cp = torch.as_tensor(cube_pose, dtype=torch.float32, device=device)
    imgs = render_chunked(model, CAM, q, cp[:, :3], cp[:, 3:7], H_PX, W_PX, chunk=batch)
    log(f"rendered {q.shape[0]} frames in {time.time() - t0:.1f}s")
    return imgs


def train(data_dir, n_steps=6000, batch=64, lr=1e-3, seed=0, log=print, model_name="solo_arm",
          device="cuda"):
    """(policy(SimState) -> ctrl, net, stats): constant-lr Adam over
    minibatches of `batch` indices drawn with replacement."""
    device = canonical_device(device)
    model = get_model(model_name)
    qpos, qvel, cube_pose, Y = load_states(data_dir, model)
    imgs = render_frames(model, qpos, cube_pose, log=log, device=device)
    P = np.concatenate([qpos, qvel], axis=1)
    stats = _bc.normalizers(P, model)
    Pn = (P - stats["mu"]) / stats["sd"]
    Yn = np.clip((Y - stats["mid"]) / stats["half"], -1, 1)

    net = zoo.bc_pixels_cnn(model.nu, img_hw=(H_PX, W_PX), proprio_dim=Pn.shape[1], seed=seed,
                            device=device)
    gen = torch.Generator()
    gen.manual_seed(seed)
    idx = torch.randint(0, Pn.shape[0], (n_steps, batch), generator=gen).to(device)
    opt, sched = adam(net.parameters(), lr)
    Pd = torch.as_tensor(Pn, dtype=torch.float32, device=device)
    Yd = torch.as_tensor(Yn, dtype=torch.float32, device=device)
    for i in range(n_steps):
        # the uint8 frames are normalized a minibatch at a time
        loss = mse_step(net, opt, sched, Yd[idx[i]], imgs[idx[i]].float() / 255.0, Pd[idx[i]])
        if i % max(1, n_steps // 5) == 0:
            log(f"pixels bc step {i}: loss {float(loss):.5f}")

    mu, sd, mid, half = (torch.as_tensor(np.asarray(stats[n], np.float32), device=device)
                         for n in ("mu", "sd", "mid", "half"))

    @torch.no_grad()
    def policy(state: SimState) -> torch.Tensor:
        img = render_camera(model, CAM, state.qpos, state.cube_pos, state.cube_quat,
                            H_PX, W_PX).float() / 255.0
        pn = (torch.cat([state.qpos, state.qvel], dim=-1) - mu) / sd
        return net(img, pn) * half + mid

    return policy, net, stats


def main(data_dir=None, device="cuda"):
    data_dir = data_dir or sys.argv[1]
    policy, _net, _stats = train(data_dir, device=device)
    rate = _bc.evaluate(policy, n_evals=12, ep_len=120, spawn_range=_bc.SPAWN_RANGE,
                        device=device)
    print(json.dumps({"metric": "bc_pixels_pick_success_rate", "value": rate,
                      "unit": "fraction", "vs_baseline": rate}))
    return rate


if __name__ == "__main__":
    main()
