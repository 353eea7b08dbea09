"""Train a policy from recorded HDF5 episodes (behavior cloning).

Port of `gym_kmanip_tpu/examples/6_train_from_dataset.py`: an MLP policy
(`PolicyMLP`: 256-256 tanh, tanh output) cloned on (qpos, qvel) -> action
from the ACT-layout episode files under `DATA_DIR/*/` (the env's
`log_h5py=True` writes them), Adam at a constant learning rate, saved as
a flat checkpoint {flat, obs_dim, act_dim}. `flat` is the parameter
vector in the order of `jax.flatten_util.ravel_pytree` on the flax
parameters (sorted keys: Dense_0's bias, then its (in, out) kernel, then
Dense_1 and Dense_2), so a checkpoint written by either package loads in
the other (`policy_mlp_from_flat`, `policy_mlp_to_flat`).

    KMANIP_DATA_DIR=<dir> python -m gym_kmanip_torch.examples.6_train_from_dataset
"""

import glob
import os
import tempfile
from typing import List, Tuple

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch import zoo
from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.utils.optim import adam, mse_step

DATA_DIR: str = os.environ.get("KMANIP_DATA_DIR", k.DATA_DIR)
BATCH_SIZE: int = 256
NUM_STEPS: int = 2000
LR: float = 3e-4
CKPT_PATH: str = os.environ.get(
    "KMANIP_CKPT_PATH", os.path.join(tempfile.gettempdir(), "kmanip_bc_policy.npz"))
HIDDEN, DEPTH = 256, 2


def policy_mlp(obs_dim: int, act_dim: int, seed: int = 0, device="cuda") -> zoo.BCMLP:
    """A fresh PolicyMLP with flax's init from `seed`."""
    return zoo.bc_mlp(act_dim, HIDDEN, DEPTH, in_dim=obs_dim, seed=seed, device=device)


def policy_mlp_to_flat(net: zoo.BCMLP) -> np.ndarray:
    """The parameters as ravel_pytree orders them: per layer, the bias,
    then the kernel (in, out) in row-major order."""
    parts = []
    for layer in net.layers:
        parts += [layer.bias.detach().cpu().numpy().ravel(),
                  layer.weight.detach().cpu().numpy().T.ravel()]
    return np.concatenate(parts).astype(np.float32)


def policy_mlp_from_flat(flat, obs_dim: int, act_dim: int, device="cuda") -> zoo.BCMLP:
    """A PolicyMLP holding a flat checkpoint's parameters."""
    flat = np.array(flat, np.float32)  # a writable copy
    sizes = [obs_dim] + [HIDDEN] * DEPTH + [act_dim]
    want = sum(b + a * b for a, b in zip(sizes[:-1], sizes[1:]))
    if flat.shape != (want,):
        raise ValueError(f"a flat checkpoint of {flat.shape} for a PolicyMLP of {obs_dim} -> "
                         f"{act_dim}, which has {want} parameters")
    layers, i = [], 0
    for a, b in zip(sizes[:-1], sizes[1:]):
        layer = torch.nn.Linear(a, b)
        with torch.no_grad():
            layer.bias.copy_(torch.as_tensor(flat[i:i + b]))
            layer.weight.copy_(torch.as_tensor(flat[i + b:i + b + a * b].reshape(a, b).T))
        layers.append(layer)
        i += b + a * b
    return zoo.BCMLP(layers).to(canonical_device(device))


def load_episodes(data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """(obs (N, 2 q_len), act (N, act_dim)) from every
    `<data_dir>/*/episode_*.hdf5`."""
    import h5py

    obs_list: List[np.ndarray] = []
    act_list: List[np.ndarray] = []
    for path in sorted(glob.glob(os.path.join(data_dir, "*", "episode_*.hdf5"))):
        with h5py.File(path, "r") as f:
            obs_list.append(np.concatenate([f["observations/qpos"][:],
                                            f["observations/qvel"][:]], axis=1))
            act_list.append(f["action"][:])
    if not obs_list:
        raise SystemExit(f"no episode_*.hdf5 under {data_dir}; record episodes with "
                         "KManipEnv(log_h5py=True) first")
    return np.concatenate(obs_list), np.concatenate(act_list)


def main(data_dir: str = None, ckpt_path: str = None, n_steps: int = NUM_STEPS, seed: int = 0,
         device="cuda"):
    """Train on `data_dir` and write the flat checkpoint to `ckpt_path`;
    returns (ckpt_path, the last loss)."""
    device = canonical_device(device)
    data_dir = data_dir or DATA_DIR
    ckpt_path = ckpt_path or CKPT_PATH
    obs, act = load_episodes(data_dir)
    print(f"dataset: {obs.shape[0]} transitions, obs {obs.shape[1]}, act {act.shape[1]}")
    net = policy_mlp(obs.shape[1], act.shape[1], seed=seed, device=device)
    opt, sched = adam(net.parameters(), LR)
    gen = torch.Generator()
    gen.manual_seed(seed)
    n = obs.shape[0]
    idx = torch.randint(0, n, (n_steps, min(BATCH_SIZE, n)), generator=gen).to(device)
    obs_d = torch.as_tensor(obs, dtype=torch.float32, device=device)
    act_d = torch.as_tensor(act, dtype=torch.float32, device=device)
    loss = torch.zeros(())
    for step in range(n_steps):
        loss = mse_step(net, opt, sched, act_d[idx[step]], obs_d[idx[step]])
        if step % 200 == 0:
            print(f"step {step}: bc loss {float(loss):.6f}")
    np.savez(ckpt_path, flat=policy_mlp_to_flat(net), obs_dim=obs.shape[1],
             act_dim=act.shape[1])
    print(f"saved policy to {ckpt_path}")
    return ckpt_path, float(loss)


if __name__ == "__main__":
    main()
