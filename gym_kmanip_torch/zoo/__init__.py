"""Policy zoo: the JAX package's shipped trained policies, loaded into torch.

Port of `gym_kmanip_tpu/zoo/__init__.py`. The artifacts are the JAX
package's files (`gym_kmanip_tpu/zoo/*.npz`), read by path: each holds the
flax parameters under their key paths (`p:`), the normalizers (`s:`) and
a JSON meta with the architecture's name and a format version, so a stale
file fails loudly instead of mis-loading.

  * bc_pick_solo, bc_pick_dual, bc_pick_torso: `bc_mlp`, a state BC MLP:
    depth x tanh(Dense(hidden)), then tanh(Dense(nu)), on the normalized
    (qpos, qvel, cube_pos, cube_quat).
  * bc_pixels_solo: `bc_pixels_cnn`, an end-to-end pixels policy: the
    policy renders its own `top` frame (img_h x img_w of the meta) with the
    raycaster, and the network reads the frame and the normalized (qpos,
    qvel), never the cube state.

`bc_mlp` and `bc_pixels_cnn` build the two architectures fresh, with
flax's default init (LeCun normal kernels, zero biases) drawn from a seeded
torch generator: examples 13 and 15 train them, and `flax_params` turns a
trained net back into the artifacts' layout for `save_policy` (the zoo's
train-and-ship tools, `gym_kmanip_torch/tools/train_zoo*.py` and
`select_zoo.py`).

`load_policy` returns `policy(SimState) -> ctrl` over any leading batch
of states (one call serves N robots), on the card unless `device` says
otherwise, with the deployment math of the JAX loader: the tanh output
rescaled to the actuators' ctrl range by the artifact's mid and half.
"""

import json
import os
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from gym_kmanip_torch.models import canonical_device, get_model
from gym_kmanip_torch.render.raycast import render_camera
from gym_kmanip_torch.utils.flax_layers import (
    SameConv, conv_params, dense, dense_params, flatten_hwc, flax_init_, images_nchw, inner,
    load_conv, same_side)

# the JAX package's shipped artifacts, read by path
_ZOO_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "gym_kmanip_tpu", "zoo",
)
_FORMAT_VERSION = 1
_ARCHS = ("bc_mlp", "bc_pixels_cnn")


class PolicyArtifact(NamedTuple):
    params: Any  # flax params: nested dicts of numpy arrays
    stats: Dict[str, np.ndarray]  # input and output normalizers
    meta: Dict[str, Any]  # arch name, model name, training provenance


class BCMLP(nn.Module):
    """`bc_mlp`: depth x tanh(Dense(hidden)), then tanh(Dense(out))."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x


class BCPixelsCNN(nn.Module):
    """`bc_pixels_cnn`: three SAME convs of stride 2 (16, 32, 64) on the
    frame, relu(Dense(hidden)), the proprioception concatenated, then
    tanh(Dense(hidden)) and tanh(Dense(out))."""

    def __init__(self, dense0, dense1, dense2):
        super().__init__()
        self.convs = nn.ModuleList([SameConv(3, 16), SameConv(16, 32), SameConv(32, 64)])
        self.dense0, self.dense1, self.dense2 = dense0, dense1, dense2

    def forward(self, img: torch.Tensor, proprio: torch.Tensor) -> torch.Tensor:
        """img (..., H, W, 3) float in [0, 1]; proprio (..., P)."""
        x, lead = images_nchw(img)
        for conv in self.convs:
            x = torch.relu(conv(x))
        x = torch.relu(self.dense0(flatten_hwc(x)))
        x = torch.cat([x, proprio.reshape(x.shape[0], -1)], dim=-1)
        x = torch.tanh(self.dense2(torch.tanh(self.dense1(x))))
        return x.reshape(lead + x.shape[-1:])


def _seeded(net: nn.Module, seed: int, device) -> nn.Module:
    gen = torch.Generator()
    gen.manual_seed(seed)
    flax_init_(net, gen)
    return net.to(canonical_device(device))


def bc_mlp(out_dim: int, hidden: int = 256, depth: int = 2, *, in_dim: int, seed: int = 0,
           device="cuda") -> BCMLP:
    """A fresh `bc_mlp` for `in_dim` inputs, flax's init from `seed`."""
    sizes = [in_dim] + [hidden] * depth + [out_dim]
    return _seeded(BCMLP([nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])]), seed,
                   device)


def bc_pixels_cnn(out_dim: int, hidden: int = 256, *, img_hw: Tuple[int, int],
                  proprio_dim: int, seed: int = 0, device="cuda") -> BCPixelsCNN:
    """A fresh `bc_pixels_cnn` for img_hw frames and `proprio_dim`
    proprioception inputs, flax's init from `seed`."""
    h, w = img_hw
    for _ in range(3):
        h, w = same_side(h), same_side(w)
    net = BCPixelsCNN(nn.Linear(h * w * 64, hidden), nn.Linear(hidden + proprio_dim, hidden),
                      nn.Linear(hidden, out_dim))
    return _seeded(net, seed, device)


def bc_mlp_from_flax(params) -> BCMLP:
    p = inner(params)
    return BCMLP([dense(p[f"Dense_{i}"]) for i in range(len(p))])


def bc_pixels_cnn_from_flax(params) -> BCPixelsCNN:
    p = inner(params)
    net = BCPixelsCNN(*(dense(p[f"Dense_{i}"]) for i in range(3)))
    for i, conv in enumerate(net.convs):
        load_conv(conv, p[f"Conv_{i}"])
    return net


def flax_params(net: nn.Module) -> Dict[str, Any]:
    """A `bc_mlp` or `bc_pixels_cnn` net's parameters in the flax layout the
    artifacts hold ({"params": {"Dense_i" / "Conv_i": {"kernel", "bias"}}}),
    as numpy arrays: the inverse of `bc_mlp_from_flax` /
    `bc_pixels_cnn_from_flax`."""
    if isinstance(net, BCMLP):
        p = {f"Dense_{i}": dense_params(layer) for i, layer in enumerate(net.layers)}
    elif isinstance(net, BCPixelsCNN):
        p = {f"Conv_{i}": conv_params(conv) for i, conv in enumerate(net.convs)}
        p.update({f"Dense_{i}": dense_params(layer)
                  for i, layer in enumerate((net.dense0, net.dense1, net.dense2))})
    else:
        raise TypeError(f"no flax layout for {type(net).__name__}")
    return {"params": p}


def _flatten_params(tree, prefix="p:"):
    """Nested dicts of arrays -> {key path: array}."""
    out = {}
    for key, v in tree.items():
        kp = f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(_flatten_params(v, prefix=f"{kp}/"))
        else:
            out[kp] = np.asarray(v)
    return out


def _unflatten_params(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for kp, arr in flat.items():
        parts = kp.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def save_policy(path: str, params, stats: Dict[str, np.ndarray], meta: Dict[str, Any]) -> None:
    """Write an artifact in the JAX package's format: `params` (flax layout,
    nested dicts of arrays) under their key paths, `stats` under s:, and
    `meta` as a JSON scalar with the format version."""
    if meta.get("arch") not in _ARCHS:
        raise ValueError(f"unknown arch {meta.get('arch')}; one of {_ARCHS}")
    arrays = _flatten_params(params)
    for key, v in stats.items():
        arrays[f"s:{key}"] = np.asarray(v)
    arrays["meta"] = np.asarray(json.dumps({**meta, "format_version": _FORMAT_VERSION}))
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def list_policies() -> Tuple[str, ...]:
    return tuple(sorted(f[: -len(".npz")] for f in os.listdir(_ZOO_DIR) if f.endswith(".npz")))


def load_artifact(name_or_path: str) -> PolicyArtifact:
    path = name_or_path
    if not os.path.exists(path):
        path = os.path.join(_ZOO_DIR, f"{name_or_path}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no policy '{name_or_path}' (shipped: {list_policies()})")
    with np.load(path) as data:
        meta = json.loads(str(data["meta"]))
        stats = {key[2:]: data[key] for key in data.files if key.startswith("s:")}
        params = _unflatten_params({key[2:]: data[key] for key in data.files
                                    if key.startswith("p:")})
    if int(meta.get("format_version", -1)) != _FORMAT_VERSION:
        raise ValueError(f"policy artifact format {meta.get('format_version')} != "
                         f"{_FORMAT_VERSION} (re-train it with "
                         f"gym_kmanip_torch/tools/train_zoo.py)")
    return PolicyArtifact(params, stats, meta)


def load_policy(name_or_path: str, device="cuda") -> Tuple[Callable, Dict[str, Any]]:
    """(policy(SimState) -> ctrl, meta) for a zoo artifact. The policy maps
    states with any leading batch dims to (..., nu) controls, on the
    states' device (the loader's `device`)."""
    art = load_artifact(name_or_path)
    meta = dict(art.meta)
    model = get_model(str(meta["model"]))
    arch = str(meta["arch"])
    if arch not in _ARCHS:
        raise ValueError(f"unknown arch {arch}; one of {_ARCHS}")
    device = canonical_device(device)

    def f32(name):
        return torch.as_tensor(np.asarray(art.stats[name], np.float32), device=device)

    mu, sd, mid, half = f32("mu"), f32("sd"), f32("mid"), f32("half")

    if arch == "bc_pixels_cnn":
        # the policy renders its own observation: it reads qpos and qvel
        # (proprioception) and pixels, never the cube state
        net = bc_pixels_cnn_from_flax(art.params).to(device)
        cam, h, w = str(meta["cam"]), int(meta["img_h"]), int(meta["img_w"])

        @torch.no_grad()
        def policy(state) -> torch.Tensor:
            img = render_camera(model, cam, state.qpos, state.cube_pos, state.cube_quat,
                                h, w).float() / 255.0
            pn = (torch.cat([state.qpos, state.qvel], dim=-1) - mu) / sd
            return net(img, pn) * half + mid

        return policy, meta

    net = bc_mlp_from_flax(art.params).to(device)

    @torch.no_grad()
    def policy(state) -> torch.Tensor:
        x = torch.cat([state.qpos, state.qvel, state.cube_pos, state.cube_quat], dim=-1)
        return net((x - mu) / sd) * half + mid

    return policy, meta
