"""Vision-in-the-loop MPC: rendered observations feeding a learned cost.

Port of `gym_kmanip_tpu/mpc/vision_cost.py`. Every rollout state is
rendered by the raycaster (render/raycast.py) and scored by a small CNN:
`make_vision_cost`'s cost renders all K rollout states of a step in one
call, (K, h, w, 3), and runs the network once on the batch, so a vision
MPPI solve at horizon H makes H renders and H network calls beside its H
substep launches.

The networks are the JAX package's flax modules as `nn.Module`s;
`cost_cnn_from_flax` and `cube_pos_cnn_from_flax` carry flax parameters
(numpy arrays) into them (utils/flax_layers.py: the SAME padding, the
flatten order and the kernel layouts). Fitting them is training, which
the port does not do yet: `fit_distance_cost` and `fit_cube_pos_estimator`
raise (ROADMAP.md Queue 1 item 6b).
"""

from typing import Callable

import torch
from torch import nn

from gym_kmanip_torch.dynamics.state import SimState, StepAux
from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.render.raycast import render_camera
from gym_kmanip_torch.utils.flax_layers import (
    SameConv, dense, flatten_hwc, flax_init_, images_nchw, inner, load_conv, same_side)


def _flat_features(height: int, width: int, n_convs: int, channels: int) -> int:
    for _ in range(n_convs):
        height, width = same_side(height), same_side(width)
    return height * width * channels


class CostCNN(nn.Module):
    """Tiny conv net: (..., h, w, 3) float in [0, 1] -> (...) cost; an
    unbatched (h, w, 3) frame gives a scalar."""

    def __init__(self, height: int = 40, width: int = 60):
        super().__init__()
        self.conv0 = SameConv(3, 8)
        self.conv1 = SameConv(8, 16)
        self.dense0 = nn.Linear(_flat_features(height, width, 2, 16), 32)
        self.dense1 = nn.Linear(32, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = images_nchw(x)
        x = torch.relu(self.conv1(torch.relu(self.conv0(x))))
        x = torch.relu(self.dense0(flatten_hwc(x)))
        return self.dense1(x)[:, 0].reshape(lead)


class CubePosCNN(nn.Module):
    """(..., h, w, 3) float in [0, 1] -> (..., 3) cube position, normalized
    to the spawn box."""

    def __init__(self, height: int = 64, width: int = 96):
        super().__init__()
        self.conv0 = SameConv(3, 16)
        self.conv1 = SameConv(16, 32)
        self.conv2 = SameConv(32, 32)
        self.dense0 = nn.Linear(_flat_features(height, width, 3, 32), 64)
        self.dense1 = nn.Linear(64, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, lead = images_nchw(x)
        for conv in (self.conv0, self.conv1, self.conv2):
            x = torch.relu(conv(x))
        x = torch.relu(self.dense0(flatten_hwc(x)))
        return self.dense1(x).reshape(lead + (3,))


def _from_flax(net: nn.Module, params, convs, denses, device) -> nn.Module:
    p = inner(params)
    for i, name in enumerate(convs):
        load_conv(getattr(net, name), p[f"Conv_{i}"])
    for i, name in enumerate(denses):
        setattr(net, name, dense(p[f"Dense_{i}"]))  # sized from the kernel
    return net.to(canonical_device(device))


def cost_cnn_from_flax(params, device="cuda") -> CostCNN:
    """A CostCNN holding the JAX package's flax CostCNN parameters
    ({"params": {...}} or the inner dict; numpy arrays), at whatever frame
    size they were made for."""
    return _from_flax(CostCNN(), params, ("conv0", "conv1"), ("dense0", "dense1"), device)


def cube_pos_cnn_from_flax(params, device="cuda") -> CubePosCNN:
    """A CubePosCNN holding the JAX package's flax CubePosCNN parameters."""
    return _from_flax(CubePosCNN(), params, ("conv0", "conv1", "conv2"),
                      ("dense0", "dense1"), device)


def make_vision_cost(model: RobotModel, net: CostCNN, cam_name: str = "grip_r",
                     height: int = 40, width: int = 60, w_vision: float = 1.0,
                     w_vel: float = 0.01) -> Callable:
    """cost_fn(state, aux, ctrl) -> (K,): render `cam_name` at the K rollout
    states in one call and score the frames with `net` (the low-resolution
    grip camera by default), plus w_vel |qvel|^2."""

    @torch.no_grad()
    def cost_fn(state: SimState, aux: StepAux, ctrl: torch.Tensor) -> torch.Tensor:
        img = render_camera(model, cam_name, state.qpos, state.cube_pos, state.cube_quat,
                            height, width)
        c = net(img.float() / 255.0)
        return w_vision * c + w_vel * torch.sum(state.qvel ** 2, dim=-1)

    return cost_fn


def init_cost_params(seed: int = 0, height: int = 40, width: int = 60,
                     device="cuda") -> CostCNN:
    """A CostCNN for (height, width) frames with flax's default init, drawn
    from a torch generator seeded with `seed` (not JAX's stream)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    net = CostCNN(height, width)
    flax_init_(net, gen)
    return net.to(canonical_device(device))


def _training_not_ported(name: str):
    return NotImplementedError(
        f"{name} trains a CNN on rendered frames; training is not ported yet: ROADMAP.md "
        f"Queue 1 item 6b")


def fit_distance_cost(*args, **kwargs):
    """Self-supervised fit of CostCNN to the EE-cube distance (training)."""
    raise _training_not_ported("fit_distance_cost")


def fit_cube_pos_estimator(*args, **kwargs):
    """Fit of CubePosCNN to the cube position from overhead frames (training)."""
    raise _training_not_ported("fit_cube_pos_estimator")
