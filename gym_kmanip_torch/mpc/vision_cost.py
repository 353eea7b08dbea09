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
flatten order and the kernel layouts).

`fit_distance_cost` and `fit_cube_pos_estimator` train them on rendered
frames of random (arm pose, cube spawn) pairs, as the JAX package does:
Adam on optax's exponential decay (utils/optim.py), full batches for the
distance cost, minibatches drawn with replacement for the cube estimator.
Every draw (poses, cubes, initial weights, minibatch indices) comes from
one CPU `torch.Generator` seeded with `seed`, so the card and the CPU fit
on the same data; the frames are rendered on the device in chunks.
"""

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.state import SimState, StepAux
from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.render.raycast import render_camera, render_chunked
from gym_kmanip_torch.utils.optim import adam, exponential_decay, mse_step
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


def _pose_bounds(model: RobotModel, around_home: Optional[float]):
    """Joint sampling bounds: the joint ranges clipped to +-3.14, and to
    home +- around_home (None: the full clipped range)."""
    lo = model.jnt_range[:, 0].clip(-3.14).astype(np.float32)
    hi = model.jnt_range[:, 1].clip(max=3.14).astype(np.float32)
    if around_home is not None:
        home = model.home_qpos.astype(np.float32)
        lo = np.maximum(lo, home - np.float32(around_home))
        hi = np.minimum(hi, home + np.float32(around_home))
    return torch.as_tensor(lo), torch.as_tensor(hi)


def _uniform(gen: torch.Generator, shape, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def draw_examples(model: RobotModel, gen: torch.Generator, n_samples: int,
                  around_home: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(qs (n, nq), cubes (n, 3)) on the CPU: poses uniform within the
    bounds of `_pose_bounds`, cubes uniform over CUBE_SPAWN_RANGE."""
    lo, hi = _pose_bounds(model, around_home)
    spawn = torch.as_tensor(k.CUBE_SPAWN_RANGE, dtype=torch.float32)
    qs = _uniform(gen, (n_samples, model.nq), lo, hi)
    cubes = _uniform(gen, (n_samples, 3), spawn[:, 0], spawn[:, 1])
    return qs, cubes


def _frames(model, cam_name, qs, cubes, height, width) -> torch.Tensor:
    """(N, h, w, 3) float32 frames in [0, 1] with the identity cube quaternion."""
    quat = torch.zeros_like(cubes[:, :1]).expand(-1, 4).clone()
    quat[:, 0] = 1.0
    return render_chunked(model, cam_name, qs, cubes, quat, height, width).float() / 255.0


def _losses_out(losses: Optional[List[float]], trace: List[torch.Tensor]):
    if losses is not None and trace:
        losses.extend(torch.stack(trace).cpu().tolist())  # one copy to the host


def fit_distance_cost(model: RobotModel, seed: int = 0, n_samples: int = 256,
                      n_steps: int = 200, height: int = 40, width: int = 60,
                      cam_name: str = "grip_r", around_home: Optional[float] = 0.5,
                      device="cuda", draws=None,
                      losses: Optional[List[float]] = None) -> CostCNN:
    """Self-supervised fit of a CostCNN to the true EE-cube distance from
    `cam_name` frames of random arm poses (home +- `around_home` rad,
    clipped to the ranges; None: the full range) and cube spawns, so the
    learned cost falls as the gripper nears the cube. Full-batch Adam on
    exponential_decay(3e-3, n_steps // 4, 0.5), which gets through the
    constant-mean plateau and then anneals. `draws` injects (qs, cubes)
    in place of the generator's; `losses` (a list) receives each step's
    loss."""
    device = canonical_device(device)
    gen = torch.Generator()
    gen.manual_seed(seed)
    qs, cubes = draw_examples(model, gen, n_samples, around_home) if draws is None else draws[:2]
    qs, cubes = (torch.as_tensor(x, dtype=torch.float32).to(device) for x in (qs, cubes))
    imgs = _frames(model, cam_name, qs, cubes, height, width)
    xpos, xquat, _ = kin.fk(model, qs)
    ee, _ = kin.site_pose(model, xpos, xquat, "eer_site")
    dists = torch.linalg.vector_norm(ee - cubes, dim=-1)

    net = CostCNN(height, width)
    flax_init_(net, gen)
    net = net.to(device)
    opt, sched = adam(net.parameters(), exponential_decay(3e-3, max(n_steps // 4, 1), 0.5))
    trace = [mse_step(net, opt, sched, dists, imgs) for _ in range(n_steps)]
    _losses_out(losses, trace)
    return net


def fit_cube_pos_estimator(model: RobotModel, seed: int = 0, n_samples: int = 512,
                           n_steps: int = 1500, height: int = 64, width: int = 96,
                           cam_name: str = "top", around_home: float = 0.4, batch: int = 128,
                           device="cuda", draws=None, init=None,
                           losses: Optional[List[float]] = None
                           ) -> Tuple[CubePosCNN, Callable]:
    """Perception for pick-from-pixels: regress the cube's world position
    from `cam_name` frames of arm poses near home (the regime of a pick
    episode's first frames) and spawns over the full CUBE_SPAWN_RANGE, in
    coordinates normalized to the spawn box. Adam on exponential_decay(3e-3,
    n_steps // 4, 0.5) over minibatches of `batch` indices drawn with
    replacement. Returns (net, estimate): estimate(img01 (..., h, w, 3)) ->
    (..., 3) cube position in world metres. `draws` injects (qs, cubes,
    idx (n_steps, batch)) and `init` the initial weights (flax
    parameters); `losses` (a list) receives each step's loss.

    Whether n_steps leave the constant-mean plateau (the loss at the
    targets' variance, ~1/3) depends on the draws, in the JAX package as
    here: at 256 frames and 800 steps, JAX's PRNGKey(1) stays on it."""
    device = canonical_device(device)
    spawn = torch.as_tensor(k.CUBE_SPAWN_RANGE, dtype=torch.float32)
    mid = ((spawn[:, 0] + spawn[:, 1]) / 2).to(device)
    half = torch.clamp_min((spawn[:, 1] - spawn[:, 0]) / 2, 1e-3).to(device)
    gen = torch.Generator()
    gen.manual_seed(seed)
    qs, cubes = draw_examples(model, gen, n_samples, around_home) if draws is None else draws[:2]
    qs, cubes = (torch.as_tensor(x, dtype=torch.float32).to(device) for x in (qs, cubes))
    imgs = _frames(model, cam_name, qs, cubes, height, width)
    targets = (cubes - mid) / half

    if init is None:
        net = CubePosCNN(height, width)
        flax_init_(net, gen)
        net = net.to(device)
    else:
        net = cube_pos_cnn_from_flax(init, device=device)
    if draws is None:
        idx = torch.randint(0, qs.shape[0], (n_steps, batch), generator=gen)
    else:
        idx = torch.as_tensor(draws[2], dtype=torch.long)
    idx = idx.to(device)
    opt, sched = adam(net.parameters(), exponential_decay(3e-3, max(n_steps // 4, 1), 0.5))
    trace = [mse_step(net, opt, sched, targets[rows], imgs[rows]) for rows in idx]
    _losses_out(losses, trace)

    @torch.no_grad()
    def estimate(img01: torch.Tensor) -> torch.Tensor:
        return net(img01) * half + mid

    return net, estimate
