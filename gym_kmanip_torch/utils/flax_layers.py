"""flax's `Conv` and `Dense` conventions in PyTorch, and the carry of their
parameters.

The JAX package's networks (the vision costs, the zoo's policies, example
12's policies) are flax modules on NHWC images. Their torch counterparts
hold the same parameters and compute the same function:

- flax `Conv(..., padding="SAME")` pads asymmetrically: per spatial side
  of n, total = max((ceil(n / s) - 1) s + k - n, 0), lo = total // 2 and
  hi = total - lo. At k = 3, s = 2 an even side pads (0, 1) and an odd
  side (1, 1), so `Conv2d(padding=1)` would be off by one pixel on every
  even side. `SameConv` pads per call, from its input's size.
- flax flattens an NHWC feature map in (h, w, c) order: `flatten_hwc`
  permutes back from NCHW first, so a carried Dense kernel keeps its rows.
- flax conv kernels are HWIO (torch: OIHW), Dense kernels (in, out)
  (torch: (out, in)).
- flax's default kernel init is LeCun normal (a normal truncated at two
  standard deviations, variance 1 / fan_in), biases zero.
"""

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's default kernel init on a torch weight ((out, in) or OIHW)."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def flax_init_(module: nn.Module, generator: Optional[torch.Generator] = None):
    """flax's default init on every Linear and Conv2d of `module`."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)


def same_side(n: int, stride: int = 2) -> int:
    """Output side of a SAME-padded conv of stride `stride` on a side of n."""
    return -(-n // stride)


class SameConv(nn.Conv2d):
    """flax `Conv(cout, (k, k), strides=s)` (SAME padding) on NCHW input."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 2):
        super().__init__(cin, cout, kernel, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n, k, s in zip(reversed(x.shape[-2:]), reversed(self.kernel_size),
                           reversed(self.stride)):
            total = max((same_side(n, s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H * W * C), flax's flatten order of NHWC."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def images_nchw(x: torch.Tensor):
    """NHWC images with any leading dims -> ((B, C, H, W), leading dims)."""
    lead = x.shape[:-3]
    return x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2), lead


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def load_dense(layer: nn.Linear, p: Dict[str, np.ndarray]):
    """Copy a flax Dense's {"kernel" (in, out), "bias"} into `layer`."""
    kernel = _f32(p["kernel"])
    if tuple(kernel.shape) != (layer.in_features, layer.out_features):
        raise ValueError(f"Dense kernel {tuple(kernel.shape)} for a Linear of "
                         f"{layer.in_features} -> {layer.out_features}")
    with torch.no_grad():
        layer.weight.copy_(kernel.T)
        layer.bias.copy_(_f32(p["bias"]))


def load_conv(layer: nn.Conv2d, p: Dict[str, np.ndarray]):
    """Copy a flax Conv's {"kernel" (HWIO), "bias"} into `layer` (OIHW)."""
    kernel = _f32(p["kernel"]).permute(3, 2, 0, 1)
    if kernel.shape != layer.weight.shape:
        raise ValueError(f"Conv kernel {tuple(kernel.shape)} (OIHW) for a Conv2d of "
                         f"{tuple(layer.weight.shape)}")
    with torch.no_grad():
        layer.weight.copy_(kernel)
        layer.bias.copy_(_f32(p["bias"]))


def dense_params(layer: nn.Linear) -> Dict[str, np.ndarray]:
    """A Linear's parameters as a flax Dense's {"kernel" (in, out), "bias"}."""
    return {"kernel": layer.weight.detach().T.float().cpu().numpy(),
            "bias": layer.bias.detach().float().cpu().numpy()}


def conv_params(layer: nn.Conv2d) -> Dict[str, np.ndarray]:
    """A Conv2d's parameters as a flax Conv's {"kernel" (HWIO), "bias"}."""
    return {"kernel": layer.weight.detach().permute(2, 3, 1, 0).float().cpu().numpy(),
            "bias": layer.bias.detach().float().cpu().numpy()}


def dense(p: Dict[str, np.ndarray]) -> nn.Linear:
    """A Linear holding a flax Dense's parameters, sized from its kernel."""
    n_in, n_out = np.shape(p["kernel"])
    layer = nn.Linear(n_in, n_out)
    load_dense(layer, p)
    return layer


def inner(params) -> dict:
    """flax's {"params": {...}} or the inner dict itself."""
    return params.get("params", params)
