"""Test helper: an Adam state carried into and read out of the port's
optimizer (torch's Adam and LambdaLR from gym_kmanip_torch/utils/optim.adam)
in flax's layout.

The port's networks hold flax's parameters with conv kernels as OIHW
(flax: HWIO) and Dense kernels as (out, in) (flax: (in, out)); their i-th
Conv2d is flax's `Conv_i` and their i-th Linear `Dense_i`, in module order.
An optax Adam state is (count, mu, nu) with mu and nu in the parameters'
tree; torch's Adam keeps `step`, `exp_avg` and `exp_avg_sq` per parameter,
and `step` is optax's count (updates done so far). Imports no JAX.
"""

import numpy as np
import torch
from torch import nn


def flax_leaves(net: nn.Module):
    """[(parameter, flax layer name, leaf name, to_torch, to_flax)] of every
    Conv2d and Linear of `net`."""
    out = []
    convs = [m for m in net.modules() if isinstance(m, nn.Conv2d)]
    denses = [m for m in net.modules() if isinstance(m, nn.Linear)]
    for kind, layers in (("Conv", convs), ("Dense", denses)):
        for i, layer in enumerate(layers):
            if kind == "Conv":
                to_t, to_f = (lambda a: a.permute(3, 2, 0, 1)), (lambda a: a.permute(2, 3, 1, 0))
            else:
                to_t, to_f = (lambda a: a.T), (lambda a: a.T)
            out.append((layer.weight, f"{kind}_{i}", "kernel", to_t, to_f))
            out.append((layer.bias, f"{kind}_{i}", "bias", lambda a: a, lambda a: a))
    return out


def _inner(tree):
    return tree.get("params", tree)


def load_adam_state(opt, sched, net: nn.Module, count: int, mu, nu):
    """Set `opt` and `sched` (utils/optim.adam over net's parameters; sched
    None for a constant learning rate) to the state of count updates with
    moments mu and nu (flax trees of arrays)."""
    if sched is not None:
        sched.last_epoch = int(count)
        for group, base, fn in zip(opt.param_groups, sched.base_lrs, sched.lr_lambdas):
            group["lr"] = base * fn(int(count))
    for p, layer, leaf, to_t, _ in flax_leaves(net):
        def t(tree):
            a = torch.tensor(np.asarray(_inner(tree)[layer][leaf], np.float32))  # a copy
            return to_t(a).contiguous().to(p.device)
        opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": t(mu),
                              "exp_avg_sq": t(nu)}


def adam_state(opt, net: nn.Module):
    """(count, mu, nu, params) of `opt` and `net` as flax trees of numpy arrays."""
    mu, nu, params, counts = {}, {}, {}, set()
    for p, layer, leaf, _, to_f in flax_leaves(net):
        st = opt.state[p]
        counts.add(int(st["step"]))
        for tree, a in ((mu, st["exp_avg"]), (nu, st["exp_avg_sq"]), (params, p.detach())):
            tree.setdefault(layer, {})[leaf] = to_f(a).cpu().numpy()
    (count,) = counts
    return count, mu, nu, params


def flax_tree(net: nn.Module):
    """net's parameters as a flax tree of numpy arrays."""
    tree = {}
    for p, layer, leaf, _, to_f in flax_leaves(net):
        tree.setdefault(layer, {})[leaf] = to_f(p.detach()).cpu().numpy()
    return tree


def draw_moments(params, rng, scale=1e-2):
    """mu ~ N(0, scale^2), nu ~ U(0.1, 1) scale^2 in the tree of `params`:
    an optimizer mid-run, whose next update is smooth in the gradient
    (from zero moments, Adam's first update is ~lr * sign(g), which float
    rounding can flip where g is near 0)."""
    inner = _inner(params)
    mu = {n: {k: (rng.normal(0, scale, np.shape(v))).astype(np.float32)
              for k, v in layer.items()} for n, layer in inner.items()}
    nu = {n: {k: (rng.uniform(0.1, 1.0, np.shape(v)) * scale ** 2).astype(np.float32)
              for k, v in layer.items()} for n, layer in inner.items()}
    return mu, nu
