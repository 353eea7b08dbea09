"""The optimizer and learning-rate schedules that the JAX package takes
from optax, in PyTorch.

`adam` gives `torch.optim.Adam` with optax's defaults (b1 0.9, b2 0.999,
eps 1e-8, no eps_root) and, for a learning rate that is a schedule of the
update count, a `LambdaLR` that applies it at optax's count: the first
update uses `schedule(0)`, and the count advances after the update. optax's
`scale_by_adam` and torch's Adam compute the same update,
lr * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), in a different
order of float32 operations.

`exponential_decay` and `cosine_decay_schedule` are plain-Python copies of
optax's schedules of the same names, at the arguments the JAX package
uses (not staircased, no transition_begin, no end value; alpha 0).
`mse_step` is the training step of every network the JAX package fits:
the mean squared error, its gradient and one update.
"""

import math
from typing import Callable, Iterable, Optional, Tuple, Union

import torch
from torch.optim.lr_scheduler import LambdaLR

Schedule = Callable[[int], float]

B1, B2, EPS = 0.9, 0.999, 1e-8


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Schedule:
    """optax.exponential_decay(init_value, transition_steps, decay_rate):
    init_value * decay_rate ** (count / transition_steps), not staircased."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        if count <= 0:
            return init_value
        return init_value * decay_rate ** (count / transition_steps)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule(init_value, decay_steps) with alpha 0:
    init_value * (1 + cos(pi * min(count, decay_steps) / decay_steps)) / 2."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))

    return schedule


def adam(params: Iterable[torch.nn.Parameter], learning_rate: Union[float, Schedule]
         ) -> Tuple[torch.optim.Adam, Optional[LambdaLR]]:
    """optax.adam(learning_rate) over `params`: (torch's Adam at optax's
    defaults, and for a schedule the LambdaLR that sets the learning rate
    to learning_rate(count); None for a constant). `mse_step` steps the
    scheduler after the optimizer, so the first update uses
    learning_rate(0) and the count advances after each update, as in
    optax."""
    if not callable(learning_rate):
        return torch.optim.Adam(params, lr=learning_rate, betas=(B1, B2), eps=EPS), None
    init = learning_rate(0)
    opt = torch.optim.Adam(params, lr=init, betas=(B1, B2), eps=EPS)
    return opt, LambdaLR(opt, lambda count: learning_rate(count) / init)


def mse_step(net: torch.nn.Module, opt: torch.optim.Optimizer, scheduler: Optional[LambdaLR],
             target: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """One step of `opt` (and then of `scheduler`, if any) on
    mean((net(*inputs) - target)^2); returns the loss before the step."""
    opt.zero_grad(set_to_none=True)
    loss = torch.mean((net(*inputs) - target) ** 2)
    loss.backward()
    opt.step()
    if scheduler is not None:
        scheduler.step()
    return loss.detach()
