"""The general traffic generator: one receding-horizon controller that
starts each solve as soon as the last one's first control is on the host.

A traffic mix (`traffic/<name>.json`) gives the number of rollouts K and
the stream's parameters; the robot's home pose and joint ranges come from
the reference's copy of its MJCF file. Everything is drawn from `--seed`:

- a pool of start states, made on the device in one call of `torch.rand`:
  the joints at home plus a uniform perturbation of `joint_perturb_frac`
  of each joint's range, clipped to the range; the cube uniform in
  `cube_range` (the reference env's reset range), upright and at rest;
  every velocity zero. Solve i starts from state i mod the pool's size;
- the noise seed of solve i, `noise_base + i`, with which the benchmark
  seeds the solver's generator before the call;
- the solves whose outputs the comparison checks: the first timed solve,
  and a reservoir sample of the rest.
"""

import random
from typing import NamedTuple, Optional

import numpy as np
import torch


class Seeds(NamedTuple):
    states: int
    noise_base: int
    sample: int


def seeds(seed: int) -> Seeds:
    """Three independent 64-bit seeds from the run's `--seed`."""
    a, b, c = (int(x) for x in np.random.SeedSequence(int(seed)).generate_state(3, np.uint64))
    return Seeds(a, b, c)


def noise_seed(s: Seeds, i: int) -> int:
    return (s.noise_base + i) % 2**64


def start_pool(robot, traffic: dict, seed: int, device) -> dict:
    """{field: (P, ...) float32 tensor} for the fields qpos, qvel, ctrl,
    cube_pos, cube_quat, cube_linvel, cube_angvel, time."""
    P, nq, nu = int(traffic["start_states"]), robot.nq, robot.nu
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand((P, nq + 3), generator=gen, device=device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    lo, hi = f32(robot.jnt_range[:, 0]), f32(robot.jnt_range[:, 1])
    home = f32(robot.home_qpos)
    qpos = torch.clamp(home + float(traffic["joint_perturb_frac"]) * (hi - lo) * (2 * u[:, :nq] - 1),
                       lo, hi)
    box = np.asarray(traffic["cube_range"], np.float32)
    cube_pos = f32(box[:, 0]) + f32(box[:, 1] - box[:, 0]) * u[:, nq:]
    zeros3 = torch.zeros((P, 3), device=device)
    return dict(
        qpos=qpos, qvel=torch.zeros((P, nq), device=device), ctrl=qpos[:, :nu].contiguous(),
        cube_pos=cube_pos, cube_quat=f32([1.0, 0.0, 0.0, 0.0]).repeat(P, 1),
        cube_linvel=zeros3, cube_angvel=zeros3.clone(), time=torch.zeros(P, device=device))


class Reservoir:
    """A uniform sample of `size` of the solves 1, 2, ... drawn from `seed`
    (Algorithm R); solve 0 is always checked, apart."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = size

    def slot(self, i: int) -> Optional[int]:
        """The slot solve i takes in the sample, or None."""
        if i < 1 or self.size < 1:
            return None
        if i <= self.size:
            return i - 1
        j = self.rng.randrange(i)
        return j if j < self.size else None
