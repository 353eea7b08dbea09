"""What the timed loop drives: the system under test, or the control.

`Program` is the port's public entry, `make_fused_pick_solver(model, cfg,
spec)` -> `solve(mppi_state, sim_state)`, built from the configuration's
file. The benchmark seeds the solver's noise generator before each call
and hands it the start states of the traffic; the warm start carries from
solve to solve inside `MPPIState`, as in a controller. A tap on the
solver's scoring call keeps the K totals of the solves that are checked
(where the solver still scores through `rollout_pick_costs`).

`Control` puts the plain reference, computed in TF32, in the program's
place: the comparison has to find it not correct.

Both have one interface: `bind(pool)`, `prepare(i, noise_seed)` -> the
start of solve i (untimed), `solve(start)` -> (u0, J) (timed), `nominal`,
`totals`, `reset()`, `k2_launches()` and `close()`.
"""

from typing import Optional

import torch

from reference import dynamics as rd
from reference import mppi as rmppi

# the name of K2's kernel (csrc/rollout_pick.cu) in the profiler's trace
K2_KERNEL = "rollout_pick_kernel"

FIELDS = ("qpos", "qvel", "ctrl", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel", "time")


def solve_config(cell) -> rmppi.SolveConfig:
    return rmppi.SolveConfig(n_samples=int(cell.traffic["n_samples"]), **cell.config["mppi"])


class _Tap:
    """Stands in for a function and keeps its outputs while `keep` is set."""

    def __init__(self, fn):
        self.fn = fn
        self.keep = False
        self.out = []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        if self.keep:
            self.out.append(out)
        return out


class Program:
    name = "program"

    def __init__(self, cell, robot, device):
        from gym_kmanip_torch.dynamics.state import SimState
        from gym_kmanip_torch.models import get_model
        from gym_kmanip_torch.mpc import mppi
        from gym_kmanip_torch.ops import rollout_pick_cuda

        c = solve_config(cell)
        self._SimState, self._mppi, self._ops = SimState, mppi, rollout_pick_cuda
        model = get_model(cell.config["robot"])
        cfg = mppi.MPPIConfig(horizon=c.horizon, n_samples=c.n_samples, temperature=c.temperature,
                              sigma=c.sigma, n_iters=c.n_iters, n_substeps=c.n_substeps, dt=c.dt,
                              contact=c.contact, noise_beta=c.noise_beta)
        spec = rollout_pick_cuda.PickCostSpec(**cell.config["pick_cost"])
        self._solve = mppi.make_fused_pick_solver(model, cfg, spec)
        self._state = mppi.init_mppi(model, cfg, seed=0, device=device)
        self._home = self._state.nominal
        self._tap = None
        if hasattr(mppi, "rollout_pick_costs"):
            self._tap = _Tap(mppi.rollout_pick_costs)
            mppi.rollout_pick_costs = self._tap
        self._starts = []

    def bind(self, pool: dict):
        P = pool["qpos"].shape[0]
        self._starts = [self._SimState(*(pool[f][i] for f in FIELDS)) for i in range(P)]

    def prepare(self, i: int, noise_seed: int, keep: bool = False):
        self._state.generator.manual_seed(noise_seed)
        if self._tap is not None:
            self._tap.keep = keep
            self._tap.out = []
        return self._starts[i % len(self._starts)]

    def solve(self, start):
        self._state, u0, J = self._solve(self._state, start)
        return u0, J

    @property
    def nominal(self) -> torch.Tensor:
        return self._state.nominal

    @property
    def totals(self) -> Optional[list]:
        return list(self._tap.out) if self._tap is not None and self._tap.out else None

    def reset(self):
        self._state = self._state._replace(nominal=self._home)

    def k2_launches(self) -> Optional[int]:
        return getattr(self._ops.rollout_pick_costs, "launches", None)

    def close(self):
        if self._tap is not None:
            self._mppi.rollout_pick_costs = self._tap.fn
        self._state = self._starts = self._solve = self._home = None


class Control:
    """The reference in TF32 in the program's place."""

    name = "control"

    def __init__(self, cell, robot, device):
        self.cfg = solve_config(cell)
        self.plain = rd.Plain(robot, device, precision="tf32")
        self.wts = rd.PickWeights(**cell.config["pick_cost"])
        self.sigma = torch.as_tensor(rmppi.sigma_per_actuator(robot.ctrl_range, self.cfg.sigma),
                                     device=device)
        self.device = device
        self._home = torch.as_tensor(robot.home_qpos[:robot.nu], dtype=torch.float32,
                                     device=device).repeat(self.cfg.horizon, 1)
        self._nominal = self._home
        self._totals = None
        self._pool = None
        self._seed = 0

    def bind(self, pool: dict):
        self._pool = pool

    def prepare(self, i: int, noise_seed: int, keep: bool = False):
        self._seed = noise_seed
        P = self._pool["qpos"].shape[0]
        return rd.State(*(self._pool[f][i % P][None] for f in rd.State._fields))

    def solve(self, start):
        noise = [n[None] for n in rmppi.draw_noise(self._seed, self.cfg, self.plain.robot.nu,
                                                   self.sigma, self.device)]
        iters, nominal = rmppi.solve(self.plain, self.cfg, self.wts, self._nominal[None], start,
                                     noise)
        self._totals = [it.costs[0] for it in iters]
        best = torch.argmin(iters[-1].costs[0])
        self._nominal = rmppi.shift(nominal[0])
        return nominal[0, 0], iters[-1].costs[0, best]

    @property
    def nominal(self) -> torch.Tensor:
        return self._nominal

    @property
    def totals(self) -> Optional[list]:
        return self._totals

    def reset(self):
        self._nominal = self._home

    def k2_launches(self) -> Optional[int]:
        return None

    def close(self):
        self._pool = None


SYSTEMS = {"program": Program, "control": Control}
