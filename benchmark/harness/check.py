"""The comparison that decides `correct`.

For each checked solve (the first timed solve, whose nominal is the
robot's home pose, and a sample of the rest drawn from the seed) the plain
reference works the solve out again in float32 from the benchmark's own
inputs: the start state, the noise seed, and the nominal the solve was
handed (the home pose for the first; for the others the warm start the
program carried, the one state of the program it follows, whose carry is
itself checked on every sampled solve by `update_misses`). It reads the
program's outputs only to judge them:

- `totals`: the program's K totals (tapped at the solver's scoring call)
  against the reference's, the gap as a share of the largest total's
  size: each checked solve's 99th percentile over its rollouts (the largest
  over its iterations), then the largest over the checked solves. A
  rollout whose fingertip grazes the cube can gain or lose a touch on the
  rounding of either float32 version, and its gap then jumps to the touch
  bonus; a sound run shows that in one or two rollouts of a solve, a lower
  precision, a dropped contact or a wrong rollout in more than 1% of them;
- `update_misses`: the checked solves whose first control and shifted
  nominal are not the candidate that the program's own totals rank first
  (the first minimum, as the solver's argmin takes it), within 1e-6 of
  each actuator's control range (the candidates are the nominal plus the
  seeded noise, clamped, worked out again by the reference: rounding in
  another order stays far below that), or whose J is not the program's
  total of that candidate. An exact comparison: its limit is 0;
- `nonfinite`: the solves of the window whose first control was not
  finite. An exact comparison: its limit is 0.
"""

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from reference import dynamics as rd
from reference import mppi as rmppi

from .systems import solve_config
from .traffic import noise_seed

# a candidate "matches" the program's output within this share of each
# actuator's control range
MATCH = 1e-6


class Record(NamedTuple):
    """What one checked solve was handed and what it produced."""

    i: int  # its index in the run
    nominal_in: Optional[torch.Tensor]  # (H, nu) the warm start; None: the home pose
    u0: torch.Tensor  # (nu,) on the host
    J: torch.Tensor  # () the expected cost
    nominal_out: torch.Tensor  # (H, nu) the shifted nominal it returned
    totals: Optional[list]  # the (K,) totals of each iteration, where tapped


def readings(cell, robot, records: List[Record], pool: dict, seeds, device,
             detail: Optional[dict] = None) -> dict:
    """{number: its reading over the checked solves}; `totals` is left out
    (and so fails) where the solver's totals were not tapped. `detail`, where
    given, receives the (R, K) gaps that `totals` reads."""
    cfg = solve_config(cell)
    nu, H, K = robot.nu, cfg.horizon, cfg.n_samples
    plain = rd.Plain(robot, device, precision="fp32")
    wts = rd.PickWeights(**cell.config["pick_cost"])
    sigma = torch.as_tensor(rmppi.sigma_per_actuator(robot.ctrl_range, cfg.sigma), device=device)
    span = plain.ctrl_hi - plain.ctrl_lo
    home = torch.as_tensor(robot.home_qpos[:nu], dtype=torch.float32, device=device).repeat(H, 1)
    P = pool["qpos"].shape[0]

    def dev(x):
        return x.to(device=device, dtype=torch.float32)

    nominal = torch.stack([home if r.nominal_in is None else dev(r.nominal_in) for r in records])
    idx = torch.as_tensor([r.i % P for r in records], device=device)
    start = rd.State(*(pool[f][idx] for f in rd.State._fields))
    draws = [rmppi.draw_noise(noise_seed(seeds, r.i), cfg, nu, sigma, device) for r in records]
    noise = [torch.stack([d[it] for d in draws]) for it in range(cfg.n_iters)]
    del draws
    tapped = all(r.totals is not None and len(r.totals) == cfg.n_iters for r in records)
    picks = None
    if tapped and cfg.n_iters > 1:  # follow the program's earlier picks
        picks = [torch.stack([torch.argmin(dev(r.totals[it])) for r in records])
                 for it in range(cfg.n_iters - 1)] + [None]
    iters, _ = rmppi.solve(plain, cfg, wts, nominal, start, noise, picks)
    del noise

    last = iters[-1]
    u0 = torch.stack([dev(r.u0) for r in records])  # (R, nu)
    out = torch.stack([dev(r.nominal_out) for r in records])  # (R, H, nu)
    gap = torch.maximum(
        (torch.abs(u0[:, None] - last.cand[:, :, 0]) / span).amax(-1),
        (torch.abs(out[:, None] - rmppi.shift(last.cand)) / span).amax((-2, -1)))  # (R, K)
    found = {}
    if not tapped:  # no totals to rank the candidates by: any candidate will do
        miss = ~(gap.amin(1) <= MATCH)
    else:
        prog = [torch.stack([dev(r.totals[it]).reshape(K) for r in records])
                for it in range(cfg.n_iters)]
        rows = torch.arange(len(records), device=device)
        pick = torch.argmin(prog[-1], dim=1)  # the first minimum, as the solver's
        J = torch.stack([dev(r.J).reshape(()) for r in records])
        miss = ~(gap[rows, pick] <= MATCH) | (J != prog[-1][rows, pick])
        rel = torch.stack([
            torch.abs(p - step.costs) / torch.abs(step.costs).amax(1, keepdim=True).clamp_min(1e-6)
            for p, step in zip(prog, iters)]).amax(0)  # (R, K)
        found["totals"] = float(torch.quantile(rel, 0.99, dim=1).max())
        if detail is not None:
            detail["totals"] = rel.cpu()
    found["update_misses"] = float(torch.sum(miss))
    return found


def judge(found: dict, limits: dict):
    """(correct, [(number, reading, limit)]): every number the cell has a
    limit for is read and within it; one that was not read fails."""
    rows = [(name, found.get(name, float("nan")), float(limit)) for name, limit in limits.items()]
    correct = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return correct, rows
