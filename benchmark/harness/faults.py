"""Faults planted under the timed path, for the checks that the comparison
finds them: the benchmark's own runs never plant one.

Each is a context manager that patches the port's module for its span:
- `state_unchanged`: the solve hands back the MPPI state it was given (no
  update, no shift);
- `physics_unchanged`: the plain rollout's substep returns its state
  unchanged (the CPU route only: on the card the substep is inside K2);
- `half_batch`: the scoring call scores the first half of the candidates
  and gives the rest their mean;
- `answer_altered`: the first control is moved by 1e-3 of the first
  actuator's range where the solve produces it;
- `pick_first` and `pick_worst`: the update keeps candidate 0 (the old
  nominal, so the update is left out) or the candidate with the largest
  total instead of the smallest, and hands back that candidate's own total
  as J;
- `tips_pass_through`: the fingertips' collision spheres shrink to a
  micrometre, so the fingers pass through the cube (on both routes: the
  model's radii are what K2 and the plain substep read). It shows only in
  rollouts that reach the cube.
The exchange between chips has no fault here: every cell runs on one chip.
"""

import contextlib
import dataclasses

import torch

NAMES = ("state_unchanged", "physics_unchanged", "half_batch", "answer_altered", "pick_first",
         "pick_worst", "tips_pass_through")


@contextlib.contextmanager
def _patched(module, attr, make):
    orig = getattr(module, attr)
    setattr(module, attr, make(orig))
    try:
        yield
    finally:
        setattr(module, attr, orig)


@contextlib.contextmanager
def _wrong_pick(mppi, worst: bool):
    seen = {}

    def make_score(orig):
        def score(model, ctrl_seqs, *args, **kwargs):
            costs = orig(model, ctrl_seqs, *args, **kwargs)
            seen["cand"], seen["costs"] = ctrl_seqs, costs
            return costs
        return score

    def make_solve(orig):
        def solve(model, cfg, mppi_state, *args, **kwargs):
            state, _, _ = orig(model, cfg, mppi_state, *args, **kwargs)
            costs = seen["costs"]
            k = torch.argmax(costs) if worst else 0
            kept = seen["cand"][k]
            return state._replace(nominal=torch.cat([kept[1:], kept[-1:]])), kept[0], costs[k]
        return solve

    with _patched(mppi, "rollout_pick_costs", make_score), \
            _patched(mppi, "mppi_solve", make_solve):
        yield


def plant(name: str):
    from gym_kmanip_torch import models
    from gym_kmanip_torch.mpc import mppi
    from gym_kmanip_torch.ops import rollout_pick_cuda

    if name == "state_unchanged":
        def make(orig):
            def solve(model, cfg, mppi_state, *args, **kwargs):
                _, u0, J = orig(model, cfg, mppi_state, *args, **kwargs)
                return mppi_state, u0, J
            return solve
        return _patched(mppi, "mppi_solve", make)
    if name == "physics_unchanged":
        def make(orig):
            def substep(model, state, dt, contact=True, implicit_actuation=False):
                _, aux = orig(model, state, dt, contact, implicit_actuation)
                return state, aux
            return substep
        return _patched(rollout_pick_cuda, "_substep_torch", make)
    if name == "half_batch":
        def make(orig):
            def score(model, ctrl_seqs, state0, *args, **kwargs):
                half = ctrl_seqs.shape[0] // 2
                costs = orig(model, ctrl_seqs[:half].contiguous(), state0, *args, **kwargs)
                return torch.cat([costs, costs.mean().expand(ctrl_seqs.shape[0] - half)])
            return score
        return _patched(mppi, "rollout_pick_costs", make)
    if name == "answer_altered":
        def make(orig):
            def solve(model, cfg, mppi_state, *args, **kwargs):
                state, u0, J = orig(model, cfg, mppi_state, *args, **kwargs)
                span = float(model.ctrl_range[0, 1] - model.ctrl_range[0, 0])
                return state, u0 + torch.nn.functional.one_hot(
                    torch.tensor(0, device=u0.device), u0.shape[0]).to(u0.dtype) * 1e-3 * span, J
            return solve
        return _patched(mppi, "mppi_solve", make)
    if name in ("pick_first", "pick_worst"):
        return _wrong_pick(mppi, worst=name == "pick_worst")
    if name == "tips_pass_through":
        def make(orig):
            def get_model(key):
                model = orig(key)
                tips = tuple(dataclasses.replace(t, radius=1e-6) for t in model.fingertips)
                return dataclasses.replace(model, fingertips=tips)
            return get_model
        return _patched(models, "get_model", make)
    raise KeyError(f"no fault {name!r}: {NAMES}")
