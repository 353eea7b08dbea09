"""Train and ship a state policy of the zoo (bc_pick_solo, bc_pick_dual,
bc_pick_torso) on the card.

Port of the JAX package's `tools/train_zoo.py`: example 13's pipeline (the
MPPI expert on K1 -> ACT HDF5 episodes -> BC -> closed-loop eval on the
plant) over the env's full spawn randomization (constants.CUBE_SPAWN_RANGE),
with DAgger rounds, the best round shipped, and the trained policy written
as a zoo artifact in the JAX package's format (`zoo.save_policy`; both
packages' loaders read it) with its provenance and eval numbers in the
meta. Re-run after a change to the dynamics or the cost.

The artifact goes to `--out-dir/<name>.npz` (`DATA_DIR/zoo` by default,
git-ignored, never beside the shipped artifacts), and only if the
incumbent there, read through the port's loader, did not eval better.
Everything runs on the card unless `--device cpu` is given.

    python -m gym_kmanip_torch.tools.train_zoo [--model solo_arm] [--episodes N] ...
"""

import argparse
import importlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch import zoo
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import canonical_device, get_model

ARTIFACT_NAME = {
    "solo_arm": "bc_pick_solo",
    "dual_arm": "bc_pick_dual",
    "torso": "bc_pick_torso",
}
DEFAULT_OUT_DIR = os.path.join(k.DATA_DIR, "zoo")


def example(n: int):
    """Example 13 (the state pipeline) or 15 (pixels) of the port."""
    return importlib.import_module(
        {13: "gym_kmanip_torch.examples.13_bc_pick",
         15: "gym_kmanip_torch.examples.15_bc_pixels"}[n])


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR,
                    help="where the artifact <name>.npz is written")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


class Stages:
    """Wall seconds by stage, the device synchronized at both ends."""

    def __init__(self, device):
        self.device = device
        self.seconds: Dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, stage: str, fn: Callable, *args, **kwargs):
        self._sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._sync()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + time.perf_counter() - t0
        return out


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def ship(path: str, net, stats, meta: dict, force: bool = False, log=print) -> bool:
    """Write `net` as the artifact at `path`, unless the incumbent there
    (read through the port's loader) has a higher eval_success_rate and
    `force` is off. Returns whether it was written."""
    if os.path.exists(path) and not force:
        prev = float(zoo.load_artifact(path).meta.get("eval_success_rate", 0.0))
        if float(meta["eval_success_rate"]) < prev:
            log(f"NOT shipping: {meta['eval_success_rate']:.2f} < the incumbent's {prev:.2f} "
                f"at {path}")
            return False
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    zoo.save_policy(path, zoo.flax_params(net), stats, meta)
    return True


def reload_check(path: str, policy: Callable, model_name: str, cube_pos, device,
                 atol: float) -> Dict:
    """The written artifact, loaded through the port's loader, reproduces
    the live policy at the spawn range's centre; returns its meta."""
    pol2, meta = zoo.load_policy(path, device=device)
    s = init_state(get_model(model_name), cube_pos=np.asarray(cube_pos), device=device)
    np.testing.assert_allclose(policy(s).cpu().numpy(), pol2(s).cpu().numpy(), atol=atol)
    return meta


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="solo_arm", choices=sorted(ARTIFACT_NAME))
    ap.add_argument("--episodes", type=int, default=64)
    ap.add_argument("--ep-len", type=int, default=100)
    ap.add_argument("--train-steps", type=int, default=8000)
    ap.add_argument("--evals", type=int, default=16)
    ap.add_argument("--noise-p", type=float, default=0.25,
                    help="DART recovery-coverage kick probability")
    ap.add_argument("--dagger-rounds", type=int, default=3)
    ap.add_argument("--dagger-episodes", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--data-dir", default=None,
                    help="reuse a recorded dataset instead of re-recording")
    # the expert's size (example 13's defaults); a toy run on the CPU shrinks it
    ap.add_argument("--samples", type=int, default=256, help="the expert's MPPI samples")
    ap.add_argument("--horizon", type=int, default=20, help="the expert's MPPI horizon")
    add_common_args(ap)
    return ap


def main(argv: Optional[list] = None, log=print) -> Dict:
    """Runs the pipeline; returns a summary: the artifact's path, whether
    it shipped, its meta, the wall seconds by stage, the expert solves and
    BC steps taken."""
    args = parser().parse_args(argv)
    device = canonical_device(args.device)
    bc = example(13)
    quiet = lambda *a: None  # noqa: E731
    stages = Stages(device)
    expert = dict(n_samples=args.samples, horizon=args.horizon, model_name=args.model,
                  spawn_range=bc.SPAWN_RANGE, device=device)
    fit = dict(n_steps=args.train_steps, model_name=args.model, hidden=args.hidden,
               depth=args.depth, log=quiet, device=device)
    eval_len = int(args.ep_len * 1.2)
    select = dict(n_evals=12, ep_len=eval_len, model_name=args.model,
                  spawn_range=bc.SPAWN_RANGE, seed=7777, log=quiet, device=device)

    data_dir = args.data_dir or tempfile.mkdtemp(prefix=f"kmanip_zoo_bc_{args.model}_")
    n_solves = n_steps = 0
    if args.data_dir and os.path.isdir(args.data_dir) and os.listdir(args.data_dir):
        expert_rate = -1.0  # a reused dataset: its rate was recorded with it
    else:
        expert_rate = stages.run("record", bc.record, data_dir, n_episodes=args.episodes,
                                 ep_len=args.ep_len, noise_p=args.noise_p, log=quiet, **expert)
        n_solves += args.episodes * args.ep_len
    # saved DAgger labels seed this run, so successive runs accumulate
    dagger_path = os.path.join(data_dir, "dagger_labels.npz")
    extra = None
    if os.path.exists(dagger_path):
        with np.load(dagger_path) as d:
            extra = (d["X"], d["Y"])
        log(f"resuming with {extra[0].shape[0]} saved dagger labels")
    policy, net, stats = stages.run("train", bc.train, data_dir, extra_data=extra, **fit)
    n_steps += args.train_steps
    # DAgger rounds label the learner's own states with the expert and
    # retrain on everything; the best round ships, chosen on a fixed-seed
    # 12-episode eval (retraining is a stochastic draw), and the shipped
    # number is a fresh eval of `--evals` episodes
    r0 = stages.run("selection_eval", bc.evaluate, policy, **select)
    log(f"initial policy: selection eval {r0:.2f}")
    best = (r0, net, stats, policy)
    rnd0 = 0 if extra is None else extra[0].shape[0] // 1600  # rounds already run
    for rnd in range(rnd0, rnd0 + args.dagger_rounds):
        Xd, Yd = stages.run("dagger", bc.dagger_collect, policy, n_episodes=args.dagger_episodes,
                            ep_len=args.ep_len, seed=1000 + 97 * rnd, log=quiet, **expert)
        n_solves += args.dagger_episodes * args.ep_len
        extra = (Xd, Yd) if extra is None else (np.concatenate([extra[0], Xd]),
                                                np.concatenate([extra[1], Yd]))
        np.savez(dagger_path, X=extra[0], Y=extra[1])
        policy, net, stats = stages.run("train", bc.train, data_dir, extra_data=extra, **fit)
        n_steps += args.train_steps
        r = stages.run("selection_eval", bc.evaluate, policy, **select)
        log(f"dagger round {rnd}: selection eval {r:.2f} ({extra[0].shape[0]} dagger labels)")
        if r > best[0]:
            best = (r, net, stats, policy)
    sel, net, stats, policy = best
    log(f"shipping the best round (selection eval {sel:.2f})")
    rate = stages.run("eval", bc.evaluate, policy, n_evals=args.evals, ep_len=eval_len,
                      model_name=args.model, spawn_range=bc.SPAWN_RANGE, log=quiet,
                      device=device)
    name = ARTIFACT_NAME[args.model]
    out = os.path.join(args.out_dir, f"{name}.npz")
    meta = dict(
        arch="bc_mlp", model=args.model, hidden=args.hidden, depth=args.depth,
        trained_by="gym_kmanip_torch/tools/train_zoo.py", device=device_name(device),
        n_expert_episodes=args.episodes, dagger_rounds=int(args.dagger_rounds),
        dagger_episodes_per_round=int(args.dagger_episodes),
        expert_success_rate=float(expert_rate), eval_success_rate=float(rate),
        eval_episodes=int(args.evals), eval_ep_len=eval_len,
        spawn_range=[list(map(float, r)) for r in bc.SPAWN_RANGE], lift_dz=float(bc.LIFT_DZ),
    )
    shipped = ship(out, net, stats, meta, log=log)
    if shipped:
        log(f"saved {out}: expert {expert_rate:.2f}, bc {rate:.2f}")
        meta = reload_check(out, policy, args.model, bc.SPAWN_RANGE.mean(axis=1), device, 1e-6)
        log(f"reload check OK (eval_success_rate {meta['eval_success_rate']})")
    return dict(artifact=out, shipped=shipped, meta=meta, selection_eval=sel,
                stage_seconds=stages.seconds, expert_solves=n_solves, bc_steps=n_steps,
                data_dir=data_dir)


if __name__ == "__main__":
    summary = main()
    print(json.dumps({key: summary[key] for key in
                      ("artifact", "shipped", "stage_seconds", "expert_solves", "bc_steps")}))
