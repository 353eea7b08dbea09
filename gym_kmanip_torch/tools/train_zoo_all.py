"""Record, train and ship the dual-arm and torso zoo artifacts on the card.

Port of the JAX package's `tools/train_zoo_all.py`: the recipe that won
for the solo artifact (expert episodes with DART kicks, success-filtered
BC at 512 x 3 on a cosine decay, no DAgger: measured net-harmful), with a
spawn range per robot:

  * dual_arm: the env's full CUBE_SPAWN_RANGE (the right arm covers it;
    the expert's least-over-arms cost sends the closer arm).
  * torso: y clipped to [0.50, 0.54]. The torso's arms cannot reach most
    of the env's spawn range (the expert's closest tip stays 0.15-0.21 m
    from a cube at y > 0.55); the artifact's meta records its envelope.

Each robot's episodes go to `--data-root/<model>` (recorded episodes there
are reused), the artifacts to `--out-dir`, through train_zoo's
never-regress guard. Everything runs on the card unless `--device cpu`.

    python -m gym_kmanip_torch.tools.train_zoo_all [--models dual_arm,torso]
"""

import argparse
import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.tools.train_zoo import (
    Stages, add_common_args, device_name, example, reload_check, ship)

ARTIFACT_NAME = {"dual_arm": "bc_pick_dual", "torso": "bc_pick_torso"}
HIDDEN, DEPTH = 512, 3


def spawn_range_for(model_name, bc):
    r = np.asarray(bc.SPAWN_RANGE, np.float64).copy()
    if model_name == "torso":
        r[1] = [0.50, 0.54]
    return r


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default="dual_arm,torso")
    ap.add_argument("--episodes", type=int, default=48)
    ap.add_argument("--ep-len", type=int, default=110)
    ap.add_argument("--train-steps", type=int, default=12000)
    ap.add_argument("--evals", type=int, default=24)
    ap.add_argument("--eval-len", type=int, default=160)
    ap.add_argument("--data-root", default=os.path.join(tempfile.gettempdir(), "kmanip_zoo"))
    ap.add_argument("--samples", type=int, default=384, help="the expert's MPPI samples")
    ap.add_argument("--horizon", type=int, default=20, help="the expert's MPPI horizon")
    add_common_args(ap)
    return ap


def main(argv: Optional[list] = None, log=print) -> Dict:
    """Returns {model: summary} as train_zoo.main does for one model."""
    args = parser().parse_args(argv)
    device = canonical_device(args.device)
    bc = example(13)
    quiet = lambda *a: None  # noqa: E731
    out_all = {}
    for model_name in args.models.split(","):
        stages = Stages(device)
        rng = spawn_range_for(model_name, bc)
        data_dir = os.path.join(args.data_root, model_name)
        os.makedirs(data_dir, exist_ok=True)
        have = len([f for f in os.listdir(data_dir) if f.startswith("episode_")])
        if have < args.episodes:
            expert_rate = stages.run(
                "record", bc.record, data_dir, n_episodes=args.episodes - have,
                ep_len=args.ep_len, noise_p=0.25, model_name=model_name, spawn_range=rng,
                ep0=have, n_samples=args.samples, horizon=args.horizon, log=quiet,
                device=device)
        else:
            expert_rate = -1.0
        policy, net, stats = stages.run(
            "train", bc.train, data_dir, n_steps=args.train_steps, model_name=model_name,
            hidden=HIDDEN, depth=DEPTH, log=quiet, device=device)
        rate = stages.run("eval", bc.evaluate, policy, n_evals=args.evals, ep_len=args.eval_len,
                          model_name=model_name, spawn_range=rng, seed=4242, log=quiet,
                          device=device)
        name = ARTIFACT_NAME[model_name]
        out = os.path.join(args.out_dir, f"{name}.npz")
        meta = dict(
            arch="bc_mlp", model=model_name, hidden=HIDDEN, depth=DEPTH,
            trained_by="gym_kmanip_torch/tools/train_zoo_all.py", device=device_name(device),
            n_expert_episodes=args.episodes, expert_success_rate=float(expert_rate),
            eval_success_rate=float(rate), eval_episodes=int(args.evals),
            eval_ep_len=int(args.eval_len), eval_seed=4242,
            spawn_range=[list(map(float, row)) for row in rng],
            spawn_note=("y clipped to the torso's measured reachable band"
                        if model_name == "torso" else "full reference CUBE_SPAWN_RANGE"),
            lift_dz=float(bc.LIFT_DZ),
        )
        shipped = ship(out, net, stats, meta, log=log)
        log(f"{name}: expert {expert_rate:.2f}, bc {rate:.2f}"
            + (f" -> {out}" if shipped else " (not shipped)"))
        if shipped:
            meta = reload_check(out, policy, model_name, rng.mean(axis=1), device, 1e-5)
            log(f"{name}: reload check OK")
        out_all[model_name] = dict(artifact=out, shipped=shipped, meta=meta,
                                   stage_seconds=stages.seconds,
                                   expert_solves=(args.episodes - have) * args.ep_len
                                   if have < args.episodes else 0,
                                   bc_steps=args.train_steps)
    return out_all


if __name__ == "__main__":
    print(json.dumps({m: {key: s[key] for key in ("artifact", "shipped", "stage_seconds")}
                      for m, s in main().items()}))
