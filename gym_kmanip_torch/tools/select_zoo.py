"""Best-of-N training draws on a fixed dataset, shipped on the card.

Port of the JAX package's `tools/select_zoo.py`. BC retraining is a
stochastic draw (a closed-loop spread of ~+-0.1 on identical data): this
tool trains `--seeds` networks, selects on a 24-episode eval, evaluates the
winner again on a fresh 48-episode set, and ships it through train_zoo's
never-regress guard into `--out-dir`. Everything runs on the card unless
`--device cpu`.

    python -m gym_kmanip_torch.tools.select_zoo --data-dir <dir> [--seeds 5]
"""

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.tools.train_zoo import (
    ARTIFACT_NAME, Stages, add_common_args, device_name, example, reload_check, ship)

# the selection eval, and the fresh one the shipped number comes from
# (48 episodes, ~0.07 binomial sigma)
SELECT_EVALS, EVALS = 24, 48


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="solo_arm", choices=sorted(ARTIFACT_NAME))
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--train-steps", type=int, default=15000)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--ep-len", type=int, default=160)
    ap.add_argument("--force", action="store_true",
                    help="ship even if below the incumbent's rate (use when the new eval "
                         "protocol is stricter than the old)")
    ap.add_argument("--dagger-slice", default=":",
                    help="numpy slice of the saved dagger buffer, e.g. "
                         "'7200:14400' or '0:0' for none")
    add_common_args(ap)
    return ap


def main(argv: Optional[list] = None, log=print) -> Dict:
    args = parser().parse_args(argv)
    device = canonical_device(args.device)
    bc = example(13)
    quiet = lambda *a: None  # noqa: E731
    stages = Stages(device)
    dagger_path = os.path.join(args.data_dir, "dagger_labels.npz")
    extra = None
    if os.path.exists(dagger_path):
        with np.load(dagger_path) as d:
            lo, _, hi = args.dagger_slice.partition(":")
            sl = slice(int(lo) if lo else None, int(hi) if hi else None)
            X, Y = d["X"][sl], d["Y"][sl]
        extra = (X, Y) if X.shape[0] else None
        log(f"{X.shape[0]} dagger labels (slice {args.dagger_slice}) + expert episodes")

    best = (-1.0, None)
    for seed in range(args.seeds):
        policy, net, stats = stages.run(
            "train", bc.train, args.data_dir, n_steps=args.train_steps, model_name=args.model,
            extra_data=extra, hidden=args.hidden, depth=args.depth, seed=seed, log=quiet,
            device=device)
        r = stages.run("selection_eval", bc.evaluate, policy, n_evals=SELECT_EVALS,
                       ep_len=args.ep_len, model_name=args.model, spawn_range=bc.SPAWN_RANGE,
                       seed=7777, log=quiet, device=device)
        log(f"seed {seed}: selection eval {r:.2f}")
        if r > best[0]:
            best = (r, (policy, net, stats))
    sel, (policy, net, stats) = best
    # the shipped number comes from a fresh eval on a seed never used for
    # selection: a selection-seed number would carry the winner's curse
    rate = stages.run("eval", bc.evaluate, policy, n_evals=EVALS, ep_len=args.ep_len,
                      model_name=args.model, spawn_range=bc.SPAWN_RANGE, seed=4242, log=quiet,
                      device=device)
    log(f"winner: selection {sel:.2f}, fresh {EVALS}-episode eval {rate:.2f}")
    out = os.path.join(args.out_dir, f"{ARTIFACT_NAME[args.model]}.npz")
    meta = dict(
        arch="bc_mlp", model=args.model, hidden=args.hidden, depth=args.depth,
        trained_by="gym_kmanip_torch/tools/select_zoo.py", device=device_name(device),
        selection_seeds=int(args.seeds), eval_success_rate=float(rate),
        eval_episodes=EVALS, eval_ep_len=int(args.ep_len), eval_seed=4242,
        spawn_range=[list(map(float, r_)) for r_ in bc.SPAWN_RANGE], lift_dz=float(bc.LIFT_DZ),
    )
    shipped = ship(out, net, stats, meta, force=args.force, log=log)
    if shipped:
        log(f"saved {out}: bc {rate:.2f}")
        meta = reload_check(out, policy, args.model, bc.SPAWN_RANGE.mean(axis=1), device, 1e-6)
    return dict(artifact=out, shipped=shipped, meta=meta, selection_eval=sel,
                stage_seconds=stages.seconds, bc_steps=args.seeds * args.train_steps)


if __name__ == "__main__":
    summary = main()
    print(json.dumps({key: summary[key] for key in ("artifact", "shipped", "stage_seconds")}))
