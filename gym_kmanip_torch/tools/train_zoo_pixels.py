"""Train and ship the pixels-BC zoo artifact (bc_pixels_solo) on the card.

Port of the JAX package's `tools/train_zoo_pixels.py`: on the state
pipeline's dataset (train_zoo's expert episodes and DAgger labels), render
the frames again, train example 15's CNN policy, evaluate it closed loop
over the full spawn range, and ship it with its provenance through
train_zoo's never-regress guard into `--out-dir`. Everything runs on the
card unless `--device cpu`.

    python -m gym_kmanip_torch.tools.train_zoo_pixels --data-dir <train_zoo's data dir>
"""

import argparse
import json
import os
from typing import Dict, Optional

from gym_kmanip_torch.models import canonical_device
from gym_kmanip_torch.tools.train_zoo import (
    Stages, add_common_args, device_name, example, reload_check, ship)

NAME = "bc_pixels_solo"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--train-steps", type=int, default=8000)
    ap.add_argument("--evals", type=int, default=16)
    ap.add_argument("--eval-len", type=int, default=120)
    add_common_args(ap)
    return ap


def main(argv: Optional[list] = None, log=print) -> Dict:
    args = parser().parse_args(argv)
    device = canonical_device(args.device)
    px, bc = example(15), example(13)
    quiet = lambda *a: None  # noqa: E731
    stages = Stages(device)
    policy, net, stats = stages.run("train", px.train, args.data_dir, n_steps=args.train_steps,
                                    log=quiet, device=device)
    rate = stages.run("eval", bc.evaluate, policy, n_evals=args.evals, ep_len=args.eval_len,
                      spawn_range=bc.SPAWN_RANGE, log=quiet, device=device)
    out = os.path.join(args.out_dir, f"{NAME}.npz")
    meta = dict(
        arch="bc_pixels_cnn", model="solo_arm", hidden=256, cam=px.CAM, img_h=px.H_PX,
        img_w=px.W_PX, trained_by="gym_kmanip_torch/tools/train_zoo_pixels.py",
        device=device_name(device), data_dir_episodes=True, eval_success_rate=float(rate),
        eval_episodes=int(args.evals), eval_ep_len=int(args.eval_len),
        spawn_range=[list(map(float, r)) for r in bc.SPAWN_RANGE], lift_dz=float(bc.LIFT_DZ),
    )
    shipped = ship(out, net, stats, meta, log=log)
    if shipped:
        log(f"saved {out}: pixels bc {rate:.2f}")
        meta = reload_check(out, policy, "solo_arm", bc.SPAWN_RANGE.mean(axis=1), device, 1e-5)
        log(f"reload check OK (eval_success_rate {meta['eval_success_rate']})")
    return dict(artifact=out, shipped=shipped, meta=meta, stage_seconds=stages.seconds,
                bc_steps=args.train_steps)


if __name__ == "__main__":
    summary = main()
    print(json.dumps({key: summary[key] for key in ("artifact", "shipped", "stage_seconds")}))
