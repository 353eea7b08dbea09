"""Run the port's zoo training tool on a GPU host that has no h5py, and
report it.

`gym_kmanip_torch/tools/train_zoo.py` records its expert episodes through
the HDF5 logger. Where h5py does not import, this script first puts in
chip_smoke.py's in-memory stand-in of h5py.File (the logger's schema, held
in memory), then runs train_zoo's `main` with the arguments given, and
prints the card's name and power limit (nvidia-smi), the wall seconds by
stage, the expert's solves/s (record and DAgger, plant steps included),
BC steps/s, the K1 launches, and the eval success rate beside the rate in
the shipped artifact's meta.

    PYTHONPATH=. python tools/train_zoo_on_card.py --model solo_arm --episodes 16 \\
        --dagger-rounds 1 --dagger-episodes 8 --evals 16 --out-dir zoo_out
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from gym_kmanip_torch import zoo  # noqa: E402
from gym_kmanip_torch.ops import substep_cuda  # noqa: E402
from gym_kmanip_torch.tools import train_zoo  # noqa: E402


def main(argv):
    _, stand_in = chip_smoke.h5py_stand_in()
    card = chip_smoke.card_line()
    args = train_zoo.parser().parse_args(argv)
    substep_cuda.substep_batched.launches = 0
    t0 = time.perf_counter()
    summary = train_zoo.main(argv)
    wall = time.perf_counter() - t0
    sec = summary["stage_seconds"]
    shipped_rate = zoo.load_artifact(train_zoo.ARTIFACT_NAME[args.model]).meta[
        "eval_success_rate"]
    report = dict(
        card=card, torch=torch.__version__, h5py="stand-in" if stand_in else "h5py",
        argv=argv, wall_s=wall, stage_seconds=sec, expert_solves=summary["expert_solves"],
        expert_solves_per_s=summary["expert_solves"] / (sec.get("record", 0.0)
                                                        + sec.get("dagger", 0.0)),
        bc_steps=summary["bc_steps"], bc_steps_per_s=summary["bc_steps"] / sec["train"],
        k1_launches=substep_cuda.substep_batched.launches,
        selection_eval=summary["selection_eval"],
        eval_success_rate=summary["meta"]["eval_success_rate"],
        expert_success_rate=summary["meta"]["expert_success_rate"],
        shipped_meta_rate=shipped_rate, shipped=summary["shipped"], artifact=summary["artifact"])
    print(json.dumps(report))


if __name__ == "__main__":
    main(sys.argv[1:])
