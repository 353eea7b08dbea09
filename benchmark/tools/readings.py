"""The comparison's readings over many seeds in one process, for setting
its limits: the program's, the control's (the reference in TF32 in the
program's place) and a planted fault's, at the cell's own size.

    python3 benchmark/tools/readings.py --workload <cell> --side program \
        --seeds 1 2 3 --seconds 3 [--out chiprun_out/readings.jsonl]

`--side` is `program`, `control` or `fault:<name>` (harness/faults.py).
Prints one JSON line a seed, then each number's largest and smallest
reading over the seeds. Each line also holds other statistics of the
totals' gaps (`gaps`: per checked solve the largest, the 99.9th, 99th and
90th percentiles over its rollouts, each then the largest and the median
over the solves; the five largest gaps of the run), for choosing what
`totals` reads. The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]

import torch  # noqa: E402

from harness import faults, manifest, runner  # noqa: E402


def gap_stats(rel):
    """Statistics of the (R, K) gaps of the totals, or None."""
    if rel is None:
        return None
    out = {}
    for name, q in (("max", None), ("p999", 0.999), ("p99", 0.99), ("p90", 0.9)):
        per_solve = rel.amax(1) if q is None else torch.quantile(rel, q, dim=1)
        out[f"{name}.max"] = float(per_solve.max())
        out[f"{name}.median"] = float(torch.quantile(per_solve, 0.5))
    out["top5"] = [float(v) for v in torch.topk(rel.flatten(), min(5, rel.numel())).values]
    return out


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--side", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    a = p.parse_args(argv)
    cell = manifest.load_cell(a.workload)
    system = "control" if a.side == "control" else "program"
    plant = (faults.plant(a.side.split(":", 1)[1]) if a.side.startswith("fault:")
             else contextlib.nullcontext())
    rows = []
    with plant:
        for seed in a.seeds:
            detail = {}
            r = runner.run_cell(cell, seed, a.seconds, False, a.device, system=system,
                                limits=False, warmup=1 if system == "control" else None,
                                detail=detail)
            row = dict(workload=a.workload, side=a.side, seed=seed, solves=r.solves,
                       checked=r.checked, found=r.found, gaps=gap_stats(detail.get("totals")))
            print(json.dumps(row), flush=True)
            rows.append(row)
            if a.device == "cuda":
                torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for name in rows[0]["found"]:
        vals = [r["found"][name] for r in rows if name in r["found"]]
        print(f"{a.workload} {a.side} {name}: max {max(vals)!r} min {min(vals)!r} over "
              f"{len(vals)} seeds")


if __name__ == "__main__":
    main(sys.argv[1:])
