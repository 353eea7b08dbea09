"""Sets of runs of one cell, each run a process of its own as the checks
run them, and the spread of each metric: the distance between the first
and third quartiles (Python's `statistics.quantiles(values, n=4)`) as a
share of the median.

    python3 benchmark/tools/sets.py --workload <cell> --seeds 11 12 13 14 15 16 \
        --sets 2 --seconds 20 [--trace 0] [--out chiprun_out/sets.jsonl]

Every set runs the same seeds, in order. Prints each run's result line and
the spreads of each set; the raw lines go to `--out`.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2, q2


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=20)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out")
    a = p.parse_args(argv)
    results = []
    for s in range(a.sets):
        for seed in a.seeds:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "benchmark/run.py", "--workload", a.workload, "--seed", str(seed),
                 "--seconds", str(a.seconds), "--trace", str(a.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
            row = dict(workload=a.workload, set=s, seed=seed, rc=proc.returncode, wall_s=wall)
            try:
                row["result"] = json.loads(line)
            except json.JSONDecodeError:
                row["stderr"] = proc.stderr[-3000:]
            print(json.dumps(row), flush=True)
            if proc.returncode != 0 or not row.get("result", {}).get("correct", False):
                print(proc.stderr[-3000:], file=sys.stderr, flush=True)
            results.append(row)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    for s in range(a.sets):
        rows = [r["result"] for r in results if r["set"] == s and "result" in r]
        if len(rows) < 2:
            continue
        for name in rows[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in rows if name in r["metrics"]]
            if len(vals) >= 2:
                sp, med = spread(vals)
                print(f"{a.workload} set {s} {name}: median {med!r} spread {sp!r} over {len(vals)} "
                      f"runs (min {min(vals)!r}, max {max(vals)!r})")


if __name__ == "__main__":
    main(sys.argv[1:])
