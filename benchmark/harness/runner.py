"""One run of one cell: set up, warm up, measure for `--seconds`, trace a
segment if asked, check the outputs against the reference, and assemble
the result line.

The window: the system solves back to back; each solve is timed on the
host clock from the call of `solve` until its first control is on the
host (`u0.cpu()`), and the next starts at once. The warm start carries
from solve to solve. Every solve of the window counts in the rate and in
the tail. With `trace`, a segment of `trace_solves` more solves follows
the window under the profiler; the per-layer metrics read it, the window's
host spans and the tapped counters. A traced run also compares K2's
launches, in the trace and by the wrapper's count, with the segment's
solves times the iterations of each (`k2_launches_off`, limit 0): K2's
metrics are per solve and its work is per launch of one iteration.
"""

import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Optional

import torch

from reference import model as rmodel

from . import check, guard, manifest, traffic
from . import trace as tr
from .systems import K2_KERNEL, SYSTEMS, solve_config


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "not read"


def k2_launches_off(trace, counted: Optional[int], want: int) -> float:
    """How far K2's launches in the trace and by the wrapper's count (None:
    not counted, a miss) lie from `want`, one a solve iteration."""
    in_trace = len(trace.kernels(K2_KERNEL))
    print(f"K2 launches: {in_trace} in the trace, {counted} counted by the wrapper, {want} "
          f"solve iterations", file=sys.stderr)
    return float(abs(in_trace - want) + abs((0 if counted is None else counted) - want))


def _solve_one(system, i, seeds, keep=False):
    start = system.prepare(i, traffic.noise_seed(seeds, i), keep)
    t0 = time.perf_counter()
    u0, J = system.solve(start)
    t1 = time.perf_counter()
    u0h = u0.cpu()
    t2 = time.perf_counter()
    return u0h, J, t0, t1, t2


def run_cell(cell, seed: int, seconds: float, trace: bool, device, system: str = "program",
             limits: bool = True, warmup: Optional[int] = None,
             detail: Optional[dict] = None) -> SimpleNamespace:
    """Run the cell once. Returns the run: its metrics' inputs, the
    comparison's readings (`found`) and, with `limits`, the verdict.
    `detail` is handed to `check.readings`."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    robot = rmodel.load(cell.config["robot"])
    cfg = solve_config(cell)
    sd = traffic.seeds(seed)
    pool = traffic.start_pool(robot, cell.traffic, sd.states, dev)
    sysm = SYSTEMS[system](cell, robot, dev)
    sysm.bind(pool)

    warmup = int(cell.traffic["warmup_solves"]) if warmup is None else warmup
    for i in range(warmup):  # every shape the window uses
        _solve_one(sysm, i, sd)
    sysm.reset()
    if on_card:
        torch.cuda.synchronize()

    res = traffic.Reservoir(sd.sample, int(cell.traffic["check_solves"]))
    sample = [None] * res.size
    first = None
    lat, host = [], []
    nonfinite = 0
    setup_s = process_age_s()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    t2 = t_start
    while i == 0 or t2 < t_end:
        slot = res.slot(i)
        keep = i == 0 or slot is not None
        nominal_in = sysm.nominal if keep else None
        u0h, J, t0, t1, t2 = _solve_one(sysm, i, sd, keep)
        lat.append(t2 - t0)
        host.append(t1 - t0)
        if not bool(torch.isfinite(u0h).all()):
            nonfinite += 1
        if keep:
            rec = check.Record(i, None if i == 0 else nominal_in, u0h, J, sysm.nominal,
                               sysm.totals)
            if i == 0:
                first = rec
            else:
                sample[slot] = rec
        i += 1
    window_s = t2 - t_start
    solves = i

    out = SimpleNamespace(cell=cell, seed=seed, robot=robot, cfg=cfg, solves=solves,
                          window_s=window_s, latencies_s=lat, host_s=host, setup_s=setup_s,
                          nonfinite=nonfinite, trace=None, trace_solves=0, k2_launches=None,
                          k2_launches_off=None,
                          power=None, memory_peak_bytes=0, device_name=str(dev))
    if trace:
        n = int(cell.traffic["trace_solves"])
        before = sysm.k2_launches()

        def segment():
            for j in range(solves, solves + n):
                _solve_one(sysm, j, sd)

        out.trace = tr.profile(segment) if on_card else None
        after = sysm.k2_launches()
        out.trace_solves = n
        out.k2_launches = None if before is None else after - before
        if out.trace is not None:
            out.k2_launches_off = k2_launches_off(out.trace, out.k2_launches, n * cfg.n_iters)
        out.power = power_limit() if on_card else None
    if on_card:
        torch.cuda.synchronize()
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
        out.device_name = torch.cuda.get_device_name(dev)

    sysm.close()
    del sysm
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    records = [first] + [r for r in sample if r is not None]
    with torch.no_grad():
        out.found = check.readings(cell, robot, records, pool, sd, dev, detail)
    out.found["nonfinite"] = float(nonfinite)
    exact = {"nonfinite": 0.0}
    if out.k2_launches_off is not None:
        out.found["k2_launches_off"] = out.k2_launches_off
        exact["k2_launches_off"] = 0.0
    out.checked = len(records)
    if limits:
        out.correct, out.rows = check.judge(out.found, {**cell.limits, **exact})
    return out


def result_line(run, trace: bool) -> dict:
    """The JSON object the run prints last: correct, attempted, failed,
    metrics, device, the breakdown with `trace`, and the numbers compared
    with their limits, last."""
    entries = run.cell.per_layer if trace else run.cell.end_to_end
    metrics = {}
    for m in entries:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": run.device_name, "count": run.cell.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": bool(run.correct), "attempted": run.solves, "failed": run.nonfinite,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s()
        out["breakdown"] = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    out["checked"] = {name: {"value": v, "limit": lim} for name, v, lim in run.rows}
    return out


def main(argv) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    cell = manifest.load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {cell.chips} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    run = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda")
    found = guard.jax_modules()
    if found:
        print(f"JAX was loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(run, bool(a.trace))
    if run.power is not None:
        print(f"card and power limit: {run.power}", file=sys.stderr)
    print(f"{run.solves} solves in {run.window_s:.3f} s, {run.checked} checked "
          f"(seed {a.seed}, {run.cell.name})", file=sys.stderr)
    for name, v, lim in run.rows:
        print(f"{name} {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0
