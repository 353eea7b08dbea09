"""Trace example 14's pick-from-pixels episodes on the card, for a replay
against the JAX package on the CPU (tools/replay_pixels_episodes.py).

    PYTHONPATH=. python tools/trace_pixels_episodes.py OUT.npz [--golden] [--defaults]
        [--device cpu --set ep_len=3 n_samples=8 ...]

Runs `run()` of gym_kmanip_torch/examples/14_pick_from_pixels.py as
chip_smoke.py's learning phase runs it (TF32 off, cuDNN's deterministic
algorithms): at the JAX slow test's sizes (tests/test_pick_from_pixels.py:
2 episodes of 90 steps, K=128, an estimator of 256 frames and 800 steps,
seed 0), or at run()'s defaults (--defaults: 5 episodes of 120 steps,
K=256, 512 frames, 1,500 steps). The estimator fits on the torch
generator's draws of the seed, or on the JAX test's own draws and initial
weights (--golden: tests/golden/pixels_estimator_draws.npz).

OUT.npz holds, per episode e: every solve's belief state, nominal, u0 and
J (`e{e}/solve/...`), every plant and belief control step's state in and
out and its touch flags (`e{e}/plant/...`, `e{e}/belief/...`), and, at
every 10th solve, the solve again with noise drawn from a seeded CPU
generator (`e{e}/probe/...`: eps, u0, J); and the estimator's weights
(`net/...`) and the spawns. The last line of its output is one JSON object
with the run's result. Imports no JAX.
"""

import argparse
import importlib
import json
import os
import time

import numpy as np
import torch

from gym_kmanip_torch import zoo

ex14 = importlib.import_module("gym_kmanip_torch.examples.14_pick_from_pixels")

TEST = dict(n_episodes=2, ep_len=90, n_samples=128, est_samples=256, est_steps=800, seed=0)
DEFAULTS = dict(n_episodes=5, ep_len=120, n_samples=256, est_samples=512, est_steps=1500, seed=0)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests", "golden",
                      "pixels_estimator_draws.npz")
PROBE_EVERY = 10
STATE = ("qpos", "qvel", "ctrl", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel", "time")


def golden_draws():
    """((qs, cubes, idx), flax params) of the JAX test's estimator fit."""
    with np.load(GOLDEN) as d:
        params = zoo._unflatten_params({key[2:]: d[key] for key in d.files
                                        if key.startswith("p:")})
        return (d["qs"], d["cubes"], d["idx"].astype(np.int64)), params


def host(x):
    return x.detach().cpu().numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--golden", action="store_true")
    ap.add_argument("--defaults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=INT",
                    help="override run()'s sizes (a small run on the CPU)")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    cfg = dict(DEFAULTS if args.defaults else TEST)
    cfg.update({kv.split("=")[0]: int(kv.split("=")[1]) for kv in args.set})
    rec = {"solves": [], "steps": [], "net": None}

    fit = ex14.fit_cube_pos_estimator

    def traced_fit(*a, **kw):
        if args.golden:
            kw["draws"], kw["init"] = golden_draws()
        net, estimate = fit(*a, **kw)
        rec["net"] = {name: host(v) for name, v in net.state_dict().items()}
        return net, estimate

    make_solver = ex14.make_mppi_solver

    def traced_make_solver(model, mcfg, cost_fn):
        solve = make_solver(model, mcfg, cost_fn)
        probe_gen = torch.Generator().manual_seed(1234)

        def traced(ms, belief):
            n = len(rec["solves"])
            out = solve(ms, belief)
            row = dict(nominal=host(ms.nominal), u0=host(out[1]), J=host(out[2]),
                       **{f"belief_{f}": host(getattr(belief, f)) for f in STATE})
            if (n % cfg["ep_len"]) % PROBE_EVERY == 0:
                eps = torch.randn((mcfg.n_iters, mcfg.n_samples, mcfg.horizon, model.nu),
                                  generator=probe_gen) * 0.1
                _, u0, J = solve(ms, belief, eps=eps.to(belief.qpos.device))
                row.update(probe_eps=eps.numpy(), probe_u0=host(u0), probe_J=host(J))
            rec["solves"].append(row)
            return out

        return traced

    make_step = ex14.make_control_step

    def traced_make_step(model):
        step = make_step(model)
        role = "plant" if len(rec["steps"]) % 2 == 0 else "belief"
        rows = []
        rec["steps"].append((role, rows))

        def traced(state, u):
            out, aux = step(state, u)
            rows.append(dict(u=host(u), touch_r=host(aux.touch_r), touch_l=host(aux.touch_l),
                             touch_table=host(aux.touch_table),
                             **{f"in_{f}": host(getattr(state, f)) for f in STATE},
                             **{f"out_{f}": host(getattr(out, f)) for f in STATE}))
            return out, aux

        return traced

    ex14.fit_cube_pos_estimator = traced_fit
    ex14.make_mppi_solver = traced_make_solver
    ex14.make_control_step = traced_make_step
    lines = []
    t0 = time.perf_counter()
    rate, est_err = ex14.run(log=lines.append, device=args.device, **cfg)
    seconds = time.perf_counter() - t0
    for ln in lines:
        print(ln)

    out, lifted = {}, []
    for name, v in rec["net"].items():
        out[f"net/{name}"] = v
    n_ep = cfg["n_episodes"]
    for e in range(n_ep):
        solves = rec["solves"][e * cfg["ep_len"]:(e + 1) * cfg["ep_len"]]
        for key in solves[0]:
            if key.startswith("probe_"):
                out[f"e{e}/probe/{key[6:]}"] = np.stack([r[key] for r in solves if key in r])
            else:
                out[f"e{e}/solve/{key}"] = np.stack([r[key] for r in solves])
        out[f"e{e}/probe/t"] = np.array([t for t, r in enumerate(solves) if "probe_u0" in r])
        for role, rows in rec["steps"][2 * e:2 * e + 2]:
            for key in rows[0]:
                out[f"e{e}/{role}/{key}"] = np.stack([r[key] for r in rows])
        spawn_z = out[f"e{e}/plant/in_cube_pos"][0, 2]
        lifted.append(bool(np.any(out[f"e{e}/plant/out_cube_pos"][:, 2] > spawn_z + ex14.LIFT_DZ)))
    out["config"] = np.array(json.dumps(dict(cfg, golden=args.golden)))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **out)
    card = torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu"
    print(json.dumps(dict(config=dict(cfg, golden=args.golden), rate=rate, est_err=est_err,
                          lifted=lifted, seconds=seconds, device=card)))


if __name__ == "__main__":
    main()
