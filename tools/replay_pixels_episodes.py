"""Replay pick-from-pixels episodes traced on the card
(tools/trace_pixels_episodes.py) through the JAX package and the port on
the CPU, and report where they part.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/replay_pixels_episodes.py TRACE.npz [--solves N]

For each episode of TRACE.npz:
  1. one step: every recorded plant and belief control step (the card's
     state in and control) through JAX's `control_step` and the port's on
     the CPU, against the card's state out;
  2. free run: the plant from the episode's first state under the card's
     control sequence, through each, against the card's plant step by step:
     the first step at which each parts from the card's by more than 1 mm
     (cube) or 1e-3 rad (qpos), and whether each lifts the cube;
  3. the cost: example 14's `make_cost` in JAX and in the port on each
     belief step's state out and aux, as each steps it;
  4. the estimator: the card's estimates (the first belief and every
     refresh while the hand is clear) against the traced weights in flax
     on JAX's frame and in the port on the port's CPU frame, flax against
     the port on the same frame, and JAX's frame against the port's;
  5. the solve, after 1-4 for every episode: at each episode's first N
     (default 1) probe steps (the card's solve with noise
     from a seeded CPU generator), the port's solve on the CPU with that
     noise against the card's u0 and J, and the port's solve with JAX's
     own noise (its key split, then sample_noise) against JAX's solve.
Prints one JSON object per episode and part.
"""

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

STATE = ("qpos", "qvel", "ctrl", "cube_pos", "cube_quat", "cube_linvel", "cube_angvel", "time")
CUBE_MM, QPOS_RAD = 1e-3, 1e-3


def state_at(tr, key, t):
    return {f: tr[f"{key}_{f}"][t] for f in STATE}


def flax_tree(state_dict):
    """The port's CubePosCNN weights as flax's CubePosCNN parameters."""
    tree = {}
    for i, name in enumerate(("conv0", "conv1", "conv2")):
        tree[f"Conv_{i}"] = dict(kernel=state_dict[f"{name}.weight"].transpose(2, 3, 1, 0),
                                 bias=state_dict[f"{name}.bias"])
    for i, name in enumerate(("dense0", "dense1")):
        tree[f"Dense_{i}"] = dict(kernel=state_dict[f"{name}.weight"].T,
                                  bias=state_dict[f"{name}.bias"])
    return {"params": tree}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--solves", type=int, default=1)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from gym_kmanip_tpu.dynamics.engine import make_control_step as jmake_control_step
    from gym_kmanip_tpu.dynamics.state import SimState as JSimState
    from gym_kmanip_tpu.models import get_model as jget_model
    from gym_kmanip_tpu.mpc import mppi as jmppi
    from gym_kmanip_tpu.mpc.vision_cost import CubePosCNN as JCubePosCNN
    from gym_kmanip_tpu.render.raycast import render_camera as jrender_camera
    from gym_kmanip_torch.dynamics.engine import make_control_step
    from gym_kmanip_torch.dynamics.state import SimState
    from gym_kmanip_torch.models import get_model
    from gym_kmanip_torch.mpc import mppi
    from gym_kmanip_torch.mpc import vision_cost as vc
    from gym_kmanip_torch.render.raycast import render_camera

    torch.set_num_threads(4)
    jex14 = importlib.import_module("gym_kmanip_tpu.examples.14_pick_from_pixels")
    ex14 = importlib.import_module("gym_kmanip_torch.examples.14_pick_from_pixels")
    data = dict(np.load(args.trace))
    cfg = json.loads(str(data["config"]))
    jm, m = jget_model("solo_arm"), get_model("solo_arm")
    jstep, step = jax.jit(jmake_control_step(jm)), make_control_step(m)
    jcost_fn, cost_fn = jex14.make_cost(jm), ex14.make_cost(m)
    jcost = jax.jit(lambda s, u: (lambda s2, aux: (s2, aux, jcost_fn(s2, aux, u)))(*jstep(s, u)))

    def jstate(d):
        return JSimState(**{f: jnp.asarray(d[f], jnp.float32) for f in STATE})

    def tstate(d):
        return SimState(**{f: torch.as_tensor(np.asarray(d[f], np.float32)) for f in STATE})

    def gap(a, b):
        return {f: float(np.max(np.abs(np.asarray(getattr(a, f), np.float64) - b[f])))
                for f in ("qpos", "qvel", "cube_pos", "cube_quat")}

    def report(**kw):
        print(json.dumps(kw), flush=True)

    sd = {k[4:]: v for k, v in data.items() if k.startswith("net/")}
    jnet, jparams = JCubePosCNN(), flax_tree(sd)
    net = vc.CubePosCNN(ex14.H_PX, ex14.W_PX)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    spawn = np.asarray(ex14.k.CUBE_SPAWN_RANGE, np.float32)
    smid, shalf = (spawn[:, 0] + spawn[:, 1]) / 2, np.maximum((spawn[:, 1] - spawn[:, 0]) / 2, 1e-3)
    jest = jax.jit(lambda img: jnet.apply(jparams, img) * shalf + smid)
    jframe = jax.jit(lambda q, c, cq: jrender_camera(jm, jex14.CAM, q, c, cq, jex14.H_PX,
                                                     jex14.W_PX))

    def episode(e):
        tr = {k.split("/", 2)[1] + "_" + k.split("/", 2)[2]: v for k, v in data.items()
              if k.startswith(f"e{e}/")}
        return tuple({k[len(role) + 1:]: v for k, v in tr.items() if k.startswith(role + "_")}
                     for role in ("plant", "belief", "solve", "probe"))

    n_ep = cfg["n_episodes"]
    for e in range(n_ep):
        plant, belief, solve, _ = episode(e)
        T = plant["u"].shape[0]
        spawn_z = float(plant["in_cube_pos"][0, 2])

        # 1. one step from the card's states, plant and belief
        for role, rec in (("plant", plant), ("belief", belief)):
            worst_j, worst_t = {}, {}
            for t in range(T):
                want = state_at(rec, "out", t)
                s2j, _ = jstep(jstate(state_at(rec, "in", t)), jnp.asarray(rec["u"][t]))
                with torch.no_grad():
                    s2t, _ = step(tstate(state_at(rec, "in", t)), torch.as_tensor(rec["u"][t]))
                for name, s2 in (("jax", s2j), ("port_cpu", s2t)):
                    g = gap(s2, want)
                    for f, v in g.items():
                        key = f"{name}/{f}"
                        if v >= worst_j.get(key, -1.0):
                            worst_j[key], worst_t[key] = v, t
            report(episode=e, part=f"one step, {role}", steps=T,
                   card_against={k: [worst_j[k], worst_t[k]] for k in sorted(worst_j)})

        # 2. free run of the plant under the card's controls
        sj, st = jstate(state_at(plant, "in", 0)), tstate(state_at(plant, "in", 0))
        parted = {"jax": None, "port_cpu": None}
        final, top = {}, {"card": float(plant["out_cube_pos"][:, 2].max()), "jax": -1e9,
                          "port_cpu": -1e9}
        for t in range(T):
            sj, _ = jstep(sj, jnp.asarray(plant["u"][t]))
            with torch.no_grad():
                st, _ = step(st, torch.as_tensor(plant["u"][t]))
            want = state_at(plant, "out", t)
            for name, s in (("jax", sj), ("port_cpu", st)):
                g = gap(s, want)
                top[name] = max(top[name], float(np.asarray(s.cube_pos)[2]))
                if parted[name] is None and (g["cube_pos"] > CUBE_MM or g["qpos"] > QPOS_RAD):
                    parted[name] = dict(step=t, **g)
                final[name] = g
        j_vs_t = gap(sj, {f: np.asarray(getattr(st, f), np.float64) for f in STATE})
        report(episode=e, part="free run, plant", steps=T, parted_from_card=parted,
               final_gap_to_card=final, final_gap_jax_port_cpu=j_vs_t,
               lifted={k: v > spawn_z + ex14.LIFT_DZ for k, v in top.items()},
               highest_cube_z=top, spawn_z=spawn_z)

        # 3. the cost on each belief step
        worst = [0.0, 0.0, -1]
        for t in range(T):
            _, _, jc = jcost(jstate(state_at(belief, "in", t)), jnp.asarray(belief["u"][t]))
            with torch.no_grad():
                s2, aux = step(tstate(state_at(belief, "in", t)), torch.as_tensor(belief["u"][t]))
                c = float(cost_fn(s2, aux, torch.as_tensor(belief["u"][t])))
            d = abs(c - float(jc))
            if d >= worst[0]:
                worst = [d, d / max(abs(float(jc)), 1e-12), t]
        report(episode=e, part="make_cost on the belief steps", steps=T,
               worst_abs=worst[0], worst_rel=worst[1], at_step=worst[2])

        # 4. the estimator at the first belief and every refresh
        refresh = [(-1, state_at(plant, "in", 0), solve["belief_cube_pos"][0])]
        for t in range(T - 1):
            if np.any(solve["belief_cube_pos"][t + 1] != belief["out_cube_pos"][t]):
                refresh.append((t, state_at(plant, "out", t), solve["belief_cube_pos"][t + 1]))
        gaps = {"jax_frame_flax": [], "port_frame_port": [], "flax_vs_port_same_frame": [],
                "jax_vs_port_frame_levels": [], "jax_vs_port_pixels_over_1": [],
                "card_err_to_true": []}
        for _, s, card_est in refresh:
            img_j = np.asarray(jframe(jnp.asarray(s["qpos"], jnp.float32),
                                      jnp.asarray(s["cube_pos"], jnp.float32),
                                      jnp.asarray(s["cube_quat"], jnp.float32)))
            with torch.no_grad():
                ts = tstate(s)
                img_t = render_camera(m, ex14.CAM, ts.qpos, ts.cube_pos, ts.cube_quat,
                                      ex14.H_PX, ex14.W_PX).numpy()
                est_t = (net(torch.as_tensor(img_t).float() / 255.0) * torch.as_tensor(shalf)
                         + torch.as_tensor(smid)).numpy()
            est_j = np.asarray(jest(jnp.asarray(img_j, jnp.float32) / 255.0))
            est_jt = np.asarray(jest(jnp.asarray(img_t, jnp.float32) / 255.0))
            levels = np.abs(img_j.astype(int) - img_t.astype(int)).max(axis=-1)
            gaps["jax_frame_flax"].append(float(np.max(np.abs(est_j - card_est))))
            gaps["port_frame_port"].append(float(np.max(np.abs(est_t - card_est))))
            gaps["flax_vs_port_same_frame"].append(float(np.max(np.abs(est_jt - est_t))))
            gaps["jax_vs_port_frame_levels"].append(int(levels.max()))
            gaps["jax_vs_port_pixels_over_1"].append(int(np.sum(levels > 1)))
            gaps["card_err_to_true"].append(float(np.linalg.norm(card_est - s["cube_pos"])))
        worst = int(np.argmax(gaps["port_frame_port"]))
        report(episode=e, part="estimator", refreshes=len(refresh),
               refresh_steps=[t for t, _, _ in refresh][:12],
               card_against={k: max(v) for k, v in gaps.items()
                             if k not in ("card_err_to_true", "jax_vs_port_pixels_over_1")},
               frames_with_a_pixel_over_1_level=int(np.sum(
                   np.asarray(gaps["jax_vs_port_pixels_over_1"]) > 0)),
               at_worst_port_gap=dict(step=refresh[worst][0],
                                      **{k: v[worst] for k, v in gaps.items()}),
               card_err_to_true_m=dict(first=gaps["card_err_to_true"][0],
                                       mean=float(np.mean(gaps["card_err_to_true"])),
                                       max=max(gaps["card_err_to_true"])))

    # 5. the solve at the first probe steps of each episode
    mcfg = mppi.MPPIConfig(horizon=cfg.get("horizon", 20), n_samples=cfg["n_samples"],
                           n_iters=2, sigma=0.15, n_substeps=10, dt=ex14.k.PHYSICS_TIMESTEP,
                           noise_beta=0.9)
    jcfg = jmppi.MPPIConfig(horizon=mcfg.horizon, n_samples=mcfg.n_samples, n_iters=2,
                            sigma=0.15, n_substeps=10, dt=ex14.k.PHYSICS_TIMESTEP,
                            noise_beta=0.9)
    solver, jsolver = mppi.make_mppi_solver(m, mcfg, cost_fn), jax.jit(
        jmppi.make_mppi_solver(jm, jcfg, jcost_fn))
    sigma = jmppi.sigma_per_actuator(jm, jcfg.sigma)
    for e in range(n_ep):
        _, _, solve, probe = episode(e)
        for i, t in enumerate(probe["t"][:args.solves]):
            s = state_at(solve, "belief", t)
            nominal = torch.as_tensor(solve["nominal"][t])
            ms = mppi.MPPIState(nominal=nominal, generator=torch.Generator())
            with torch.no_grad():
                _, u0, J = solver(ms, tstate(s), eps=torch.as_tensor(probe["eps"][i]))
            jms = jmppi.MPPIState(nominal=jnp.asarray(solve["nominal"][t]),
                                  rng=jax.random.PRNGKey(int(t)))
            t0 = time.time()
            _, ju0, jJ = jsolver(jms, jstate(s))
            ju0.block_until_ready()
            jax_s = time.time() - t0
            rng, draws = jms.rng, []
            for _ in range(2):
                rng, sub = jax.random.split(rng)
                draws.append(np.array(jmppi.sample_noise(sub, jcfg.n_samples, jcfg.horizon,
                                                         jm.nu, sigma, jcfg.noise_beta)))
            with torch.no_grad():
                _, pu0, pJ = solver(ms, tstate(s), eps=torch.as_tensor(np.stack(draws)))
            report(episode=e, part="solve", step=int(t),
                   card_probe_vs_port_cpu=dict(u0=float(np.max(np.abs(u0.numpy()
                                                                      - probe["u0"][i]))),
                                               J=float(abs(float(J) - float(probe["J"][i])))),
                   jax_vs_port_cpu_on_jax_noise=dict(
                       u0=float(np.max(np.abs(pu0.numpy() - np.asarray(ju0)))),
                       J=float(abs(float(pJ) - float(jJ))), J_jax=float(jJ)),
                   jax_solve_s_with_compile=jax_s)


if __name__ == "__main__":
    main()
