"""Pick from pixels: grasp and lift with the cube's state taken only from
rendered camera frames.

Port of `gym_kmanip_tpu/examples/14_pick_from_pixels.py`:

  * a CubePosCNN estimator (`vision_cost.fit_cube_pos_estimator`) is fit
    self-supervised on top-camera renders of random (arm, cube) pairs;
  * at control time the controller never reads the plant's cube state:
    its belief holds proprioception (qpos, qvel, as encoders give them) and
    a cube pose from the estimator while the hand is clear of the cube,
    dead-reckoned through the controller's own dynamics model once the
    hand is within OCCLUDE_DIST of it;
  * example 8's MPPI pick solve runs on the belief; success is judged on
    the true plant (the cube >= 4 cm above its spawn), which the controller
    never sees.

Each episode starts from the same nominal and the same generator state
(`mppi.rewinder`), as the JAX example starts each from one immutable
MPPIState.

    python -m gym_kmanip_torch.examples.14_pick_from_pixels
"""

import json
import time

import numpy as np
import torch

from gym_kmanip_torch import constants as k
from gym_kmanip_torch.dynamics.engine import make_control_step
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import canonical_device, get_model
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver, rewinder
from gym_kmanip_torch.mpc.vision_cost import fit_cube_pos_estimator
from gym_kmanip_torch.ops import kinematics as kin
from gym_kmanip_torch.render.raycast import render_camera

H_PX, W_PX = 64, 96
CAM = "top"
LIFT_DZ = 0.04
# hand-to-belief-cube distance below which the camera's view of the cube
# counts as occluded and the belief dead-reckons
OCCLUDE_DIST = 0.10


def make_cost(model):
    def cost_fn(s, aux, u):
        d2 = torch.sum((aux.tip_pos - s.cube_pos[..., None, :]) ** 2, dim=-1)
        touched = aux.touch_r | aux.touch_l
        return (
            50.0 * d2.mean(dim=-1)
            + 0.01 * torch.sum(s.qvel ** 2, dim=-1)
            - torch.where(touched, 5.0, 0.0)
            - torch.where(touched & ~aux.touch_table, 10.0, 0.0)
        )

    return cost_fn


def run_episode(model, solver, mppi_state, estimate, spawn, ep_len=120, n_samples=256,
                log=print, device="cuda"):
    """One pixels-only pick episode. Returns (lifted, est_err_m)."""
    device = canonical_device(device)
    plant_step = make_control_step(model)  # the true plant
    belief_step = make_control_step(model)  # the controller's model
    true_state = init_state(model, cube_pos=spawn, device=device)
    zero3 = torch.zeros(3, device=device)

    def observe_cube(state):
        img = render_camera(model, CAM, state.qpos, state.cube_pos, state.cube_quat,
                            H_PX, W_PX).float() / 255.0
        return estimate(img)

    def ee_pos_of(state):
        xp, xq, _ = kin.fk(model, state.qpos)
        return kin.site_pose(model, xp, xq, "eer_site")[0]

    # the first belief: proprioception and the vision estimate, cube at rest
    est0 = observe_cube(true_state)
    est_err = float(torch.linalg.vector_norm(est0 - true_state.cube_pos))
    belief = true_state._replace(
        cube_pos=est0, cube_quat=torch.tensor([1.0, 0, 0, 0], device=device),
        cube_linvel=zero3, cube_angvel=zero3)

    lifted = False
    for t in range(ep_len):
        mppi_state, u0, J = solver(mppi_state, belief)
        # the true plant advances (the controller never reads its cube)
        true_state, _ = plant_step(true_state, u0)
        # the belief advances through the controller's own model;
        # proprioception is the plant's (encoders), the cube stays the model's
        belief, _ = belief_step(belief, u0)
        belief = belief._replace(qpos=true_state.qpos, qvel=true_state.qvel)
        hand_dist = float(torch.linalg.vector_norm(ee_pos_of(belief) - belief.cube_pos))
        if hand_dist > OCCLUDE_DIST:
            # the hand is clear of the cube: the belief's cube from pixels
            belief = belief._replace(cube_pos=observe_cube(true_state), cube_linvel=zero3,
                                     cube_angvel=zero3)
        true_z = float(true_state.cube_pos[2])
        lifted = lifted or true_z > float(spawn[2]) + LIFT_DZ
        if t % 20 == 0:
            err = float(torch.linalg.vector_norm(belief.cube_pos - true_state.cube_pos))
            log(f"  t={t}: belief-cube err {err:.3f} m, true cube_z={true_z:.3f}, "
                f"hand_dist={hand_dist:.3f}")
    return lifted, est_err


def run(n_episodes=5, ep_len=120, n_samples=256, est_samples=512, est_steps=1500, seed=0,
        log=print, horizon=20, device="cuda"):
    """(success rate, mean initial estimator error in m) over n_episodes
    spawns drawn from RandomState(seed + 1) around example 8's spawn."""
    device = canonical_device(device)
    model = get_model("solo_arm")
    log("training the cube-position estimator on renders...")
    t0 = time.time()
    _net, estimate = fit_cube_pos_estimator(
        model, seed=seed, n_samples=est_samples, n_steps=est_steps, height=H_PX, width=W_PX,
        cam_name=CAM, device=device)
    log(f"estimator trained in {time.time() - t0:.1f}s")

    cfg = MPPIConfig(horizon=horizon, n_samples=n_samples, n_iters=2, sigma=0.15, n_substeps=10,
                     dt=k.PHYSICS_TIMESTEP, noise_beta=0.9)
    solver = make_mppi_solver(model, cfg, make_cost(model))
    start = rewinder(init_mppi(model, cfg, device=device))

    rng = np.random.RandomState(seed + 1)
    spawn_lo, spawn_hi = k.CUBE_SPAWN_RANGE[:, 0], k.CUBE_SPAWN_RANGE[:, 1]
    n_lift, errs = 0, []
    for ep in range(n_episodes):
        spawn = np.array([0.15, 0.58, 0.62]) + rng.uniform(-1, 1, 3) * np.array([0.02, 0.02, 0.0])
        spawn = np.clip(spawn, spawn_lo, spawn_hi)
        lifted, est_err = run_episode(model, solver, start(), estimate, spawn, ep_len=ep_len,
                                      n_samples=n_samples, log=log, device=device)
        n_lift += int(lifted)
        errs.append(est_err)
        log(f"episode {ep}: lifted={lifted} (initial estimate err {est_err * 100:.1f} cm, "
            f"spawn {spawn.round(3)})")
    return n_lift / n_episodes, float(np.mean(errs))


def main(device="cuda"):
    rate, est_err = run(device=device)
    print(json.dumps({"metric": "pixels_pick_success_rate", "value": rate,
                      "unit": "fraction", "vs_baseline": rate}))
    print(json.dumps({"metric": "cube_estimator_err_m", "value": est_err,
                      "unit": "m", "vs_baseline": est_err / 0.01}))
    return rate, est_err


if __name__ == "__main__":
    main()
