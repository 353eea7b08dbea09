"""The port's vision networks, vision cost and policy zoo against the JAX
package, on the CPU.

One module-scoped JAX program, jitted once: the flax networks applied to
seeded inputs (`CostCNN` and `CubePosCNN` of mpc/vision_cost.py, the zoo's
`bc_pixels_cnn`, example 12's `CNNPolicy`) with weights drawn by numpy in
flax's layout, each at an even and an odd frame size (flax pads SAME
asymmetrically: (0, 1) on an even side at stride 2, (1, 1) on an odd one);
`make_vision_cost` on K = 8 seeded rollout states; and `load_policy` of
the four shipped artifacts on three seeded states each. The port carries
the same weights (`cost_cnn_from_flax`, `cube_pos_cnn_from_flax`,
`cnn_policy_from_flax`, the zoo's loader).

Bands: the networks rtol 1e-4, atol 1e-5; the vision cost the same; the
zoo's controls 1e-4 of the ctrl range (bc_mlp) and 1e-3 (bc_pixels, which
also renders its frame).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from gym_kmanip_tpu import zoo as jzoo
from gym_kmanip_tpu.dynamics.state import SimState as JSimState
from gym_kmanip_tpu.models import get_model as jax_model
from gym_kmanip_tpu.mpc import vision_cost as jvc
from gym_kmanip_tpu.render import raycast as jr

from gym_kmanip_torch import zoo
from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.mpc import vision_cost as vc

torch.set_num_threads(1)

jex12 = importlib.import_module("gym_kmanip_tpu.examples.12_train_vec_rl")
ex12 = importlib.import_module("gym_kmanip_torch.examples.12_train_vec_rl")

ACT = 7
# name: (flax module, input shapes, input dtype)
NETS = {
    "cost_even": (jvc.CostCNN(), [(2, 40, 60, 3)], np.float32),
    "cost_odd": (jvc.CostCNN(), [(2, 13, 17, 3)], np.float32),
    "cost_frame": (jvc.CostCNN(), [(13, 17, 3)], np.float32),  # unbatched: a scalar
    "cube_pos_even": (jvc.CubePosCNN(), [(2, 64, 96, 3)], np.float32),
    "cube_pos_odd": (jvc.CubePosCNN(), [(2, 15, 21, 3)], np.float32),
    "bc_pixels_odd": (jzoo._bc_pixels_cnn(10, hidden=32), [(2, 15, 21, 3), (2, 20)], np.float32),
    "cnn_policy_even": (jex12.CNNPolicy(ACT), [(2, 32, 32, 3)], np.uint8),
    "cnn_policy_odd": (jex12.CNNPolicy(ACT), [(2, 13, 11, 3)], np.uint8),
}
K_COST = 8
COST_HW = (12, 15)
POLICIES = ("bc_pick_solo", "bc_pick_dual", "bc_pick_torso", "bc_pixels_solo")


def _inputs(shapes, dtype, rng):
    if dtype == np.uint8:
        return [rng.integers(0, 256, s).astype(np.uint8) for s in shapes]
    return [rng.uniform(0, 1, s).astype(np.float32) for s in shapes]


def _flax_params(net, inputs, rng):
    """Weights in flax's layout, drawn by numpy: kernels ~ N(0, 1 / fan_in),
    biases ~ N(0, 0.1); the shapes from flax's own init, traced only."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, s):
        if path[-1].key == "bias":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        if path[-1].key == "log_std":
            return rng.normal(-0.7, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _states(model, n, rng):
    """n seeded states as a numpy SimState batch."""
    return dict(
        qpos=(model.home_qpos + rng.uniform(-0.3, 0.3, (n, model.nq))).astype(np.float32),
        qvel=rng.normal(0, 0.3, (n, model.nq)).astype(np.float32),
        ctrl=np.tile(model.home_qpos[: model.nu].astype(np.float32), (n, 1)),
        cube_pos=rng.uniform([0.1, 0.5, 0.6], [0.3, 0.7, 0.7], (n, 3)).astype(np.float32),
        cube_quat=np.tile(np.float32([1.0, 0, 0, 0]), (n, 1)),
        cube_linvel=np.zeros((n, 3), np.float32), cube_angvel=np.zeros((n, 3), np.float32),
        time=np.zeros(n, np.float32))


@pytest.fixture(scope="module")
def jax_refs():
    rng = np.random.default_rng(0)
    nets = {}
    for name, (net, shapes, dtype) in NETS.items():
        inputs = _inputs(shapes, dtype, rng)
        nets[name] = (inputs, _flax_params(net, inputs, rng))
    cost_params = _flax_params(jvc.CostCNN(), [np.zeros(COST_HW + (3,), np.float32)], rng)
    solo = jax_model("solo_arm")
    cost_states = _states(solo, K_COST, rng)
    policies = {name: jzoo.load_policy(name) for name in POLICIES}
    policy_states = {name: _states(jax_model(meta["model"]), 3, rng)
                     for name, (_, meta) in policies.items()}
    cost_fn = jvc.make_vision_cost(solo, cost_params, "top", *COST_HW)

    def refs(nets, cost_params, cost_states, policy_states):
        out = {name: NETS[name][0].apply(p, *x) for name, (x, p) in nets.items()}
        out["vision_cost"] = jax.vmap(lambda s: cost_fn(JSimState(**s), None, None))(cost_states)
        out["cost_frames"] = jax.vmap(lambda s: jr.render_camera(
            solo, "top", s["qpos"], s["cube_pos"], s["cube_quat"], *COST_HW))(cost_states)
        for name, (policy, _) in policies.items():
            out[name] = jax.vmap(lambda s: policy(JSimState(**s)))(policy_states[name])
        return out

    out = jax.jit(refs)(nets, cost_params, cost_states, policy_states)
    return dict(nets=nets, cost_params=cost_params, cost_states=cost_states,
                policy_states=policy_states, out=jax.tree.map(np.asarray, out))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["cost_even", "cost_odd", "cost_frame"])
def test_cost_cnn_matches_flax(jax_refs, name):
    (x,), params = jax_refs["nets"][name]
    net = vc.cost_cnn_from_flax(params, device="cpu")
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
    want = jax_refs["out"][name]
    assert got.shape == want.shape == x.shape[:-3]
    _close(got, want)


@pytest.mark.parametrize("name", ["cube_pos_even", "cube_pos_odd"])
def test_cube_pos_cnn_matches_flax(jax_refs, name):
    (x,), params = jax_refs["nets"][name]
    with torch.no_grad():
        got = vc.cube_pos_cnn_from_flax(params, device="cpu")(torch.as_tensor(x)).numpy()
    _close(got, jax_refs["out"][name])


def test_bc_pixels_cnn_matches_flax_at_an_odd_size(jax_refs):
    (img, proprio), params = jax_refs["nets"]["bc_pixels_odd"]
    with torch.no_grad():
        got = zoo.bc_pixels_cnn_from_flax(params)(torch.as_tensor(img), torch.as_tensor(proprio))
    _close(got.numpy(), jax_refs["out"]["bc_pixels_odd"])


@pytest.mark.parametrize("name,hw", [("cnn_policy_even", (32, 32)), ("cnn_policy_odd", (13, 11))])
def test_cnn_policy_matches_flax(jax_refs, name, hw):
    (x,), params = jax_refs["nets"][name]
    policy = ex12.cnn_policy_from_flax(params, hw=hw)
    with torch.no_grad():
        mean, log_std, value = policy(torch.as_tensor(x))
    want = jax_refs["out"][name]
    for g, w in zip((mean, log_std, value), want):
        _close(g.detach().numpy(), w)


def test_vision_cost_matches_jax(jax_refs, monkeypatch):
    """make_vision_cost on K = 8 rollout states: one render call of the
    batch and one network call. A frame may differ from JAX's by one level
    at a pixel (test_torch_render.py), and the network carries that into
    the cost: the costs of frames equal to JAX's are held at the band, and
    every cost on JAX's own frames."""
    net = vc.cost_cnn_from_flax(jax_refs["cost_params"], device="cpu")
    model = get_model("solo_arm")
    cost_fn = vc.make_vision_cost(model, net, "top", *COST_HW)
    state = SimState(**{key: torch.as_tensor(v) for key, v in jax_refs["cost_states"].items()})
    got = cost_fn(state, None, None).numpy()
    want, frames = jax_refs["out"]["vision_cost"], jax_refs["out"]["cost_frames"]
    assert got.shape == (K_COST,)
    mine = vc.render_camera(model, "top", state.qpos, state.cube_pos, state.cube_quat,
                            *COST_HW).numpy()
    diff = np.abs(mine.astype(np.int32) - frames.astype(np.int32))
    assert diff.max() <= 1
    same = np.all(diff == 0, axis=(1, 2, 3))
    assert same.sum() >= K_COST // 2
    _close(got[same], want[same])
    monkeypatch.setattr(vc, "render_camera", lambda *a: torch.as_tensor(np.array(frames)))
    _close(cost_fn(state, None, None).numpy(), want)


@pytest.mark.parametrize("name", POLICIES)
def test_zoo_policy_matches_jax(jax_refs, name):
    policy, meta = zoo.load_policy(name, device="cpu")
    model = get_model(meta["model"])
    states = jax_refs["policy_states"][name]
    batch = SimState(**{key: torch.as_tensor(v) for key, v in states.items()})
    got = policy(batch).numpy()  # one call for the three states
    span = model.ctrl_range[:, 1] - model.ctrl_range[:, 0]
    tol = 1e-3 if meta["arch"] == "bc_pixels_cnn" else 1e-4
    want = jax_refs["out"][name]
    assert got.shape == want.shape == (3, model.nu)
    assert np.all(np.abs(got - want) <= tol * span), np.abs(got - want).max(axis=0) / span
    # an unbatched state gives the same control as its row of the batch
    one = policy(SimState(*(x[1] for x in batch))).numpy()
    np.testing.assert_allclose(one, got[1], rtol=0, atol=1e-6)


def test_zoo_artifacts_round_trip_and_refuse_stale_formats(tmp_path):
    assert zoo.list_policies() == tuple(sorted(POLICIES))
    art = zoo.load_artifact("bc_pick_solo")
    assert art.meta["arch"] == "bc_mlp" and art.meta["format_version"] == 1
    path = str(tmp_path / "copy.npz")
    zoo.save_policy(path, art.params, art.stats, art.meta)
    again = zoo.load_artifact(path)
    assert again.meta == art.meta
    for key in art.stats:
        np.testing.assert_array_equal(again.stats[key], art.stats[key])
    np.testing.assert_array_equal(again.params["params"]["Dense_3"]["kernel"],
                                  art.params["params"]["Dense_3"]["kernel"])
    stale = str(tmp_path / "stale.npz")
    np.savez(stale, meta=np.asarray('{"arch": "bc_mlp", "format_version": 0}'))
    with pytest.raises(ValueError, match="format"):
        zoo.load_artifact(stale)
    with pytest.raises(FileNotFoundError):
        zoo.load_artifact("no_such_policy")
    with pytest.raises(ValueError, match="unknown arch"):
        zoo.save_policy(path, art.params, art.stats, {"arch": "resnet"})


def test_vision_mppi_solve_scores_rollouts_with_the_vision_cost():
    """make_mppi_solver with make_vision_cost (example 10's recipe at H = 3,
    K = 8, the top camera at 12 x 15) on the K1 route (engine.substep): the
    solve's J is the least of `rollout`'s totals for the same candidates
    under the same cost, and u0 is that candidate's first control."""
    from gym_kmanip_torch.dynamics.state import init_state
    from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
    from gym_kmanip_torch.mpc.rollout import rollout

    model = get_model("solo_arm")
    cost = vc.make_vision_cost(model, vc.init_cost_params(0, *COST_HW, device="cpu"), "top",
                               *COST_HW)
    cfg = MPPIConfig(horizon=3, n_samples=8, n_iters=1, noise_beta=0.9)
    state = init_state(model, cube_pos=np.array([0.15, 0.58, 0.62]), device="cpu")
    ms = init_mppi(model, cfg, seed=0, device="cpu")
    eps = torch.as_tensor(np.random.default_rng(2).normal(0, 0.05, (8, 3, model.nu)),
                          dtype=torch.float32)
    _, u0, J = make_mppi_solver(model, cfg, cost)(ms, state, eps=eps)
    lo, hi = (torch.as_tensor(model.ctrl_range[:, i], dtype=torch.float32) for i in (0, 1))
    cand = torch.clamp(ms.nominal[None] + torch.cat([torch.zeros_like(eps[:1]), eps[1:]]), lo, hi)
    cand[1] = ms.nominal  # slot 1: the previous iteration's average, the nominal at first
    totals, _ = rollout(model, state, cand, cost)
    assert bool(torch.isfinite(totals).all()) and float(totals.std()) > 0
    assert float(J) == float(totals.min())
    assert torch.equal(u0, cand[int(torch.argmin(totals))][0])
