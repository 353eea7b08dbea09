"""The port's learning path against the JAX package, on the CPU.

The JAX references are the flax / optax update math only: no JAX program
here holds a render or a substep. The frames are the port's own renders at
12 x 16 and 16 x 24, fed to both sides; every draw (poses, cubes,
weights, optimizer moments, minibatch indices) is numpy's, from a seed.

- (a) `utils/optim`'s two schedules against optax's, counts 0..n+1,
  rel 1e-6.
- (b) Two full-batch CostCNN steps and two CubePosCNN minibatch steps of
  the fits (`optim.mse_step` on the exponential decay, lr 3e-3), (c) one
  BC-MLP step of example 13
  (cosine decay) and one BCPixelsCNN step of example 15 (constant lr),
  each from an Adam state carried from optax (count 3, drawn moments) on
  carried flax parameters: losses rel 1e-5; parameters, mu and nu atol
  1e-6. One module-scoped jit computes every JAX step.
- (d) Example 6's flat checkpoint both ways, with JAX's `ravel_pytree`
  run eagerly: bit for bit.
- (e) `log/log_h5py` against the JAX package's writer on the same info and
  steps (numpy both), a camera included: every dataset and attr equal.
- (f) `KManipEnv(log_h5py=True)` through gym.make: the ACT schema of
  tests/test_logging.py:18-41.
- (g) Port-only end-to-end runs at K <= 8, H <= 3: both fits (a finite loss
  that falls), examples 10, 13 (record -> _load -> dagger_collect -> train
  -> evaluate), 14, 15, 6 and 7 (the checkpoint and the heuristic).
- (h) Example 14's episodes start from one generator state.
"""

import glob
import importlib
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from gym_kmanip_tpu import constants as jk
from gym_kmanip_tpu import zoo as jzoo
from gym_kmanip_tpu.log import log_h5py as jlog
from gym_kmanip_tpu.mpc import vision_cost as jvc

from gym_kmanip_torch import constants as tk
from gym_kmanip_torch import zoo
from gym_kmanip_torch.log import log_h5py
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.mpc import vision_cost as vc
from gym_kmanip_torch.utils import optim

from torch_optim_carry import adam_state, draw_moments, load_adam_state

torch.set_num_threads(1)


def _example(name):
    return importlib.import_module(f"gym_kmanip_torch.examples.{name}")


jex6 = importlib.import_module("gym_kmanip_tpu.examples.6_train_from_dataset")
ex6, ex13, ex14, ex15 = (_example(n) for n in ("6_train_from_dataset", "13_bc_pick",
                                               "14_pick_from_pixels", "15_bc_pixels"))

COUNT = 3  # the carried optimizer's count
COST_HW, POS_HW = (12, 16), (16, 24)
N_FRAMES, BATCH = 6, 4
N_FIT = 8  # the fits' n_steps: transition_steps 2
N_BC, HIDDEN = 10, 32


def _flax_params(net, inputs, rng):
    """Weights in flax's layout, drawn by numpy (kernels ~ N(0, 1 / fan_in),
    biases ~ N(0, 0.1)); the shapes from flax's init, traced only."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, s):
        if path[-1].key == "bias":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _frames(rng, hw):
    """Port renders of seeded poses and cubes: (frames in [0, 1], qs, cubes)."""
    model = get_model("solo_arm")
    qs = (model.home_qpos + rng.uniform(-0.4, 0.4, (N_FRAMES, model.nq))).astype(np.float32)
    cubes = rng.uniform(tk.CUBE_SPAWN_RANGE[:, 0], tk.CUBE_SPAWN_RANGE[:, 1],
                        (N_FRAMES, 3)).astype(np.float32)
    imgs = vc._frames(model, "top", torch.as_tensor(qs), torch.as_tensor(cubes), *hw)
    return imgs.numpy(), qs, cubes


def _carried(tx, params, mu, nu):
    """An optax Adam state of COUNT updates with moments mu and nu."""
    adam, sched = tx.init(params)
    adam = adam._replace(count=jnp.int32(COUNT), mu={"params": mu}, nu={"params": nu})
    if "count" in getattr(sched, "_fields", ()):
        sched = sched._replace(count=jnp.int32(COUNT))
    return adam, sched


@pytest.fixture(scope="module")
def cases():
    """Each network's carried parameters, optimizer state, data and the
    JAX steps' outputs (one jit)."""
    rng = np.random.default_rng(11)
    model = get_model("solo_arm")
    out = {}
    imgs, qs, cubes = _frames(rng, COST_HW)
    xp, xq, _ = vc.kin.fk(model, torch.as_tensor(qs))
    ee, _ = vc.kin.site_pose(model, xp, xq, "eer_site")
    dists = torch.linalg.vector_norm(ee - torch.as_tensor(cubes), dim=-1).numpy()
    out["cost"] = dict(net=jvc.CostCNN(), args=(imgs, dists),
                       sched=optax.exponential_decay(3e-3, max(N_FIT // 4, 1), 0.5),
                       params=_flax_params(jvc.CostCNN(), [imgs[0]], rng))
    imgs, qs, cubes = _frames(rng, POS_HW)
    spawn = tk.CUBE_SPAWN_RANGE.astype(np.float32)
    mid, half = (spawn[:, 0] + spawn[:, 1]) / 2, np.maximum((spawn[:, 1] - spawn[:, 0]) / 2, 1e-3)
    out["cube_pos"] = dict(net=jvc.CubePosCNN(), args=(imgs, (cubes - mid) / half),
                           idx=rng.integers(0, N_FRAMES, (2, BATCH)),
                           sched=optax.exponential_decay(3e-3, max(N_FIT // 4, 1), 0.5),
                           params=_flax_params(jvc.CubePosCNN(), [imgs[:1]], rng))
    X = rng.normal(size=(20, 27)).astype(np.float32)
    Y = rng.uniform(-1, 1, (20, 10)).astype(np.float32)
    net = jzoo._bc_mlp(10, hidden=HIDDEN, depth=2)
    out["bc_mlp"] = dict(net=net, args=(X, Y), idx=rng.integers(0, 20, (1, BATCH)),
                         sched=optax.cosine_decay_schedule(1e-3, N_BC),
                         params=_flax_params(net, [X[:1]], rng))
    frames = rng.integers(0, 256, (8,) + POS_HW + (3,)).astype(np.uint8)
    P = rng.normal(size=(8, 20)).astype(np.float32)
    Yp = rng.uniform(-1, 1, (8, 10)).astype(np.float32)
    net = jzoo._bc_pixels_cnn(10, hidden=HIDDEN)
    out["bc_pixels"] = dict(net=net, args=(frames, P, Yp), idx=rng.integers(0, 8, (1, BATCH)),
                            sched=1e-3, params=_flax_params(
                                net, [frames[:1].astype(np.float32), P[:1]], rng))
    for case in out.values():
        case["mu"], case["nu"] = draw_moments(case["params"], rng)
        case["tx"] = optax.adam(case["sched"])
        case["opt"] = _carried(case["tx"], case["params"], case["mu"], case["nu"])

    def loss_fns():
        # the JAX package's losses: vision_cost.py:124-127 and :218-221,
        # examples/13_bc_pick.py:260-262, examples/15_bc_pixels.py:112-115
        c, p_, b, x = (out[n]["net"] for n in ("cost", "cube_pos", "bc_mlp", "bc_pixels"))
        return dict(
            cost=lambda p, imgs, d, idx: jnp.mean(
                (jax.vmap(lambda im: c.apply(p, im))(imgs) - d) ** 2),
            cube_pos=lambda p, imgs, t, idx: jnp.mean((p_.apply(p, imgs[idx]) - t[idx]) ** 2),
            bc_mlp=lambda p, X, Y, idx: jnp.mean((b.apply(p, X[idx]) - Y[idx]) ** 2),
            bc_pixels=lambda p, im, P, Y, idx: jnp.mean(
                (x.apply(p, im[idx].astype(jnp.float32) / 255.0, P[idx]) - Y[idx]) ** 2))

    fns = loss_fns()
    n_steps = {"cost": 2, "cube_pos": 2, "bc_mlp": 1, "bc_pixels": 1}

    def refs(state):
        res = {}
        for name, (params, opt, args, idx) in state.items():
            tx, steps = out[name]["tx"], []
            for i in range(n_steps[name]):
                loss, grads = jax.value_and_grad(fns[name])(
                    params, *args, None if idx is None else idx[i])
                upd, opt = tx.update(grads, opt)
                params = optax.apply_updates(params, upd)
                steps.append(dict(loss=loss, params=params["params"], mu=opt[0].mu["params"],
                                  nu=opt[0].nu["params"]))
            res[name] = steps
        return res

    state = {n: (c["params"], c["opt"], c["args"], c.get("idx")) for n, c in out.items()}
    res = jax.tree.map(np.asarray, jax.jit(refs)(state))
    for name, case in out.items():
        case["want"] = res[name]
    return out


def _port(name, case):
    """The port's network and optimizer at the carried state."""
    params = case["params"]
    if name == "cost":
        net = vc.cost_cnn_from_flax(params, device="cpu")
        lr = optim.exponential_decay(3e-3, max(N_FIT // 4, 1), 0.5)
    elif name == "cube_pos":
        net = vc.cube_pos_cnn_from_flax(params, device="cpu")
        lr = optim.exponential_decay(3e-3, max(N_FIT // 4, 1), 0.5)
    elif name == "bc_mlp":
        net, lr = zoo.bc_mlp_from_flax(params), optim.cosine_decay_schedule(1e-3, N_BC)
    else:
        net, lr = zoo.bc_pixels_cnn_from_flax(params), 1e-3
    opt = optim.adam(net.parameters(), lr)
    load_adam_state(*opt, net, COUNT, case["mu"], case["nu"])
    return net, opt


def _port_step(name, net, opt, case, i):
    """`optim.mse_step` on the inputs the port's loop gives it: the whole
    batch (fit_distance_cost), a minibatch (fit_cube_pos_estimator and
    example 13's train), a minibatch of uint8 frames normalized to [0, 1]
    (example 15's train)."""
    args = [torch.as_tensor(a) for a in case["args"]]
    if name == "cost":
        imgs, dists = args
        return optim.mse_step(net, *opt, dists, imgs)
    idx = torch.as_tensor(case["idx"][i])
    if name == "bc_pixels":
        frames, P, Y = args
        return optim.mse_step(net, *opt, Y[idx], frames[idx].float() / 255.0, P[idx])
    x, y = args
    return optim.mse_step(net, *opt, y[idx], x[idx])


def _hold(name, net, opt, case, i, loss):
    want = case["want"][i]
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5, err_msg=name)
    count, mu, nu, params = adam_state(opt[0], net)
    assert count == COUNT + i + 1
    for tree, ref in ((params, want["params"]), (mu, want["mu"]), (nu, want["nu"])):
        for layer, leaves in ref.items():
            for leaf, w in leaves.items():
                np.testing.assert_allclose(tree[layer][leaf], w, rtol=0, atol=1e-6,
                                           err_msg=f"{name} {layer}/{leaf} step {i}")


@pytest.mark.parametrize("name,exact", [
    ("exponential_decay", (3e-3, 2, 0.5)), ("exponential_decay", (1e-2, 7, 0.3)),
    ("cosine_decay_schedule", (1e-3, 10)), ("cosine_decay_schedule", (5e-4, 3))])
def test_schedules_match_optax(name, exact):
    n = exact[1]
    port, ref = getattr(optim, name)(*exact), getattr(optax, name)(*exact)
    for count in range(n + 2):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6, err_msg=count)


@pytest.mark.parametrize("name", ["cost", "cube_pos"])
def test_fit_steps_match_optax(cases, name):
    """Two Adam steps of each fit: the full-batch CostCNN step and the
    CubePosCNN minibatch step, on the exponential decay at optax's count."""
    case = cases[name]
    net, opt = _port(name, case)
    for i in range(2):
        _hold(name, net, opt, case, i, _port_step(name, net, opt, case, i))


@pytest.mark.parametrize("name", ["bc_mlp", "bc_pixels"])
def test_bc_steps_match_optax(cases, name):
    """One step of example 13's BC-MLP (cosine decay) and of example 15's
    BCPixelsCNN (constant lr; uint8 frames normalized per minibatch)."""
    case = cases[name]
    net, opt = _port(name, case)
    _hold(name, net, opt, case, 0, _port_step(name, net, opt, case, 0))


def test_flat_checkpoint_both_ways():
    """Example 6's {flat, obs_dim, act_dim}: JAX's ravel_pytree order
    loads into the port, and the port's flat vector unravels in JAX to the
    port's parameters; example 7's policy on a JAX-written file computes the
    flax MLP (numpy reference)."""
    rng = np.random.default_rng(6)
    obs_dim, act_dim = 20, 7
    params = _flax_params(jex6.PolicyMLP(act_dim=act_dim), [np.zeros((1, obs_dim))], rng)
    flat, unravel = ravel_pytree(params)
    net = ex6.policy_mlp_from_flat(np.asarray(flat), obs_dim, act_dim, device="cpu")
    for i, layer in enumerate(net.layers):
        p = params["params"][f"Dense_{i}"]
        np.testing.assert_array_equal(layer.weight.detach().numpy(), np.asarray(p["kernel"]).T)
        np.testing.assert_array_equal(layer.bias.detach().numpy(), np.asarray(p["bias"]))
    np.testing.assert_array_equal(ex6.policy_mlp_to_flat(net), np.asarray(flat))
    fresh = ex6.policy_mlp(obs_dim, act_dim, seed=3, device="cpu")
    back = unravel(jnp.asarray(ex6.policy_mlp_to_flat(fresh)))["params"]
    for i, layer in enumerate(fresh.layers):
        np.testing.assert_array_equal(np.asarray(back[f"Dense_{i}"]["kernel"]),
                                      layer.weight.detach().numpy().T)
        np.testing.assert_array_equal(np.asarray(back[f"Dense_{i}"]["bias"]),
                                      layer.bias.detach().numpy())
    with pytest.raises(ValueError, match="parameters"):
        ex6.policy_mlp_from_flat(np.asarray(flat)[:-1], obs_dim, act_dim, device="cpu")


def _writer_run(log, k, log_dir, cams):
    """One episode through a writer: new, cam, three steps, end."""
    info = dict(sim=True, episode=2, q_len=4, act_list=["eer_pos", "grip_r"],
                act_dims={"eer_pos": 3, "grip_r": 1}, step=0, q_keys=["a", "b", "c", "d"],
                reward=0.5, cameras=[k.CAMERAS[c] for c in cams], obs_list=["q_pos"])
    rng = np.random.default_rng(3)
    f = log.new(log_dir, info)
    cache = f.id.get_access_plist().get_cache()
    for cam in info["cameras"]:
        log.cam(f, cam)
    for t in range(3):
        info["step"] = t + 1
        obs = {"q_pos": rng.normal(size=4), "q_vel": rng.normal(size=4)}
        for cam in info["cameras"]:
            obs[cam.log_name] = rng.integers(0, 256, (cam.h, cam.w, 3)).astype(np.uint8)
        log.step(f, {"eer_pos": rng.normal(size=3), "grip_r": rng.normal(size=1)}, obs, info)
    log.end(f)
    return os.path.join(log_dir, "episode_2.hdf5"), cache


def _contents(path):
    items = {}
    with h5py.File(path, "r") as f:
        items["/"] = dict(f.attrs)

        def visit(name, obj):
            attrs = dict(obj.attrs)
            if isinstance(obj, h5py.Dataset):
                items[name] = (obj[()], obj.dtype, obj.chunks, attrs)
            else:
                items[name] = attrs
        f.visititems(visit)
    return items


@pytest.mark.parametrize("cams", [(), ("grip_r",)])
def test_h5py_writer_matches_jax(tmp_path, cams):
    runs = []
    for log, k, sub in ((jlog, jk, "jax"), (log_h5py, tk, "port")):
        d = tmp_path / sub
        d.mkdir()
        runs.append(_writer_run(log, k, str(d), cams))
    (want_path, want_cache), (got_path, got_cache) = runs
    assert got_cache == want_cache and got_cache[2] == tk.H5PY_CHUNK_SIZE_BYTES
    want, got = _contents(want_path), _contents(got_path)
    assert sorted(got) == sorted(want)
    assert ("observations/images/grip_r" in got) == bool(cams)
    for name, w in want.items():
        g = got[name]
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], w[0], err_msg=name)
            assert g[1:3] == w[1:3], name
            g, w = g[3], w[3]
        assert sorted(g) == sorted(w), name
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=f"{name}.{key}")


def test_env_log_h5py_writes_the_act_schema(tmp_path, monkeypatch):
    """tests/test_logging.py:18-41 through the port's registered id."""
    gym = pytest.importorskip("gymnasium")
    from gym_kmanip_torch import env

    env.register()
    monkeypatch.setattr(tk, "DATA_DIR", str(tmp_path))
    e = gym.make("gym_kmanip_torch/KManipSoloArm", device="cpu", log_h5py=True, log_prefix="t")
    e.reset(seed=0)
    for _ in range(3):
        e.step(e.action_space.sample())
    e.close()
    files = glob.glob(str(tmp_path / "t.*" / "episode_*.hdf5"))
    assert len(files) == 1
    with h5py.File(files[0], "r") as f:
        assert f["observations/qpos"].shape == (tk.MAX_EPISODE_STEPS, 10)
        assert f["observations/qvel"].shape == (tk.MAX_EPISODE_STEPS, 10)
        assert f["action"].shape == (tk.MAX_EPISODE_STEPS, 7)  # eer_pos 3 + eer_orn 3 + grip_r 1
        assert "metadata" in f and f.attrs["sim"]
        assert np.any(f["observations/qpos"][0] != 0)
        assert np.all(f["observations/qpos"][3] == 0)  # three steps recorded


@pytest.mark.parametrize("fit", ["distance", "cube_pos"])
def test_fits_run_and_lower_the_loss(fit):
    model = get_model("solo_arm")
    losses = []
    if fit == "distance":
        net = vc.fit_distance_cost(model, seed=0, n_samples=8, n_steps=6, height=12, width=16,
                                   cam_name="top", device="cpu", losses=losses)
        assert isinstance(net, vc.CostCNN)
        out = net(torch.zeros(2, 12, 16, 3))
        assert out.shape == (2,)
    else:
        rng = np.random.default_rng(0)
        qs, cubes = vc.draw_examples(model, torch.Generator().manual_seed(1), 8, 0.4)
        idx = rng.integers(0, 8, (6, 4))
        net, estimate = vc.fit_cube_pos_estimator(
            model, seed=0, n_samples=8, n_steps=6, height=16, width=24, batch=4, device="cpu",
            draws=(qs, cubes, idx), losses=losses)
        est = estimate(torch.zeros(2, 5, 16, 24, 3))
        assert est.shape == (2, 5, 3) and bool(torch.isfinite(est).all())
        lo, hi = vc._pose_bounds(model, 0.4)
        assert bool(((qs >= lo) & (qs <= hi)).all())
    assert len(losses) == 6 and np.all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_example_10_vision_mpc(monkeypatch):
    ex10 = _example("10_vision_mpc")
    monkeypatch.setattr(ex10, "H_PX", 12)
    monkeypatch.setattr(ex10, "W_PX", 16)
    out = ex10.main(horizon=2, n_samples=4, n_solves=1, n_closed_loop=2, fit_samples=4,
                    fit_steps=2, device="cpu")
    assert np.isfinite(out["d0"]) and out["dists"].shape == (2,) and np.isfinite(out["J"])


@pytest.fixture(scope="module")
def bc_data(tmp_path_factory):
    """Example 13's record: two expert episodes of 3 steps at K = 8, H = 2,
    with DART kicks, in `<root>/run/` (example 6 reads `<root>/*/`)."""
    root = tmp_path_factory.mktemp("bc")
    rate = ex13.record(str(root / "run"), n_episodes=2, ep_len=3, n_samples=8, horizon=2,
                       noise_p=0.5, log=lambda *a: None, device="cpu")
    return root, rate


def test_example_13_record_load_dagger_train_evaluate(bc_data):
    root, rate = bc_data
    data = str(root / "run")
    assert rate in (0.0, 0.5, 1.0)
    files = sorted(glob.glob(os.path.join(data, "episode_*.hdf5")))
    assert len(files) == 2
    with h5py.File(files[0], "r") as f:
        assert f["observations/cube_pose"].shape == (2 * tk.MAX_EPISODE_STEPS, 7)
        assert int(f.attrs["ep_len"]) == 3 and "expert_lifted" in f.attrs
        assert f["action"].shape == (tk.MAX_EPISODE_STEPS, 10)
        np.testing.assert_allclose(np.linalg.norm(f["observations/cube_pose"][0, 3:]), 1.0, atol=1e-5)
    X, Y = ex13._load(data)
    assert X.shape == (6, 27) and Y.shape == (6, 10)
    policy, net, stats = ex13.train(data, n_steps=4, batch=4, hidden=16, log=lambda *a: None,
                                    device="cpu")
    np.testing.assert_allclose(stats["sd"], X.std(0) + 1e-6)  # population std, as numpy's
    Xd, Yd = ex13.dagger_collect(policy, n_episodes=1, ep_len=2, n_samples=8, horizon=2,
                                 log=lambda *a: None, device="cpu")
    assert Xd.shape == (2, 27) and Yd.shape == (2, 10) and np.all(np.isfinite(Xd))
    policy, _, _ = ex13.train(data, n_steps=2, batch=4, hidden=16, extra_data=(Xd, Yd),
                              log=lambda *a: None, device="cpu")
    lines = []
    assert ex13.evaluate(policy, n_evals=3, ep_len=2, log=lines.append, device="cpu") == 0.0
    rng = np.random.RandomState(100)
    for i, line in enumerate(lines):  # the JAX example's spawns, in order
        assert str(ex13._sample_spawn(rng).round(3)) in line


def test_example_15_trains_on_the_recorded_episodes(bc_data, monkeypatch):
    monkeypatch.setattr(ex15, "H_PX", 12)
    monkeypatch.setattr(ex15, "W_PX", 16)
    root, rate = bc_data
    data = str(root / "run")
    # the lifted episodes (none, one or both) and the DAgger labels
    np.savez(str(root / "run" / "dagger_labels.npz"), X=np.zeros((2, 27), np.float32) + 0.5,
             Y=np.zeros((2, 10), np.float32))
    try:
        qpos, qvel, cube_pose, Y = ex15.load_states(data, get_model("solo_arm"))
        assert qpos.shape[0] == 6 * rate + 2 and cube_pose.shape == (qpos.shape[0], 7)
        policy, net, stats = ex15.train(data, n_steps=3, batch=4, log=lambda *a: None,
                                        device="cpu")
    finally:
        os.remove(str(root / "run" / "dagger_labels.npz"))
    state = ex13.init_state(get_model("solo_arm"), device="cpu")
    u = policy(state)
    assert u.shape == (10,) and bool(torch.isfinite(u).all())
    assert stats["mu"].shape == (20,)


def test_examples_6_and_7_checkpoint_and_heuristic(bc_data, tmp_path):
    pytest.importorskip("gymnasium")
    root, _ = bc_data
    ckpt = str(tmp_path / "policy.npz")
    path, loss = ex6.main(data_dir=str(root), ckpt_path=ckpt, n_steps=3, device="cpu")
    assert path == ckpt and np.isfinite(loss)
    with np.load(ckpt) as c:
        assert int(c["obs_dim"]) == 20 and int(c["act_dim"]) == 10
    ex7 = _example("7_eval_policy")
    # example 6 trained on ctrl actions (10); the env's action is 7 wide,
    # so the BC branch takes a checkpoint of the env's own widths
    env_ckpt = str(tmp_path / "env_policy.npz")
    net = ex6.policy_mlp(20, 7, seed=1, device="cpu")
    np.savez(env_ckpt, flat=ex6.policy_mlp_to_flat(net), obs_dim=20, act_dim=7)
    for path in (env_ckpt, str(tmp_path / "none.npz")):
        results = ex7.main(num_episodes=1, max_steps=2, ckpt_path=path, device="cpu")
        assert len(results) == 1 and np.isfinite(results[0][0])


def test_example_14_pick_from_pixels(monkeypatch):
    monkeypatch.setattr(ex14, "H_PX", 12)
    monkeypatch.setattr(ex14, "W_PX", 16)
    rate, err = ex14.run(n_episodes=1, ep_len=2, n_samples=4, est_samples=4, est_steps=2,
                         horizon=2, log=lambda *a: None, device="cpu")
    assert rate == 0.0 and np.isfinite(err)


def test_example_14_episodes_start_from_one_generator_state(monkeypatch):
    """Both episodes see the same nominal and the same noise stream, as the
    JAX example starts each from one immutable MPPIState."""
    monkeypatch.setattr(ex14, "H_PX", 12)
    monkeypatch.setattr(ex14, "W_PX", 16)
    starts, ends = [], []
    run_episode = ex14.run_episode

    def spy(model, solver, mppi_state, *args, **kwargs):
        starts.append((mppi_state.generator.get_state().clone(), mppi_state.nominal.clone()))
        out = run_episode(model, solver, mppi_state, *args, **kwargs)
        ends.append(mppi_state.generator.get_state().clone())
        return out

    monkeypatch.setattr(ex14, "run_episode", spy)
    ex14.run(n_episodes=2, ep_len=2, n_samples=4, est_samples=4, est_steps=1, horizon=2,
             log=lambda *a: None, device="cpu")
    assert len(starts) == 2
    assert torch.equal(starts[0][0], starts[1][0]) and torch.equal(starts[0][1], starts[1][1])
    assert not torch.equal(ends[0], starts[1][0])  # the episode drew noise


def test_pixels_estimator_draws_are_the_jax_tests():
    """tests/golden/pixels_estimator_draws.npz, the draws chip_smoke.py
    gives example 14's estimator fit, is JAX's at tests/test_pick_from_pixels.py's
    seed: the poses, cubes, initial weights and first minibatches as
    tools/make_golden_learning.py draws them (eagerly), bit for bit; and a
    fit given `init` starts from those weights."""
    from tools.make_golden_learning import draws

    want = draws(n_steps=3)
    golden = os.path.join(os.path.dirname(__file__), "golden", "pixels_estimator_draws.npz")
    with np.load(golden) as d:
        got = {key: d[key] for key in d.files}
    assert sorted(got) == sorted(want) and got["idx"].shape == (800, 128)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key][:3] if key == "idx" else got[key], w, err_msg=key)
    params = zoo._unflatten_params({key[2:]: v for key, v in got.items() if key.startswith("p:")})
    net, _ = vc.fit_cube_pos_estimator(
        get_model("solo_arm"), n_samples=4, n_steps=0, height=64, width=96, device="cpu",
        draws=(got["qs"][:4], got["cubes"][:4], np.zeros((0, 4), np.int64)), init=params)
    np.testing.assert_array_equal(net.dense0.weight.detach().numpy(),
                                  got["p:params/Dense_0/kernel"].T)
