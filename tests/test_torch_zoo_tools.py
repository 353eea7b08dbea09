"""The zoo's train-and-ship tools of the port (gym_kmanip_torch/tools/
train_zoo.py, train_zoo_all.py, train_zoo_pixels.py, select_zoo.py) on the
CPU at toy sizes, and the artifacts they write against the JAX package's
loader.

One module-scoped toy run of train_zoo (one expert episode of two steps at
K = 4, H = 1, one DAgger round, three BC steps) writes a `bc_pick_solo`
artifact into a temporary --out-dir. The JAX package's `zoo.load_artifact`
must read it with the same arrays and meta as the port's loader, and its
jitted `load_policy` must give the port's actions at 1e-5. The
never-regress guard must keep a better incumbent. The expert's quality is
not measured here: chip_smoke.py runs the pipeline on the card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_kmanip_tpu import zoo as jzoo
from gym_kmanip_tpu.dynamics.state import SimState as JSimState

from gym_kmanip_torch import zoo
from gym_kmanip_torch.dynamics.state import init_state
from gym_kmanip_torch.models import get_model
from gym_kmanip_torch.tools import select_zoo, train_zoo, train_zoo_all, train_zoo_pixels

torch.set_num_threads(1)

TOY = ["--episodes", "1", "--ep-len", "2", "--samples", "4", "--horizon", "1",
       "--dagger-rounds", "1", "--dagger-episodes", "1", "--train-steps", "3", "--evals", "2",
       "--hidden", "8", "--depth", "1", "--device", "cpu"]
META_KEYS = {"arch", "model", "hidden", "depth", "trained_by", "device", "n_expert_episodes",
             "dagger_rounds", "dagger_episodes_per_round", "expert_success_rate",
             "eval_success_rate", "eval_episodes", "eval_ep_len", "spawn_range", "lift_dz",
             "format_version"}


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("zoo_out"))
    data_dir = str(tmp_path_factory.mktemp("zoo_data"))
    lines = []
    summary = train_zoo.main(TOY + ["--out-dir", out_dir, "--data-dir", data_dir],
                             log=lines.append)
    return summary, lines


def _states(n=3):
    rng = np.random.RandomState(2)
    model = get_model("solo_arm")
    states = []
    for _ in range(n):
        s = init_state(model, cube_pos=rng.uniform([0.1, 0.5, 0.6], [0.3, 0.7, 0.7]),
                       device="cpu")
        states.append(s._replace(qpos=s.qpos + torch.as_tensor(
            0.05 * rng.randn(model.nq), dtype=torch.float32)))
    return states


def test_toy_pipeline_writes_a_complete_artifact(toy_run):
    summary, lines = toy_run
    path = summary["artifact"]
    assert summary["shipped"] and os.path.basename(path) == "bc_pick_solo.npz"
    meta = zoo.load_artifact(path).meta
    assert set(meta) == META_KEYS
    assert meta["trained_by"] == "gym_kmanip_torch/tools/train_zoo.py"
    assert (meta["device"], meta["hidden"], meta["depth"], meta["eval_episodes"]) == ("cpu", 8,
                                                                                      1, 2)
    assert 0.0 <= meta["eval_success_rate"] <= 1.0
    # record, train (twice), the selection evals, one DAgger round, the eval
    assert set(summary["stage_seconds"]) == {"record", "train", "selection_eval", "dagger",
                                             "eval"}
    assert summary["expert_solves"] == 2 * 2 and summary["bc_steps"] == 2 * 3
    assert any("reload check OK" in line for line in lines)
    files = os.listdir(summary["data_dir"])
    assert "dagger_labels.npz" in files and "episode_0.hdf5" in files


def test_port_artifact_loads_in_jax(toy_run):
    path = toy_run[0]["artifact"]
    mine, theirs = zoo.load_artifact(path), jzoo.load_artifact(path)
    assert mine.meta == theirs.meta
    assert mine.stats.keys() == theirs.stats.keys()
    for key in mine.stats:
        np.testing.assert_array_equal(mine.stats[key], theirs.stats[key])
    mp, tp = mine.params["params"], theirs.params["params"]
    assert sorted(mp) == sorted(tp) == ["Dense_0", "Dense_1"]
    for layer in mp:
        for leaf in ("kernel", "bias"):
            assert mp[layer][leaf].dtype == np.float32
            np.testing.assert_array_equal(mp[layer][leaf], np.asarray(tp[layer][leaf]))
    policy, _ = zoo.load_policy(path, device="cpu")
    jpolicy, _ = jzoo.load_policy(path)
    for s in _states():
        want = jpolicy(JSimState(*(jnp.asarray(x.numpy()) for x in s)))
        np.testing.assert_allclose(policy(s).numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_never_regress_guard(toy_run, tmp_path):
    path = toy_run[0]["artifact"]
    art = zoo.load_artifact(path)
    net = zoo.bc_mlp_from_flax(art.params)
    out = str(tmp_path / "bc_pick_solo.npz")
    meta = {key: v for key, v in art.meta.items() if key != "format_version"}
    zoo.save_policy(out, art.params, art.stats, dict(meta, eval_success_rate=0.75))
    before = open(out, "rb").read()
    lines = []
    assert not train_zoo.ship(out, net, art.stats, dict(meta, eval_success_rate=0.5),
                              log=lines.append)
    assert open(out, "rb").read() == before and "NOT shipping" in lines[0]
    # an equal or better rate replaces it, and --force replaces a better one
    assert train_zoo.ship(out, net, art.stats, dict(meta, eval_success_rate=0.75))
    assert train_zoo.ship(out, net, art.stats, dict(meta, eval_success_rate=0.25), force=True)
    assert zoo.load_artifact(out).meta["eval_success_rate"] == 0.25


def test_flax_params_round_trip():
    """A fresh net of each architecture through its flax layout and back
    computes the same function; the pixels layout is the JAX package's."""
    mlp = zoo.bc_mlp(10, 16, 2, in_dim=27, seed=3, device="cpu")
    x = torch.randn(4, 27)
    back = zoo.bc_mlp_from_flax(zoo.flax_params(mlp))
    torch.testing.assert_close(back(x), mlp(x), rtol=0, atol=0)
    cnn = zoo.bc_pixels_cnn(10, 16, img_hw=(12, 15), proprio_dim=20, seed=4, device="cpu")
    img, pro = torch.rand(2, 12, 15, 3), torch.randn(2, 20)
    params = zoo.flax_params(cnn)
    back = zoo.bc_pixels_cnn_from_flax(params)
    torch.testing.assert_close(back(img, pro), cnn(img, pro), rtol=0, atol=0)
    shapes = {k: v["kernel"].shape for k, v in params["params"].items()}
    assert shapes["Conv_0"] == (3, 3, 3, 16) and shapes["Dense_1"] == (16 + 20, 16)
    with pytest.raises(TypeError):
        zoo.flax_params(torch.nn.Linear(2, 2))


def test_other_tools_at_toy_sizes(toy_run, tmp_path):
    """select_zoo and train_zoo_pixels on the toy run's dataset, and
    train_zoo_all on the dual arm, each into its own --out-dir."""
    data_dir = toy_run[0]["data_dir"]
    out = str(tmp_path / "select")
    s = select_zoo.main(["--data-dir", data_dir, "--seeds", "1", "--train-steps", "2",
                         "--hidden", "8", "--depth", "1", "--ep-len", "1", "--device", "cpu",
                         "--out-dir", out],
                        log=lambda *a: None)
    assert s["shipped"] and s["meta"]["trained_by"] == "gym_kmanip_torch/tools/select_zoo.py"
    assert s["meta"]["selection_seeds"] == 1 and s["bc_steps"] == 2
    out = str(tmp_path / "pixels")
    s = train_zoo_pixels.main(["--data-dir", data_dir, "--train-steps", "2", "--evals", "1",
                               "--eval-len", "1", "--device", "cpu", "--out-dir", out],
                              log=lambda *a: None)
    assert s["shipped"] and os.path.basename(s["artifact"]) == "bc_pixels_solo.npz"
    meta = zoo.load_artifact(s["artifact"]).meta
    assert (meta["arch"], meta["cam"], meta["img_h"], meta["img_w"]) == ("bc_pixels_cnn", "top",
                                                                       64, 96)
    out, root = str(tmp_path / "all"), str(tmp_path / "data")
    s = train_zoo_all.main(["--models", "dual_arm", "--episodes", "1", "--ep-len", "1",
                            "--samples", "4", "--horizon", "1", "--train-steps", "2",
                            "--evals", "1", "--eval-len", "1", "--data-root", root,
                            "--device", "cpu", "--out-dir", out],
                           log=lambda *a: None)["dual_arm"]
    assert s["shipped"] and s["meta"]["spawn_note"] == "full reference CUBE_SPAWN_RANGE"
    assert os.listdir(os.path.join(root, "dual_arm")) == ["episode_0.hdf5"]


@pytest.mark.parametrize("tool", [train_zoo, train_zoo_all, train_zoo_pixels, select_zoo])
def test_tools_need_a_card_unless_told_cpu(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = ["--out-dir", str(tmp_path)]
    if tool in (train_zoo_pixels, select_zoo):
        argv += ["--data-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
    assert os.listdir(tmp_path) == []


def test_default_out_dir_is_the_shared_data_dir():
    """Artifacts go to DATA_DIR/zoo (git-ignored), never beside the shipped
    ones in the JAX package's zoo/."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert train_zoo.DEFAULT_OUT_DIR == os.path.join(repo, "gym_kmanip_tpu", "data", "zoo")
    assert train_zoo.parser().parse_args([]).out_dir == train_zoo.DEFAULT_OUT_DIR
    assert os.path.dirname(train_zoo.DEFAULT_OUT_DIR) != zoo._ZOO_DIR
