"""The seeded stream: the same seed gives the same inputs, another seed
other inputs; every input is inside its stated range."""

import numpy as np
import torch

from harness import traffic
from reference import model as rmodel

TRAFFIC = {"start_states": 64, "cube_range": [[0.1, 0.3], [0.5, 0.7], [0.6, 0.7]],
           "joint_perturb_frac": 0.05}


def test_stream_repeats_for_a_seed_and_differs_across_seeds():
    robot = rmodel.load("solo_arm")
    big = 2**31 + 12345
    a = traffic.start_pool(robot, TRAFFIC, traffic.seeds(big).states, "cpu")
    b = traffic.start_pool(robot, TRAFFIC, traffic.seeds(big).states, "cpu")
    c = traffic.start_pool(robot, TRAFFIC, traffic.seeds(big + 1).states, "cpu")
    for f in a:
        assert torch.equal(a[f], b[f]), f
    assert not torch.equal(a["qpos"], c["qpos"])
    assert not torch.equal(a["cube_pos"], c["cube_pos"])
    sa, sc = traffic.seeds(big), traffic.seeds(big + 1)
    assert traffic.noise_seed(sa, 7) == traffic.noise_seed(traffic.seeds(big), 7)
    assert traffic.noise_seed(sa, 7) != traffic.noise_seed(sc, 7)
    assert len({traffic.noise_seed(sa, i) for i in range(100)}) == 100


def test_stream_stays_in_its_ranges():
    robot = rmodel.load("torso")
    pool = traffic.start_pool(robot, TRAFFIC, 5, "cpu")
    lo, hi = robot.jnt_range[:, 0], robot.jnt_range[:, 1]
    q = pool["qpos"].numpy()
    assert np.all(q >= lo.astype(np.float32)) and np.all(q <= hi.astype(np.float32))
    home = robot.home_qpos
    assert np.all(np.abs(q - home) <= 0.05 * (hi - lo) + 1e-6)
    box = np.asarray(TRAFFIC["cube_range"], np.float32)
    c = pool["cube_pos"].numpy()
    assert np.all(c >= box[:, 0]) and np.all(c <= box[:, 1])
    assert torch.all(pool["qvel"] == 0) and torch.all(pool["cube_linvel"] == 0)
    assert torch.all(pool["cube_quat"] == torch.tensor([1.0, 0.0, 0.0, 0.0]))


def test_reservoir_is_seeded_and_uniform():
    picks = []
    for seed in (1, 2):
        r = traffic.Reservoir(seed, 4)
        slots = [None] * 4
        for i in range(1, 2000):
            s = r.slot(i)
            if s is not None:
                slots[s] = i
        picks.append(slots)
    assert picks[0] != picks[1]
    r1, r2 = traffic.Reservoir(9, 4), traffic.Reservoir(9, 4)
    assert [r1.slot(i) for i in range(500)] == [r2.slot(i) for i in range(500)]
    assert traffic.Reservoir(9, 4).slot(0) is None  # the first solve is checked apart
    # every solve is equally likely to end in the sample
    counts = np.zeros(100)
    for seed in range(2000):
        r = traffic.Reservoir(seed, 5)
        slots = [None] * 5
        for i in range(1, 101):
            s = r.slot(i)
            if s is not None:
                slots[s] = i
        for i in slots:
            counts[i - 1] += 1
    assert abs(counts.mean() - 100.0) < 1e-9 and counts.min() > 60 and counts.max() < 140
