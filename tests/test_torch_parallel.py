"""The port's mesh and sharded solvers (gym_kmanip_torch/parallel/mesh.py)
against the JAX package's and against the port's single-device solvers.

One module-scoped fixture spawns one group of two gloo ranks on the CPU
(tests/torch_parallel_ranks.py) that runs every distributed check; the
tests read its results. The JAX package's results on a two-device mesh
are goldens (tests/golden/parallel_sharded.npz, written by
`python tools/make_golden_parallel.py`), so no JAX sharded solver is
compiled here. No test imports JAX.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks_mod
from gym_kmanip_torch.mpc.mppi import MPPIConfig, init_mppi, make_mppi_solver
from gym_kmanip_torch.parallel import mesh as pm
from gym_kmanip_torch.solvers.ilqr import make_ilqr_solver, unflatten_state

torch.set_num_threads(1)

_TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(ranks_mod.GOLDEN))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results after checking that every result is replicated:
    rank 1's equal to the bit."""
    out_dir = tmp_path_factory.mktemp("ranks")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ranks_mod.REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_TESTS, "torch_parallel_ranks.py"), str(r), str(WORLD),
         str(port), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    results = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(WORLD)]
    for key, value in results[0].items():
        np.testing.assert_array_equal(results[1][key], value, err_msg=key)
    return results[0]


@pytest.fixture(scope="module")
def mppi_case(golden):
    return ranks_mod.mppi_setup(golden)


def test_mesh_spans_world(ranks):
    """The mesh spans the group with the JAX axis name
    (tests/test_parallel.py:33-36); a process with no group is a mesh of
    one, and asking it for two ranks raises."""
    assert int(ranks["size"]) == WORLD
    assert tuple(ranks["axis_names"]) == ("rollout",)
    mesh = pm.make_mesh()
    assert (mesh.size, mesh.rank, mesh.axis_names) == (1, 0, ("rollout",))
    with pytest.raises(ValueError):
        pm.make_mesh(2)


def test_two_rank_psum_and_tie_break(ranks):
    """tests/test_multihost.py:89-124 over two processes: the psum of every
    cost, and a tie at the minimum resolved to the smallest global index."""
    k = WORLD * ranks_mod.ELITE_LOCAL_K
    costs = np.ones(k, np.float32)
    costs[ranks_mod.ELITE_LOCAL_K + 1] = costs[(WORLD - 1) * ranks_mod.ELITE_LOCAL_K] = 0.5
    cand = np.arange(k * 4, dtype=np.float32).reshape(k, 4)
    assert float(ranks["psum"]) == float(costs.sum())
    assert float(ranks["multihost_gmin"]) == 0.5
    np.testing.assert_array_equal(ranks["multihost_best"], cand[int(np.argmin(costs))])


def test_global_elite_matches_jax(ranks, golden):
    """JAX's global_elite on two devices (the tie pattern of
    tests/test_parallel.py:60-88, and a tie across the devices): the same
    single candidate, never a blend."""
    for i, costs in enumerate(golden["elite_costs"]):
        np.testing.assert_array_equal(ranks[f"elite{i}_best"], golden["elite_best"][i])
        np.testing.assert_array_equal(ranks[f"elite{i}_best"],
                                      golden["elite_cand"][int(np.argmin(costs))])
        assert float(ranks[f"elite{i}_gmin"]) == float(golden["elite_gmin"][i])


@pytest.mark.parametrize("n_iters", [1, 2])
def test_sharded_mppi_matches_jax(ranks, golden, n_iters):
    """Two ranks on JAX's per-device draws (its key split, then sample_noise
    per device, device-major) against JAX's sharded solve on two devices:
    u0 and nominal 1e-5, J 1e-4 (tests/test_torch_mppi.py:140-185)."""
    for name, tol in (("u0", 1e-5), ("J", 1e-4), ("nominal", 1e-5)):
        np.testing.assert_allclose(ranks[f"mppi{n_iters}_{name}"],
                                   golden[f"mppi{n_iters}_{name}"], atol=tol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_sharded_mppi_equals_single_device(ranks, golden, mppi_case, n_iters):
    """On the same global noise, two ranks, the in-process one-rank mesh and
    `make_mppi_solver` pick the same elite to the bit (u0, the shifted
    nominal and J); the generator's draws are sliced, so each rank's
    generator ends where the single solve's does."""
    model, sim0, cost_fn = mppi_case
    cfg = MPPIConfig(n_iters=n_iters, **ranks_mod.MPPI)
    nominal0 = torch.as_tensor(golden[f"mppi{n_iters}_nominal0"])
    eps = torch.as_tensor(golden[f"mppi{n_iters}_eps"])
    one_rank = pm.make_sharded_mppi_solver(model, cfg, cost_fn, pm.make_mesh())
    single = make_mppi_solver(model, cfg, cost_fn)
    for solve in (one_rank, single):
        st = init_mppi(model, cfg, device="cpu")._replace(nominal=nominal0)
        st2, u0, J = solve(st, sim0, eps=eps)
        np.testing.assert_array_equal(ranks[f"mppi{n_iters}_u0"], u0.numpy())
        np.testing.assert_array_equal(ranks[f"mppi{n_iters}_J"], J.numpy())
        np.testing.assert_array_equal(ranks[f"mppi{n_iters}_nominal"], st2.nominal.numpy())
        st2, u0, J = solve(init_mppi(model, cfg, seed=ranks_mod.OWN_NOISE_SEED, device="cpu"),
                           sim0)
        np.testing.assert_array_equal(ranks[f"own{n_iters}_u0"], u0.numpy())
        np.testing.assert_array_equal(ranks[f"own{n_iters}_J"], J.numpy())
        np.testing.assert_array_equal(ranks[f"own{n_iters}_nominal"], st2.nominal.numpy())
        np.testing.assert_array_equal(ranks[f"own{n_iters}_generator"],
                                      st2.generator.get_state().numpy())


def test_sharded_mppi_proposal_equals_single_device(ranks, golden, mppi_case):
    """The averaged proposal, read where the second iteration scores it
    (rank 0's slot 1, through the controls the cost sees): two ranks, the
    one-rank mesh and `make_mppi_solver` agree within 1e-6 (their weights
    sum in other orders)."""
    model, sim0, cost_fn = mppi_case
    cfg = MPPIConfig(n_iters=2, **ranks_mod.MPPI)
    nominal0 = torch.as_tensor(golden["mppi2_nominal0"])
    for make in (lambda cost: pm.make_sharded_mppi_solver(model, cfg, cost, pm.make_mesh()),
                 lambda cost: make_mppi_solver(model, cfg, cost)):
        seen = []

        def recording(s, aux, u):
            seen.append(u[1])
            return cost_fn(s, aux, u)

        st = init_mppi(model, cfg, device="cpu")._replace(nominal=nominal0)
        make(recording)(st, sim0, eps=torch.as_tensor(golden["mppi2_eps"]))
        proposal = torch.stack(seen[cfg.horizon:]).numpy()  # the second iteration's
        np.testing.assert_allclose(ranks["mppi2_proposal"], proposal, atol=1e-6, rtol=0)
    assert not np.array_equal(ranks["mppi2_proposal"], nominal0.numpy())


def test_sharded_ilqr_matches_jax(ranks, golden):
    """Two ranks on the JAX package's CPU route (the serial linalg.solve
    backward) against JAX's sharded iLQR on two devices, held as
    tests/test_parallel.py:231-238 holds JAX's own: at least 80% of the
    costs within rtol 2e-3, all within 10%, the tight ones' controls within
    1e-2, every problem descends."""
    c, c_jax = ranks["ilqr_costs"], golden["ilqr_costs"]
    tight = np.isclose(c, c_jax, rtol=2e-3, atol=1e-6)
    assert tight.sum() >= int(0.8 * len(c)), (c, c_jax)
    np.testing.assert_allclose(c, c_jax, rtol=0.10)
    np.testing.assert_allclose(ranks["ilqr_us"][tight], golden["ilqr_us"][tight], atol=1e-2)
    tr = ranks["ilqr_traces"]
    assert np.all(tr[:, -1] <= tr[:, 0] + 1e-5)
    assert np.all(c[:, None] == tr[:, -1:])


@pytest.mark.parametrize("route", ["ilqr", "ilqr_card"])
def test_sharded_ilqr_equals_single_device(ranks, golden, mppi_case, route):
    """Each problem of the two-rank solve equals `make_ilqr_solver` on its
    SimState (its x0 over the template) to the bit, on the JAX package's
    CPU route and on the card's (the Riccati sweep's plain version)."""
    model, sim0, _ = mppi_case
    cfg, cost_xu, quad_xu = ranks_mod.ilqr_setup(golden, model, route == "ilqr_card")
    solve = make_ilqr_solver(model, cfg, cost_xu, quad_xu=quad_xu)
    for b, (x0, us) in enumerate(zip(golden["ilqr_x0s"], golden["ilqr_uss"])):
        r = solve(unflatten_state(model, torch.as_tensor(x0), sim0), torch.as_tensor(us))
        np.testing.assert_array_equal(ranks[f"{route}_us"][b], r.us.numpy())
        np.testing.assert_array_equal(ranks[f"{route}_costs"][b], r.cost.numpy())
        np.testing.assert_array_equal(ranks[f"{route}_traces"][b], r.cost_trace.numpy())


def test_sharded_solvers_refuse_what_they_cannot_split(mppi_case, golden):
    """The JAX package's refusals (mesh.py:106-110: the fused FD solve
    only; a batch that divides over the ranks), and the MPPI's: K divides
    over the ranks, with two slots on rank 0 for the nominal and the
    proposal."""
    model, sim0, cost_fn = mppi_case
    cfg, cost_xu, quad_xu = ranks_mod.ilqr_setup(golden, model, False)
    three = pm.Mesh(size=3, rank=0)
    with pytest.raises(ValueError, match="divide"):
        pm.make_sharded_ilqr_solver(model, cfg, cost_xu, three, sim0, 4, quad_xu=quad_xu)
    for bad in (dict(fused_solve=False), dict(fd_linearize=False)):
        with pytest.raises(ValueError, match="fused"):
            pm.make_sharded_ilqr_solver(model, cfg._replace(**bad), cost_xu, pm.make_mesh(),
                                        sim0, 4, quad_xu=quad_xu)
    mcfg = MPPIConfig(**ranks_mod.MPPI)
    with pytest.raises(ValueError, match="divide"):
        pm.make_sharded_mppi_solver(model, mcfg, cost_fn, three)
    with pytest.raises(ValueError, match="two slots"):
        pm.make_sharded_mppi_solver(model, mcfg, cost_fn, pm.Mesh(size=4, rank=0))


def test_init_distributed_and_backend_choice(monkeypatch):
    """One process joins no group; the backend is gloo on the CPU and where
    ranks share a card, NCCL where each rank has its own, and asking NCCL
    for shared cards raises."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert pm.init_distributed(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert pm.choose_backend(cpu, 2) == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        pm.choose_backend(cpu, 2, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pm.choose_backend(cuda, 1) == "nccl"
    assert pm.choose_backend(cuda, 2) == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        pm.choose_backend(cuda, 2, "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pm.choose_backend(cuda, 4) == "nccl"
    assert pm.rank_device(5) == torch.device("cuda", 1)
