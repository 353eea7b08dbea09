"""The rollout mesh and the sharded MPPI and iLQR solvers.

Port of `gym_kmanip_tpu/parallel/mesh.py` on `torch.distributed`. The JAX
package splits the MPPI sample batch (and a batch of iLQR problems) over a
1-D ("rollout",) mesh of chips with `shard_map`, and reduces across chips
with `pmin` and `psum`. Here a mesh is the ranks of one process group,
one process per rank, and each collective is an `all_reduce` with
`ReduceOp.MIN` or `ReduceOp.SUM`: the one-for-one counterparts of `pmin`
and `psum`, which gloo runs on CUDA tensors as well as CPU ones. Only
scalars, (H, nu) sequences and the iLQR outputs cross ranks, never rollout
trajectories.

A process with no process group is a mesh of one rank, where every
collective is the identity: the sharded solvers then run on one device
with no launcher. Under `torchrun --nproc-per-node N`, `init_distributed()`
reads the launcher's variables, picks the backend and returns the rank's
device.

Every rank holds the replicated inputs (the MPPI state and its generator,
the sim state, the whole iLQR batch) and gets the replicated outputs.
"""

import datetime
import os
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from gym_kmanip_torch.dynamics.state import SimState
from gym_kmanip_torch.models import canonical_device, model_tensors
from gym_kmanip_torch.models.spec import RobotModel
from gym_kmanip_torch.mpc.mppi import (
    MPPIConfig, MPPIState, injected_noise, sample_noise, sigma_tensor)
from gym_kmanip_torch.mpc.rollout import rollout
from gym_kmanip_torch.solvers.ilqr import _clip_u, make_ilqr_solver, unflatten_state

ROLLOUT_AXIS = "rollout"
INDEX_SENTINEL = torch.iinfo(torch.int64).max


def rank_device(local_rank: int, device="cuda") -> torch.device:
    """The device of the rank with this local rank: `cuda:(local_rank %
    device_count)` unless `device` is the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", local_rank % n)


def choose_backend(device: torch.device, local_world_size: int,
                   backend: Optional[str] = None) -> str:
    """NCCL when every rank on this host has a card of its own, gloo on the
    CPU and when ranks share a card (NCCL refuses two ranks on one
    device). Asking for NCCL with shared cards raises."""
    shared = device.type == "cuda" and local_world_size > torch.cuda.device_count()
    if backend is None:
        return "nccl" if device.type == "cuda" and not shared else "gloo"
    if backend == "nccl" and (device.type != "cuda" or shared):
        raise ValueError(
            f"NCCL needs a card for each rank: {local_world_size} ranks on this host, "
            f"{torch.cuda.device_count()} cards, device {device}")
    return backend


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda",
                     timeout_s: float = 300.0) -> torch.device:
    """Join the process group of `num_processes` ranks as rank `process_id`
    through `coordinator_address` ("host:port", a `tcp://` rendezvous), and
    return this rank's device. Arguments left None are read from the
    variables `torchrun` sets (WORLD_SIZE, RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT). One process joins no
    group. The rendezvous and every collective time out after `timeout_s`."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", process_id))
    dev = rank_device(local_rank, device)
    if num_processes <= 1:
        return dev
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = choose_backend(dev, local_world_size, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


class Mesh(NamedTuple):
    """A 1-D mesh over the ranks of the process group `group`; with no
    group (None), a mesh of one rank whose collectives are the identity."""

    size: int
    rank: int
    group: Optional[dist.ProcessGroup] = None
    axis_names: Tuple[str, ...] = (ROLLOUT_AXIS,)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The ("rollout",) mesh over every rank of the default process group
    (one of one rank too, whose collectives then run through its backend);
    in a process with no group, a mesh of one rank with no group.
    `n_devices`, where given, must be the group's size."""
    if dist.is_available() and dist.is_initialized():
        mesh = Mesh(size=dist.get_world_size(), rank=dist.get_rank(), group=dist.group.WORLD)
    else:
        mesh = Mesh(size=1, rank=0)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} ranks in a process group of {mesh.size}: "
                         f"start {n_devices} processes and call init_distributed() in each")
    return mesh


def _all_reduce(t: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    """`op` (ReduceOp.MIN or SUM) of `t` over the mesh, in a new tensor;
    the identity on a mesh with no process group."""
    if mesh.group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _all_reduce(t, dist.ReduceOp.SUM, mesh)


def pmin(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _all_reduce(t, dist.ReduceOp.MIN, mesh)


def global_elite(costs: torch.Tensor, cand: torch.Tensor, local_k: int,
                 mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best_cand, gmin): the one candidate with the globally minimal cost,
    ties broken by the smallest global index (rank-major), never a blend of
    tied candidates. `costs` is this rank's (local_k,) shard, `cand` its
    (local_k, ...) candidates."""
    gmin = pmin(torch.min(costs), mesh)
    local_idx = torch.argmin(costs)  # the first local minimum
    gidx = local_idx + mesh.rank * local_k
    masked = torch.where(costs[local_idx] <= gmin, gidx,
                         torch.full_like(gidx, INDEX_SENTINEL))
    win = pmin(masked, mesh)
    sel = (gidx == win).to(cand.dtype)
    return psum(sel * cand[local_idx], mesh), gmin


def make_sharded_mppi_solver(model: RobotModel, cfg: MPPIConfig, cost_fn: Callable,
                             mesh: Mesh):
    """Sharded MPPI: (MPPIState, SimState, eps=None) -> (MPPIState, u0, J),
    as `mpc.mppi.make_mppi_solver`, with the K samples split over the mesh.

    Rank r scores candidates [r local_k, (r + 1) local_k) through `rollout`;
    rank 0's slot 0 is the zero-noise nominal and its slot 1 the carried
    proposal. Every rank draws the whole (K, H, nu) noise from the
    replicated generator and keeps its slice, so the generators stay in
    step; an injected `eps` is the global (n_iters, K, H, nu), or (K, H,
    nu) for one iteration. So at any world size the solve scores the
    candidates of `make_mppi_solver` on the same state and noise and picks
    the same elite, but for the averaged proposal (slot 1 from the second
    iteration on), whose float32 sums run in another order.

    Seven all-reduces an iteration: five of a scalar (the elite's cost and
    index, MIN; the costs' mean and variance and the weights' sum, SUM) and
    two of an (H, nu) sequence (the elite and the weighted sum, SUM)."""
    K, H, nu = cfg.n_samples, cfg.horizon, model.nu
    if K % mesh.size:
        raise ValueError(f"{K} samples do not divide over {mesh.size} ranks")
    local_k = K // mesh.size
    if local_k < 2:
        raise ValueError(f"{local_k} sample per rank: rank 0 needs two slots, the nominal "
                         f"and the proposal")
    first = mesh.rank * local_k

    def solve(mppi_state: MPPIState, sim_state: SimState,
              eps: Optional[torch.Tensor] = None):
        device = canonical_device(mppi_state.nominal.device)
        t = model_tensors(model, device)
        lo, hi = t.ctrl_lo, t.ctrl_hi
        sigma = sigma_tensor(model, cfg, device)
        eps = injected_noise(model, cfg, eps)
        nominal = proposal = mppi_state.nominal
        gmin = None
        for it in range(cfg.n_iters):
            e = (sample_noise(mppi_state.generator, K, H, nu, sigma, cfg.noise_beta)
                 if eps is None else eps[it])[first:first + local_k]
            if mesh.rank == 0:
                e = torch.cat([torch.zeros_like(e[:1]), e[1:]])
            cand = torch.clamp(nominal[None] + e, lo, hi)
            if mesh.rank == 0:
                cand = torch.cat([cand[:1], proposal[None], cand[2:]])
            costs, _ = rollout(model, sim_state, cand, cost_fn, n_substeps=cfg.n_substeps,
                               dt=cfg.dt, contact=cfg.contact)
            best, gmin = global_elite(costs, cand, local_k, mesh)
            # scale-invariant temperature from the global mean and
            # population variance
            gmean = psum(torch.sum(costs), mesh) / K
            gvar = psum(torch.sum((costs - gmean) ** 2), mesh) / K
            lam = cfg.temperature * (torch.sqrt(gvar) + 1e-6)
            w_un = torch.exp(-(costs - gmin) / lam)
            z = psum(torch.sum(w_un), mesh)
            weighted = psum(torch.sum(w_un[:, None, None] * cand, dim=0), mesh)
            nominal, proposal = best, torch.clamp(weighted / z, lo, hi)
        u0 = nominal[0]
        shifted = torch.cat([nominal[1:], nominal[-1:]], dim=0)
        return MPPIState(nominal=shifted, generator=mppi_state.generator), u0, gmin

    return solve


def make_sharded_ilqr_solver(model: RobotModel, cfg, cost_xu: Callable, mesh: Mesh,
                             state0_template: SimState, batch: int,
                             cost_final: Optional[Callable] = None,
                             quad_xu: Optional[Callable] = None,
                             quad_final: Optional[Callable] = None):
    """A batch of independent iLQR problems split over the mesh:
    solve(x0s (B, n), uss (B, H, nu)) -> (us (B, H, nu), costs (B,), traces
    (B, n_iters)) on every rank.

    Rank r solves problems [r B/W, (r + 1) B/W) one after another with
    `solvers.ilqr.make_ilqr_solver`; each problem's SimState is its flat x0
    over `state0_template` (the cube under reduced_state, ctrl and time),
    and its warm start is clipped to ctrl_range. The ranks' results meet in
    one SUM of a zero-filled buffer, which is exact. As in the JAX package,
    the solve must be the fused single-dispatch FD one."""
    if not (cfg.fused_solve and cfg.fd_linearize):
        raise ValueError("sharded iLQR requires the fused single-dispatch solve "
                         "(cfg.fused_solve + cfg.fd_linearize)")
    if batch % mesh.size:
        raise ValueError(f"a batch of {batch} problems does not divide over {mesh.size} ranks")
    local = batch // mesh.size
    first = mesh.rank * local
    solver = make_ilqr_solver(model, cfg, cost_xu, cost_final=cost_final, quad_xu=quad_xu,
                              quad_final=quad_final)

    def solve(x0s: torch.Tensor, uss: torch.Tensor):
        if x0s.shape[0] != batch or uss.shape[0] != batch:
            raise ValueError(f"the solver takes {batch} problems, not {x0s.shape[0]}")
        H, nu = uss.shape[1:]
        us = uss.new_zeros((batch, H, nu))
        costs = uss.new_zeros(batch)
        traces = uss.new_zeros((batch, cfg.n_iters))
        for b in range(first, first + local):
            r = solver(unflatten_state(model, x0s[b], state0_template), _clip_u(model, uss[b]))
            us[b], costs[b], traces[b] = r.us, r.cost, r.cost_trace
        flat = psum(torch.cat([us.reshape(-1), costs, traces.reshape(-1)]), mesh)
        n_us = batch * H * nu
        return (flat[:n_us].view(batch, H, nu), flat[n_us:n_us + batch],
                flat[n_us + batch:].view(batch, cfg.n_iters))

    return solve
