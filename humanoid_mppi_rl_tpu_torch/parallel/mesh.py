"""K-sharded MPPI over torch.distributed (parallel/mesh.py counterpart).

Each process of the group holds one device and K / n of a replan's
samples: it draws (or slices) its part of the noise, rolls its samples
out, and the replan's weighting crosses the processes in three
all_reduces of O(T nu) payload:

    beta = MIN over ranks of min_k costs_k
    norm = SUM over ranks of sum_k exp(-(costs_k - beta) / lambda) (+ eps)
    U   += SUM over ranks of sum_k (w_k / norm) noise_k

and one more SUM carries the diagnostics (mean cost, sum of squared
weights, weight entropy) by JAX's formulas. Nothing else waits for the
device: NCCL's collectives are queued on the stream like any kernel.

With cfg.noise_block, every rank draws whole blocks of
solver.mppi.sample_noise_blocked's field at its offset, so the sharded
planner draws exactly the single-device planner's noise; without it each
rank draws one block of K / n (JAX: one folded key per shard). `noise=`
injects the global field in the single-device planner's own layout, of
which each rank takes its part: the matched-noise hook.

The planners are the single-device ones (solver/mppi.make_mppi,
solver/kernel_mppi.make_kernel_mppi) given this rank's `k_shard`: its
slice of K and these reductions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..solver.kernel_mppi import make_kernel_mppi
from ..solver.mppi import KShard, MPPIConfig, MPPIDiagnostics, make_mppi, weighted_update
from .distributed import local_rank


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The default process group as the planner sees it: this process's
    rank, the group's size and the device this rank computes on."""

    rank: int
    size: int
    device: torch.device


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The default process group as a 1-D mesh over the K axis. Each rank
    computes on cuda:LOCAL_RANK (device="cuda") or on the CPU (gloo). The
    group must be initialized (parallel.distributed.maybe_initialize, or
    the caller's init_process_group)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group "
                           "(parallel.distributed.maybe_initialize or init_process_group)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but the process group has {size} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    return Mesh(rank=dist.get_rank(), size=size, device=dev)


def _all_reduce(x: torch.Tensor, op) -> torch.Tensor:
    dist.all_reduce(x, op=op)
    return x


def _total(x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.SUM)


def _weights(costs, temperature, weight_eps):
    """(w, beta): beta (MIN) and the weights normalized by the global sum
    (SUM), as solver.mppi.mppi_weights computes them on one device."""
    beta = _all_reduce(torch.min(costs).clone(), dist.ReduceOp.MIN)
    w = torch.exp(-(costs - beta) / temperature)
    return w / (_total(torch.sum(w)) + weight_eps), beta


def _diagnostics(size: int, costs, w, beta, update) -> MPPIDiagnostics:
    """The replan's diagnostics by JAX's formulas in one SUM: the pmean of
    the cost, the sum of squared weights (ess = 1 / psum(w^2)) and the
    weights' entropy."""
    local = torch.stack([torch.mean(costs) / size, torch.sum(w * w),
                         torch.sum(w * torch.where(w > 0, torch.log(w + 1e-30), 0.0))])
    mean_cost, w2, ent = _total(local)
    return MPPIDiagnostics(beta=beta, mean_cost=mean_cost, ess=1.0 / w2, weight_entropy=-ent,
                           update_norm=torch.linalg.norm(update))


def k_shard(mesh: Mesh) -> KShard:
    """This rank's slice of K and the group's reductions, for the
    single-device planners' `shard` argument."""
    return KShard(index=mesh.rank, count=mesh.size, weights=_weights, total=_total,
                  diagnostics=functools.partial(_diagnostics, mesh.size))


def sharded_update_op(mesh: Mesh, cfg: MPPIConfig):
    """f(costs_local (K/n,), noise_local (K/n, T, nu)) -> (update (T, nu),
    (w_local, beta)): the reduced exponential weighting, w_local normalized
    by the global sum; usable as make_mppi's update_op in a sharded
    replan."""
    return functools.partial(weighted_update, cfg=cfg, shard=k_shard(mesh))


def make_sharded_kernel_mppi(model, kernel_cost_factory: Callable, cfg: MPPIConfig, mesh: Mesh,
                             cost_kwargs: Optional[dict] = None):
    """The rollout-kernel planner (solver/kernel_mppi.make_kernel_mppi)
    with K sharded over `mesh`: each rank launches the CUDA rollout kernel
    (its plain version on the CPU) once a replan on its K / n samples.
    plan(mppi_state, plant, params=None, noise=None) -> (action, state',
    diag); params' slots 11 and 12 scale sigma and the temperature as in
    the single-device planner; `noise` is the global (T, nu, K) field."""
    return make_kernel_mppi(model, kernel_cost_factory, cfg, cost_kwargs, device=mesh.device,
                            shard=k_shard(mesh))


def make_sharded_mppi(dynamics_fn: Callable, cost_fn: Callable, cfg: MPPIConfig, mesh: Mesh,
                      terminal_fn: Optional[Callable] = None):
    """solver/mppi.make_mppi with K sharded over `mesh`: same semantics,
    one sample/weight/update pass a replan (as JAX's sharded planner).
    plan(mppi_state, x0, noise=None); `noise` is the global (K, T, nu)
    field. As make_mppi, the rollouts hand dynamics_fn the whole local K
    batch (rollout_costs_batched: JAX's batched_dynamics=True route, which
    the estimator kernel's surrogates take)."""
    return make_mppi(dynamics_fn, cost_fn, dataclasses.replace(cfg, replans_per_step=1),
                     terminal_fn, shard=k_shard(mesh))
