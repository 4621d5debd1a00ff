"""Rank bodies of tests/test_torch_port_parallel.py. Each runs in one
process of a gloo group on the CPU (spawned by `start_group`), imports torch
and the port only, and saves what it computed to <out_dir>/rank<r>.pt.

Inputs are made from numpy seeds on every rank alike: the per-sample
costs and noise of the update op, and the global noise fields the
planners slice (`kernel_noise` (T, nu, K), `array_noise` (K, T, nu))."""

import dataclasses
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

K, T, NU_UPDATE, BLOCK = 16, 3, 2, 4
F64 = torch.float64


def update_inputs():
    rng = np.random.default_rng(5)
    return 3.0 * rng.normal(size=K), rng.normal(size=(K, T, NU_UPDATE))


def update_config(cfg_cls):
    return cfg_cls(n_samples=K, horizon=T, temperature=0.7, weight_eps=1e-3)


def kernel_params():
    """Runtime params with the sigma and temperature slots (11, 12) set."""
    p = np.zeros(16)
    p[11], p[12] = -0.2, 0.1
    return p


def planner_configs(cfg):
    """(kernel planner's, array planner's) configs at K, T, each also with
    noise_block=BLOCK."""
    base = dataclasses.replace(cfg, n_samples=K, horizon=T)
    return base, dataclasses.replace(base, noise_block=BLOCK)


def kernel_noise(nu):
    return np.random.default_rng(7).normal(size=(T, nu, K))


def array_noise(nu):
    return 0.5 * np.random.default_rng(8).normal(size=(K, T, nu))


def _outputs(action, state, diag):
    return dict(action=action, U=state.U, **dataclasses.asdict(diag))


def rank_main(rank: int, n: int, init_file: str, out_dir: str, from_env: bool):
    torch.set_num_threads(1)
    from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
    from humanoid_mppi_rl_tpu_torch.parallel import distributed
    from humanoid_mppi_rl_tpu_torch.parallel.mesh import (
        make_mesh, make_sharded_kernel_mppi, make_sharded_mppi, sharded_update_op)
    from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIConfig, MPPIState

    if from_env:
        os.environ.update(HUMANOID_MPPI_COORDINATOR=f"file://{init_file}",
                          HUMANOID_MPPI_NUM_PROCESSES=str(n), HUMANOID_MPPI_PROCESS_ID=str(rank))
        assert distributed.maybe_initialize(device="cpu") is (n > 1)
    else:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=n,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(n, device="cpu")
    out = dict(info=distributed.process_info(), shard=list(distributed.episode_shard(10)))

    costs, noise = update_inputs()
    sl = slice(rank * K // n, (rank + 1) * K // n)
    update, (w, beta) = sharded_update_op(mesh, update_config(MPPIConfig))(
        torch.tensor(costs[sl]), torch.tensor(noise[sl]))
    out["update_op"] = dict(update=update, w=w, beta=beta)

    spec, model, dyn, running, terminal, init, cfg = load_task("cartpole", device="cpu",
                                                               dtype=F64)
    seeded = lambda: MPPIState.seeded(3, T, model.nu, device="cpu", dtype=F64)
    cfg_k, cfg_kb = planner_configs(cfg)
    plan = make_sharded_kernel_mppi(model, spec.kernel_cost_factory, cfg_k, mesh,
                                    spec.cost_kwargs)
    out["kernel"] = _outputs(*plan(seeded(), init, params=kernel_params(),
                                   noise=torch.tensor(kernel_noise(model.nu))))
    plan = make_sharded_kernel_mppi(model, spec.kernel_cost_factory, cfg_kb, mesh,
                                    spec.cost_kwargs)
    out["kernel_blocked"] = _outputs(*plan(seeded(), init, params=kernel_params()))
    plan = make_sharded_mppi(dyn, running, cfg_k, mesh, terminal_fn=terminal)
    out["array"] = _outputs(*plan(seeded(), init, noise=torch.tensor(array_noise(model.nu))))
    plan = make_sharded_mppi(dyn, running, cfg_kb, mesh, terminal_fn=terminal)
    out["array_blocked"] = _outputs(*plan(seeded(), init))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def start_group(n: int, from_env: bool = False, timeout: float = 240.0):
    """Spawn n ranks of rank_main on the CPU (gloo over the loopback
    device, a file:// rendezvous); `join_group` waits for them."""
    out_dir = tempfile.mkdtemp(prefix="port_parallel_")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.start_processes(rank_main, args=(n, os.path.join(out_dir, "init"), out_dir,
                                              from_env),
                             nprocs=n, join=False, start_method="spawn")
    return ctx, n, out_dir, time.monotonic() + timeout


def join_group(group):
    """The ranks' saved outputs in rank order; kills the ranks and raises
    once the group's timeout has passed."""
    ctx, n, out_dir, deadline = group
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n} ranks did not finish in time")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(n)]
