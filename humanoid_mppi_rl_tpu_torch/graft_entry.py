"""The graft entry points (the JAX repo's __graft_entry__.py): a one-device
replan check and a multi-process dry run of every sharded part.

  python -m humanoid_mppi_rl_tpu_torch.graft_entry [--device cpu]

prints "entry ok" after one replan of `entry` and "dryrun ok" after
`dryrun_multichip(n)`, n the cards present or 1 (JAX's takes its device
count)."""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import tempfile
import time

import numpy as np
import torch


def entry(device="cuda", dtype=torch.float32):
    """(plan, (mppi_state, physics_state)): the MPPI replan on the flagship
    model (humanoid_collect: make_mppi over the penalty engine batched over
    K) at K=64, H=16, as a check-size version of the K=8192 x H=64
    operating point. plan(mppi_state, physics_state, noise=None) ->
    (action, new_mppi_state, diagnostics)."""
    from .envs.tasks import load_task
    from .solver.mppi import MPPIState, make_mppi

    spec, model, dynamics, running, terminal, init_state, cfg = load_task(
        "humanoid_collect", device=device, dtype=dtype)
    cfg = dataclasses.replace(cfg, n_samples=64, horizon=16)
    plan = make_mppi(dynamics, running, cfg, terminal_fn=terminal)
    ms = MPPIState.seeded(0, cfg.T, model.nu, device=init_state.qpos.device, dtype=dtype)
    return plan, (ms, init_state)


def train_inputs(batch: int, seed: int = 1):
    """(x (batch, 51), y (batch, 30)) of the data-parallel train step: the
    humanoid surrogate's input and target widths, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(batch, 30 + 21)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(batch, 30)), dtype=torch.float32))


def train_net():
    """The dry run's narrow humanoid surrogate and its Adam, seeded."""
    from .models.predictors import seeded_model

    net = seeded_model("humanoid_attention", 1, hidden_dim=32, attn_layers=1, num_heads=2)
    return net, torch.optim.Adam(net.parameters(), lr=1e-3)


def data_parallel_train_step(net, opt, x, y) -> torch.Tensor:
    """One Adam step on this rank's shard (x, y) of the batch, the
    gradients averaged over the process group (an all_reduce SUM over
    equal shards, divided by the ranks); returns the batch's mean loss. On
    a group of one, or with no group, the one-process step."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    opt.zero_grad()
    loss = torch.mean((net(x) - y) ** 2)
    loss.backward()
    total = loss.detach().clone()
    if n > 1:
        for p in net.parameters():
            dist.all_reduce(p.grad, op=dist.ReduceOp.SUM)
            p.grad /= n
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
    opt.step()
    return total / n


def _finite(*xs) -> None:
    for x in xs:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("dryrun_multichip: a non-finite result")


def _dryrun_rank(rank: int, n: int, init_file: str, out_dir: str) -> None:
    """JAX dryrun_multichip's five parts on this rank of an n-rank gloo
    group, at its shapes; saves what it computed to <out_dir>/rank<r>.pt."""
    import torch.distributed as dist

    from .collect.estimator import ESTIMATOR_CONFIGS, quadruped_estimator_costs
    from .dynamics.learned import make_learned_dynamics
    from .envs.tasks import load_task
    from .models.predictors import seeded_model
    from .ops.estimator_kernel import make_flash_feature_attention
    from .parallel.mesh import make_mesh, make_sharded_kernel_mppi, make_sharded_mppi
    from .solver.mppi import MPPIState

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(n, device="cpu")
    out = {}

    # sample-parallel MPPI over the group (the array planner)
    spec, model, dynamics, running, terminal, init_state, cfg = load_task(
        "humanoid_collect", device="cpu")
    cfg = dataclasses.replace(cfg, n_samples=2 * n, horizon=3)
    plan = make_sharded_mppi(dynamics, running, cfg, mesh, terminal_fn=terminal)
    out["array"], _, diag = plan(MPPIState.seeded(0, cfg.T, model.nu, device="cpu"), init_state)
    _finite(out["array"], diag.beta)

    # sample-parallel MPPI through the rollout kernel (its plain version here)
    cp_spec, cp_model, _, _, _, cp_init, cp_cfg = load_task("cartpole", device="cpu")
    cp_cfg = dataclasses.replace(cp_cfg, n_samples=4 * n, horizon=3)
    kplan = make_sharded_kernel_mppi(cp_model, cp_spec.kernel_cost_factory, cp_cfg, mesh,
                                     cp_spec.cost_kwargs)
    out["kernel"], _, kdiag = kplan(MPPIState.seeded(2, cp_cfg.T, cp_model.nu, device="cpu"),
                                    cp_init)
    _finite(out["kernel"], kdiag.beta)

    # sample-parallel estimator MPPI on a learned surrogate
    qnet = seeded_model("quadruped_attention", 3, hidden_dim=16, attn_layers=1, num_heads=2)
    qrun, qterm = quadruped_estimator_costs()
    qcfg = dataclasses.replace(ESTIMATOR_CONFIGS["quadruped"], n_samples=2 * n, horizon=3)
    x0 = torch.zeros(37)
    qplan = make_sharded_mppi(make_learned_dynamics(qnet, state_slice=37), qrun, qcfg, mesh,
                              terminal_fn=qterm)
    out["estimator"], _, _ = qplan(MPPIState.seeded(4, qcfg.T, 12, device="cpu"), x0)

    # the same through the estimator kernel (its plain version here), batched
    flash = make_flash_feature_attention(qnet, torch.float32, device="cpu")
    fplan = make_sharded_mppi(make_learned_dynamics(flash, state_slice=37), qrun, qcfg, mesh,
                              terminal_fn=qterm)
    out["flash"], _, _ = fplan(MPPIState.seeded(4, qcfg.T, 12, device="cpu"), x0)
    _finite(out["estimator"], out["flash"])

    # one data-parallel train step, the batch sharded over the group
    net, opt = train_net()
    x, y = train_inputs(2 * n)
    sl = slice(2 * rank, 2 * rank + 2)
    out["loss"] = data_parallel_train_step(net, opt, x[sl], y[sl])
    out["grads"] = {k: p.grad.clone() for k, p in net.named_parameters()}
    out["params"] = {k: v.detach().clone() for k, v in net.state_dict().items()}
    _finite(out["loss"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> list:
    """Run the sharded pipeline once on tiny shapes over n_devices gloo
    processes on the CPU (the kernels' plain versions): the humanoid array
    replan with K sharded over the group, the cartpole's kernel replan,
    estimator replans on a learned surrogate through its forward and
    through the estimator kernel, and a data-parallel train step. JAX's
    contract is n virtual CPU devices; here each is a process. Returns the
    ranks' results in rank order (each rank's action of every part, the
    step's loss, its averaged gradients and the parameters after it)."""
    import torch.multiprocessing as mp

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory(prefix="graft_dryrun_") as out_dir:
        ctx = mp.start_processes(_dryrun_rank, args=(n_devices, os.path.join(out_dir, "init"),
                                                     out_dir),
                                 nprocs=n_devices, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"dryrun_multichip: {n_devices} ranks did not finish in time")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(n_devices)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one replan of entry(), then dryrun_multichip")
    ap.add_argument("--device", default="cuda",
                    help="entry's device (default cuda; the dry run is on the CPU)")
    args = ap.parse_args(argv)
    fn, fargs = entry(device=args.device)
    action, _, _ = fn(*fargs)
    _finite(action)
    print("entry ok")
    dryrun_multichip(max(1, torch.cuda.device_count()))
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
