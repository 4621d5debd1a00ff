"""Command-line interface: ``python -m humanoid_mppi_rl_tpu_torch <cmd> ...``
(the JAX package's cli.py, on PyTorch and the card).

  tasks                     list the task registry (per-task MPPI presets)
  run      --task NAME      one episode of any registry task, CSVs out
  collect  --robot humanoid|humanoid_jl|humanoid_v2py|quadruped
                            the reference data-collection scripts,
                            episode-sharded across processes via
                            --shard-index/--num-shards
  train    --preset NAME    dynamics learning on collected CSVs
  estimate --preset NAME    MPPI on a surrogate driving the real plant
  replay   --states CSV     kinematic replay of a logged trajectory
  profile  --task NAME      N replans under torch.profiler -> chrome trace
                            + timing counters
  bench                     not ported yet: refuses
  warm                      build every CUDA kernel and time a first replan

The subcommands, arguments, defaults, files written and JSON keys are the
JAX CLI's. Every subcommand that computes takes --device (default cuda,
refused without a card; --device cpu runs the plain PyTorch versions).
Differences from the JAX CLI:
- estimate --checkpoint reads this package's learning/train checkpoints
  (a state_dict .pt), not an orbax directory; with neither checkpoint
  option the module's initial weights come from PyTorch's initialisers
  under a generator seeded with --seed, not from flax's init;
- replay --asset takes an MJCF path or name whose basename names a model
  snapshot (humanoid.xml -> assets/humanoid.json), or a snapshot .json;
- run --live and replay --video need mujoco's viewer and renderer, which
  the port does not use: they exit with an error;
- bench exits with an error: the port's benchmark is not written yet;
- warm builds the CUDA kernels (ops/_build's cache) where the JAX CLI
  warms the XLA compile cache.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

NO_MUJOCO = "needs mujoco's {what}, which the PyTorch port does not use (ROADMAP A10)"
NO_BENCH = ("bench: the port has no benchmark yet (ROADMAP A, the note on BENCHMARK.json); "
            "bench.py drives the JAX package, and chip_smoke.py drives the port's paths on "
            "the card")


def _add_common(p):
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="data", help="output directory")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain PyTorch versions)")


def _mppi_override(args):
    ov = {}
    if args.K:
        ov["n_samples"] = args.K
    if args.T:
        ov["horizon"] = args.T
    return ov or None


def _add_kt(p):
    p.add_argument("--K", type=int, default=0, help="override sample count")
    p.add_argument("--T", type=int, default=0, help="override horizon")


def _seconds(fn, device) -> float:
    """fn()'s seconds: CUDA events on a card, read after a synchronise;
    the host clock on the CPU."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3


def cmd_tasks(args):
    from .envs.tasks import TASKS

    for name, spec in TASKS.items():
        cfg = spec.mppi
        print(f"{name:24s} asset={spec.model}.xml "
              f"K={cfg.n_samples} T={cfg.horizon} "
              f"lam={cfg.temperature} sigma={cfg.sigma}")
    return 0


def cmd_run(args):
    from .collect.runner import EpisodeRunner

    if args.live:
        raise SystemExit(f"run --live {NO_MUJOCO.format(what='viewer')}")
    runner = EpisodeRunner(args.task, use_kernel=args.kernel,
                           mppi_override=_mppi_override(args), device=args.device)
    res = runner.run(max_steps=args.steps, seed=args.seed, metrics_path=args.metrics)
    res.logger.save_run_dir(args.out)
    print(json.dumps({
        "task": args.task, "steps": res.steps,
        "goal_reached": bool(res.goal_reached), "fell": bool(res.fell),
        "final_qpos_xyz": [round(float(v), 4) for v in res.final_qpos[:3]],
        "out": args.out,
    }))
    return 0


def cmd_collect(args):
    from .collect import runner

    common = dict(seed=args.seed, max_steps=args.steps, shard_index=args.shard_index,
                  num_shards=args.num_shards, device=args.device)
    # --kernel reaches the two humanoid collectors that take it; the v2.py
    # collector and the Go1's ignore it, and the Go1's --K/--T too, as in
    # the JAX CLI
    if args.robot == "humanoid":
        extra = {"task_name": args.task} if args.task else {}
        results = runner.collect_humanoid(
            n_episodes=args.episodes, out_dir=args.out, use_kernel=args.kernel,
            mppi_override=_mppi_override(args), retries=args.retries,
            metrics_path=args.metrics, **common, **extra)
    elif args.robot == "humanoid_jl":
        results = runner.collect_humanoid_jl(
            n_episodes=args.episodes, out_dir=args.out, use_kernel=args.kernel,
            mppi_override=_mppi_override(args), metrics_path=args.metrics, **common)
    elif args.robot == "humanoid_v2py":
        results = runner.collect_humanoid_v2py(
            n_episodes=args.episodes, out_dir=args.out,
            mppi_override=_mppi_override(args), **common)
    elif args.robot == "quadruped":
        results = runner.collect_quadruped(n_runs=args.episodes, out_base=args.out, **common)
    else:
        raise SystemExit(f"unknown robot {args.robot}")
    print(json.dumps({"robot": args.robot, "results": results}))
    return 0


def cmd_profile(args):
    """N replans of a task under torch.profiler: a chrome trace in --out
    and one JSON line of counters. compile_s is the first replan's seconds
    (the kernel's build or cache load, then its first launch); replan_ms
    the mean of the traced replans, timed by CUDA events on a card."""
    import dataclasses

    import torch

    from ._device import resolve_device
    from .envs.tasks import load_task
    from .solver.kernel_mppi import make_kernel_mppi
    from .solver.mppi import MPPIState, make_mppi

    dev = resolve_device(args.device)
    spec, model, dynamics, running, terminal, init_state, cfg = load_task(args.task, device=dev)
    ov = _mppi_override(args)
    if ov:
        cfg = dataclasses.replace(cfg, **ov)
    kernel = bool(args.kernel and spec.kernel_cost is not None)
    if kernel:
        plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg,
                                cost_kwargs=spec.cost_kwargs, device=dev)
    else:
        plan = make_mppi(dynamics, running, cfg, terminal_fn=terminal)
    state = [MPPIState.seeded(args.seed, cfg.T, model.nu, device=dev)]

    def replans(n):
        for _ in range(n):
            _, state[0], _ = plan(state[0], init_state)

    t0 = time.perf_counter()
    replans(1)
    state[0].U.cpu()
    compile_s = time.perf_counter() - t0

    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        lat = _seconds(lambda: replans(args.iters), dev) / args.iters
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    print(json.dumps({
        "task": args.task, "K": cfg.n_samples, "T": cfg.horizon, "kernel": kernel,
        "replan_ms": round(lat * 1e3, 3),
        "rollouts_per_s": round(cfg.n_samples / lat, 1),
        "compile_s": round(compile_s, 1), "trace_dir": args.out,
    }))
    return 0


def cmd_train(args):
    import dataclasses

    from .learning import train

    cfg = train.PRESET_CONFIGS.get(args.preset, train.TrainConfig())
    over = {}
    if args.epochs:
        over["epochs"] = args.epochs
    if args.ckpt_dir:
        over["ckpt_dir"] = args.ckpt_dir
    if args.resume_from:
        over["resume_from"] = args.resume_from
    if args.metrics:
        over["log_path"] = args.metrics
    cfg = dataclasses.replace(cfg, **over)
    out = train.train_model(args.states, args.actions, cfg, device=args.device)
    print(json.dumps({k: v for k, v in out.items()
                      if isinstance(v, (int, float, str, bool))}))
    return 0


def _estimator_module(preset: str, seed: int, checkpoint=None, torch_checkpoint=None,
                     device="cuda"):
    """The `<preset>_attention` surrogate of `estimate`: a reference .pth
    (torch_checkpoint), a learning/train checkpoint, or seeded PyTorch
    initialisers, on `device`."""
    from ._device import resolve_device
    from .learning.torch_import import load_reference_checkpoint
    from .learning.train import load_checkpoint
    from .models.predictors import seeded_model

    dev = resolve_device(device)
    name = f"{preset}_attention"
    if torch_checkpoint:
        return load_reference_checkpoint(torch_checkpoint, name, device=dev)
    module = seeded_model(name, seed).to(dev)
    if checkpoint:
        load_checkpoint(checkpoint, module)
    return module


def cmd_estimate(args):
    from .collect import estimator
    from .costs import cartpole as cartpole_cost
    from .utils.trajio import write_csv

    preset = args.preset
    if preset == "cartpole":
        state_slice, task = None, "cartpole"
        running, terminal = cartpole_cost.make_costs_flat()
    elif preset == "quadruped":
        state_slice, task = 37, "go1"
        running, terminal = estimator.quadruped_estimator_costs()
    else:
        raise SystemExit(f"unknown estimator preset {preset}")
    module = _estimator_module(preset, args.seed, args.checkpoint, args.torch_checkpoint,
                              args.device)
    runner = estimator.EstimatorRunner(task, module, estimator.ESTIMATOR_CONFIGS[preset],
                                       running, terminal, state_slice=state_slice,
                                       seed=args.seed, device=args.device)
    log = runner.run(n_steps=args.steps, seed=args.seed)
    os.makedirs(args.out, exist_ok=True)
    s, a, t = log.arrays()
    write_csv(os.path.join(args.out, "states.csv"), s)
    write_csv(os.path.join(args.out, "actions.csv"), a)
    write_csv(os.path.join(args.out, "times.csv"), t.reshape(-1, 1))
    print(json.dumps({"preset": preset, "steps": int(s.shape[0]), "out": args.out}))
    return 0


def _snapshot_model(asset: str):
    """The PhysicsModel that --asset names: a snapshot .json path, which
    must exist, or an MJCF path or name whose basename names a committed
    snapshot."""
    from .physics.model import load_model, model_from_arrays

    if asset.endswith(".json"):
        if not os.path.exists(asset):
            raise SystemExit(f"replay --asset {asset}: no such snapshot file")
        with open(asset) as f:
            return model_from_arrays(json.load(f))
    return load_model(os.path.splitext(os.path.basename(asset))[0])


def cmd_replay(args):
    import numpy as np

    from .utils.trajio import read_csv
    from .viz.replay import kinematic_replay

    if args.video:
        raise SystemExit(f"replay --video {NO_MUJOCO.format(what='renderer')}")
    states = read_csv(args.states)
    frames = kinematic_replay(_snapshot_model(args.asset), states, stride=args.stride,
                              device=args.device)
    print(json.dumps({"frames": int(frames.shape[0]),
                      "nbody": int(frames.shape[1]),
                      "root_travel": round(float(
                          np.linalg.norm(frames[-1, 1] - frames[0, 1])), 4)}))
    return 0


def cmd_bench(args):
    raise SystemExit(NO_BENCH)


def cmd_warm(args):
    """Build every CUDA kernel (ops/_build: one nvcc per source, all
    started together; a cached build is loaded) and time one replan of
    --task on the rollout kernel at --k, --horizon in f32 (compile_s: the
    build or cache load, then the first launch). --full also runs two
    control steps of humanoid_walk on the rollout kernel."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from ._device import resolve_device
    from .envs.tasks import load_task
    from .ops import _build
    from .solver.kernel_mppi import make_kernel_mppi
    from .solver.mppi import MPPIState

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("warm builds the CUDA kernels: it runs on the card only")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        builds = dict(zip(_build.SOURCES, pool.map(_build.build, _build.SOURCES)))
    spec, model, _, _, _, init_state, cfg = load_task(args.task, device=dev)
    cfg = dataclasses.replace(cfg, n_samples=args.k, horizon=args.horizon)
    plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg,
                            cost_kwargs=spec.cost_kwargs, device=dev)
    ms = MPPIState.seeded(0, cfg.T, model.nu, device=dev)
    action, ms, _ = plan(ms, init_state)
    action.cpu()
    out = {"task": args.task, "K": args.k, "H": args.horizon,
           "compile_s": round(time.perf_counter() - t0, 1),
           "cached": {src: b["cached"] for src, b in builds.items()},
           "nvcc_s": round(sum(b["seconds"] for b in builds.values()), 1)}
    if args.full:
        from .collect.runner import EpisodeRunner

        t0 = time.perf_counter()
        r = EpisodeRunner("humanoid_walk", use_kernel=True,
                          mppi_override={"n_samples": args.k, "horizon": args.horizon},
                          device=dev)
        r.run(max_steps=2, chunk=2)
        out["collect_compile_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="humanoid_mppi_rl_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("tasks", help="list registry tasks").set_defaults(fn=cmd_tasks)

    p = sub.add_parser("run", help="one episode of a registry task")
    p.add_argument("--task", required=True)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--kernel", action="store_true",
                   help="plan through the CUDA rollout kernel")
    p.add_argument("--live", action="store_true",
                   help="the JAX CLI's MuJoCo viewer mirror (refused: no mujoco)")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    _add_kt(p)
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("collect", help="batch data collection")
    p.add_argument("--robot", required=True,
                   choices=["humanoid", "humanoid_jl", "humanoid_v2py", "quadruped"])
    p.add_argument("--task", default=None,
                   help="registry task override for --robot humanoid "
                        "(e.g. humanoid_walk: tuned gait + narrower noise)")
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--shard-index", type=int, default=0)
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--retries", type=int, default=0)
    p.add_argument("--kernel", action="store_true")
    p.add_argument("--metrics", default=None)
    _add_kt(p)
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_collect)

    p = sub.add_parser("profile", help="trace N replans with torch.profiler")
    p.add_argument("--task", required=True)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--kernel", action="store_true")
    _add_kt(p)
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("train", help="train a dynamics surrogate")
    p.add_argument("--preset", default="humanoid", help="humanoid | cartpole | quadruped")
    p.add_argument("--states", required=True, help="states CSV dir")
    p.add_argument("--actions", required=True, help="actions CSV dir")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--metrics", default=None)
    _add_device(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("estimate", help="MPPI on a trained surrogate")
    p.add_argument("--preset", required=True, help="cartpole | quadruped")
    p.add_argument("--checkpoint", default=None,
                   help="a learning/train checkpoint .pt (default: seeded init)")
    p.add_argument("--torch-checkpoint", default=None,
                   help="reference-trained .pth state_dict to import")
    p.add_argument("--steps", type=int, default=200)
    _add_common(p)
    _add_device(p)
    p.set_defaults(fn=cmd_estimate)

    p = sub.add_parser("replay", help="replay a logged trajectory")
    p.add_argument("--states", required=True, help="states CSV")
    p.add_argument("--asset", required=True,
                   help="MJCF path or name naming a model snapshot, or a snapshot .json")
    p.add_argument("--video", default=None, help="mp4 output (refused: no mujoco)")
    p.add_argument("--fps", type=int, default=60)
    p.add_argument("--stride", type=int, default=1)
    _add_device(p)
    p.set_defaults(fn=cmd_replay)

    sub.add_parser("bench", help="repo benchmark (not ported yet)").set_defaults(fn=cmd_bench)

    p = sub.add_parser("warm", help="build every CUDA kernel and time a first replan")
    p.add_argument("--task", default="humanoid_collect")
    p.add_argument("--k", type=int, default=8192)
    p.add_argument("--horizon", type=int, default=64)
    p.add_argument("--full", action="store_true",
                   help="also run two collection control steps")
    _add_device(p)
    p.set_defaults(fn=cmd_warm)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
