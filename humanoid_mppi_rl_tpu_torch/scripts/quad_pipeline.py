"""Quadruped (Go1) full pipeline on one command (the JAX repo's
scripts/quad_pipeline.py, on PyTorch and the card):

  1. collect   -- rollout-kernel multi-goal Go1 trot collection (run i's
                 goal at (2 + i mod 3, 0), a fall below trunk z = 0.08 ends
                 the attempt, only reached goals kept, per-run dirs
                 quad_data_goal/run_<i>/; 37-col states). All runs share one
                 planner: the goal rides in the kernel cost's runtime params.
  2. train     -- FeatureAttention(37,12,512,4,2) on the self-collected runs,
                 flattened into data_quadruped/{states,actions}/ (50 epochs,
                 Adam 1e-4 cosine), rollout_k=8
  3. estimator -- closed-loop estimator MPPI on the self-trained surrogate
                 against the coupled-tier Go1 plant from its `home` keyframe
                 (--flash: the CUDA estimator kernel)

Stages are resumable via completion markers (as full_pipeline's).
Observable outputs under --out: per-run CSV dirs, the flattened training
dirs, metrics JSONL, checkpoints (.pt state_dicts), the closed-loop
trajectory npz and summary.json.

  python -m humanoid_mppi_rl_tpu_torch.scripts.quad_pipeline --out artifacts/quad_pipeline
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import time
from typing import Optional

import numpy as np

from ..cli import _add_device as add_device
from ._stages import finish, load_summary, pending, summary_path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/quad_pipeline")
    ap.add_argument("--runs", type=int, default=24)
    ap.add_argument("--max-steps", type=int, default=12000)
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--reference-cost", action="store_true",
                    help="zero gait deltas (reference cost verbatim) instead of "
                         "costs/quadruped.GAIT_TUNED")
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--rollout-k", type=int, default=8,
                    help="multi-step rollout loss window (1 = the reference's one-step "
                         "contract)")
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=0.0,
                    help="override the preset learning rate (0 = preset)")
    ap.add_argument("--estimator-steps", type=int, default=200)
    ap.add_argument("--estimator-k", type=int, default=2048)
    ap.add_argument("--estimator-horizon", type=int, default=25)
    ap.add_argument("--surrogate", choices=["full", "qpos"], default="full",
                    help="full = the reference 37-in contract (FeatureAttention(37,12,...)); "
                         "qpos = position-only 19-in training + FD-velocity estimator cost")
    ap.add_argument("--estimator-cost", choices=["goal", "gait"], default="gait",
                    help="bare reference goal cost vs the FD/time-augmented trot cost "
                         "(collect/estimator.quadruped_gait_estimator_costs)")
    ap.add_argument("--flash", action="store_true",
                    help="estimator rollouts through the CUDA estimator kernel "
                         "(ops/estimator_kernel)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--force", action="store_true")
    add_device(ap)
    return ap.parse_args(argv)


def collect_stage(args, summary: dict) -> None:
    """Multi-goal collection into <out>/quad_data_goal/run_<i>/."""
    from ..collect.runner import collect_quadruped
    from ..costs.quadruped import GAIT_TUNED

    out = args.out
    if not pending(out, "collect", args.force):
        return
    gait = None if args.reference_cost else np.asarray(GAIT_TUNED, np.float32)
    # a fresh metrics file: the JSONL covers exactly this collect
    mpath = os.path.join(out, "collect_metrics.jsonl")
    if os.path.exists(mpath):
        os.remove(mpath)
    t0 = time.time()
    results = collect_quadruped(
        n_runs=args.runs, out_base=os.path.join(out, "quad_data_goal"), seed=args.seed,
        max_steps=args.max_steps, use_kernel=True,
        mppi_override={"n_samples": args.k, "horizon": args.horizon}, gait_params=gait,
        # the reference's committed data distribution: near goals in a cycle,
        # failed runs retried with reseeded noise
        goal_for_run=lambda i: (2.0 + (i % 3), 0.0),
        retries=args.retries, chunk=args.chunk,
        shard_index=args.shard_index, num_shards=args.num_shards,
        metrics_path=mpath, device=args.device)
    wall = time.time() - t0
    n_ok = sum(1 for r in results if r["goal"])
    # strict accounting: every executed control step of every attempt over
    # the wall clock, the kernel's build included
    steps = sum(r["steps_executed"] for r in results)
    finish(out, summary, "collect", {
        "runs_attempted": len(results), "runs_goal": n_ok,
        "goal_rate": round(n_ok / max(len(results), 1), 3),
        "attempts": sum(r["attempts"] for r in results),
        "fell_attempts": sum(1 for r in results if r["outcome"] == "fell"),
        "stalled_attempts": sum(1 for r in results if r["outcome"] == "stalled"),
        "control_steps_executed": steps, "wall_s": round(wall, 1),
        "steps_per_s_strict": round(steps / max(wall, 1e-9), 2),
        "K": args.k, "horizon": args.horizon,
        "results": results,
    })


def flatten_runs(out: str) -> int:
    """Copy each run dir's CSVs into data_quadruped/{states,actions}/
    <run>.csv (the reference trainer's flat layout); returns the count."""
    run_base, flat = os.path.join(out, "quad_data_goal"), os.path.join(out, "data_quadruped")
    for kind in ("states", "actions"):
        os.makedirs(os.path.join(flat, kind), exist_ok=True)
    n_flat = 0
    if os.path.isdir(run_base):
        for rd in sorted(os.listdir(run_base)):
            if not os.path.exists(os.path.join(run_base, rd, "states.csv")):
                continue
            for kind in ("states", "actions"):
                shutil.copyfile(os.path.join(run_base, rd, f"{kind}.csv"),
                                os.path.join(flat, kind, f"{rd}.csv"))
            n_flat += 1
    return n_flat


def train_stage(args, summary: dict, n_flat: int,
                model_overrides: Optional[dict] = None) -> None:
    """The quadruped preset on the flattened runs (the qpos surrogate: the
    19 position columns, ego x/y). `model_overrides` narrows the module for
    a test."""
    from ..learning.train import PRESET_CONFIGS, train_model

    out = args.out
    if not pending(out, "train", args.force):
        return
    tpath = os.path.join(out, "train_metrics.jsonl")
    if os.path.exists(tpath):
        os.remove(tpath)   # fresh per-run metrics (as the collect stage's)
    qpos = args.surrogate == "qpos"
    overrides = {**({"state_dim": 19} if qpos else {}), **(model_overrides or {})}
    cfg = dataclasses.replace(
        PRESET_CONFIGS["quadruped"], epochs=args.epochs,
        lr=args.lr or PRESET_CONFIGS["quadruped"].lr,
        ckpt_dir=os.path.abspath(os.path.join(out, "ckpt")), scan_epochs=True,
        rollout_k=args.rollout_k, grad_clip=args.grad_clip,
        state_idxes=tuple(range(19)) if qpos else None,
        model_overrides=overrides or None,
        ego_xy_cols=(0, 1) if qpos else None,
        plot_path=os.path.join(out, "loss_curve.png"),
        log_path=tpath)
    t0 = time.time()
    flat = os.path.join(out, "data_quadruped")
    res = train_model(os.path.join(flat, "states"), os.path.join(flat, "actions"), cfg,
                      device=args.device)
    wall = time.time() - t0
    finish(out, summary, "train", {
        "epochs": args.epochs, "rollout_k": args.rollout_k,
        "surrogate": args.surrogate,
        "n_runs_used": n_flat,
        "n_pairs": res["n_pairs"],
        "best_eval_loss": res["best_eval_loss"],
        "final_train_loss": res["final_train_loss"],
        "best_checkpoint": res["best_checkpoint"],
        "final_checkpoint": res["final_checkpoint"],
        "wall_s": round(wall, 1),
    })


def estimator_stage(args, summary: dict, model_overrides: Optional[dict] = None) -> None:
    """The closed loop on the train stage's best checkpoint against
    go1_collect's coupled plant, from the `home` keyframe."""
    from ..collect.estimator import (ESTIMATOR_CONFIGS, EstimatorRunner,
                                     quadruped_estimator_costs,
                                     quadruped_fd_gait_estimator_costs,
                                     quadruped_gait_estimator_costs)
    from ..learning.train import load_checkpoint
    from ..models.predictors import make_model
    from ..physics.model import load_model

    out = args.out
    if not pending(out, "estimator", args.force):
        return
    qpos = args.surrogate == "qpos"
    best = summary.get("train", {}).get(
        "best_checkpoint", os.path.abspath(os.path.join(out, "ckpt", "model_best.pt")))
    net = load_checkpoint(best, make_model("quadruped_attention",
                                           **({"state_dim": 19} if qpos else {}),
                                           **(model_overrides or {})))
    cfg = dataclasses.replace(ESTIMATOR_CONFIGS["quadruped"], n_samples=args.estimator_k,
                              horizon=args.estimator_horizon)
    kw = dict(batched_dynamics=args.flash, device=args.device)
    init_plan = None
    if args.estimator_cost == "gait":
        pm = load_model("go1")
        home12 = dict(pm.keyframes)["home"][7:19]
        if qpos:
            running, terminal = quadruped_fd_gait_estimator_costs(home12, dt=float(pm.timestep))
            # the collection's operating point: accumulate update around a
            # home-seeded plan, sigma 0.3 * 0.6, no tail decay, the noise
            # and the ctrl clamped to the position servos' ranges
            lo = tuple(float(a.ctrlrange[0]) for a in pm.actuators)
            hi = tuple(float(a.ctrlrange[1]) for a in pm.actuators)
            cfg = dataclasses.replace(cfg, update_mode="accumulate", sigma=0.3 * 0.6,
                                      tail_decay=0.0, ctrl_low=lo, ctrl_high=hi,
                                      clamp_rollout_ctrl=True)
            est = EstimatorRunner("go1_collect", net, cfg, running, terminal,
                                  state_fn=lambda plant: plant.qpos, fd_time_augment=19,
                                  ego_cols=(0, 1), **kw)
            init_plan = home12
        else:
            running, terminal = quadruped_gait_estimator_costs(home12)
            est = EstimatorRunner("go1_collect", net, cfg, running, terminal,
                                  fd_time_augment=37, **kw)
    else:
        running, terminal = quadruped_estimator_costs()
        est = EstimatorRunner("go1_collect", net, cfg, running, terminal, **kw)
    # the reference resets to the model's home keyframe before the loop
    init_qpos = dict(est.plant_model.keyframes).get("home")
    t0 = time.time()
    log = est.run(n_steps=args.estimator_steps, seed=args.seed, init_plan=init_plan,
                  init_qpos=init_qpos)   # ends with a host fetch
    wall = time.time() - t0
    s, a, t = log.arrays()
    np.savez_compressed(os.path.join(out, "estimator_closedloop.npz"), states=s, actions=a,
                        times=t)
    finish(out, summary, "estimator", {
        "steps": int(s.shape[0]), "K": args.estimator_k,
        "T": args.estimator_horizon, "cost": args.estimator_cost,
        "surrogate": args.surrogate,
        "finite": bool(np.isfinite(s).all()),
        "final_root_xyz": [round(float(v), 4) for v in s[-1, :3]],
        "min_trunk_z": round(float(s[:, 2].min()), 4),
        "forward_progress_m": round(float(s[-1, 0] - s[0, 0]), 4),
        "wall_s": round(wall, 1),
        "replan_s": round(wall / max(1, s.shape[0]), 3),
        "checkpoint": best,
    })


def main(argv=None) -> int:
    import json

    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    summary = load_summary(args.out)
    collect_stage(args, summary)
    n_flat = flatten_runs(args.out)
    train_stage(args, summary, n_flat)
    estimator_stage(args, summary)
    print(json.dumps({"stage": "done", "summary": summary_path(args.out)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
