"""Velocity-supervised surrogate pipeline (the JAX repo's
scripts/vel_pipeline.py, on PyTorch and the card).

The surrogate predicts the full 57-col logged state [qpos(28); qvel(27);
foot_l_z; foot_r_z] with the multi-step rollout loss
(TrainConfig.rollout_k) and egocentric root x/y, and the estimator loop's
cost reads the predicted velocities directly
(collect/estimator.humanoid_predvel_estimator_costs): no finite
differences in the cost.

Stages (resumable via .done_* markers, as full_pipeline's):
  1. collect   goal-gated rollout-kernel humanoid_walk episodes (plus the
               trajectories of artifacts/full_pipeline/data_sample, under
               the working directory, when that directory exists)
  2. train     FeatureAttention(57,21,512,8,7), rollout_k=8, ego-x/y,
               grad_clip=1.0
  3. estimator closed loop at K=2048/T=25 (--flash: the CUDA estimator
               kernel), with the JAX record's FK-cost baseline (0.159 m /
               120 steps) and truth ceiling (0.634 m / 240 steps) beside it

  python -m humanoid_mppi_rl_tpu_torch.scripts.vel_pipeline --episodes 24 --epochs 150 --flash
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
from ._stages import finish, load_summary, pending

SAMPLE_DIR = os.path.join("artifacts", "full_pipeline", "data_sample")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/vel_surrogate")
    ap.add_argument("--episodes", type=int, default=24)
    ap.add_argument("--max-steps", type=int, default=2500)
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="peak LR; 1e-3 (the 30-dim rollout_k recipe) is unstable on the "
                         "57-dim velocity-supervised composition (eval oscillates 1e3-5e3 "
                         "in the JAX record)")
    ap.add_argument("--rollout-k", type=int, default=8)
    ap.add_argument("--estimator-steps", type=int, default=120)
    ap.add_argument("--estimator-k", type=int, default=2048)
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--force", action="store_true")
    add_device(ap)
    return ap.parse_args(argv)


def collect_stage(args, summary: dict, mppi_override: Optional[dict] = None,
                  chunk: Optional[int] = None) -> None:
    """Goal-gated humanoid_walk collection into <out>/data, then the sample
    trajectories merged in. `mppi_override` and `chunk` shrink the run for
    a test."""
    from ..collect.runner import CHUNK, collect_humanoid

    out = args.out
    if not pending(out, "collect", args.force):
        return
    data_dir = os.path.join(out, "data")
    t0 = time.time()
    results = collect_humanoid(
        n_episodes=args.episodes, out_dir=data_dir, seed=args.seed, max_steps=args.max_steps,
        task_name="humanoid_walk", use_kernel=True, retries=args.retries,
        metrics_path=os.path.join(out, "collect_metrics.jsonl"),
        mppi_override=mppi_override, chunk=chunk or CHUNK, device=args.device)
    wall = time.time() - t0
    # the committed sample trajectories (same task and collection settings)
    merged = 0
    if os.path.isdir(SAMPLE_DIR):
        for sub in ("states_ft", "actions_ft", "times_ft"):
            dst = os.path.join(data_dir, sub)
            os.makedirs(dst, exist_ok=True)
            for f in os.listdir(os.path.join(SAMPLE_DIR, sub)):
                shutil.copy(os.path.join(SAMPLE_DIR, sub, f), os.path.join(dst, f))
                merged += sub == "states_ft"
    n_ok = sum(1 for r in results if r["goal"])
    steps = sum(r["steps_executed"] for r in results)
    finish(out, summary, "collect", {
        "episodes_attempted": len(results), "episodes_goal": n_ok,
        "goal_rate": round(n_ok / max(len(results), 1), 3),
        "control_steps_executed": steps, "wall_s": round(wall, 1),
        "steps_per_s_strict": round(steps / wall, 2),
        "merged_sample_trajectories": merged,
    })


def train_stage(args, summary: dict, model_overrides: Optional[dict] = None) -> None:
    """The full 57-col state, rollout_k windows, ego x/y. `model_overrides`
    narrows the module for a test."""
    from ..learning.train import PRESET_CONFIGS, train_model

    out = args.out
    if not pending(out, "train", args.force):
        return
    cfg = dataclasses.replace(
        PRESET_CONFIGS["humanoid"], epochs=args.epochs, lr=args.lr,
        ckpt_dir=os.path.abspath(os.path.join(out, "ckpt")), scan_epochs=True,
        rollout_k=args.rollout_k, grad_clip=1.0,
        state_idxes=None,                      # the full 57-col state
        model_overrides={"state_dim": 57, **(model_overrides or {})},
        ego_xy_cols=(0, 1),
        plot_path=os.path.join(out, "loss_curve.png"),
        log_path=os.path.join(out, "train_metrics.jsonl"))
    t0 = time.time()
    data_dir = os.path.join(out, "data")
    res = train_model(os.path.join(data_dir, "states_ft"), os.path.join(data_dir, "actions_ft"),
                      cfg, device=args.device)
    wall = time.time() - t0
    finish(out, summary, "train", {
        "epochs": args.epochs, "n_pairs": res["n_pairs"],
        "rollout_k": args.rollout_k,
        "best_eval_loss": res["best_eval_loss"],
        "final_train_loss": res["final_train_loss"],
        "best_checkpoint": res["best_checkpoint"],
        "wall_s": round(wall, 1),
    })


def estimator_stage(args, summary: dict, model_overrides: Optional[dict] = None) -> None:
    """The closed loop on ckpt/model_best.pt against humanoid_collect's
    coupled plant, the predicted-velocity walking cost."""
    import torch

    from ..collect.estimator import (ESTIMATOR_CONFIGS, EstimatorRunner,
                                     humanoid_predvel_estimator_costs)
    from ..learning.train import load_checkpoint
    from ..models.predictors import make_model
    from ..physics.model import load_model

    out = args.out
    if not pending(out, "estimator", args.force):
        return
    net = load_checkpoint(os.path.abspath(os.path.join(out, "ckpt", "model_best.pt")),
                          make_model("humanoid_attention",
                                     **{"state_dim": 57, **(model_overrides or {})}))
    pm = load_model("humanoid_plant")
    id_l, id_r = pm.body_id("foot_left"), pm.body_id("foot_right")

    def state_fn(plant):
        return torch.cat([plant.qpos, plant.qvel, plant.xpos[id_l, 2:3],
                          plant.xpos[id_r, 2:3]])

    cfg = dataclasses.replace(ESTIMATOR_CONFIGS["humanoid"], n_samples=args.estimator_k,
                              horizon=args.horizon)
    running, terminal = humanoid_predvel_estimator_costs(pm)
    est = EstimatorRunner("humanoid_collect", net, cfg, running, terminal, state_fn=state_fn,
                          batched_dynamics=args.flash, fd_time_augment=57, ego_cols=(0, 1),
                          device=args.device)
    t0 = time.time()
    log = est.run(n_steps=args.estimator_steps, seed=args.seed)   # ends with a host fetch
    wall = time.time() - t0
    s, a, t = log.arrays()
    np.savez_compressed(os.path.join(out, "estimator_closedloop.npz"), states=s, actions=a,
                        times=t)
    x, z = s[:, 0], s[:, 2]
    finish(out, summary, "estimator", {
        "K": args.estimator_k, "T": args.horizon,
        "steps": int(s.shape[0]),
        "finite": bool(np.isfinite(s).all()),
        "x_progress_m": round(float(x[-1] - x[0]), 3),
        "torso_z_min": round(float(z.min()), 3),
        "torso_z_final": round(float(z[-1]), 3),
        "y_drift": round(float(s[-1, 1] - s[0, 1]), 3),
        "replan_s": round(wall / max(1, s.shape[0]), 3),
        "r5_fk_fd_baseline_m_120steps": 0.159,
        "truth_ceiling_m_240steps": 0.634,
    })


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    summary = load_summary(args.out)
    collect_stage(args, summary)
    train_stage(args, summary)
    estimator_stage(args, summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
