"""Full-scale reference pipeline on one command (the JAX repo's
scripts/full_pipeline.py, on PyTorch and the card):

  1. collect   -- rollout-kernel, goal-gated humanoid episode collection at
                 reference scale (N randomized goal episodes, only
                 successes saved, 57-col states in data/{states,actions,
                 times}_ft/)
  2. train     -- humanoid preset FeatureAttention(30,21,512,8,7) for the
                 full reference budget (200 epochs, Adam 1e-3 cosine->1e-6,
                 batch 64), epochs as one device pass each
                 (TrainConfig.scan_epochs)
  3. estimator -- closed-loop estimator MPPI on the self-trained surrogate
                 against the coupled-tier physics plant (--flash: the
                 rollouts through the CUDA estimator kernel)

Stages are resumable: each writes a completion marker under --out and is
skipped when the marker exists (delete the marker or pass --force to
re-run). Everything observable lands under --out: collected CSVs, metrics
JSONL per stage, checkpoints (.pt state_dicts), the estimator trajectory
and summary.json.

  python -m humanoid_mppi_rl_tpu_torch.scripts.full_pipeline \\
      --out artifacts/full_pipeline --episodes 50 --epochs 200

--device (default cuda) runs every stage on that device; --device cpu runs
the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np

from ..cli import _add_device as add_device
from ._stages import finish, load_summary, pending, summary_path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts/full_pipeline")
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--max-steps", type=int, default=2500)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--task", default="humanoid_walk")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--rollout-k", type=int, default=1,
                    help="multi-step rollout loss window (8 reproduces the rollout_k "
                         "surrogate that is open-loop sane; 1 = the reference one-step "
                         "contract)")
    ap.add_argument("--grad-clip", type=float, default=0.0)
    ap.add_argument("--estimator-steps", type=int, default=100)
    ap.add_argument("--estimator-k", type=int, default=2048)
    ap.add_argument("--flash", action="store_true",
                    help="plan estimator rollouts through the CUDA estimator kernel "
                         "(ops/estimator_kernel)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-index", type=int, default=0)
    ap.add_argument("--num-shards", type=int, default=1)
    ap.add_argument("--force", action="store_true")
    add_device(ap)
    return ap.parse_args(argv)


def collect_stage(args, summary: dict, mppi_override: Optional[dict] = None,
                  chunk: Optional[int] = None) -> None:
    """Goal-gated collection into <out>/data. `mppi_override` and `chunk`
    (collect_humanoid's; a chunk always runs to its end) shrink the run
    for a test; the command line uses the task's preset."""
    from ..collect.runner import CHUNK, collect_humanoid

    out = args.out
    if not pending(out, "collect", args.force):
        return
    t0 = time.time()
    results = collect_humanoid(
        n_episodes=args.episodes, out_dir=os.path.join(out, "data"), seed=args.seed,
        max_steps=args.max_steps, task_name=args.task, use_kernel=True,
        retries=args.retries, shard_index=args.shard_index, num_shards=args.num_shards,
        metrics_path=os.path.join(out, "collect_metrics.jsonl"),
        mppi_override=mppi_override, chunk=chunk or CHUNK, device=args.device)
    wall = time.time() - t0
    n_ok = sum(1 for r in results if r["goal"])
    # strict accounting: every executed control step across retries, wall
    # clock including the kernel's build
    steps = sum(r["steps_executed"] for r in results)
    finish(out, summary, "collect", {
        "episodes_attempted": len(results), "episodes_goal": n_ok,
        "goal_rate": round(n_ok / max(len(results), 1), 3),
        "control_steps_executed": steps, "wall_s": round(wall, 1),
        "steps_per_s_strict": round(steps / wall, 2),
        "task": args.task, "results": results,
    })


def train_stage(args, summary: dict, model_overrides: Optional[dict] = None) -> None:
    """The humanoid preset on data/{states,actions}_ft/ (the goal-gated
    collector's layout). `model_overrides` narrows the module for a test."""
    from ..learning.train import PRESET_CONFIGS, train_model

    out = args.out
    if not pending(out, "train", args.force):
        return
    cfg = dataclasses.replace(
        PRESET_CONFIGS["humanoid"], epochs=args.epochs,
        ckpt_dir=os.path.abspath(os.path.join(out, "ckpt")), scan_epochs=True,
        rollout_k=args.rollout_k,
        grad_clip=(args.grad_clip or (1.0 if args.rollout_k > 1 else 0.0)),
        plot_path=os.path.join(out, "loss_curve.png"),
        log_path=os.path.join(out, "train_metrics.jsonl"),
        model_overrides=model_overrides)
    t0 = time.time()
    data_dir = os.path.join(out, "data")
    res = train_model(os.path.join(data_dir, "states_ft"), os.path.join(data_dir, "actions_ft"),
                      cfg, device=args.device)
    wall = time.time() - t0
    n_steps = args.epochs * max(1, res["n_pairs"] // cfg.batch_size)
    finish(out, summary, "train", {
        "epochs": args.epochs, "n_pairs": res["n_pairs"],
        "best_eval_loss": res["best_eval_loss"],
        "final_train_loss": res["final_train_loss"],
        "best_checkpoint": res["best_checkpoint"],
        "final_checkpoint": res["final_checkpoint"],
        "wall_s": round(wall, 1),
        "train_steps_per_s": round(n_steps / wall, 1),
        "samples_per_s": round(n_steps * cfg.batch_size / wall, 1),
    })


def estimator_stage(args, summary: dict, model_overrides: Optional[dict] = None,
                    mppi_override: Optional[dict] = None) -> None:
    """The closed loop on the trained surrogate (the train stage's best
    checkpoint) against humanoid_collect's coupled plant, the surrogate's
    state [qpos; foot_l_z; foot_r_z]."""
    from ..collect.estimator import (ESTIMATOR_CONFIGS, EstimatorRunner,
                                     humanoid_estimator_costs, humanoid_foot_state_fn)
    from ..learning.train import load_checkpoint
    from ..models.predictors import make_model
    from ..physics.model import load_model

    out = args.out
    if not pending(out, "estimator", args.force):
        return
    best = summary.get("train", {}).get(
        "best_checkpoint", os.path.abspath(os.path.join(out, "ckpt", "model_best.pt")))
    net = load_checkpoint(best, make_model("humanoid_attention", **(model_overrides or {})))
    cfg = dataclasses.replace(ESTIMATOR_CONFIGS["humanoid"], n_samples=args.estimator_k,
                              **(mppi_override or {}))
    running, terminal = humanoid_estimator_costs()
    # the 30 columns the surrogate was trained on: [qpos(28); foot_l_z;
    # foot_r_z] (the train preset's state_idxes [0..27, 55, 56])
    state_fn = humanoid_foot_state_fn(load_model("humanoid_plant"))
    est = EstimatorRunner("humanoid_collect", net, cfg, running, terminal, state_fn=state_fn,
                          batched_dynamics=args.flash, device=args.device)
    t0 = time.time()
    log = est.run(n_steps=args.estimator_steps, seed=args.seed)   # ends with a host fetch
    wall = time.time() - t0
    s, a, t = log.arrays()
    np.savez_compressed(os.path.join(out, "estimator_closedloop.npz"), states=s, actions=a,
                        times=t)
    finish(out, summary, "estimator", {
        "steps": int(s.shape[0]), "K": args.estimator_k,
        "finite": bool(np.isfinite(s).all()),
        "final_root_xyz": [round(float(v), 4) for v in s[-1, :3]],
        "min_torso_z": round(float(s[:, 2].min()), 4),
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
    train_stage(args, summary)
    estimator_stage(args, summary)
    print(json.dumps({"stage": "done", "summary": summary_path(args.out)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
