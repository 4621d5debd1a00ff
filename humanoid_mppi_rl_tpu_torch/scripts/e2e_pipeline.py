"""End-to-end pipeline demo: MPPI data collection -> dynamics learning ->
estimator MPPI (the reference workflow: src/*_datacollection.* ->
learning/train*.py -> src/*_mppi_estimator.py) at demo sizes, as the JAX
repo's scripts/e2e_pipeline.py.

Run:        python -m humanoid_mppi_rl_tpu_torch.scripts.e2e_pipeline [--device cpu]
Env knobs:  E2E_TASK (default go1_collect), E2E_EPISODES, E2E_STEPS,
            E2E_EPOCHS, E2E_K, E2E_OUT

On the card (--device cuda, the default) the collection plans with the
rollout kernel; on the CPU with the array planner, as the JAX script picks
the kernel planner on an accelerator.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np

from ..cli import _add_device as add_device


def settings(device: str) -> dict:
    """The environment knobs, and the planner the device takes."""
    import torch

    return dict(task=os.environ.get("E2E_TASK", "go1_collect"),
                n_ep=int(os.environ.get("E2E_EPISODES", "3")),
                n_steps=int(os.environ.get("E2E_STEPS", "250")),
                epochs=int(os.environ.get("E2E_EPOCHS", "10")),
                K=int(os.environ.get("E2E_K", "1024")),
                out=os.environ.get("E2E_OUT", "/tmp/e2e_demo"),
                use_kernel=torch.device(device).type == "cuda", device=device)


def collect_stage(s: dict, chunk: int = 50):
    """n_ep episodes of the task into <out>/{states,actions}/ep<i>.csv;
    returns the runner. `chunk` (EpisodeRunner.run's; a chunk always runs
    to its end) shrinks the run for a test."""
    from ..collect.runner import EpisodeRunner
    from ..utils.trajio import write_csv

    t0 = time.time()
    runner = EpisodeRunner(s["task"], mppi_override={"n_samples": s["K"]},
                           use_kernel=s["use_kernel"], device=s["device"])
    sdir, adir = os.path.join(s["out"], "states"), os.path.join(s["out"], "actions")
    for ep in range(s["n_ep"]):
        res = runner.run(max_steps=s["n_steps"], seed=ep, chunk=chunk)
        st, a, _ = res.logger.arrays()
        os.makedirs(sdir, exist_ok=True)
        os.makedirs(adir, exist_ok=True)
        write_csv(os.path.join(sdir, f"ep{ep}.csv"), st)
        write_csv(os.path.join(adir, f"ep{ep}.csv"), a)
        print(f"[collect] episode {ep}: {res.steps} steps, "
              f"final qpos[0:3]={np.round(res.final_qpos[:3], 3)}")
    print(f"[collect] done in {time.time() - t0:.0f}s")
    return runner


def train_stage(s: dict, model_overrides: Optional[dict] = None) -> dict:
    """The task's surrogate preset on the collected CSVs; returns
    train_model's result. `model_overrides` narrows the module for a test."""
    from ..learning.train import TrainConfig, train_model

    t0 = time.time()
    cfg = TrainConfig(
        model_preset="quadruped_attention" if "go1" in s["task"] else "humanoid_attention",
        lr=3e-4, epochs=s["epochs"], batch_size=64,
        ckpt_dir=os.path.join(s["out"], "ckpt"), ckpt_every=0,
        model_overrides=model_overrides)
    result = train_model(os.path.join(s["out"], "states"), os.path.join(s["out"], "actions"),
                         cfg, device=s["device"])
    print(f"[train] best eval loss {result['best_eval_loss']:.5f} "
          f"({result['n_pairs']} pairs) in {time.time() - t0:.0f}s")
    return result


def estimator_stage(s: dict, module, n_steps: int = 50,
                    mppi_override: Optional[dict] = None) -> np.ndarray:
    """n_steps control steps of estimator MPPI on the trained surrogate
    against the task's plant; returns the logged states. `n_steps` and
    `mppi_override` shrink the run for a test."""
    from ..collect.estimator import (ESTIMATOR_CONFIGS, EstimatorRunner,
                                     quadruped_estimator_costs)

    t0 = time.time()
    running, terminal = quadruped_estimator_costs()
    ecfg = dataclasses.replace(ESTIMATOR_CONFIGS["quadruped"], n_samples=min(2048, s["K"]),
                               **(mppi_override or {}))
    est = EstimatorRunner(s["task"], module, ecfg, running, terminal, device=s["device"])
    s2, _, _ = est.run(n_steps=n_steps).arrays()
    print(f"[estimator] {n_steps} control steps on the surrogate in "
          f"{time.time() - t0:.0f}s; plant finite={np.isfinite(s2).all()}, "
          f"final root x={s2[-1, 0]:.3f}")
    return s2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    s = settings(ap.parse_args(argv).device)
    collect_stage(s)
    result = train_stage(s)
    estimator_stage(s, result["model"])
    print("E2E PIPELINE OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
