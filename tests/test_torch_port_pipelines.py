"""PyTorch port, slice 15: the four pipeline scripts
(humanoid_mppi_rl_tpu_torch/scripts/{e2e,full,quad,vel}_pipeline.py, the
JAX repo's scripts/*_pipeline.py) on the CPU at tiny sizes.

Each stage function runs with a narrow surrogate (16 wide, one layer) and
K <= 16, a step or two. Goal-gated collection saves only the episodes that
reach their goal, and a step or two reaches none, so the later stages are
fed through the pipelines' own resume mechanism: a small seeded dataset in
the reference layout, the collect stage's marker already written. Checked:
each stage writes its marker and its summary.json record with the JAX
script's keys (those tests/test_{full,quad}_pipeline_artifacts.py and
tests/test_vel_surrogate_artifacts.py read among them); a second run skips
a stage and --force reruns it; the JAX package's utils/trajio reads the
CSVs a pipeline wrote. vel_pipeline's surrogate has 78 tokens: the bf16
attention kernel's query tiles past 64 tokens, whose exact-sum check
inputs are checked here."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from chip_smoke import exact_stage_cases
from humanoid_mppi_rl_tpu.utils.trajio import read_csv as jax_read_csv
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
from humanoid_mppi_rl_tpu_torch.scripts import (e2e_pipeline, full_pipeline, quad_pipeline,
                                                vel_pipeline)
from humanoid_mppi_rl_tpu_torch.scripts._stages import load_summary, marker
from humanoid_mppi_rl_tpu_torch.utils.trajio import write_csv
from test_torch_port_estimator import _SumSpans

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

TINY = dict(n_samples=4, horizon=2)
NARROW = dict(hidden_dim=16, attn_layers=1, num_heads=2)

# summary.json's records, key for key as the JAX scripts write them
FULL_KEYS = {
    "collect": ["episodes_attempted", "episodes_goal", "goal_rate", "control_steps_executed",
                "wall_s", "steps_per_s_strict", "task", "results"],
    "train": ["epochs", "n_pairs", "best_eval_loss", "final_train_loss", "best_checkpoint",
              "final_checkpoint", "wall_s", "train_steps_per_s", "samples_per_s"],
    "estimator": ["steps", "K", "finite", "final_root_xyz", "min_torso_z", "wall_s",
                  "replan_s", "checkpoint"],
}
VEL_KEYS = {
    "collect": ["episodes_attempted", "episodes_goal", "goal_rate", "control_steps_executed",
                "wall_s", "steps_per_s_strict", "merged_sample_trajectories"],
    "train": ["epochs", "n_pairs", "rollout_k", "best_eval_loss", "final_train_loss",
              "best_checkpoint", "wall_s"],
    "estimator": ["K", "T", "steps", "finite", "x_progress_m", "torso_z_min", "torso_z_final",
                  "y_drift", "replan_s", "r5_fk_fd_baseline_m_120steps",
                  "truth_ceiling_m_240steps"],
}
QUAD_KEYS = {
    "collect": ["runs_attempted", "runs_goal", "goal_rate", "attempts", "fell_attempts",
                "stalled_attempts", "control_steps_executed", "wall_s", "steps_per_s_strict",
                "K", "horizon", "results"],
    "train": ["epochs", "rollout_k", "surrogate", "n_runs_used", "n_pairs", "best_eval_loss",
              "final_train_loss", "best_checkpoint", "final_checkpoint", "wall_s"],
    "estimator": ["steps", "K", "T", "cost", "surrogate", "finite", "final_root_xyz",
                  "min_trunk_z", "forward_progress_m", "wall_s", "replan_s", "checkpoint"],
}
RESULT_KEYS = ["run", "goal", "steps_saved", "steps_executed", "attempts", "outcome"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The trainer writes TensorBoard scalars when it can import them; the
    import alone takes seconds."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _walk(rng, rows: int, cols: int) -> np.ndarray:
    return np.cumsum(rng.normal(0, 0.05, (rows, cols)), axis=0) + rng.normal(0, 0.5, cols)


def _humanoid_data(data_dir, seed: int = 0, episodes: int = 2, rows: int = 40) -> None:
    """Seeded humanoid episodes in the goal-gated collector's layout:
    {states,actions,times}_ft/<kind>_<i>.csv, 57-col states."""
    rng = np.random.default_rng(seed)
    for i in range(episodes):
        for kind, arr in (("states", _walk(rng, rows, 57)), ("actions", _walk(rng, rows, 21)),
                          ("times", 0.005 * np.arange(rows)[:, None])):
            os.makedirs(os.path.join(data_dir, f"{kind}_ft"), exist_ok=True)
            write_csv(os.path.join(data_dir, f"{kind}_ft", f"{kind}_{i}.csv"), arr)


def _record(out, stage: str, keys: dict) -> dict:
    rec = load_summary(str(out))[stage]
    assert list(rec) == keys[stage] and os.path.exists(marker(str(out), stage))
    return rec


def _stage_lines(capsys) -> list:
    return [json.loads(ln)["stage"] for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_full_pipeline_stages_markers_and_resume(tmp_path, capsys):
    out = tmp_path / "full"
    argv = ["--out", str(out), "--episodes", "1", "--max-steps", "1", "--retries", "0",
            "--epochs", "1", "--estimator-steps", "1", "--estimator-k", "4", "--device", "cpu"]
    args = full_pipeline.parse_args(argv)
    os.makedirs(out)
    summary = load_summary(str(out))
    full_pipeline.collect_stage(args, summary, mppi_override=TINY, chunk=1)
    rec = _record(out, "collect", FULL_KEYS)
    assert rec["episodes_attempted"] == 1 and rec["task"] == "humanoid_walk"
    assert list(rec["results"][0]) == RESULT_KEYS and rec["control_steps_executed"] == 1
    assert len(open(out / "collect_metrics.jsonl").readlines()) == 2   # a chunk, the episode
    _humanoid_data(out / "data")
    full_pipeline.train_stage(args, summary, model_overrides=NARROW)
    rec = _record(out, "train", FULL_KEYS)
    assert rec["best_checkpoint"].endswith("model_best.pt") and rec["n_pairs"] == 78
    assert os.path.exists(out / "train_metrics.jsonl") and os.path.exists(rec["final_checkpoint"])
    full_pipeline.estimator_stage(args, summary, model_overrides=NARROW,
                                  mppi_override=dict(horizon=2))
    rec = _record(out, "estimator", FULL_KEYS)
    assert rec["steps"] == 1 and rec["finite"] and rec["checkpoint"].endswith("model_best.pt")
    npz = np.load(out / "estimator_closedloop.npz")
    assert npz["states"].shape == (1, 55) and npz["actions"].shape == (1, 21)
    assert _stage_lines(capsys) == ["collect", "train", "estimator"]

    # a second run skips every stage; --force reruns one
    before = open(out / "summary.json").read()
    assert full_pipeline.main(argv) == 0
    assert _stage_lines(capsys) == ["done"] and open(out / "summary.json").read() == before
    os.remove(out / "ckpt" / "model_final.pt")
    full_pipeline.train_stage(args, summary, model_overrides=NARROW)
    assert not os.path.exists(out / "ckpt" / "model_final.pt")
    full_pipeline.train_stage(full_pipeline.parse_args(argv + ["--force"]), summary,
                              model_overrides=NARROW)
    assert os.path.exists(out / "ckpt" / "model_final.pt") and _stage_lines(capsys) == ["train"]


def test_vel_pipeline_stages_and_the_sample_merge(tmp_path, monkeypatch, capsys):
    """The collect stage merges artifacts/full_pipeline/data_sample, under
    the working directory, only when it exists."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "vel"
    argv = ["--out", str(out), "--episodes", "1", "--max-steps", "1", "--retries", "0",
            "--epochs", "1", "--rollout-k", "2", "--estimator-steps", "1",
            "--estimator-k", "4", "--horizon", "2", "--device", "cpu"]
    args = vel_pipeline.parse_args(argv)
    os.makedirs(out)
    summary = load_summary(str(out))
    vel_pipeline.collect_stage(args, summary, mppi_override=TINY, chunk=1)
    assert _record(out, "collect", VEL_KEYS)["merged_sample_trajectories"] == 0
    _humanoid_data(tmp_path / vel_pipeline.SAMPLE_DIR, seed=1)
    vel_pipeline.collect_stage(args, summary, mppi_override=TINY, chunk=1)   # skipped
    assert _record(out, "collect", VEL_KEYS)["merged_sample_trajectories"] == 0
    vel_pipeline.collect_stage(vel_pipeline.parse_args(argv + ["--force"]), summary,
                               mppi_override=TINY, chunk=1)
    assert _record(out, "collect", VEL_KEYS)["merged_sample_trajectories"] == 2
    assert sorted(os.listdir(out / "data" / "times_ft")) == ["times_0.csv", "times_1.csv"]
    vel_pipeline.train_stage(args, summary, model_overrides=NARROW)
    rec = _record(out, "train", VEL_KEYS)
    assert rec["rollout_k"] == 2 and np.isfinite(rec["best_eval_loss"])
    vel_pipeline.estimator_stage(args, summary, model_overrides=NARROW)
    rec = _record(out, "estimator", VEL_KEYS)
    assert (rec["K"], rec["T"], rec["steps"]) == (4, 2, 1) and rec["finite"]
    assert rec["r5_fk_fd_baseline_m_120steps"] == 0.159
    assert np.load(out / "estimator_closedloop.npz")["states"].shape == (1, 55)
    assert _stage_lines(capsys) == ["collect", "collect", "train", "estimator"]
    assert vel_pipeline.main(argv) == 0 and _stage_lines(capsys) == []


def test_quad_pipeline_stages_flatten_and_resume(tmp_path, capsys):
    out = tmp_path / "quad"
    argv = ["--out", str(out), "--runs", "1", "--max-steps", "1", "--retries", "0",
            "--chunk", "1", "--k", "4", "--horizon", "2", "--epochs", "1",
            "--rollout-k", "2", "--surrogate", "qpos", "--estimator-steps", "1",
            "--estimator-k", "4", "--estimator-horizon", "2", "--device", "cpu"]
    args = quad_pipeline.parse_args(argv)
    os.makedirs(out)
    summary = load_summary(str(out))
    quad_pipeline.collect_stage(args, summary)
    rec = _record(out, "collect", QUAD_KEYS)
    assert (rec["runs_attempted"], rec["K"], rec["horizon"]) == (1, 4, 2)
    assert list(rec["results"][0]) == RESULT_KEYS
    # reached goals land in quad_data_goal/run_<i>/: two seeded runs there
    rng = np.random.default_rng(2)
    for i in (0, 2):
        run = out / "quad_data_goal" / f"run_{i:03d}"
        os.makedirs(run)
        for kind, cols in (("states", 37), ("actions", 12), ("times", 1)):
            write_csv(str(run / f"{kind}.csv"), _walk(rng, 40, cols))
    assert quad_pipeline.flatten_runs(str(out)) == 2
    assert sorted(os.listdir(out / "data_quadruped" / "states")) == ["run_000.csv",
                                                                    "run_002.csv"]
    quad_pipeline.train_stage(args, summary, 2, model_overrides=NARROW)
    rec = _record(out, "train", QUAD_KEYS)
    assert (rec["surrogate"], rec["n_runs_used"], rec["rollout_k"]) == ("qpos", 2, 2)
    quad_pipeline.estimator_stage(args, summary, model_overrides=NARROW)
    rec = _record(out, "estimator", QUAD_KEYS)
    assert (rec["steps"], rec["T"], rec["cost"], rec["finite"]) == (1, 2, "gait", True)
    states = np.load(out / "estimator_closedloop.npz")["states"]
    assert states.shape == (1, 37)
    # the loop starts from the Go1's `home` keyframe
    np.testing.assert_allclose(states[0, 2], 0.27, atol=0.05)
    assert _stage_lines(capsys) == ["collect", "train", "estimator"]
    assert quad_pipeline.main(argv) == 0 and _stage_lines(capsys) == ["done"]
    quad_pipeline.estimator_stage(quad_pipeline.parse_args(argv + ["--force"]), summary,
                                  model_overrides=NARROW)
    assert _stage_lines(capsys) == ["estimator"]


def test_e2e_pipeline_runs_and_the_jax_reader_reads_its_csvs(tmp_path, monkeypatch, capsys):
    """collect -> train -> estimator on go1_collect (the array planner on
    the CPU, as JAX's script plans without the kernel there)."""
    for k, v in dict(E2E_EPISODES="2", E2E_STEPS="3", E2E_EPOCHS="1", E2E_K="4",
                     E2E_OUT=str(tmp_path / "e2e")).items():
        monkeypatch.setenv(k, v)
    s = e2e_pipeline.settings("cpu")
    assert s["task"] == "go1_collect" and not s["use_kernel"]
    runner = e2e_pipeline.collect_stage(s, chunk=3)
    assert (runner.cfg.K, runner.use_kernel) == (4, False)
    for ep in (0, 1):
        states = jax_read_csv(str(tmp_path / "e2e" / "states" / f"ep{ep}.csv"))
        actions = jax_read_csv(str(tmp_path / "e2e" / "actions" / f"ep{ep}.csv"))
        assert states.shape == (3, 37) and actions.shape == (3, 12)
        assert np.isfinite(states).all()
    result = e2e_pipeline.train_stage(s, model_overrides=NARROW)
    assert result["n_pairs"] == 4 and os.path.exists(tmp_path / "e2e" / "ckpt" / "model_final.pt")
    states = e2e_pipeline.estimator_stage(s, result["model"], n_steps=1,
                                          mppi_override=dict(horizon=2))
    assert states.shape == (1, 37) and np.isfinite(states).all()
    out = capsys.readouterr().out
    assert "[collect] episode 1: 3 steps" in out and "[estimator] 1 control steps" in out


@pytest.mark.parametrize("state_dim", [57, 107])
def test_wide_surrogate_exact_stage_inputs_make_every_sum_exact(state_dim):
    """vel_pipeline's surrogate (humanoid_attention, state_dim 57: F=78
    tokens) and the widest row the bf16 attention kernel takes (F=128) run
    its query tiles 5-8; chip_smoke.wide_estimator_checks holds each kernel
    alone against its plain stage bit for bit on exact_stage_cases there,
    which is right only if every f32 sum is exact in any order (as
    tests/test_torch_port_estimator.py checks for the presets)."""
    for name, (stage, args, kw) in exact_stage_cases(
            make_model("humanoid_attention", state_dim=state_dim), B=3, seed=0,
            device="cpu").items():
        plain = ek.STAGES[stage][1]
        mode = _SumSpans()
        with mode:
            got = plain(*args, **kw)
        assert mode.spans and max(mode.spans) < 24, (name, mode.spans)
        up = lambda a: a.float() if isinstance(a, torch.Tensor) else a
        unrounded = plain(*map(up, args), **{k: up(v) for k, v in kw.items()})
        assert not torch.equal(got.float(), unrounded.float()), name
    assert ek.attention_rows(state_dim + 21, 64) == (80 if state_dim == 57 else 128)
