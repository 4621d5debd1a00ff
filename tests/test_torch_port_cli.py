"""The PyTorch port's command line against the JAX package's, on the CPU.

- `tasks` prints what the JAX CLI prints, and every subcommand takes the
  JAX CLI's options (plus --device).
- `run`, `collect`, `train` and `estimate` with the runner, collector,
  trainer and estimator replaced by recorders in both packages: both CLIs
  make the same calls with the same arguments and print the same JSON,
  without a JAX compile.
- One real tiny run of each computing subcommand with --device cpu: the
  cartpole run -> train -> estimate chain, replay and profile.
- --device cuda without a card raises; bench, run --live, replay
  --video and warm on the CPU exit non-zero.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu import cli as jax_cli
from humanoid_mppi_rl_tpu.collect import estimator as jax_estimator
from humanoid_mppi_rl_tpu.collect import runner as jax_runner
from humanoid_mppi_rl_tpu.learning import train as jax_train
from humanoid_mppi_rl_tpu_torch import cli
from humanoid_mppi_rl_tpu_torch.collect import estimator as port_estimator
from humanoid_mppi_rl_tpu_torch.collect import runner as port_runner
from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS
from humanoid_mppi_rl_tpu_torch.learning import train as port_train
from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

COMMANDS = ("tasks", "run", "collect", "profile", "train", "estimate", "replay", "bench", "warm")


def _call(main, argv):
    """(exit code, stdout) of main(argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(argv, tmp_path):
    """Each CLI's stdout on argv, "TMP/" in argv standing for tmp_path."""
    argv = [str(tmp_path / a[4:]) if a.startswith("TMP/") else a for a in argv]
    outs = [_call(main, argv) for main in (jax_cli.main, cli.main)]
    assert [rc for rc, _ in outs] == [0, 0]
    return [out for _, out in outs]


def test_tasks_output_equals_jax():
    rc, ref = _call(jax_cli.main, ["tasks"])
    rc2, got = _call(cli.main, ["tasks"])
    assert rc == rc2 == 0
    assert got == ref
    assert [ln.split()[0] for ln in got.splitlines()] == list(TASKS)


def _options(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        main(argv + ["--help"])
    assert e.value.code == 0
    return buf.getvalue()


def test_help_lists_the_nine_subcommands():
    assert "{" + ",".join(COMMANDS) + "}" in _options(cli.main, [])
    assert "{" + ",".join(COMMANDS) + "}" in _options(jax_cli.main, [])


@pytest.mark.parametrize("cmd", COMMANDS)
def test_subcommand_options_match_jax(cmd):
    """Every option of the JAX subcommand (the recorders below hold the
    defaults); the port adds --device wherever the command computes."""
    opts = lambda text: set(re.findall(r"(--[a-z][a-z-]*)", text))
    ref, got = _options(jax_cli.main, [cmd]), _options(cli.main, [cmd])
    computes = cmd not in ("tasks", "bench")
    assert opts(got) == opts(ref) | ({"--device"} if computes else set())


class _Log:
    def __init__(self, calls, rows=3):
        self.calls, self.rows = calls, rows

    def save_run_dir(self, d):
        self.calls.append(("save_run_dir", os.path.basename(d)))
        return d

    def arrays(self):
        rng = np.random.default_rng(0)
        return rng.normal(size=(self.rows, 4)), rng.normal(size=(self.rows, 1)), \
            np.arange(self.rows) * 0.01


def _episode_runner(calls):
    class Runner:
        def __init__(self, task_name, **kw):
            kw.pop("device", None)
            calls.append(("EpisodeRunner", task_name, kw))

        def run(self, **kw):
            calls.append(("run", kw))
            return types.SimpleNamespace(
                steps=3, goal_reached=False, fell=True,
                final_qpos=np.array([1.234567, -2.0, 0.5, 9.0]), logger=_Log(calls))
    return Runner


@pytest.mark.parametrize("argv", [
    ["run", "--task", "cartpole", "--steps", "7", "--K", "8", "--T", "5", "--seed", "3",
     "--out", "TMP/run", "--metrics", "m.jsonl"],
    ["run", "--task", "humanoid_walk", "--kernel", "--out", "TMP/run"],
], ids=["array", "kernel"])
def test_run_makes_the_jax_calls(argv, tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_runner, "EpisodeRunner", _episode_runner(calls["jax"]))
    monkeypatch.setattr(port_runner, "EpisodeRunner", _episode_runner(calls["port"]))
    ref, got = _both(argv, tmp_path)
    assert got == ref and json.loads(got)["final_qpos_xyz"] == [1.2346, -2.0, 0.5]
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 3


def _collector(calls, name):
    def collect(**kw):
        kw.pop("device", None)
        calls.append((name, kw))
        return [{"run": 0, "goal": False, "steps_saved": 2}]
    return collect


COLLECTORS = ("collect_humanoid", "collect_humanoid_jl", "collect_humanoid_v2py",
              "collect_quadruped")


@pytest.mark.parametrize("kernel", [False, True], ids=["array", "kernel"])
@pytest.mark.parametrize("robot", ["humanoid", "humanoid_jl", "humanoid_v2py", "quadruped"])
def test_collect_makes_the_jax_calls(robot, kernel, tmp_path, monkeypatch):
    """--kernel reaches collect_humanoid and collect_humanoid_jl only; the
    v2.py and Go1 collectors ignore it (and the Go1's --K/--T), as in JAX."""
    calls = {"jax": [], "port": []}
    for name in COLLECTORS:
        monkeypatch.setattr(jax_runner, name, _collector(calls["jax"], name))
        monkeypatch.setattr(port_runner, name, _collector(calls["port"], name))
    argv = ["collect", "--robot", robot, "--episodes", "2", "--steps", "9", "--K", "16",
            "--shard-index", "1", "--num-shards", "2", "--seed", "4", "--out", "TMP/c"]
    argv += (["--kernel"] if kernel else []) + (["--task", "humanoid_walk", "--retries", "1"]
                                               if robot == "humanoid" else [])
    ref, got = _both(argv, tmp_path)
    assert got == ref
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 1


def _trainer(calls):
    def train_model(states, actions, cfg, **kw):
        kw.pop("device", None)
        d = dataclasses.asdict(cfg)
        d["compute_dtype"] = str(np.dtype(d["compute_dtype"]) if "jax" in str(
            d["compute_dtype"]) else d["compute_dtype"]).replace("torch.", "")
        calls.append((states, actions, d, kw))
        return {"best_eval_loss": 0.5, "final_train_loss": 0.25, "best_checkpoint": None,
                "final_checkpoint": "final", "n_pairs": 3, "epochs": cfg.epochs,
                "rollout_k": cfg.rollout_k, "model": object()}
    return train_model


@pytest.mark.parametrize("argv", [
    ["train", "--preset", "cartpole", "--states", "s", "--actions", "a", "--epochs", "3",
     "--ckpt-dir", "TMP/ck", "--resume-from", "r.pt", "--metrics", "m.jsonl"],
    ["train", "--states", "s", "--actions", "a"],
    ["train", "--preset", "unknown", "--states", "s", "--actions", "a"],
], ids=["cartpole", "default", "unknown"])
def test_train_makes_the_jax_calls(argv, tmp_path, monkeypatch):
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_train, "train_model", _trainer(calls["jax"]))
    monkeypatch.setattr(port_train, "train_model", _trainer(calls["port"]))
    ref, got = _both(argv, tmp_path)
    assert got == ref
    assert calls["port"] == calls["jax"] and len(calls["jax"]) == 1


def _estimator_runner(calls, rows):
    class Runner:
        def __init__(self, plant, *args, state_slice=None, seed=0, **kw):
            kw.pop("device", None)
            cfg = next(a for a in args if type(a).__name__ == "MPPIConfig")
            running, terminal = args[-2:]
            arr = (lambda a: a) if plant.endswith(".xml") else torch.as_tensor
            x = arr(np.linspace(-1.0, 1.0, 37)[: 4 if state_slice is None else 37])
            u = arr(np.linspace(0.5, -0.5, 1 if state_slice is None else 12))
            costs = [float(running(x, u, 0.0)), float(terminal(x, 0.0))]
            calls.append(("EstimatorRunner", os.path.basename(plant).replace(".xml", ""),
                          dataclasses.asdict(cfg), state_slice, seed, kw, costs))

        def run(self, **kw):
            calls.append(("run", kw))
            return _Log(calls, rows)
    return Runner


@pytest.mark.parametrize("preset", ["cartpole", "quadruped"])
def test_estimate_makes_the_jax_calls(preset, tmp_path, monkeypatch):
    """The plant (JAX's asset, the port's task), the configuration, the
    costs (evaluated on one input), the state slice and the seeds; the
    CSVs written."""
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_estimator, "EstimatorRunner", _estimator_runner(calls["jax"], 3))
    monkeypatch.setattr(port_estimator, "EstimatorRunner",
                        _estimator_runner(calls["port"], 3))
    argv = ["estimate", "--preset", preset, "--steps", "3", "--seed", "2", "--out", "TMP/e"]
    outs = []
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        d = tmp_path / name
        extra = ["--device", "cpu"] if name == "port" else []
        rc, out = _call(main, [str(d / "e") if a == "TMP/e" else a for a in argv] + extra)
        outs.append(out.replace(str(d), "TMP"))
        for kind in ("states", "actions", "times"):
            assert read_csv(str(d / "e" / f"{kind}.csv")).shape[0] == 3
    assert outs[0] == outs[1]
    jax_plant = {"cartpole": "cartpole", "quadruped": "go1"}[preset]
    assert calls["jax"][0][1] == jax_plant and calls["port"][0][1] == jax_plant
    for a, b in zip(calls["jax"], calls["port"]):
        if a[0] == "EstimatorRunner":
            assert a[2:6] == b[2:6]
            np.testing.assert_allclose(b[6], a[6], rtol=1e-12)
        else:
            assert a == b


@pytest.fixture(scope="module")
def cart_run(tmp_path_factory):
    """run --task cartpole at K=8, T=5 on the CPU: the rows logged, split
    into states/ and actions/ dirs for train. (A chunk of 50 control steps
    runs whole whatever --steps is; 40 logged rows give the trainer one
    batch of 32.)"""
    root = tmp_path_factory.mktemp("cli")
    rc, out = _call(cli.main, ["run", "--task", "cartpole", "--K", "8", "--T", "5", "--steps",
                               "40", "--device", "cpu", "--out", str(root / "run")])
    for kind in ("states", "actions"):
        (root / kind).mkdir()
        (root / kind / f"{kind}_0.csv").write_bytes((root / "run" / f"{kind}.csv").read_bytes())
    return root, rc, json.loads(out)


@pytest.fixture(scope="module")
def cart_ckpt(cart_run):
    root = cart_run[0]
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None   # its import takes seconds
    try:
        rc, out = _call(cli.main, ["train", "--preset", "cartpole", "--states",
                                   str(root / "states"), "--actions", str(root / "actions"),
                                   "--epochs", "1", "--ckpt-dir", str(root / "ckpt"),
                                   "--device", "cpu"])
    finally:
        if saved is None:
            sys.modules.pop("torch.utils.tensorboard")
        else:
            sys.modules["torch.utils.tensorboard"] = saved
    return rc, json.loads(out)


def test_cli_run_on_the_cpu(cart_run):
    root, rc, out = cart_run
    assert rc == 0 and out["task"] == "cartpole" and out["steps"] == 40
    assert list(out) == ["task", "steps", "goal_reached", "fell", "final_qpos_xyz", "out"]
    states = read_csv(str(root / "run" / "states.csv"))
    assert states.shape == (40, 4) and np.isfinite(states).all()
    assert read_csv(str(root / "run" / "actions.csv")).shape == (40, 1)
    assert read_csv(str(root / "run" / "times.csv")).shape == (40, 1)


def test_cli_train_on_the_cpu(cart_ckpt):
    rc, out = cart_ckpt
    assert rc == 0 and out["n_pairs"] == 39 and out["epochs"] == 1
    assert np.isfinite(out["final_train_loss"]) and os.path.exists(out["final_checkpoint"])


def test_cli_estimate_on_the_cpu(cart_run, cart_ckpt, monkeypatch):
    """The cartpole configuration cut to K=16, T=5 (the CLI has no --K/--T
    for estimate, as JAX's has none): at K=2048, T=100 a CPU step takes
    seconds, and minutes beside other test workers."""
    monkeypatch.setitem(port_estimator.ESTIMATOR_CONFIGS, "cartpole", dataclasses.replace(
        port_estimator.ESTIMATOR_CONFIGS["cartpole"], n_samples=16, horizon=5))
    root = cart_run[0]
    rc, out = _call(cli.main, ["estimate", "--preset", "cartpole", "--checkpoint",
                               cart_ckpt[1]["final_checkpoint"], "--steps", "2", "--device",
                               "cpu", "--out", str(root / "est")])
    assert rc == 0 and json.loads(out) == {"preset": "cartpole", "steps": 2,
                                           "out": str(root / "est")}
    states = read_csv(str(root / "est" / "states.csv"))
    assert states.shape == (2, 4) and np.isfinite(states).all()


def test_cli_replay_on_the_cpu(cart_run):
    root = cart_run[0]
    rc, out = _call(cli.main, ["replay", "--states", str(root / "run" / "states.csv"),
                               "--asset", "assets/cartpole.xml", "--stride", "2",
                               "--device", "cpu"])
    out = json.loads(out)
    assert rc == 0 and (out["frames"], out["nbody"]) == (20, 3)
    assert np.isfinite(out["root_travel"])


def test_cli_replay_refuses_a_missing_snapshot_file(cart_run, tmp_path):
    """A .json --asset names a snapshot file, which must exist: no fallback
    to the committed snapshot of the same basename."""
    with pytest.raises(SystemExit, match="no such snapshot file"):
        cli.main(["replay", "--states", str(cart_run[0] / "run" / "states.csv"),
                  "--asset", str(tmp_path / "cartpole.json"), "--device", "cpu"])


def test_cli_profile_on_the_cpu(tmp_path):
    rc, out = _call(cli.main, ["profile", "--task", "cartpole", "--K", "8", "--T", "5",
                               "--iters", "2", "--device", "cpu", "--out", str(tmp_path)])
    out = json.loads(out)
    assert rc == 0 and list(out) == ["task", "K", "T", "kernel", "replan_ms",
                                     "rollouts_per_s", "compile_s", "trace_dir"]
    assert (out["K"], out["T"], out["kernel"]) == (8, 5, False) and out["replan_ms"] > 0
    assert os.path.getsize(tmp_path / "trace.json") > 0


@pytest.mark.parametrize("argv", [
    ["run", "--task", "cartpole"],
    ["collect", "--robot", "humanoid"],
    ["profile", "--task", "cartpole"],
    ["train", "--states", "s", "--actions", "a"],
    ["estimate", "--preset", "cartpole"],
    ["replay", "--states", "STATES", "--asset", "cartpole.xml"],
    ["warm"],
], ids=lambda a: a[0])
def test_computing_commands_refuse_the_card_without_one(argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    states = tmp_path / "states.csv"
    states.write_text("0,0,0,0\n")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([str(states) if a == "STATES" else a for a in argv])


@pytest.mark.parametrize("argv", [
    ["bench"],
    ["run", "--task", "cartpole", "--live", "--device", "cpu"],
    ["replay", "--states", "s.csv", "--asset", "cartpole.xml", "--video", "v.mp4",
     "--device", "cpu"],
    ["warm", "--device", "cpu"],
], ids=["bench", "live", "video", "warm_cpu"])
def test_refused_commands_exit_non_zero(argv):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code not in (0, None)
    assert "bench" not in sys.modules
