"""PyTorch port: the model snapshot, and the port's isolation from JAX.

The snapshot (humanoid_mppi_rl_tpu_torch/assets/humanoid.json) carries the
compiled humanoid across to the port so the card needs no mujoco; it must
equal a fresh export of build_from_mjcf. The port must import neither jax,
mujoco nor the JAX package, and its entry points must refuse to run on the
CPU unless asked to."""

import os
import subprocess
import sys

import pytest
import torch

from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.collect.estimator import (
    ESTIMATOR_CONFIGS, EstimatorRunner, make_cartpole_estimator, quadruped_estimator_costs)
from humanoid_mppi_rl_tpu_torch.collect.runner import (EpisodeRunner, collect_humanoid,
                                                       collect_humanoid_jl,
                                                       collect_humanoid_v2py, collect_quadruped)
from humanoid_mppi_rl_tpu_torch.learning.train import TrainConfig, train_model
from humanoid_mppi_rl_tpu_torch.models.convert import load_trained
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_plant, load_task
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs
from humanoid_mppi_rl_tpu_torch.ops.estimator_kernel import make_flash_feature_attention
from humanoid_mppi_rl_tpu_torch.ops.rollout_kernel import build_rollout_kernel
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json,
    snapshot_path)
from humanoid_mppi_rl_tpu_torch.scripts import (e2e_pipeline, full_pipeline, quad_pipeline,
                                                vel_pipeline)
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
from humanoid_mppi_rl_tpu_torch import graft_entry

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
HUMANOID_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "humanoid.xml")


def test_snapshot_equals_fresh_mjcf_export():
    """The planner's snapshot carries the array engine's fields too (the
    penalty-tier planner steps it), without the body-body pairs."""
    fresh = snapshot_json(export_model_arrays(build_from_mjcf(HUMANOID_XML), plant=True))
    with open(snapshot_path("humanoid")) as f:
        assert f.read() == fresh, (
            "assets/humanoid.json is stale: regenerate it with "
            "snapshot_json(export_model_arrays(build_from_mjcf(...), plant=True))")
    assert load_model("humanoid").pred_mask is not None


def test_export_round_trips():
    d = export_model_arrays(build_from_mjcf(HUMANOID_XML))
    m = model_from_arrays(d)
    assert snapshot_json(export_model_arrays(m)) == snapshot_json(d)
    assert (m.nq, m.nv, m.nu, m.nbody) == (28, 27, 21, 17)
    assert snapshot_json(export_model_arrays(load_model("humanoid"))) == snapshot_json(d)


_ISOLATED = r"""
import dataclasses, importlib, pkgutil, sys
for name in ("jax", "jaxlib", "mujoco", "humanoid_mppi_rl_tpu"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import humanoid_mppi_rl_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
import chip_smoke
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState
spec, model, _, _, _, init, cfg = load_task("humanoid_bench", device="cpu")
cfg = dataclasses.replace(cfg, n_samples=16, horizon=2)
plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, spec.cost_kwargs, device="cpu")
st = MPPIState.seeded(0, cfg.T, model.nu, device="cpu")
action, st, diag = plan(st, init)
assert action.shape == (model.nu,) and bool(torch.isfinite(st.U).all())
assert bool(torch.isfinite(diag.beta))
from humanoid_mppi_rl_tpu_torch.collect.estimator import (
    ESTIMATOR_CONFIGS, quadruped_estimator_costs)
from humanoid_mppi_rl_tpu_torch.dynamics.learned import make_learned_dynamics
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.ops.estimator_kernel import make_flash_feature_attention
from humanoid_mppi_rl_tpu_torch.solver.mppi import make_mppi
net = make_model("quadruped_attention", hidden_dim=32, attn_layers=1)
running, terminal = quadruped_estimator_costs()
cfg = dataclasses.replace(ESTIMATOR_CONFIGS["quadruped"], n_samples=8, horizon=2)
plan = make_mppi(make_learned_dynamics(make_flash_feature_attention(net, device="cpu"),
                                       state_slice=37), running, cfg, terminal_fn=terminal)
st = MPPIState.seeded(0, cfg.T, 12, device="cpu")
action, st, diag = plan(st, torch.zeros(37))
assert action.shape == (12,) and bool(torch.isfinite(st.U).all())
assert bool(torch.isfinite(diag.ess))
import os, tempfile
import numpy as np
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner, collect_humanoid
from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv
tiny = dict(n_samples=4, horizon=2)
runner = EpisodeRunner("humanoid_walk", use_kernel=True, mppi_override=tiny, device="cpu")
res = runner.run(max_steps=2, chunk=2)
assert res.steps == 2 and np.isfinite(res.final_qpos).all() and len(res.logger) == 2
out_dir = tempfile.mkdtemp()
out = collect_humanoid(n_episodes=1, out_dir=out_dir, max_steps=1, goal_threshold=1e9,
                       task_name="humanoid_walk", use_kernel=True, mppi_override=tiny,
                       chunk=1, device="cpu")
assert out[0]["goal"], out
states = [os.path.join(d, f) for d, _, fs in os.walk(out_dir) for f in fs if "states" in f]
assert read_csv(states[0]).shape == (1, 57)
from humanoid_mppi_rl_tpu_torch.collect.runner import collect_quadruped
from humanoid_mppi_rl_tpu_torch.costs.quadruped import GAIT_TUNED
for task in ("go1", "go1_collect"):
    spec, model, _, _, _, init, cfg = load_task(task, device="cpu")
    cfg = dataclasses.replace(cfg, n_samples=4, horizon=2)
    plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, spec.cost_kwargs, device="cpu")
    action, st, diag = plan(MPPIState.seeded(0, cfg.T, model.nu, device="cpu"), init)
    assert action.shape == (12,) and bool(torch.isfinite(st.U).all())
quad_dir = tempfile.mkdtemp()
out = collect_quadruped(n_runs=1, out_base=quad_dir, max_steps=1, goal_tolerance=1e9,
                        use_kernel=True, mppi_override=tiny, chunk=1, device="cpu",
                        gait_params=GAIT_TUNED)
assert out[0]["goal"], out
assert read_csv(os.path.join(quad_dir, "run_000", "states.csv")).shape == (1, 37)
from humanoid_mppi_rl_tpu_torch.collect.estimator import (
    EstimatorRunner, quadruped_fd_gait_estimator_costs)
from humanoid_mppi_rl_tpu_torch.learning.data import MultiTrajectoryDataset
from humanoid_mppi_rl_tpu_torch.learning.train import PRESET_CONFIGS, train_model
from humanoid_mppi_rl_tpu_torch.models.convert import load_trained
from humanoid_mppi_rl_tpu_torch.utils.trajio import write_csv
cfg = dataclasses.replace(PRESET_CONFIGS["quadruped"], epochs=2, batch_size=4,
                          ckpt_dir=os.path.join(quad_dir, "ckpt"), scan_epochs=True,
                          rollout_k=2, grad_clip=1.0, state_idxes=tuple(range(19)),
                          model_overrides={"state_dim": 19, "hidden_dim": 16},
                          ego_xy_cols=(0, 1), eval_split=0.5)
for kind, cols in (("states", 37), ("actions", 12)):
    os.makedirs(os.path.join(quad_dir, "flat", kind))
    for i in range(2):
        write_csv(os.path.join(quad_dir, "flat", kind, f"run_{i}.csv"),
                  np.random.default_rng(i).normal(size=(12, cols)))
out = train_model(os.path.join(quad_dir, "flat", "states"),
                  os.path.join(quad_dir, "flat", "actions"), cfg, device="cpu")
assert np.isfinite(out["best_eval_loss"]) and os.path.exists(out["best_checkpoint"])
net = load_trained("quad_pipeline_best", device="cpu")
spec, model, _, _, _, init, cfg = load_task("go1_collect", device="cpu")
home = dict(model.keyframes)["home"]
cfg = dataclasses.replace(ESTIMATOR_CONFIGS["quadruped"], n_samples=4, horizon=2,
                          update_mode="accumulate", ctrl_low=cfg.ctrl_low,
                          ctrl_high=cfg.ctrl_high)
runner = EstimatorRunner("go1_collect", net, cfg,
                         *quadruped_fd_gait_estimator_costs(home[7:19]),
                         state_fn=lambda plant: plant.qpos, batched_dynamics=True,
                         fd_time_augment=19, ego_cols=(0, 1), device="cpu")
states, actions, times = runner.run(n_steps=1, init_qpos=home, init_plan=home[7:19]).arrays()
assert states.shape == (1, 37) and np.isfinite(actions).all()
import humanoid_mppi_rl_tpu_torch.costs.base, humanoid_mppi_rl_tpu_torch.costs.humanoid
from humanoid_mppi_rl_tpu_torch.collect.estimator import (
    humanoid_fk_estimator_costs, humanoid_foot_state_fn)
from humanoid_mppi_rl_tpu_torch.collect.runner import collect_humanoid_jl
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
pm = load_model("humanoid_plant")
cfg = dataclasses.replace(ESTIMATOR_CONFIGS["humanoid"], n_samples=4, horizon=2)
runner = EstimatorRunner("humanoid_collect", load_trained("rollout_k_surrogate_best", device="cpu"),
                         cfg, *humanoid_fk_estimator_costs(pm),
                         state_fn=humanoid_foot_state_fn(pm), batched_dynamics=True,
                         fd_time_augment=30, device="cpu")
states, actions, times = runner.run(n_steps=1).arrays()
assert states.shape == (1, 55) and np.isfinite(actions).all()
out = collect_humanoid_jl(n_episodes=1, out_dir=tempfile.mkdtemp(), max_steps=1,
                          mppi_override=tiny, chunk=1, device="cpu")
assert out == [(0, 1)], out
from humanoid_mppi_rl_tpu_torch.collect.estimator import make_cartpole_estimator
for task, ncol in (("cartpole", 4), ("hopper", 14)):
    res = EpisodeRunner(task, use_kernel=True, mppi_override=tiny, device="cpu").run(
        max_steps=2, chunk=2)
    assert res.logger.arrays()[0].shape == (2, ncol) and np.isfinite(res.final_qpos).all()
from humanoid_mppi_rl_tpu_torch.costs.cartpole import make_costs_flat
for runner in (make_cartpole_estimator(make_model("cartpole_attention", hidden_dim=8),
                                       device="cpu"),
               EstimatorRunner("cartpole", make_model("cartpole_attention", hidden_dim=8),
                               dataclasses.replace(ESTIMATOR_CONFIGS["cartpole"], **tiny),
                               *make_costs_flat(), batched_dynamics=True, device="cpu")):
    states, actions, times = runner.run(n_steps=1, init_qpos=(0.0, 3.14)).arrays()
    assert states.shape == (1, 4) and np.isfinite(actions).all()
from humanoid_mppi_rl_tpu_torch.collect.runner import collect_humanoid_v2py
spec, model, dyn, running, terminal, init, cfg = load_task("humanoid", device="cpu")
assert spec.kernel_cost == "humanoid_v1" and (cfg.K, cfg.T) == (50, 100)
for task in ("humanoid", "humanoid_hard"):
    res = EpisodeRunner(task, use_kernel=True, mppi_override=tiny, device="cpu").run(
        max_steps=1, chunk=1)
    assert np.isfinite(res.final_qpos).all()
res = EpisodeRunner("humanoid_collect", use_kernel=False, mppi_override=tiny,
                    device="cpu").run(max_steps=2, chunk=2)
assert res.steps == 2 and np.isfinite(res.final_qpos).all()
v2_dir = tempfile.mkdtemp()
assert collect_humanoid_v2py(out_dir=v2_dir, max_steps=2, mppi_override=tiny, chunk=2,
                             device="cpu") == [(0, 2)]
states = [os.path.join(d, f) for d, _, fs in os.walk(v2_dir) for f in fs if "states" in f]
assert read_csv(states[0]).shape == (2, 56)
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
for name in ("arm5", "arm5_plant", "site_act_plant", "tendon_act_plant"):
    assert load_model(name).nu > 0
spec, model, _, _, _, init, cfg = load_task("arm5_reach", device="cpu")
cfg = dataclasses.replace(cfg, n_samples=4, horizon=2)
plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, spec.cost_kwargs, device="cpu")
action, st, diag = plan(MPPIState.seeded(0, cfg.T, model.nu, device="cpu"), init)
assert action.shape == (4,) and bool(torch.isfinite(st.U).all())
import contextlib, io
from humanoid_mppi_rl_tpu_torch import cli
from humanoid_mppi_rl_tpu_torch.learning.torch_import import load_reference_checkpoint
from humanoid_mppi_rl_tpu_torch.viz.replay import kinematic_replay
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli.main(["tasks"]) == 0
assert len(buf.getvalue().splitlines()) == 15, buf.getvalue()
pth = os.path.join(tempfile.mkdtemp(), "cross.pth")
torch.save(make_model("humanoid_cross").state_dict(), pth)
assert load_reference_checkpoint(pth, "humanoid_cross", device="cpu")(torch.zeros(2, 76)).shape == (2, 55)
assert kinematic_replay(load_model("humanoid"), np.zeros((2, 57)), device="cpu").shape == (2, 17, 3)
import torch.distributed as dist
from humanoid_mppi_rl_tpu_torch.parallel import distributed as pdist
from humanoid_mppi_rl_tpu_torch.parallel.mesh import make_mesh, make_sharded_kernel_mppi
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.solver.lqr import make_lqr_controller
eng = Engine(load_model("cartpole_plant"), device="cpu", dtype=torch.float64)
ctrl, (A, B, K) = make_lqr_controller(eng, np.zeros(2), device="cpu")
st = eng.forward(torch.tensor([0.1, 0.15], dtype=torch.float64), torch.zeros(2, dtype=torch.float64))
assert bool(torch.isfinite(eng.step(st, ctrl(st)).qpos).all())
assert pdist.maybe_initialize(device="cpu") is False
dist.init_process_group("gloo", init_method="file://" + os.path.join(tempfile.mkdtemp(), "init"),
                        world_size=1, rank=0)
spec, model, _, _, _, init, cfg = load_task("cartpole", device="cpu")
plan = make_sharded_kernel_mppi(model, spec.kernel_cost_factory,
                                dataclasses.replace(cfg, n_samples=4, horizon=2),
                                make_mesh(device="cpu"), spec.cost_kwargs)
action, st, diag = plan(MPPIState.seeded(0, 2, model.nu, device="cpu"), init)
assert bool(torch.isfinite(action).all()) and pdist.process_info()["num_processes"] == 1
dist.destroy_process_group()
from humanoid_mppi_rl_tpu_torch import graft_entry
from humanoid_mppi_rl_tpu_torch.physics.engine import spatial_tendon_geometry
from humanoid_mppi_rl_tpu_torch.scripts import e2e_pipeline, full_pipeline, quad_pipeline, vel_pipeline
fn, (ms0, st0) = graft_entry.entry(device="cpu")
action, _, _ = fn(ms0, st0)
assert action.shape == (21,) and bool(torch.isfinite(action).all())
eng = Engine(load_model("spatial_tendon_plant"), device="cpu", dtype=torch.float64)
st = eng.forward(torch.tensor([0.4, -0.3], dtype=torch.float64), torch.zeros(2, dtype=torch.float64))
assert float(spatial_tendon_geometry(eng, st)[0][0]) > 0.62
for solver in ("coupled", "penalty"):
    assert bool(torch.isfinite(eng.step(st, torch.ones(1, dtype=torch.float64), solver=solver).qvel).all())
for mod in (full_pipeline, quad_pipeline, vel_pipeline):
    done = tempfile.mkdtemp()
    for stage in ("collect", "train", "estimator"):
        open(os.path.join(done, f".done_{stage}"), "w").write("ok")
    assert mod.main(["--out", done, "--device", "cpu"]) == 0
assert e2e_pipeline.settings("cpu")["task"] == "go1_collect"
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "mujoco", "humanoid_mppi_rl_tpu"))
assert not loaded, loaded
print("ISOLATED-OK")
"""


def test_port_runs_without_jax_mujoco_or_the_jax_package():
    """Stands in for the card's installations, which have none of them."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


@pytest.mark.parametrize("entry", ["load_task", "make_kernel_mppi",
                                   "build_rollout_kernel",
                                   "make_flash_feature_attention",
                                   "load_plant", "EpisodeRunner", "collect_humanoid",
                                   "collect_quadruped", "EstimatorRunner", "train_model",
                                   "load_trained", "collect_humanoid_jl",
                                   "make_cartpole_estimator", "EpisodeRunner_cartpole",
                                   "EpisodeRunner_hopper", "EpisodeRunner_array",
                                   "collect_humanoid_v2py", "graft_entry", "full_pipeline",
                                   "quad_pipeline", "vel_pipeline", "e2e_pipeline"])
def test_entry_points_default_to_cuda_and_refuse_without_it(entry, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    spec, model, *_, cfg = load_task("humanoid_bench", device="cpu")
    calls = {
        "load_task": lambda: load_task("humanoid_bench"),
        "make_kernel_mppi": lambda: make_kernel_mppi(
            model, kernel_costs.humanoid, cfg, spec.cost_kwargs),
        "build_rollout_kernel": lambda: build_rollout_kernel(
            model, kernel_costs.humanoid, 4),
        "make_flash_feature_attention": lambda: make_flash_feature_attention(
            make_model("cartpole_attention")),
        "load_plant": lambda: load_plant("humanoid_walk"),
        "EpisodeRunner": lambda: EpisodeRunner("humanoid_walk", use_kernel=True),
        "collect_humanoid": lambda: collect_humanoid(task_name="humanoid_walk",
                                                     use_kernel=True, save=False),
        "collect_quadruped": lambda: collect_quadruped(n_runs=1, use_kernel=True,
                                                       save=False),
        "EstimatorRunner": lambda: EstimatorRunner(
            "go1_collect", make_model("quadruped_attention", hidden_dim=8),
            ESTIMATOR_CONFIGS["quadruped"], *quadruped_estimator_costs()),
        "train_model": lambda: train_model(".", ".", TrainConfig()),
        "load_trained": lambda: load_trained("quad_pipeline_best"),
        "collect_humanoid_jl": lambda: collect_humanoid_jl(save=False),
        "make_cartpole_estimator": lambda: make_cartpole_estimator(
            make_model("cartpole_attention")),
        "EpisodeRunner_cartpole": lambda: EpisodeRunner("cartpole", use_kernel=True),
        "EpisodeRunner_hopper": lambda: EpisodeRunner("hopper", use_kernel=True),
        "EpisodeRunner_array": lambda: EpisodeRunner("humanoid_collect"),
        "collect_humanoid_v2py": lambda: collect_humanoid_v2py(save=False),
        "graft_entry": lambda: graft_entry.entry(),
        "full_pipeline": lambda: full_pipeline.main(["--out", str(tmp_path)]),
        "quad_pipeline": lambda: quad_pipeline.main(["--out", str(tmp_path)]),
        "vel_pipeline": lambda: vel_pipeline.main(["--out", str(tmp_path)]),
        "e2e_pipeline": lambda: e2e_pipeline.main([]),
    }
    monkeypatch.setenv("E2E_OUT", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()
