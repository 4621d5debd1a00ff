"""PyTorch port: the collection loop (collect/{runner,logging}.py,
utils/{trajio,metrics}.py) against the JAX package on the CPU.

The JAX reference cannot run its kernel planner on the CPU for the humanoid
(its Pallas interpret compile outgrows the machine), so the loop reference
drives the JAX *plant* (engine.step, coupled tier, jitted once) and plans
with a JAX stand-in: the rollout kernel's body as a plain loop of
ops/scalar_physics plus the humanoid kernel cost, then the weighting,
update and shift of solver/kernel_mppi.py (as tests/test_torch_port_slice.py
does). Both sides get the same noise through the runner's noise_fn hook.
Tolerances: the logged 57-column rows, actions and times in f64 at
qpos-level 1e-10 / velocity-level 1e-9 (tests/test_kernel.py's)."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from humanoid_mppi_rl_tpu.collect import runner as jrunner
from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu.utils import trajio as jtrajio
from humanoid_mppi_rl_tpu_torch.collect import runner as prunner
from humanoid_mppi_rl_tpu_torch.collect.logging import TrajectoryLogger
from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS, load_task
from humanoid_mppi_rl_tpu_torch.utils import trajio as ptrajio
from humanoid_mppi_rl_tpu_torch.utils.metrics import JSONLWriter

ROOT = os.path.join(os.path.dirname(__file__), "..")
HUMANOID_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "humanoid.xml")
TASK = "humanoid_walk"
K, T, CHUNK, STEPS = 8, 3, 2, 4
TINY = dict(n_samples=K, horizon=T)
GOAL = np.array([1.7, -0.2, 1.28])


def _jax_plan(jm, kw, cfg, qpos, qvel, U, noise, params):
    """The rollout kernel's body as a plain JAX loop, then
    solver/kernel_mppi.py's weighting, update and shift: (action, U')."""
    running, terminal = jkc.humanoid(jm, **kw)
    Tn, nu, Kn = noise.shape
    h = jm.timestep
    qp = [jnp.full(Kn, qpos[i]) for i in range(jm.nq)]
    qv = [jnp.full(Kn, qvel[i]) for i in range(jm.nv)]
    prm = [jnp.asarray(x) for x in params]
    fwd = jsph.scalar_forward(jm, qp, qv)
    cost = jnp.zeros(Kn)
    for t in range(Tn):
        u = [U[t, i] + jnp.asarray(noise[t, i]) for i in range(nu)]
        qp, qv, _ = jsph.scalar_step(jm, qp, qv, u, jnp.zeros(Kn) + t * h, fwd=fwd)
        fwd = jsph.scalar_forward(jm, qp, qv)
        ctx = jsph.ctx_from(jm, fwd, qp, qv, u, (t + 1) * h)
        ctx.params = prm
        cost = cost + running(ctx, t)
    ctx = jsph.ctx_from(jm, fwd, qp, qv, [0.0] * nu, Tn * h)
    ctx.params = prm
    costs = cost + terminal(ctx)
    temperature = cfg.temperature * np.exp(params[12])
    w = jnp.exp(-(costs - jnp.min(costs)) / temperature)
    w = w / (jnp.sum(w) + cfg.weight_eps)
    U_new = U + jnp.einsum("tuk,k->tu", jnp.asarray(noise), w)
    return U_new[0], jnp.concatenate([U_new[1:], cfg.tail_decay * U_new[-1:]], axis=0)


def _noise(n_steps):
    cfg = TASKS[TASK].mppi
    rng = np.random.default_rng(5)
    nu = 21
    return [cfg.sigma * rng.normal(0, 1, (T, nu, K)) for _ in range(n_steps)]


@pytest.fixture(scope="module")
def reference():
    """The JAX loop over STEPS control steps from the task's initial state:
    logged rows (57 columns), actions, times, and the plant qpos after each
    step."""
    jm = build_from_mjcf(HUMANOID_XML)
    jpm = build_from_mjcf(HUMANOID_XML, include_self_collisions=True)
    step = jax.jit(lambda s, u: jeng.step(jpm, s, u))
    spec = TASKS[TASK]
    cfg = dataclasses.replace(spec.mppi, **TINY)
    kw = dict(spec.cost_kwargs, param_target=True)
    params = np.pad(GOAL, (0, 16 - 3))
    plant = jeng.forward(jpm, jnp.asarray(jm.qpos0), jnp.zeros(jm.nv))
    U = jnp.zeros((T, jm.nu))
    il, ir = jm.body_id("foot_left"), jm.body_id("foot_right")
    rows, actions, times, after = [], [], [], []
    for noise in _noise(STEPS):
        rows.append(np.concatenate([np.asarray(plant.qpos), np.asarray(plant.qvel),
                                    [float(plant.xpos[il, 2]), float(plant.xpos[ir, 2])]]))
        times.append(float(plant.time))
        action, U = _jax_plan(jm, kw, cfg, np.asarray(plant.qpos), np.asarray(plant.qvel),
                              U, noise, params)
        actions.append(np.asarray(action))
        plant = step(plant, action)
        after.append(np.asarray(plant.qpos))
    return dict(rows=np.stack(rows), actions=np.stack(actions), times=np.array(times),
                after=np.stack(after), time_end=float(plant.time))


@pytest.fixture(scope="module")
def runner():
    return prunner.EpisodeRunner(TASK, use_kernel=True, mppi_override=TINY,
                                 cost_kwargs_override={"param_target": True},
                                 device="cpu", dtype=torch.float64)


def _run(runner, **kw):
    noise = [torch.tensor(n) for n in _noise(STEPS)]
    m = runner.model
    return runner.run(max_steps=STEPS, chunk=CHUNK, params=GOAL,
                      state_row_fn=prunner._humanoid_state_row(m.body_id("foot_left"),
                                                               m.body_id("foot_right")),
                      noise_fn=lambda i: noise[i], **kw)


def _assert_rows(got, want):
    nq, nv = 28, 27
    np.testing.assert_allclose(got[:, :nq], want[:, :nq], atol=1e-10)
    np.testing.assert_allclose(got[:, nq:nq + nv], want[:, nq:nq + nv], atol=1e-9)
    np.testing.assert_allclose(got[:, nq + nv:], want[:, nq + nv:], atol=1e-10)


def test_loop_matches_jax(runner, reference):
    """4 control steps in chunks of 2 (K=8, T=3, f64, matched noise): the
    logged rows, actions and times, the final state and the sim time."""
    res = _run(runner)
    states, actions, times = res.logger.arrays()
    assert states.shape == (STEPS, 57) and actions.shape == (STEPS, 21)
    assert (res.steps, res.goal_reached, res.fell, res.stalled) == (STEPS, False, False, False)
    _assert_rows(states, reference["rows"])
    np.testing.assert_allclose(actions, reference["actions"], atol=1e-9)
    np.testing.assert_allclose(times, reference["times"], atol=1e-15)
    np.testing.assert_allclose(res.final_qpos, reference["after"][-1], atol=1e-10)
    assert res.sim_time == pytest.approx(reference["time_end"], abs=1e-15)


def test_goal_inside_a_chunk_truncates_the_log(runner, reference):
    """A goal met at the third step (the first of the second chunk): three
    rows are logged, and the plant (final qpos, sim time) is at the end of
    the chunk, four steps in."""
    x3 = float(reference["after"][2][0])
    res = _run(runner, goal_fn=lambda qpos, params: torch.abs(qpos[0] - x3) < 1e-9)
    states, actions, times = res.logger.arrays()
    assert res.goal_reached and res.steps == 3 and states.shape == (3, 57)
    _assert_rows(states, reference["rows"][:3])
    np.testing.assert_allclose(res.final_qpos, reference["after"][3], atol=1e-10)
    assert res.sim_time == pytest.approx(reference["time_end"], abs=1e-15)


def test_fall_stops_at_its_step(runner):
    """fall_fn true from the first step: one row logged, the chunk run out."""
    res = runner.run(max_steps=STEPS, chunk=CHUNK, fall_fn=lambda qpos, params: qpos[2] < 10.0)
    assert (res.steps, res.fell, res.goal_reached, len(res.logger)) == (1, True, False, 1)
    assert res.logger.arrays()[0].shape == (1, 55)
    assert res.sim_time == pytest.approx(CHUNK * 0.005)


def test_run_hooks_and_metrics(runner, tmp_path):
    """params_update_fn runs after each step (a counter in params[3] that
    goal_fn reads), per_chunk_callback once per chunk, plant_update_fn on
    the stepped plant; metrics_path gets a chunk event per chunk and one
    episode event."""
    seen = []
    path = str(tmp_path / "metrics.jsonl")
    res = runner.run(max_steps=STEPS, chunk=CHUNK, metrics_path=path,
                     params_update_fn=lambda plant, p: p + torch.nn.functional.one_hot(
                         torch.tensor(3), 16).to(p),
                     plant_update_fn=lambda plant, p: dataclasses.replace(plant, time=plant.time + 1.0),
                     goal_fn=lambda qpos, p: p[3] > 2.5,
                     per_chunk_callback=lambda plant: seen.append(float(plant.time)))
    assert res.goal_reached and res.steps == 3
    # the plant hook adds 1 s to the clock each step, the chunk ran out (4 steps)
    assert seen == pytest.approx([2 * 1.005, 4 * 1.005])
    np.testing.assert_allclose(res.logger.arrays()[2], [0.0, 1.005, 2.01])
    import json
    events = [json.loads(line) for line in open(path)]
    assert [e["kind"] for e in events] == ["chunk", "chunk", "episode"]
    assert events[-1]["goal"] is True and events[0]["steps"] == CHUNK


def test_params_are_padded_and_capped(runner):
    with pytest.raises(ValueError, match="at most 16"):
        runner.run(max_steps=1, params=np.zeros(17))


def test_pose_and_goal_draws_match_jax():
    model = load_task(TASK, device="cpu")[1]
    jm = build_from_mjcf(HUMANOID_XML)
    for seed in (0, 3, 11):
        for ep in range(3):
            r1, r2 = np.random.default_rng(seed + ep * 7919), np.random.default_rng(seed + ep * 7919)
            np.testing.assert_array_equal(prunner.random_humanoid_goal(r1),
                                          jrunner.random_humanoid_goal(r2))
            for a, b in zip(prunner.randomize_humanoid_pose(model, r1),
                            jrunner.randomize_humanoid_pose(jm, r2)):
                np.testing.assert_array_equal(a, b)


def _collect(tmp_path, **kw):
    kw = dict(dict(n_episodes=1, out_dir=str(tmp_path), max_steps=2, task_name=TASK,
                   use_kernel=True, mppi_override=TINY, chunk=CHUNK, device="cpu"), **kw)
    return prunner.collect_humanoid(**kw)


def _csv_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs if f.endswith(".csv"))


def test_collect_saves_only_reached_goals(tmp_path):
    """A cap saves nothing; a goal (threshold 1e9: met at the first step)
    saves one episode in the 57/21/1-column split-dir layout."""
    capped = _collect(tmp_path / "cap", goal_threshold=0.0, stall_steps=None)
    assert capped == [dict(run=0, goal=False, steps_saved=2, steps_executed=2, attempts=1,
                           outcome="cap")]
    assert not os.path.exists(tmp_path / "cap")
    reached = _collect(tmp_path / "goal", goal_threshold=1e9)
    assert reached == [dict(run=0, goal=True, steps_saved=1, steps_executed=1, attempts=1,
                            outcome="goal")]
    files = _csv_files(tmp_path / "goal")
    assert [f.split(os.sep)[0] for f in files] == ["actions_ft", "states_ft", "times_ft"]
    cols = {f.split(os.sep)[0]: ptrajio.read_csv(str(tmp_path / "goal" / f)).shape
            for f in files}
    assert cols == {"states_ft": (1, 57), "actions_ft": (1, 21), "times_ft": (1, 1)}


def test_collect_shards_episodes_and_retries(tmp_path):
    """Episode i runs on shard i % num_shards; a missed goal is retried
    with a reseeded noise stream and every attempt's steps are counted."""
    out = _collect(tmp_path, n_episodes=4, num_shards=3, shard_index=1, goal_threshold=0.0,
                   stall_steps=None, retries=1, save=False)
    assert [r["run"] for r in out] == [1]
    assert out[0]["attempts"] == 2 and out[0]["steps_executed"] == 4
    out = _collect(tmp_path, n_episodes=5, num_shards=2, shard_index=0, goal_threshold=1e9,
                   save=False)
    assert [r["run"] for r in out] == [0, 2, 4] and all(r["goal"] for r in out)


def test_stall_watchdog_abandons_the_episode(runner):
    """No xy progress of 1e9 m: the first chunk sets the best distance, the
    second adds its logged steps, and stall_steps=2 abandons the episode."""
    res = runner.run(max_steps=10, chunk=CHUNK, params=GOAL, stall_steps=2,
                     stall_min_progress=1e9)
    assert (res.stalled, res.steps, res.goal_reached, res.fell) == (True, 4, False, False)
    out = dataclasses.asdict(res)
    assert set(out) == {"steps", "goal_reached", "fell", "final_qpos", "logger", "sim_time",
                        "stalled"}
    assert res.final_qpos.shape == (28,) and isinstance(res.sim_time, float)


def _jax_writer(tmp_path):
    """The JAX package's write_csv through its native codec. Its loader
    builds the library into the package on first use and falls back to
    np.savetxt when that fails (as when another test process is building it
    at the same moment); then the same source is built here instead."""
    if jtrajio._load() is not None:
        return jtrajio.write_csv
    import ctypes
    import shutil
    import subprocess

    so = str(tmp_path / "libtrajio_jax.so")
    subprocess.run([shutil.which("g++"), "-O3", "-shared", "-fPIC", jtrajio._SRC, "-o", so],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.trajio_write_csv.argtypes = [ctypes.c_char_p, dptr, ctypes.c_int64, ctypes.c_int64]

    def write(path, arr):
        a = np.ascontiguousarray(arr, dtype=np.float64)
        a = a[:, None] if a.ndim == 1 else a
        assert lib.trajio_write_csv(path.encode(), a.ctypes.data_as(dptr), *a.shape) == 0
    return write


def test_csv_bytes_equal_the_jax_writer(tmp_path):
    """The port's native writer and the JAX package's write the same bytes;
    the port's reader gives what the JAX reader gives (when its native
    codec loaded), within a few ulps of what was written (past 15 digits the native parser scales an integer
    mantissa by an inexact power of ten: 8.4e-15 relative at most here)."""
    rng = np.random.default_rng(7)
    arrays = {"states": rng.normal(size=(6, 57)) * 10.0 ** rng.integers(-8, 8, (6, 57)),
              "actions": rng.normal(size=(6, 21)), "times": np.arange(6) * 0.005,
              "edge": np.array([[0.0, -0.0, 1e-300, 1.7976931348623157e308, 5e-324, 0.1]])}
    jax_write = _jax_writer(tmp_path)
    for name, a in arrays.items():
        p, j = str(tmp_path / f"{name}_port.csv"), str(tmp_path / f"{name}_jax.csv")
        ptrajio.write_csv(p, a)
        jax_write(j, a)
        assert filecmp.cmp(p, j, shallow=False), name
        back = ptrajio.read_csv(p)
        np.testing.assert_allclose(back, a.reshape(back.shape), rtol=1e-14, atol=0)
        if jtrajio._load() is not None:
            np.testing.assert_array_equal(back, jtrajio.read_csv(j))


def test_logger_layouts_and_metrics(tmp_path):
    log = TrajectoryLogger()
    for i in range(3):
        log.log(np.full(57, i), np.full(21, -i), 0.005 * i)
    run_dir = log.save_run_dir(str(tmp_path / "run"))
    assert sorted(os.listdir(run_dir)) == ["actions.csv", "states.csv", "times.csv"]
    ts = log.save_split_dirs(str(tmp_path / "split"), timestamp="T0")
    assert ts == "T0"
    assert ptrajio.read_csv(str(tmp_path / "split" / "states_ft" / "states_T0.csv")).shape == (3, 57)
    path = str(tmp_path / "m" / "events.jsonl")
    w = JSONLWriter(path)
    w.write(kind="chunk", steps=2)
    w.close()
    import json
    ev = json.loads(open(path).read())
    assert ev["kind"] == "chunk" and ev["steps"] == 2 and "t" in ev


def test_unported_planners_raise():
    """Planning on the coupled tier (a batched Newton over K) is the array
    planner's: it plans humanoid_walk with make_mppi over the coupled step
    of the planner model, and its first control step runs; the kernel
    planner never had it and refuses. The default, the array planner on the
    penalty tier, is ported."""
    coupled = prunner.EpisodeRunner(TASK, planner_solver="coupled", device="cpu",
                                    mppi_override=dict(n_samples=2, horizon=2))
    assert not coupled.use_kernel and not hasattr(coupled.plan, "rollouts")
    ms = coupled.fresh_controller()
    action, ms, plant, diag = coupled.control_step(ms, coupled.init_state, None)
    assert action.shape == (coupled.model.nu,) and torch.isfinite(action).all()
    assert torch.isfinite(plant.qpos).all() and torch.isfinite(diag.beta).all()
    with pytest.raises(ValueError, match="penalty tier only"):
        prunner.EpisodeRunner(TASK, use_kernel=True, planner_solver="coupled", device="cpu")
    runner = prunner.EpisodeRunner(TASK, mppi_override=dict(n_samples=2, horizon=2),
                                   device="cpu")
    assert not runner.use_kernel and not hasattr(runner.plan, "rollouts")
