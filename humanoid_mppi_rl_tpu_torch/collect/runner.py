"""Receding-horizon episode loop, humanoid and Go1 data collection
(collect/runner.py counterpart).

- `EpisodeRunner.run()` (any task of envs/tasks; the default row is
  [qpos; qvel]): plan, step the coupled plant (envs/tasks.load_plant), log,
  check goal and fall. The planner is the CUDA rollout kernel
  (solver/kernel_mppi, use_kernel=True) or, as in the JAX package by
  default, `make_mppi` over the array engine's penalty tier batched over K
  (use_kernel=False). Rows, actions, times and goal/fall flags stay on the
  device and cross to the host once per chunk.
- `collect_humanoid()`: the reference's src/Humanoid_datacollection_v2.jl:
  randomized pose and goal, goal-gated saving, 57-column states with the
  foot heights, episodes sharded across processes.
- `collect_humanoid_jl()`: the reference's src/Humanoid_datacollection.jl:
  the stand start, an advancing goal, 55-column [qpos; qvel] rows.
- `collect_humanoid_v2py()`: the reference's
  src/Humanoid_datacollection_v2.py: the FD-velocity cost on a GaitFDState
  carried through plant and rollouts, two replans a control step, the goal
  advance, 56-column rows (qpos, then its FD velocity).
- `collect_quadruped()`: the reference's src/quadruped_datacollection.py:
  the Go1 goal ladder, fall abort, per-run save dirs of 37-column
  [qpos; qvel] rows, only reached goals kept.

Semantics kept from the JAX runner: a control step logs the state before
it (with its time), plans, steps the plant, then evaluates goal_fn/fall_fn
on the state after it; a chunk always runs `chunk` steps, logs the rows up
to and including the first terminating step, and leaves the plant (final
qpos, sim time) at the chunk's end.

Planning on the coupled tier (planner_solver="coupled", a batched Newton
over K) is ROADMAP A3; until it exists that option raises.
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..costs.humanoid import advance_goal_v2py
from ..envs.tasks import load_plant, load_task
from ..solver.kernel_mppi import make_kernel_mppi
from ..solver.mppi import MPPIState, make_mppi
from ..utils.metrics import JSONLWriter
from .logging import TrajectoryLogger

NP = 16  # runtime cost-parameter slots (ops/kernel_costs PARAM_SLOTS)
CHUNK = 50  # control steps a chunk runs whole, as the JAX runner's scan


@dataclasses.dataclass
class EpisodeResult:
    steps: int
    goal_reached: bool
    fell: bool
    final_qpos: np.ndarray
    logger: TrajectoryLogger
    sim_time: float
    stalled: bool = False  # abandoned by the progress watchdog


class EpisodeRunner:
    """One task, cost and MPPI configuration, reusable across episodes: the
    planner (the rollout kernel, or make_mppi over the penalty engine) and
    the coupled plant on `device` in `dtype`."""

    def __init__(self, task_name: str, seed: int = 0,
                 cost_kwargs_override: Optional[dict] = None,
                 mppi_override: Optional[dict] = None,
                 use_kernel: bool = False,
                 planner_solver: Optional[str] = None,
                 device="cuda", dtype=torch.float32):
        """`planner_solver="coupled"` (rollouts on the coupled tier, JAX's
        array-engine option) is not ported: it raises."""
        if planner_solver not in (None, "penalty"):
            if use_kernel:
                raise ValueError("the kernel planner implements the penalty tier only; "
                                 "coupled planning is the array engine's")
            raise NotImplementedError(
                f'planner_solver="{planner_solver}" plans on a batched coupled engine, '
                "which is not ported yet (ROADMAP A3)")
        self.device, self.dtype = resolve_device(device), dtype
        spec, model, dynamics, running, terminal, init_state, cfg = load_task(
            task_name, device=self.device, dtype=dtype)
        kw = dict(spec.cost_kwargs)
        if cost_kwargs_override:
            kw.update(cost_kwargs_override)
        if mppi_override:
            cfg = dataclasses.replace(cfg, **mppi_override)
        self.spec, self.model, self.cfg = spec, model, cfg
        self.init_state = init_state
        self.seed = seed
        self.use_kernel = use_kernel
        # environment plant: the coupled tier with body-body contacts; the
        # planner's rollouts keep the penalty tier
        self.plant_model, self.plant_dyn = load_plant(task_name, init_state, self.device, dtype)
        if use_kernel:
            self.plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, cost_kwargs=kw,
                                         device=self.device)
        else:
            if cost_kwargs_override:
                running, terminal = spec.cost_factory(model, **kw)
            self.plan = make_mppi(dynamics, running, cfg, terminal_fn=terminal)

    def fresh_controller(self, seed: Optional[int] = None) -> MPPIState:
        return MPPIState.seeded(self.seed if seed is None else seed, self.cfg.T,
                                self.model.nu, device=self.device, dtype=self.dtype)

    def control_step(self, ms: MPPIState, plant, params, noise=None):
        """Plan, then step the plant: (action, ms', plant', diag). `noise`
        (T, nu, K) replaces the planner's draw (the array planner reads it
        as (K, T, nu)); `params` are the kernel cost's runtime parameters
        (the array costs take theirs at construction)."""
        if self.use_kernel:
            action, ms, diag = self.plan(ms, plant, params=params, noise=noise)
        else:
            action, ms, diag = self.plan(ms, plant,
                                         None if noise is None else noise.permute(2, 0, 1))
        return action, ms, self.plant_dyn(plant, action, 0), diag

    def run(
        self,
        max_steps: int = 1000,
        init_state=None,
        seed: Optional[int] = None,
        state_row_fn: Optional[Callable] = None,
        goal_fn: Optional[Callable] = None,
        fall_fn: Optional[Callable] = None,
        logger: Optional[TrajectoryLogger] = None,
        params=None,
        chunk: int = CHUNK,
        plant_update_fn: Optional[Callable] = None,
        params_update_fn: Optional[Callable] = None,
        metrics_path: Optional[str] = None,
        per_chunk_callback: Optional[Callable] = None,
        stall_steps: Optional[int] = None,
        stall_min_progress: float = 0.05,
        noise_fn: Optional[Callable] = None,
    ) -> EpisodeResult:
        """state_row_fn(plant) -> row tensor; goal_fn/fall_fn(qpos, params)
        -> bool tensor, evaluated on the device. `params` (at most 16
        slots, zero-padded) carries the episode's runtime cost parameters
        (the goal in params[0:3]). `metrics_path` appends a JSONL event per
        chunk. `per_chunk_callback(plant)` runs on the host after each
        chunk. `stall_steps` arms the progress watchdog: the episode is
        abandoned when the root's xy distance to params[0:2] has not
        improved by `stall_min_progress` over that many logged steps.
        `noise_fn(step) -> (T, nu, K)` replaces the planner's noise draw at
        executed step `step` (the parity tests' matched-noise hook).
        plant_update_fn(plant, params) and params_update_fn(plant, params)
        rewrite the plant or the params after each step."""
        plant = (self.init_state if init_state is None else init_state).to(
            self.device, self.dtype)
        ms = self.fresh_controller(seed)
        params = np.zeros(NP) if params is None else np.asarray(params, dtype=np.float64)
        if params.shape[0] > NP:
            raise ValueError(f"params has {params.shape[0]} slots; the kernel cost param "
                             f"vector is at most {NP} (ops.kernel_costs.PARAM_SLOTS)")
        params = torch.as_tensor(np.pad(params, (0, NP - params.shape[0])),
                                 dtype=self.dtype, device=self.device)
        log = logger if logger is not None else TrajectoryLogger()
        met = JSONLWriter(metrics_path)
        nu = self.model.nu
        goal = fell = stalled = False
        steps = executed = 0
        best_dist, steps_since_best = np.inf, 0
        while steps < max_steps:
            n = min(chunk, max_steps - steps)
            t_chunk = _time.perf_counter()
            packed = []
            for _ in range(chunk):
                row = (state_row_fn(plant) if state_row_fn
                       else torch.cat([plant.qpos, plant.qvel]))
                noise = noise_fn(executed) if noise_fn is not None else None
                action, ms, plant2, _ = self.control_step(ms, plant, params, noise)
                executed += 1
                if plant_update_fn is not None:
                    plant2 = plant_update_fn(plant2, params)
                if params_update_fn is not None:
                    params = params_update_fn(plant2, params)
                flag = lambda fn: (fn(plant2.qpos, params) if fn is not None
                                   else torch.zeros((), dtype=torch.bool, device=row.device))
                packed.append(torch.cat([row, action, plant.time[None],
                                         flag(goal_fn).to(row.dtype)[None],
                                         flag(fall_fn).to(row.dtype)[None]]))
                plant = plant2
            packed = torch.stack(packed).cpu().numpy()   # one host fetch per chunk
            dt_chunk = _time.perf_counter() - t_chunk
            met.write(kind="chunk", task=self.spec.name, steps=n, wall_s=dt_chunk,
                      replan_ms=dt_chunk / n * 1e3, steps_per_s=n / dt_chunk,
                      K=self.cfg.K, T=self.cfg.T)
            rows = packed[:, :-(nu + 3)]
            actions = packed[:, -(nu + 3):-3]
            times = packed[:, -3]
            goals = packed[:, -2] > 0.5
            falls = packed[:, -1] > 0.5
            # the first termination inside the logged part of the chunk
            stop = n
            for i in range(n):
                if falls[i]:
                    fell, stop = True, i + 1
                    break
                if goals[i]:
                    goal, stop = True, i + 1
                    break
            for i in range(stop):
                log.log(rows[i], actions[i], float(times[i]))
            steps += stop
            if per_chunk_callback is not None:
                per_chunk_callback(plant)
            if goal or fell:
                break
            if stall_steps:
                qp = plant.qpos.cpu().numpy()
                pv = params.cpu().numpy()
                dist = float(np.linalg.norm(qp[0:2] - pv[0:2]))
                if dist < best_dist - stall_min_progress:
                    best_dist, steps_since_best = dist, 0
                else:
                    steps_since_best += stop
                if steps_since_best >= stall_steps:
                    stalled = True
                    break
        met.write(kind="episode", task=self.spec.name, steps=steps, goal=bool(goal),
                  fell=bool(fell), stalled=bool(stalled))
        met.close()
        return EpisodeResult(steps=steps, goal_reached=goal, fell=fell,
                             final_qpos=plant.qpos.cpu().numpy(), logger=log,
                             sim_time=float(plant.time), stalled=stalled)


# ---------------------------------------------------------------------------
# Humanoid collection (reference src/Humanoid_datacollection_v2.jl)
# ---------------------------------------------------------------------------

def randomize_humanoid_pose(model, rng: np.random.Generator):
    """Reference randomize_initial_pose! (:13-36): root xy +-0.2 m, joint
    angles +-0.05, velocities +-0.05."""
    qpos = model.qpos0.copy()
    qpos[0] += (rng.random() - 0.5) * 0.4
    qpos[1] += (rng.random() - 0.5) * 0.4
    qpos[7:] += (rng.random(len(qpos) - 7) - 0.5) * 0.1
    qvel = (rng.random(model.nv) - 0.5) * 0.1
    return qpos, qvel


def random_humanoid_goal(rng: np.random.Generator):
    """Reference :40-41: x in [0.5, 2.5], y in [-0.5, 0.5], z = 1.28."""
    return np.array([rng.random() * 2.0 + 0.5, rng.random() - 0.5, 1.28])


def _humanoid_state_row(id_l: int, id_r: int):
    def state_row(st):
        # 57-column layout (reference src/Humanoid_datacollection_v2.jl:70-81)
        return torch.cat([st.qpos, st.qvel, st.xpos[id_l, 2:3], st.xpos[id_r, 2:3]])
    return state_row


def _humanoid_goal_fn(goal_threshold: float):
    def goal_fn(qpos, params):
        xy = torch.linalg.vector_norm(qpos[0:2] - params[0:2])
        return (xy < goal_threshold) & (torch.abs(qpos[2] - params[2]) < 0.1)
    return goal_fn


def collect_humanoid(
    n_episodes: int = 1,
    out_dir: str = "data",
    seed: int = 0,
    max_steps: int = 10000,
    goal_threshold: float = 0.15,
    save: bool = True,
    shard_index: int = 0,
    num_shards: int = 1,
    task_name: str = "humanoid_collect",
    use_kernel: bool = False,
    mppi_override: Optional[dict] = None,
    retries: int = 0,
    metrics_path: Optional[str] = None,
    stall_steps: Optional[int] = 800,
    stall_min_progress: float = 0.05,
    chunk: int = CHUNK,
    device="cuda",
    dtype=torch.float32,
):
    """Goal-gated humanoid episode collection. Episode i runs on shard
    i % num_shards. On the kernel planner the goal is a runtime parameter
    (params[0:3], `param_target=True`), so one runner serves every episode;
    the array planner (use_kernel=False) bakes it into each episode's cost
    (the goal check reads params either way). `retries`
    re-runs an episode that missed its goal with a reseeded noise stream.
    Only successful episodes are saved (reference :268-275). `chunk` is
    EpisodeRunner.run's (the JAX function always runs chunks of 50)."""
    results = []
    runner = EpisodeRunner(task_name, use_kernel=use_kernel,
                           cost_kwargs_override={"param_target": True} if use_kernel else None,
                           mppi_override=mppi_override, device=device, dtype=dtype)
    model = runner.model
    state_row = _humanoid_state_row(model.body_id("foot_left"), model.body_id("foot_right"))
    goal_fn = _humanoid_goal_fn(goal_threshold)
    engine = runner.plant_dyn.engine
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=runner.device)
    for ep in range(n_episodes):
        if ep % num_shards != shard_index:
            continue
        rng = np.random.default_rng(seed + ep * 7919)
        goal = random_humanoid_goal(rng)
        if not use_kernel:
            # the array cost bakes the goal in: a planner per episode
            runner = EpisodeRunner(task_name, cost_kwargs_override={"target": tuple(goal)},
                                   mppi_override=mppi_override, device=device, dtype=dtype)
        qpos, qvel = randomize_humanoid_pose(model, rng)
        init = engine.forward(as_t(qpos), as_t(qvel))
        steps_executed = attempts = 0
        for attempt in range(retries + 1):
            res = runner.run(max_steps=max_steps, init_state=init,
                             seed=seed + ep + attempt * 65537, state_row_fn=state_row,
                             goal_fn=goal_fn, params=goal, chunk=chunk,
                             metrics_path=metrics_path,
                             stall_steps=stall_steps, stall_min_progress=stall_min_progress)
            steps_executed += res.steps
            attempts += 1
            if res.goal_reached:
                break
        if save and res.goal_reached:
            res.logger.save_split_dirs(out_dir)
        # steps_executed counts every logged control step across attempts
        results.append(dict(
            run=ep, goal=bool(res.goal_reached), steps_saved=int(res.steps),
            steps_executed=int(steps_executed), attempts=int(attempts),
            outcome=("goal" if res.goal_reached else
                     ("fell" if res.fell else ("stalled" if res.stalled else "cap")))))
    return results


def _jl_goal_advance(goal_step=(1.0, 0.0), threshold: float = 0.15):
    """Reference src/Humanoid_datacollection.jl:181-185 goal advance: every
    control step with the torso xy within `threshold` of the goal adds one
    to a counter and sets the goal to counter * goal_step. params layout:
    [goal_x, goal_y, goal_z, counter, ...]; on the device, no host sync."""
    sx, sy = float(goal_step[0]), float(goal_step[1])

    def params_update(plant, params):
        near = torch.linalg.vector_norm(plant.qpos[0:2] - params[0:2]) < threshold
        counter = params[3:4] + near.to(params.dtype)
        return torch.cat([counter * sx, counter * sy, params[2:3], counter, params[4:]])

    return params_update


def collect_humanoid_jl(
    n_episodes: int = 1,
    out_dir: str = "data",
    seed: int = 0,
    max_steps: int = 10000,
    goal_threshold: float = 0.15,
    save: bool = True,
    shard_index: int = 0,
    num_shards: int = 1,
    use_kernel: bool = True,
    mppi_override: Optional[dict] = None,
    metrics_path: Optional[str] = None,
    chunk: int = CHUNK,
    device="cuda",
    dtype=torch.float32,
):
    """Reference src/Humanoid_datacollection.jl collection: the v3 cost at K=75,
    sigma=0.5, the default stand start, and an advancing goal: it starts at
    (1, 0); each control step with the torso xy within `goal_threshold`
    adds one to a counter and re-targets the goal to counter * (1, 0)
    (:14-17, 181-185; the reference quirk kept: the first "reach" leaves
    the goal at (1, 0)). The goal is a runtime kernel parameter
    (`param_target=True`). Logs 55-column [qpos; qvel] rows and saves every
    episode into out_dir/<timestamp>_<ep>/{states,actions,times}.csv.
    Returns [(episode, steps)]. use_kernel=False plans on the array engine
    with the goal of the cost fixed at (1, 0, 1.28): the advance then moves
    only the logged params (the JAX package's documented deviation)."""
    from datetime import datetime

    results = []
    cost_kw = {"param_target": True} if use_kernel else {"target": (1.0, 0.0, 1.28)}
    runner = EpisodeRunner("humanoid_collect_jl", use_kernel=use_kernel,
                           cost_kwargs_override=cost_kw, mppi_override=mppi_override,
                           device=device, dtype=dtype)
    advance = _jl_goal_advance((1.0, 0.0), goal_threshold)
    for ep in range(n_episodes):
        if ep % num_shards != shard_index:
            continue
        res = runner.run(max_steps=max_steps, seed=seed + ep,
                         params=np.array([1.0, 0.0, 1.28, 0.0]), params_update_fn=advance,
                         metrics_path=metrics_path, chunk=chunk)
        if save:
            ts = datetime.now().strftime("%Y-%m-%d_%H%M%S") + f"_{ep:03d}"
            res.logger.save_run_dir(os.path.join(out_dir, ts))
        results.append((ep, res.steps))
    return results


def _v2py_state_row(inv_dt: float):
    def state_row(st):
        # 56-column layout: [qpos; (qpos - prev_qpos) / dt], the FD velocity
        # estimate of qpos (nq-sized, not qvel) that the reference logs
        # (src/Humanoid_datacollection_v2.py:68-83); the first row has
        # prev == qpos, so zeros, as the reference's None guard gives
        return torch.cat([st.phys.qpos, (st.phys.qpos - st.prev_qpos) * inv_dt])
    return state_row


def _v2py_plant_update(plant, params):
    return advance_goal_v2py(plant)


def collect_humanoid_v2py(
    n_episodes: int = 1,
    out_dir: str = "data",
    seed: int = 0,
    max_steps: int = 2000,
    save: bool = True,
    shard_index: int = 0,
    num_shards: int = 1,
    mppi_override: Optional[dict] = None,
    chunk: int = CHUNK,
    device="cuda",
    dtype=torch.float32,
    noise_fn: Optional[Callable] = None,
):
    """Reference src/Humanoid_datacollection_v2.py collection: the
    FD-velocity cost on the array planner (the task has no kernel cost),
    the hysteresis gait phase threaded through the control steps, TWO
    replans per executed action, the goal advance (+ (2, 0, 0) within 0.15
    m of the full 3D goal), 56-column rows saved unconditionally into
    out_dir/<timestamp>_<ep>/{states,actions,times}.csv. Returns
    [(episode, steps)].

    As in the JAX package: one row per control step (the reference logs
    three per plant step, duplicating timestamps), and `max_steps` steps
    (the reference runs until its viewer closes). `chunk` and `noise_fn`
    are EpisodeRunner.run's (noise injection needs replans_per_step=1)."""
    from datetime import datetime

    results = []
    runner = EpisodeRunner("humanoid_collect_v2py", mppi_override=mppi_override,
                           device=device, dtype=dtype)
    state_row = _v2py_state_row(1.0 / runner.model.timestep)
    for ep in range(n_episodes):
        if ep % num_shards != shard_index:
            continue
        res = runner.run(max_steps=max_steps, seed=seed + ep, state_row_fn=state_row,
                         plant_update_fn=_v2py_plant_update, chunk=chunk, noise_fn=noise_fn)
        if save:
            ts = datetime.now().strftime("%Y-%m-%d_%H%M%S") + f"_{ep:03d}"
            res.logger.save_run_dir(os.path.join(out_dir, ts))
        results.append((ep, res.steps))
    return results


# ---------------------------------------------------------------------------
# Quadruped collection (reference src/quadruped_datacollection.py:207-260)
# ---------------------------------------------------------------------------

def _quad_goal_fn(goal_tolerance: float):
    def goal_fn(qpos, params):
        dist = torch.linalg.vector_norm(qpos[0:2] - params[0:2])
        return (dist < goal_tolerance) | (qpos[0] >= params[0])
    return goal_fn


def _quad_fall_fn(fall_z: float):
    def fall_fn(qpos, params):
        return qpos[2] < fall_z
    return fall_fn


def collect_quadruped(
    n_runs: int = 100,
    out_base: str = "quad_data_goal",
    seed: int = 0,
    max_steps: int = 5000,
    goal_tolerance: float = 0.5,
    fall_z: float = 0.08,
    save: bool = True,
    shard_index: int = 0,
    num_shards: int = 1,
    use_kernel: bool = False,
    mppi_override: Optional[dict] = None,
    metrics_path: Optional[str] = None,
    chunk: int = CHUNK,
    stall_steps: Optional[int] = 1500,
    stall_min_progress: float = 0.05,
    gait_params: Optional[np.ndarray] = None,
    goal_for_run: Optional[Callable] = None,
    retries: int = 0,
    device="cuda",
    dtype=torch.float32,
    noise_fn: Optional[Callable] = None,
):
    """Multi-goal Go1 collection: run i's goal at (i + 2, 0) (or
    goal_for_run(i)), a fall below trunk z = fall_z ends the attempt, a
    missed goal is retried `retries` times with a reseeded noise stream
    (seed + i + attempt * 65537), and only reached goals are saved, each in
    <out_base>/run_<i>/{states,actions,times}.csv. Run i goes to shard
    i % num_shards. On the kernel planner the goal rides in the runtime
    cost params (slots 0-1, `param_goal=True`), so one runner serves every
    run, and `gait_params` (kernel_costs.quadruped's slots 4..12, e.g.
    costs.quadruped.GAIT_TUNED) adds the gait deltas (`param_gait=True`);
    the array planner (use_kernel=False) bakes the goal into each run's
    cost and has no gait deltas. `chunk` and `noise_fn` are
    EpisodeRunner.run's. Returns one dict per run: goal, steps_saved,
    steps_executed (every logged step of every attempt), attempts and the
    outcome ("goal", "fell", "stalled" or "cap")."""
    results = []
    kw = {"param_goal": True}
    if gait_params is not None:
        kw["param_gait"] = True
    runner = None
    for i in range(n_runs):
        if i % num_shards != shard_index:
            continue
        goal_xy = (i + 2.0, 0.0) if goal_for_run is None else goal_for_run(i)
        if not use_kernel:
            # the array cost bakes the goal in: a planner per run
            runner = EpisodeRunner("go1_collect", cost_kwargs_override={"goal_xy": goal_xy},
                                   mppi_override=mppi_override, device=device, dtype=dtype)
        elif runner is None:
            runner = EpisodeRunner("go1_collect", cost_kwargs_override=kw,
                                   use_kernel=True, mppi_override=mppi_override,
                                   device=device, dtype=dtype)
        params = np.asarray(goal_xy, np.float32)
        if gait_params is not None:
            params = np.concatenate([params, np.zeros(2, np.float32),
                                     np.asarray(gait_params, np.float32)])
        steps_executed = attempts = 0
        fell = stalled = False
        for attempt in range(retries + 1):
            res = runner.run(max_steps=max_steps, seed=seed + i + attempt * 65537,
                             goal_fn=_quad_goal_fn(goal_tolerance),
                             fall_fn=_quad_fall_fn(fall_z), params=params, chunk=chunk,
                             metrics_path=metrics_path, stall_steps=stall_steps,
                             stall_min_progress=stall_min_progress, noise_fn=noise_fn)
            steps_executed += res.steps
            attempts += 1
            fell, stalled = res.fell, res.stalled
            if res.goal_reached:
                break
        if save and res.goal_reached:
            res.logger.save_run_dir(os.path.join(out_base, f"run_{i:03d}"))
        results.append(dict(
            run=i, goal=bool(res.goal_reached), steps_saved=int(res.steps),
            steps_executed=int(steps_executed), attempts=int(attempts),
            outcome=("goal" if res.goal_reached else
                     ("fell" if fell else ("stalled" if stalled else "cap")))))
    return results
