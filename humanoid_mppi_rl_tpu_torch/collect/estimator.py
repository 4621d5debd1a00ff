"""Estimator MPPI: closed-loop control that plans on a learned surrogate
while the coupled plant plays the real robot (collect/estimator.py
counterpart): the solver configurations, the costs and EstimatorRunner.

Every cost here is batched: x (..., nx) and u (..., nu) -> (...), summing
over the last axis only (the JAX costs are per-sample and vmapped over K).
The cartpole's flat costs are costs/cartpole.make_costs_flat
(make_cartpole_estimator).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..costs import cartpole as cartpole_cost
from ..costs import humanoid as humc
from ..costs.base import EngineCache
from ..dynamics.learned import flat_state_from_physics, make_learned_dynamics
from ..envs.tasks import load_plant
from ..ops.estimator_kernel import make_flash_feature_attention
from ..physics import spatial as sp
from ..solver.mppi import MPPIConfig, MPPIState, make_mppi
from .logging import TrajectoryLogger

ESTIMATOR_CONFIGS = {
    # reference src/cartpole_mppi_estimator.py:37-40
    "cartpole": MPPIConfig(n_samples=2048, horizon=100, temperature=10.0,
                           sigma=0.5, update_mode="replace", tail_decay=0.1),
    # reference src/quadruped_mppi_estimator.py:38-41
    "quadruped": MPPIConfig(n_samples=2048, horizon=50, temperature=10.0,
                            sigma=0.4, update_mode="replace", tail_decay=0.1),
    # the humanoid surrogate, in the same replace-mode pattern
    "humanoid": MPPIConfig(n_samples=2048, horizon=50, temperature=10.0,
                           sigma=0.4, update_mode="replace", tail_decay=0.1),
}


def _const(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _goal_costs(goal_pos):
    """Drive the root toward the goal, regularise control; terminal 10x."""

    def running(x, u, t):
        goal = _const(goal_pos, x)
        return (torch.sum((x[..., :3] - goal) ** 2, dim=-1)
                + 0.1 * torch.sum(u ** 2, dim=-1))

    def terminal(x, t):
        return 10.0 * torch.sum((x[..., :3] - _const(goal_pos, x)) ** 2, dim=-1)

    return running, terminal


def humanoid_estimator_costs(goal_pos=(2.0, 0.0, 1.28), action_dim=21):
    """Goal-reaching cost over the humanoid surrogate's 30-dim state
    [qpos(28); foot_l_z; foot_r_z]."""
    return _goal_costs(goal_pos)


def humanoid_foot_state_fn(model):
    """state_fn of the humanoid surrogate: [qpos; foot_left z; foot_right z]
    (scripts/dev_estimator_walk.py:65-67)."""
    id_l, id_r = model.body_id("foot_left"), model.body_id("foot_right")

    def state_fn(plant):
        return torch.cat([plant.qpos, plant.xpos[id_l, 2:3], plant.xpos[id_r, 2:3]])

    return state_fn


# the humanoid_walk preset as the estimator loop runs it
_WALK_ESTIMATOR = dict(humc.WEIGHTS_WALK, target=(10.0, 0.0, 1.28),
                       w_height=22.0, w_orient=17.0, w_goal_xy=1.0,
                       w_clearance=1.0, w_foot_lift=10.0,
                       w_swing_vel=0.20, target_vel=(0.4, 0.0))


def _full_state_costs(model, reconstruct, cost_kwargs):
    """costs/humanoid.make_costs (the walk preset, `cost_kwargs` on top) on
    the state that `reconstruct(eng, x_aug (K, n)) -> (qpos, qvel, time)`
    rebuilds through the engine's batched forward kinematics."""
    kw = dict(_WALK_ESTIMATOR)
    kw.update(cost_kwargs or {})
    run_full, term_full = humc.make_costs(model, **kw)
    engine = EngineCache(model)

    def state_of(x_aug):
        eng = engine(x_aug)
        return eng.forward(*reconstruct(x_aug.reshape(-1, x_aug.shape[-1])))

    def running(x_aug, u, t):
        return run_full(state_of(x_aug), u.reshape(-1, u.shape[-1]), t).reshape(x_aug.shape[:-1])

    def terminal(x_aug, t):
        return term_full(state_of(x_aug), t).reshape(x_aug.shape[:-1])

    return running, terminal


def humanoid_fk_estimator_costs(model, dt: float = 0.005, nx: int = 30,
                                cost_kwargs: Optional[dict] = None):
    """The humanoid_walk cost on surrogate rollouts of [qpos(28); foot z(2)]
    in the [x; x_prev; t_abs] augmentation: qvel by finite differences (root
    linear from xyz, root angular from the local quaternion difference,
    joint rates directly), then forward kinematics of the predicted qpos
    and costs/humanoid.make_costs on that state. `model` is the kinematic
    model (the humanoid plant snapshot)."""
    nv = model.nv

    def reconstruct(x_aug):
        q = x_aug[:, :28]
        prev = x_aug[:, nx:nx + 28]
        v_lin = (q[:, 0:3] - prev[:, 0:3]) / dt
        w_loc = sp.quat_sub(q[:, 3:7], prev[:, 3:7]) / dt
        v_jnt = (q[:, 7:28] - prev[:, 7:28]) / dt
        return q, torch.cat([v_lin, w_loc, v_jnt], dim=-1)[:, :nv], x_aug[:, 2 * nx]

    return _full_state_costs(model, reconstruct, cost_kwargs)


def humanoid_predvel_estimator_costs(model, nx: int = 57,
                                     cost_kwargs: Optional[dict] = None):
    """The same walking cost over a velocity-predicting surrogate's state
    [qpos(28); qvel(27); foot z(2)]: the predicted qvel, no finite
    differences; the augmentation only carries the clock. The qpos width
    28 is the reference's, whatever the model [sic]."""
    nv = model.nv

    def reconstruct(x_aug):
        return x_aug[:, :28], x_aug[:, 28:28 + nv], x_aug[:, 2 * nx]

    return _full_state_costs(model, reconstruct, cost_kwargs)


def quadruped_estimator_costs(goal_pos=(2.0, 0.0, 0.35), action_dim=12):
    """reference src/quadruped_mppi_estimator.py:48-55"""
    return _goal_costs(goal_pos)


def make_fd_time_augmented(base_dyn, nx: int, dt: float):
    """Wrap a flat-state surrogate dynamics with the [x_t; x_{t-1}; t_abs]
    augmentation, so costs can finite-difference velocities and keep an
    absolute gait clock across replans."""

    def dyn(x_aug, u, t):
        x = x_aug[..., :nx]
        tau = x_aug[..., 2 * nx:]
        return torch.cat([base_dyn(x, u, t), x, tau + dt], dim=-1)

    def augment_state(x, t_abs):
        return torch.cat([x, x, _const(t_abs, x).reshape(1)])

    return dyn, augment_state


def humanoid_gait_estimator_costs(goal_pos=(3.0, 0.0, 1.28), nx: int = 30,
                                  dt: float = 0.005,
                                  target_vel: float = 0.35,
                                  gait_period: float = 0.9,
                                  foot_lift: float = 0.10,
                                  w_vel=10.0, w_height=22.0, w_orient=17.0,
                                  w_goal=1.0, w_lat=2.0, w_gait=60.0,
                                  w_ctrl=0.1):
    """Gait-shaped cost over the FD/time-augmented humanoid surrogate state
    [qpos(28); foot_l_z; foot_r_z; prev...; t_abs]: forward-velocity
    tracking from FD root x, an alternating foot-lift clock on the two
    predicted foot heights, orientation and height anchors."""
    om = 2.0 * math.pi / gait_period

    def running(x_aug, u, t):
        goal = _const(goal_pos, x_aug)
        x = x_aug[..., :nx]
        xp = x_aug[..., nx:2 * nx]
        tau = x_aug[..., 2 * nx]
        vx = (x[..., 0] - xp[..., 0]) / dt
        vy = (x[..., 1] - xp[..., 1]) / dt
        qw, qx, qy, qz = x[..., 3], x[..., 4], x[..., 5], x[..., 6]
        roll = torch.atan2(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
        pitch = torch.asin(torch.clamp(2 * (qw * qy - qz * qx), -1.0, 1.0))
        fl, fr = x[..., 28], x[..., 29]
        s = torch.sin(om * tau)
        tl = 0.07 + foot_lift * torch.clamp(s, min=0.0)
        tr = 0.07 + foot_lift * torch.clamp(-s, min=0.0)
        c = w_vel * (vx - target_vel) ** 2 + w_vel * vy ** 2
        c = c + w_height * (x[..., 2] - goal[2]) ** 2
        c = c + w_orient * (roll ** 2 + pitch ** 2)
        c = c + w_lat * x[..., 1] ** 2
        c = c + w_goal * torch.sum((x[..., :2] - goal[:2]) ** 2, dim=-1)
        c = c + w_gait * ((fl - tl) ** 2 + (fr - tr) ** 2)
        return c + w_ctrl * torch.sum(u ** 2, dim=-1)

    def terminal(x_aug, t):
        goal = _const(goal_pos, x_aug)
        x = x_aug[..., :nx]
        return 10.0 * (w_goal * torch.sum((x[..., :2] - goal[:2]) ** 2, dim=-1)
                       + w_height * (x[..., 2] - goal[2]) ** 2)

    return running, terminal


def quadruped_gait_estimator_costs(home12, goal_xy=(2.0, 0.0), nx: int = 37,
                                   target_vel: float = 0.45,
                                   w_home: float = 3000.0):
    """The trot cost of the true Go1 plant (costs/quadruped.make_costs with
    GAIT_TUNED shaping) over the surrogate's predicted [qpos(19); qvel(18)]
    state in the FD/time augmentation. `home12` is the home-keyframe leg
    pose. Indices marked [sic] follow the reference."""
    gx, gy = float(goal_xy[0]), float(goal_xy[1])

    def running(x_aug, u, t):
        home = _const(home12, x_aug)
        x = x_aug[..., :nx]
        tau = x_aug[..., 2 * nx]
        q = x[..., :19]
        v = x[..., 19:37]
        phase = (tau % 0.5) / 0.5 * 2 * math.pi
        trot = torch.sin(phase)
        tv = target_vel + 0.1 * torch.sin(phase)
        c = 10000.0 * (q[..., 2] - 0.4) ** 2          # GAIT_TUNED w_height
        c = c + 30000.0 * (v[..., 0] - tv) ** 2
        c = c + 500.0 * (q[..., 6] ** 2 + q[..., 7] ** 2)   # [sic]
        c = c + 20.0 * torch.sum(v[..., 6:9] ** 2, dim=-1)
        c = c + 50000.0 * (q[..., 1] ** 2 + v[..., 1] ** 2)
        c = c + 0.01 * torch.sum(u ** 2, dim=-1)
        c = c + 3000.0 * ((q[..., 0] - gx) ** 2 + (q[..., 1] - gy) ** 2)
        f1 = (q[..., 2] - q[..., 11]) * trot          # [sic]
        f2 = (q[..., 5] - q[..., 8]) * (-trot)
        c = c + 34000.0 * (f1 * f1 + f2 * f2)
        c = c + w_home * torch.sum((q[..., 7:19] - home) ** 2, dim=-1)
        nk = 0.5
        c = c + 2000.0 * ((q[..., 2] - nk) ** 2 + (q[..., 5] - nk) ** 2
                          + (q[..., 8] - nk) ** 2 + (q[..., 11] - nk) ** 2)
        return c + 5.0 * torch.sum(q[..., 0:12] ** 2, dim=-1)

    def terminal(x_aug, t):
        x = x_aug[..., :nx]
        return 10.0 * 3000.0 * ((x[..., 0] - gx) ** 2 + (x[..., 1] - gy) ** 2)

    return running, terminal


def quadruped_fd_gait_estimator_costs(home12, goal_xy=(2.0, 0.0),
                                      nx: int = 19, dt: float = 0.002,
                                      w_home: float = 3000.0):
    """The collection trot cost (costs/quadruped.make_costs plus the
    GAIT_TUNED deltas) over a position-only quad surrogate state [qpos(19)],
    every velocity read replaced by its finite difference over the
    [x; x_prev; t_abs] augmentation. Indices marked [sic] follow the
    reference."""
    w_pos, w_height, w_vel = 50000.0, 500.0 * math.exp(3.0), 30000.0
    w_ori, w_ang, w_ctrl = 500.0, 20.0, 0.01
    w_goal, w_trot = 3000.0, 34000.0
    w_front, w_back = 4400.0, 10000.0
    w_knee, w_posture = 2000.0, 5.0
    target_height, base_tv, osc, nk, period = 0.4, 0.9, 0.1, 0.5, 0.5

    def running(x_aug, u, t):
        goal = _const([float(goal_xy[0]), float(goal_xy[1])], x_aug)
        home = _const(home12, x_aug)
        q = x_aug[..., :nx]
        qp = x_aug[..., nx:2 * nx]
        tau = x_aug[..., 2 * nx]
        vel3 = (q[..., 0:3] - qp[..., 0:3]) / dt
        ang3 = (q[..., 6:9] - qp[..., 6:9]) / dt   # [sic]
        phase = (tau % period) / period * 2 * math.pi
        trot = torch.sin(phase)
        tv = base_tv + osc * torch.sin(phase)
        FL, FR = q[..., 2], q[..., 5]              # [sic]
        RL, RR = q[..., 8], q[..., 11]
        c = w_height * (q[..., 2] - target_height) ** 2
        c = c + w_vel * (vel3[..., 0] - tv) ** 2
        c = c + w_ori * (q[..., 6] ** 2 + q[..., 7] ** 2)   # [sic]
        c = c + w_ang * torch.sum(ang3 ** 2, dim=-1)
        c = c + w_pos * (q[..., 1] ** 2 + vel3[..., 1] ** 2)
        c = c + w_ctrl * torch.sum(u ** 2, dim=-1)
        c = c + w_goal * torch.sum((q[..., 0:2] - goal) ** 2, dim=-1)
        f1 = (FL - RR) * trot
        f2 = (FR - RL) * (-trot)
        c = c + w_trot * (f1 * f1 + f2 * f2)
        c = c - w_front * (u[..., 1] ** 2 + u[..., 4] ** 2)
        c = c + w_front * (u[..., 2] ** 2 + u[..., 5] ** 2)
        c = c - w_back * (u[..., 7] ** 2 + u[..., 10] ** 2)
        c = c + w_back * (u[..., 8] ** 2 + u[..., 11] ** 2)
        c = c + w_knee * ((FL - nk) ** 2 + (FR - nk) ** 2
                          + (RL - nk) ** 2 + (RR - nk) ** 2)
        c = c + w_posture * torch.sum(q[..., 0:12] ** 2, dim=-1)
        return c + w_home * torch.sum((q[..., 7:19] - home) ** 2, dim=-1)

    def terminal(x_aug, t):
        # the reference adds no terminal (costs/quadruped.make_costs)
        return torch.zeros(x_aug.shape[:-1], dtype=x_aug.dtype, device=x_aug.device)

    return running, terminal


class EstimatorRunner:
    """Plan on the surrogate; execute on the task's coupled plant
    (envs/tasks.load_plant: the coupled constraint tier with body-body
    contacts, as the JAX runner's build_from_mjcf(...,
    include_self_collisions=True) and step(solver="coupled")).

    `module` is the surrogate (models/predictors); it is moved to `device`
    and put in eval mode. With `batched_dynamics=True` the rollouts go
    through the CUDA estimator kernel
    (ops/estimator_kernel.make_flash_feature_attention in bf16, the JAX
    kernel's default; on CPU tensors its plain version), else through the
    module's own forward. `state_fn(plant) -> x` overrides the default
    [qpos; qvel] estimator state.
    `fd_time_augment=nx` wraps the surrogate in the [x; x_prev; t_abs]
    augmentation (make_fd_time_augmented), t_abs read from the plant's
    clock. The plant runs on `device` in `dtype`; the plan is float32, as
    the JAX MPPIState's."""

    def __init__(self, task_name: str, module, cfg: MPPIConfig, running, terminal,
                 state_slice: Optional[int] = None, seed: int = 0,
                 state_fn: Optional[Callable] = None, batched_dynamics: bool = False,
                 fd_time_augment: Optional[int] = None, ego_cols=None,
                 device="cuda", dtype=torch.float32):
        self.device, self.dtype = resolve_device(device), dtype
        self.plant_model, self.plant_dyn = load_plant(task_name, device=self.device, dtype=dtype)
        self.cfg = cfg
        module = module.to(self.device).eval()
        self.apply = (make_flash_feature_attention(module, torch.bfloat16, self.device)
                      if batched_dynamics else module)
        net_dyn = make_learned_dynamics(self.apply, state_slice=state_slice, ego_cols=ego_cols)
        extract = state_fn or flat_state_from_physics
        if fd_time_augment is not None:
            net_dyn, augment = make_fd_time_augmented(
                net_dyn, fd_time_augment, float(self.plant_model.timestep))
            base_extract = extract
            extract = lambda plant: augment(base_extract(plant), plant.time)
        self.extract = extract
        self.plan = make_mppi(net_dyn, running, cfg, terminal_fn=terminal)
        self.seed = seed

    @torch.no_grad()
    def control_step(self, ms: MPPIState, plant, noise=None):
        """Plan on the surrogate from the plant's state, then step the
        plant: (action, ms', plant', diag). `noise` (K, T, nu) replaces the
        planner's draw."""
        action, ms, diag = self.plan(ms, self.extract(plant), noise=noise)
        return action, ms, self.plant_dyn(plant, action), diag

    def start(self, init_qpos=None, init_qvel=None, seed: Optional[int] = None,
              init_plan=None):
        """(ms, plant): a seeded controller and the plant's forward state at
        time 0 from (init_qpos or qpos0, init_qvel or zeros). `init_plan`
        (nu,) seeds every horizon row of the plan (a position-servo robot's
        zero plan commands zero joint targets)."""
        m = self.plant_model
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)
        plant = self.plant_dyn.engine.forward(
            as_t(m.qpos0 if init_qpos is None else init_qpos),
            as_t(np.zeros(m.nv) if init_qvel is None else init_qvel))
        ms = MPPIState.seeded(self.seed if seed is None else seed, self.cfg.T, m.nu,
                              device=self.device)
        if init_plan is not None:
            ms.U = torch.as_tensor(np.asarray(init_plan, np.float32),
                                   device=self.device).repeat(self.cfg.T, 1)
        return ms, plant

    def run(self, n_steps: int = 200, init_qpos=None, init_qvel=None,
            seed: Optional[int] = None, init_plan=None, chunk: int = 50,
            noise_fn: Optional[Callable] = None) -> TrajectoryLogger:
        """n_steps control steps from `start(...)`; logs [qpos; qvel], the
        action and the sim time of the state before each step. Rows stay on
        the device and cross to the host once per `chunk` steps.
        `noise_fn(step) -> (K, T, nu)` replaces the planner's noise draw at
        step `step` (the parity tests' matched-noise hook)."""
        ms, plant = self.start(init_qpos, init_qvel, seed, init_plan)
        nq, nv = self.plant_model.nq, self.plant_model.nv
        log = TrajectoryLogger()
        done = 0
        while done < n_steps:
            packed = []
            for _ in range(min(chunk, n_steps - done)):
                noise = noise_fn(done) if noise_fn is not None else None
                action, ms, nxt, _ = self.control_step(ms, plant, noise)
                packed.append(torch.cat([plant.qpos, plant.qvel, action.to(plant.qpos.dtype),
                                         plant.time.reshape(1)]))
                plant = nxt
                done += 1
            for row in torch.stack(packed).cpu().numpy():   # one host fetch per chunk
                log.log(row[:nq + nv], row[nq + nv:-1], float(row[-1]))
        return log


def make_cartpole_estimator(module, seed: int = 0, device="cuda",
                            dtype=torch.float32,
                            mppi_override: Optional[dict] = None) -> EstimatorRunner:
    """The cartpole closed loop of reference src/cartpole_mppi_estimator.py
    (JAX collect/estimator.py:444-449): ESTIMATOR_CONFIGS["cartpole"]
    (K=2048, T=100, replace update), costs/cartpole.make_costs_flat on the
    surrogate's [x, theta, xdot, thetadot], the cartpole's coupled plant,
    the module's own forward. The port's API takes the surrogate module
    (models/predictors cartpole_attention) where JAX takes (apply_fn,
    params, asset_path); the plant comes from the "cartpole" task. The
    estimator kernel's route is EstimatorRunner("cartpole", module, cfg,
    *make_costs_flat(), batched_dynamics=True). `mppi_override` replaces
    fields of the config (as EpisodeRunner's; the JAX function has none)."""
    running, terminal = cartpole_cost.make_costs_flat()
    cfg = dataclasses.replace(ESTIMATOR_CONFIGS["cartpole"], **(mppi_override or {}))
    return EstimatorRunner("cartpole", module, cfg, running, terminal,
                           seed=seed, device=device, dtype=dtype)
