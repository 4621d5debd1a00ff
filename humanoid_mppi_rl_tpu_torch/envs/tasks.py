"""Task registry (envs/tasks.py counterpart): every task of the JAX
registry (the humanoid, Go1, cartpole, hopper and arm5 tasks) with the same
constants (envs/tasks.py:69-151), each with its array cost (`cost_factory`,
batched over K) and, where it has one, its kernel cost (`kernel_cost`);
`load_task` builds the planner tier (the penalty engine, floor pairs only)
and `load_plant` the environment plant (the coupled tier with the
body-body pairs).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..costs import arm5 as arm5_cost
from ..costs import cartpole as cartpole_cost
from ..costs import hopper as hopper_cost
from ..costs import humanoid as humanoid_cost
from ..costs import quadruped as quadruped_cost
from ..costs.humanoid import WEIGHTS_WALK
from ..dynamics.physics import make_physics_dynamics
from ..ops import kernel_costs
from ..physics.model import PhysicsModel, load_model
from ..solver.mppi import MPPIConfig


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    model: str                         # assets/<model>.json snapshot
    plant: str                         # the plant's snapshot (with self pairs)
    mppi: MPPIConfig
    cost_factory: Callable             # (model, **cost_kwargs) -> (running, terminal)
    cost_kwargs: dict = dataclasses.field(default_factory=dict)
    init_keyframe: Optional[str] = None     # None -> init_qpos or the model's qpos0
    init_qpos: Optional[Tuple[float, ...]] = None
    clamp_ctrl_to_range: bool = False       # clip to the actuator ctrlrange
    ctrl_clamp_abs: Optional[float] = None  # clip to +-c (src/mppi.jl:93)
    kernel_cost: Optional[str] = None       # ops.kernel_costs.KERNEL_COSTS key
    # (model) -> ((dynamics, init) -> (dynamics', init')) for tasks whose
    # state is augmented beyond PhysicsState (the v2.py FD-velocity and
    # gait-hysteresis carry)
    state_wrapper: Optional[Callable] = None

    @property
    def kernel_cost_factory(self) -> Callable:
        """The rollout kernel's cost (ops.kernel_costs) of the task."""
        if self.kernel_cost is None:
            raise ValueError(f"task {self.name} has no kernel cost")
        return kernel_costs.KERNEL_COSTS[self.kernel_cost]


def _mk(name, cost_factory, K, T, lam, sigma, tail=0.1, cost_kwargs=None, robot="humanoid",
        replans_per_step=1, **kw):
    cfg = MPPIConfig(n_samples=K, horizon=T, temperature=lam, sigma=sigma,
                     tail_decay=tail, replans_per_step=replans_per_step)
    return TaskSpec(name=name, model=robot, plant=f"{robot}_plant", mppi=cfg,
                    cost_factory=cost_factory, cost_kwargs=dict(cost_kwargs or {}), **kw)


TASKS = {   # in the JAX registry's order
    t.name: t
    for t in [
        # reference src/cartpole_mppi.py:12-15 and
        # src/cartpole_datacollection.jl:19-22, from the pole hanging down
        _mk("cartpole", cartpole_cost.make_costs, K=30, T=100, lam=1.0, sigma=1.0,
            robot="cartpole", kernel_cost="cartpole", init_qpos=(0.0, math.pi)),
        _mk("cartpole_collect", cartpole_cost.make_costs, K=75, T=100, lam=1.0, sigma=0.75,
            robot="cartpole", kernel_cost="cartpole", init_qpos=(0.0, math.pi)),
        # reference src/Humanoid_mppi.jl:22-25 (time-phased gait)
        _mk("humanoid", humanoid_cost.make_costs_v1, K=50, T=100, lam=1.0, sigma=1.0,
            kernel_cost="humanoid_v1"),
        _mk("humanoid_v3", humanoid_cost.make_costs, K=30, T=75, lam=1.0, sigma=0.75,
            kernel_cost="humanoid"),
        # reference src/Humanoid_datacollection.py:35-38 (hard-penalty cost)
        _mk("humanoid_hard", humanoid_cost.make_costs_hard_penalty, K=30, T=75, lam=1.0,
            sigma=0.75, kernel_cost="humanoid_hard"),
        _mk("humanoid_collect", humanoid_cost.make_costs, K=50, T=100, lam=1.0, sigma=0.5,
            kernel_cost="humanoid"),
        _mk("humanoid_collect_jl", humanoid_cost.make_costs, K=75, T=100, lam=1.0, sigma=0.5,
            kernel_cost="humanoid"),
        _mk("humanoid_walk", humanoid_cost.make_costs, K=8192, T=64, lam=1.0,
            sigma=0.5 * float(np.exp(-0.35)), kernel_cost="humanoid",
            cost_kwargs=dict(WEIGHTS_WALK, target=(10.0, 0.0, 1.28),
                             w_height=22.0, w_orient=17.0, w_goal_xy=1.0,
                             w_clearance=1.0, w_foot_lift=10.0,
                             w_swing_vel=0.20, target_vel=(0.5, 0.0))),
        # reference src/Humanoid_datacollection_v2.py:37-40: the FD-velocity
        # cost, the hysteresis gait phase, two replans a control step
        _mk("humanoid_collect_v2py", humanoid_cost.make_costs_v2py, K=30, T=75, lam=1.0,
            sigma=0.75, replans_per_step=2, state_wrapper=humanoid_cost.make_gait_fd_wrapper),
        # reference src/mppi.jl:10-13 and src/quadruped_datacollection.py:24-27
        _mk("go1", quadruped_cost.make_costs_mppi_jl, K=50, T=30, lam=0.2, sigma=0.3,
            tail=0.0, robot="go1", kernel_cost="quadruped_jl", init_keyframe="home",
            ctrl_clamp_abs=10.0),
        _mk("go1_collect", quadruped_cost.make_costs, K=50, T=30, lam=0.2, sigma=0.3,
            tail=0.0, robot="go1", kernel_cost="quadruped", init_keyframe="home",
            clamp_ctrl_to_range=True),
        # the JAX package's planar hopper task (no reference analog)
        _mk("hopper", hopper_cost.make_costs, K=64, T=50, lam=0.5, sigma=0.6, robot="hopper",
            kernel_cost="hopper"),
        # the JAX package's fifth robot (no reference analog): ball joints with
        # springs and a limit, ball and free motors, plane-vs-mesh contacts
        _mk("arm5_reach", arm5_cost.make_costs, K=64, T=40, lam=0.5, sigma=0.8, robot="arm5",
            kernel_cost="arm5"),
    ]
}
# the benchmark scale of the cartpole (the JAX registry's cartpole_pr1)
TASKS["cartpole_pr1"] = dataclasses.replace(
    TASKS["cartpole"], name="cartpole_pr1",
    mppi=dataclasses.replace(TASKS["cartpole"].mppi, n_samples=256, horizon=30))
# the benchmark scale of humanoid_collect (bench.py _bench_primary)
TASKS["humanoid_bench"] = dataclasses.replace(
    TASKS["humanoid_collect"], name="humanoid_bench",
    mppi=dataclasses.replace(TASKS["humanoid_collect"].mppi, n_samples=8192, horizon=64))


def load_task(name: str, device="cuda", dtype=torch.float32):
    """(spec, model, dynamics, running, terminal, init_state, cfg), JAX
    load_task's tuple: the planner model, its penalty-tier dynamics on
    `device` in `dtype` (floor pairs only; one sample or a K batch), the
    array costs of spec.cost_factory with spec.cost_kwargs, the forward
    state of (the task's keyframe, its init_qpos or qpos0; zero velocity)
    at time 0, and cfg with the task's control bounds (the actuator
    ctrlrange or +-ctrl_clamp_abs, each with clamp_plan). A task with a
    state wrapper gets the wrapped dynamics and initial state."""
    dev = resolve_device(device)
    spec = TASKS[name]
    model: PhysicsModel = load_model(spec.model)
    cfg = spec.mppi
    if spec.clamp_ctrl_to_range:
        lo, hi = model.ctrl_range()
        cfg = dataclasses.replace(cfg, ctrl_low=tuple(float(x) for x in lo),
                                  ctrl_high=tuple(float(x) for x in hi), clamp_plan=True)
    elif spec.ctrl_clamp_abs is not None:
        c = float(spec.ctrl_clamp_abs)
        cfg = dataclasses.replace(cfg, ctrl_low=(-c,) * model.nu, ctrl_high=(c,) * model.nu,
                                  clamp_plan=True)
    running, terminal = spec.cost_factory(model, **spec.cost_kwargs)
    dynamics = make_physics_dynamics(model, solver="penalty", device=dev, dtype=dtype)
    if spec.init_keyframe is not None:
        qpos0 = dict(model.keyframes)[spec.init_keyframe]
    elif spec.init_qpos is not None:
        qpos0 = spec.init_qpos
    else:
        qpos0 = model.qpos0
    init_state = dynamics.engine.forward(
        torch.as_tensor(qpos0, dtype=dtype, device=dev),
        torch.zeros(model.nv, dtype=dtype, device=dev))
    if spec.state_wrapper is not None:
        dynamics, init_state = spec.state_wrapper(model)(dynamics, init_state)
    return spec, model, dynamics, running, terminal, init_state, cfg


def load_plant(name: str, init_state=None, device="cuda", dtype=torch.float32):
    """(plant_model, plant_dynamics): the environment plant of a task, the
    coupled constraint tier with body-body pairs (the planner's model has
    floor pairs only). For a task with a state wrapper the plant dynamics
    are wrapped too, around `init_state` (the plain PhysicsState or the
    wrapped state, whose .phys is used), as JAX load_plant does."""
    spec = TASKS[name]
    plant_model = load_model(spec.plant)
    dyn = make_physics_dynamics(plant_model, solver="coupled", device=device, dtype=dtype)
    if spec.state_wrapper is not None:
        dyn, _ = spec.state_wrapper(plant_model)(dyn, getattr(init_state, "phys", init_state))
    return plant_model, dyn
