"""Task registry (envs/tasks.py counterpart): the tasks whose kernel cost
the port carries -- the humanoid tasks (`humanoid`), the Go1 tasks
(`quadruped`, `quadruped_jl`), the cartpole tasks (`cartpole`) and the
planar hopper (`hopper`) -- with the same constants as the JAX registry
(envs/tasks.py:69-151), and their environment plant
(`load_plant`).

The remaining JAX tasks (arm5, humanoid v1/hard/v2py) need kernel
features and costs the port does not have yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .._device import resolve_device
from ..costs.humanoid import WEIGHTS_WALK
from ..ops import kernel_costs
from ..dynamics.physics import make_physics_dynamics
from ..physics.engine import Engine
from ..physics.model import PhysicsModel, load_model
from ..solver.mppi import MPPIConfig


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    model: str                         # assets/<model>.json snapshot
    plant: str                         # the plant's snapshot (with self pairs)
    mppi: MPPIConfig
    kernel_cost: str                   # ops.kernel_costs.KERNEL_COSTS key
    cost_kwargs: dict = dataclasses.field(default_factory=dict)
    init_keyframe: Optional[str] = None     # None -> init_qpos or the model's qpos0
    init_qpos: Optional[Tuple[float, ...]] = None
    clamp_ctrl_to_range: bool = False       # clip to the actuator ctrlrange
    ctrl_clamp_abs: Optional[float] = None  # clip to +-c (src/mppi.jl:93)

    @property
    def cost_factory(self):
        return kernel_costs.KERNEL_COSTS[self.kernel_cost]


def _mk(name, K, T, lam, sigma, tail=0.1, cost_kwargs=None, robot="humanoid",
        kernel_cost="humanoid", **kw):
    cfg = MPPIConfig(n_samples=K, horizon=T, temperature=lam, sigma=sigma,
                     tail_decay=tail)
    return TaskSpec(name=name, model=robot, plant=f"{robot}_plant", mppi=cfg,
                    kernel_cost=kernel_cost, cost_kwargs=dict(cost_kwargs or {}), **kw)


TASKS = {
    t.name: t
    for t in [
        _mk("humanoid_v3", K=30, T=75, lam=1.0, sigma=0.75),
        _mk("humanoid_collect", K=50, T=100, lam=1.0, sigma=0.5),
        _mk("humanoid_collect_jl", K=75, T=100, lam=1.0, sigma=0.5),
        _mk("humanoid_walk", K=8192, T=64, lam=1.0,
            sigma=0.5 * float(math.exp(-0.35)),
            cost_kwargs=dict(WEIGHTS_WALK, target=(10.0, 0.0, 1.28),
                             w_height=22.0, w_orient=17.0, w_goal_xy=1.0,
                             w_clearance=1.0, w_foot_lift=10.0,
                             w_swing_vel=0.20, target_vel=(0.5, 0.0))),
        # the benchmark scale of humanoid_collect (bench.py _bench_primary)
        _mk("humanoid_bench", K=8192, T=64, lam=1.0, sigma=0.5),
        # reference src/mppi.jl:10-13 and src/quadruped_datacollection.py:24-27
        _mk("go1", K=50, T=30, lam=0.2, sigma=0.3, tail=0.0, robot="go1",
            kernel_cost="quadruped_jl", init_keyframe="home", ctrl_clamp_abs=10.0),
        _mk("go1_collect", K=50, T=30, lam=0.2, sigma=0.3, tail=0.0, robot="go1",
            kernel_cost="quadruped", init_keyframe="home", clamp_ctrl_to_range=True),
        # reference src/cartpole_mppi.py:12-15 and
        # src/cartpole_datacollection.jl:19-22, from the pole hanging down
        _mk("cartpole", K=30, T=100, lam=1.0, sigma=1.0, robot="cartpole",
            kernel_cost="cartpole", init_qpos=(0.0, math.pi)),
        _mk("cartpole_collect", K=75, T=100, lam=1.0, sigma=0.75, robot="cartpole",
            kernel_cost="cartpole", init_qpos=(0.0, math.pi)),
        # the JAX package's planar hopper task (no reference analog)
        _mk("hopper", K=64, T=50, lam=0.5, sigma=0.6, robot="hopper", kernel_cost="hopper"),
    ]
}
# the benchmark scale of the cartpole (the JAX registry's cartpole_pr1)
TASKS["cartpole_pr1"] = dataclasses.replace(
    TASKS["cartpole"], name="cartpole_pr1",
    mppi=dataclasses.replace(TASKS["cartpole"].mppi, n_samples=256, horizon=30))


def load_task(name: str, device="cuda", dtype=torch.float32):
    """(spec, model, cfg, init_state): cfg carries the task's control bounds
    (the actuator ctrlrange or +-ctrl_clamp_abs, each with clamp_plan, as
    JAX load_task); init_state is the forward state of (the task's keyframe,
    its init_qpos or qpos0, zeros) at time 0 on `device` in `dtype`."""
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
    if spec.init_keyframe is not None:
        qpos0 = dict(model.keyframes)[spec.init_keyframe]
    elif spec.init_qpos is not None:
        qpos0 = spec.init_qpos
    else:
        qpos0 = model.qpos0
    init_state = Engine(model, dev, dtype).forward(
        torch.as_tensor(qpos0, dtype=dtype, device=dev),
        torch.zeros(model.nv, dtype=dtype, device=dev))
    return spec, model, cfg, init_state


def load_plant(name: str, init_state=None, device="cuda", dtype=torch.float32):
    """(plant_model, plant_dynamics): the environment plant of a task, the
    coupled constraint tier with body-body pairs (the planner's model has
    floor pairs only). `init_state` is the JAX signature's, for tasks with a
    state wrapper; the ported tasks have none."""
    spec = TASKS[name]
    plant_model = load_model(spec.plant)
    return plant_model, make_physics_dynamics(plant_model, solver="coupled",
                                              device=device, dtype=dtype)
