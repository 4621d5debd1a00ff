"""Task registry: the tasks whose kernel cost is `humanoid`
(envs/tasks.py counterpart, same constants as envs/tasks.py:69-151).

The remaining JAX tasks (cartpole, hopper, go1, arm5, humanoid_v1/hard/v2py)
need kernel features and costs the port does not have yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .._device import resolve_device
from ..ops import kernel_costs
from ..physics.model import PhysicsModel, load_model
from ..physics.state import PhysicsState
from ..solver.mppi import MPPIConfig

# costs/humanoid.py WEIGHTS_WALK: the tuned walking posture base weights
WEIGHTS_WALK = dict(w_orient=15.0, w_goal_xy=2.5, w_height=20.0,
                    w_swing_x=0.0, w_swing_vel=0.0, w_knee_x=0.0,
                    w_clearance=0.0)


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    model: str                         # assets/<model>.json snapshot
    mppi: MPPIConfig
    kernel_cost: str                   # ops.kernel_costs.KERNEL_COSTS key
    cost_kwargs: dict = dataclasses.field(default_factory=dict)

    @property
    def cost_factory(self):
        return kernel_costs.KERNEL_COSTS[self.kernel_cost]


def _mk(name, K, T, lam, sigma, tail=0.1, cost_kwargs=None):
    cfg = MPPIConfig(n_samples=K, horizon=T, temperature=lam, sigma=sigma,
                     tail_decay=tail)
    return TaskSpec(name=name, model="humanoid", mppi=cfg, kernel_cost="humanoid",
                    cost_kwargs=dict(cost_kwargs or {}))


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
    ]
}


def load_task(name: str, device="cuda", dtype=torch.float32):
    """(spec, model, cfg, init_state): init_state is (qpos0, zeros, 0) on
    `device` in `dtype`, which is all the kernel planner reads."""
    dev = resolve_device(device)
    spec = TASKS[name]
    model: PhysicsModel = load_model(spec.model)
    init_state = PhysicsState(
        qpos=torch.as_tensor(model.qpos0, dtype=dtype, device=dev),
        qvel=torch.zeros(model.nv, dtype=dtype, device=dev),
        time=torch.zeros((), dtype=dtype, device=dev))
    return spec, model, spec.mppi, init_state
