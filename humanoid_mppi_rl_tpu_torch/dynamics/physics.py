"""Physics-engine dynamics for the planner and the plant (dynamics/physics.py
counterpart)."""

from __future__ import annotations

import torch

from ..ops.scalar_physics import scalar_step
from ..physics.engine import Engine
from ..physics.model import PhysicsModel


def make_physics_dynamics(model: PhysicsModel, substeps: int = 1, solver: str = "coupled",
                          device="cuda", dtype=torch.float32):
    """dynamics(state, ctrl, t=None, info=None) -> state, stepping the array
    engine `substeps` times per control step with constraint tier `solver`:
    "coupled" for the environment plant (and the planner that plans on
    it), "coupled_pgs" for the legacy dual solver, "penalty" for the
    planner's decoupled law, which the rollout kernel matches; one sample
    or a (K,)-batched state with ctrl (K, nu). `info`, when a dict,
    receives the last coupled substep's Newton diagnostics;
    `dynamics.engine` is the Engine."""
    if solver not in ("coupled", "coupled_pgs", "penalty"):
        raise ValueError(f"unknown solver {solver!r}")
    engine = Engine(model, device, dtype)

    def dynamics(state, ctrl, t=None, info=None):
        s = state
        for _ in range(substeps):
            s = engine.step(s, ctrl, solver=solver, info=info)
        return s

    dynamics.engine = engine
    return dynamics


def make_scalar_plant_dynamics(model: PhysicsModel, substeps: int = 1, device="cuda",
                               dtype=torch.float32):
    """dynamics(state, ctrl, t=None) -> state through ops.scalar_physics
    (the rollout kernel's math as plain PyTorch, the penalty tier) and the
    engine's kinematics of the new state: JAX make_scalar_plant_dynamics.
    One sample, or a state whose fields carry a leading K axis."""
    engine = Engine(model, device, dtype)
    h = model.timestep

    def one(state, ctrl):
        qp = [state.qpos[..., i] for i in range(model.nq)]
        qv = [state.qvel[..., i] for i in range(model.nv)]
        uu = [ctrl[..., i] for i in range(model.nu)]
        qpn, qvn, _ = scalar_step(model, qp, qv, uu, state.time)
        like = state.qpos[..., 0]
        as_t = lambda xs: torch.stack([x if torch.is_tensor(x) else torch.full_like(like, x)
                                       for x in xs], dim=-1)
        return engine.forward(as_t(qpn), as_t(qvn), state.time + h)

    def dynamics(state, ctrl, t=None, info=None):
        s = state
        for _ in range(substeps):
            s = one(s, ctrl)
        return s

    dynamics.engine = engine
    return dynamics
