"""Physics-engine dynamics for the collection loop (dynamics/physics.py
counterpart)."""

from __future__ import annotations

import torch

from ..physics.engine import Engine
from ..physics.model import PhysicsModel


def make_physics_dynamics(model: PhysicsModel, substeps: int = 1, solver: str = "coupled",
                          device="cuda", dtype=torch.float32):
    """dynamics(state, ctrl, t=None, info=None) -> state, stepping the array
    engine `substeps` times per control step with constraint tier `solver`
    ("coupled"; "penalty" and "coupled_pgs" are ROADMAP A3). `info`, when a
    dict, receives the last substep's Newton diagnostics; `dynamics.engine`
    is the Engine."""
    if solver != "coupled":
        raise NotImplementedError(f'solver="{solver}" is not ported yet (ROADMAP A3)')
    engine = Engine(model, device, dtype)

    def dynamics(state, ctrl, t=None, info=None):
        s = state
        for _ in range(substeps):
            s = engine.step(s, ctrl, solver=solver, info=info)
        return s

    dynamics.engine = engine
    return dynamics
