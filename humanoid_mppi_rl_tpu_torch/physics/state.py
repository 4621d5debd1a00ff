"""Plant state read by the kernel planner (physics/engine.py PhysicsState,
without the cached kinematics the kernel recomputes itself)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PhysicsState:
    qpos: torch.Tensor    # (nq,)
    qvel: torch.Tensor    # (nv,)
    time: torch.Tensor    # scalar
