"""Plant state (physics/engine.py PhysicsState counterpart): the dynamic
state and the kinematics cached for it by engine.forward.

The kernel planner reads only qpos, qvel and time; a state made without
forward (the kinematics left None) is enough for it."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .spatial import cross


@dataclasses.dataclass
class PhysicsState:
    qpos: torch.Tensor                       # (nq,)
    qvel: torch.Tensor                       # (nv,)
    time: torch.Tensor                       # scalar
    xpos: Optional[torch.Tensor] = None      # (nbody, 3) body frame origins
    xquat: Optional[torch.Tensor] = None     # (nbody, 4)
    S: Optional[torch.Tensor] = None         # (nv, 6) motion subspace, origin frame
    body_vel: Optional[torch.Tensor] = None  # (nbody, 6) [w; v_origin]

    def body_linvel(self, bodyid: int) -> torch.Tensor:
        """World linear velocity of the body-frame origin (mujoco cvel analog)."""
        w = self.body_vel[bodyid, :3]
        v0 = self.body_vel[bodyid, 3:]
        return v0 + cross(w, self.xpos[bodyid])

    def body_angvel(self, bodyid: int) -> torch.Tensor:
        return self.body_vel[bodyid, :3]

    def to(self, device=None, dtype=None) -> "PhysicsState":
        """Every tensor field on `device` in `dtype` (None keeps it)."""
        return PhysicsState(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self)})
