"""Shared cost helpers (costs/base.py counterpart), batched: a state's
kinematics carry a leading K axis."""

from __future__ import annotations

import torch

from ..physics import spatial as sp
from ..physics.engine import Engine
from ..physics.model import PhysicsModel


def quat_rpy(q: torch.Tensor):
    """Roll/pitch/yaw of (..., 4) (w, x, y, z) quaternions (reference
    src/Humanoid_datacollection_v2.jl:95-101 formulas)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def body_com_linvel(state, eng: Engine, bodyid: int) -> torch.Tensor:
    """World linear velocity (K, 3) of a body's com (mujoco cvel-linear
    analog, the reference's get_body_vx, src/Humanoid_datacollection_v2.jl:
    84-87) for a state whose xquat/xpos/body_vel are (K, nbody, .). `eng`
    is the model's Engine on the state's device and dtype (body_ipos)."""
    R = sp.quat_to_mat(state.xquat[:, bodyid])
    xipos = state.xpos[:, bodyid] + torch.einsum("kij,j->ki", R, eng.body_ipos[bodyid])
    V = state.body_vel[:, bodyid]
    return V[:, 3:] + sp.cross(V[:, :3], xipos)


class EngineCache:
    """A model's Engine per (device, dtype), built on first use: costs
    built from a PhysicsModel read its constants where their inputs lie."""

    def __init__(self, model: PhysicsModel):
        self.model = model
        self._engines = {}

    def __call__(self, like: torch.Tensor) -> Engine:
        key = (like.device, like.dtype)
        if key not in self._engines:
            self._engines[key] = Engine(self.model, like.device, like.dtype)
        return self._engines[key]

