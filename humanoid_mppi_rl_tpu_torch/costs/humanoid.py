"""Humanoid locomotion costs (costs/humanoid.py counterpart), batched over
K: `running(state, u, t) -> (K,)` for a state whose fields carry a leading
K axis (Engine.forward on (K, nq) inputs).

`make_costs` is the v2/v3 collection cost (reference
src/Humanoid_datacollection_v2.jl:90-160) with the JAX package's fix: the
body-frame gait terms read each rollout's own state. The other cost
families of the JAX module (hard penalty, the gait FD wrapper, v2py, v1)
plan on the array engine and wait for it (ROADMAP A4).
"""

from __future__ import annotations

import torch

from ..physics.model import PhysicsModel
from .base import EngineCache, body_com_linvel, quat_rpy

# Weight presets for make_costs / ops.kernel_costs.humanoid: the reference
# v3 weights (src/Humanoid_mppi_v3.jl), and "walk", the JAX package's tuned
# walking posture (the velocity-gait terms off, posture over goal distance;
# the humanoid_walk task).
WEIGHTS_V3 = dict(w_orient=5.0, w_goal_xy=12.5, w_height=5.0,
                  w_swing_x=8.0, w_swing_vel=0.15, w_knee_x=3.0,
                  w_clearance=2.0)
WEIGHTS_WALK = dict(w_orient=15.0, w_goal_xy=2.5, w_height=20.0,
                    w_swing_x=0.0, w_swing_vel=0.0, w_knee_x=0.0,
                    w_clearance=0.0)


def make_costs(model: PhysicsModel, target=(2.0, 0.0, 1.28), target_vel=(0.3, 0.0),
               w_orient=5.0, w_goal_xy=12.5, w_height=5.0, w_swing_x=8.0,
               w_swing_vel=0.15, w_knee_x=3.0, w_clearance=2.0,
               w_foot_lift=0.0, **_unused):
    """(running, terminal); terminal = 10 x running with zero control. Each
    per-sample choice of a body (swing or stance foot, swing knee) is a
    torch.where between the two gathered rows."""
    id_shin_l = model.body_id("shin_left")
    id_shin_r = model.body_id("shin_right")
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    tx, ty, tz = (float(v) for v in target)
    tvx, tvy = (float(v) for v in target_vel)
    engine = EngineCache(model)

    def running(state, u, t):
        eng = engine(state.qpos)
        qpos, qvel, xpos = state.qpos, state.qvel, state.xpos
        root = qpos[:, 0:3]

        roll, pitch, yaw = quat_rpy(qpos[:, 3:7])
        cost = w_orient * (roll ** 2 + pitch ** 2) + 0.075 * yaw ** 2

        goal_xy = torch.stack([root[:, 0] - tx, root[:, 1] - ty], dim=-1)
        cost = cost + w_goal_xy * torch.linalg.vector_norm(goal_xy, dim=-1)
        cost = cost + w_height * torch.abs(tz - root[:, 2])
        vel_xy = torch.stack([qvel[:, 0] - tvx, qvel[:, 1] - tvy], dim=-1)
        cost = cost + 1.0 * torch.linalg.vector_norm(vel_xy, dim=-1)

        # gait phase from the shins' forward com velocities
        vx_l = body_com_linvel(state, eng, id_shin_l)[:, 0]
        vx_r = body_com_linvel(state, eng, id_shin_r)[:, 0]
        left_swings = vx_l > vx_r
        pick = lambda a, b: torch.where(left_swings[:, None], xpos[:, a], xpos[:, b])

        foot_targetx = root[:, 0] + 0.5
        swing_foot = pick(id_foot_l, id_foot_r)
        stance_foot = pick(id_foot_r, id_foot_l)
        cost = cost + w_swing_x * torch.abs(swing_foot[:, 0] - foot_targetx)

        vx_swing = torch.where(left_swings,
                               body_com_linvel(state, eng, id_foot_l)[:, 0],
                               body_com_linvel(state, eng, id_foot_r)[:, 0])
        cost = cost - w_swing_vel * vx_swing

        swing_knee_x = pick(id_shin_l, id_shin_r)[:, 0]
        cost = cost + w_knee_x * (swing_knee_x - foot_targetx) ** 2

        clearance = swing_foot[:, 2] - stance_foot[:, 2]
        cost = cost + torch.where(clearance < 0.05, w_clearance * clearance ** 2,
                                  torch.zeros_like(clearance))

        leg_clearance = xpos[:, id_foot_l, 1] - xpos[:, id_foot_r, 1]
        cost = cost + torch.where(leg_clearance < 0.0, 0.5 * leg_clearance ** 2,
                                  torch.zeros_like(leg_clearance))

        # foot lift above a walking band (no reference analog, weight 0 by
        # default)
        lift_l = torch.clamp(xpos[:, id_foot_l, 2] - 0.25, min=0.0)
        lift_r = torch.clamp(xpos[:, id_foot_r, 2] - 0.25, min=0.0)
        cost = cost + w_foot_lift * (lift_l ** 2 + lift_r ** 2)

        return cost + 0.01 * torch.sum(u ** 2, dim=-1)

    def terminal(state, t):
        zeros = torch.zeros(state.qpos.shape[0], model.nu, dtype=state.qpos.dtype,
                            device=state.qpos.device)
        return 10.0 * running(state, zeros, t)

    return running, terminal


def make_costs_walk(model: PhysicsModel, target=(2.0, 0.0, 1.28), target_vel=(0.3, 0.0),
                    **kw):
    """The humanoid_walk preset: make_costs with WEIGHTS_WALK, `kw` on top."""
    merged = dict(WEIGHTS_WALK)
    merged.update(kw)
    return make_costs(model, target=target, target_vel=target_vel, **merged)
