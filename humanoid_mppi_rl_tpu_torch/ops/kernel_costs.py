"""Scalar-SoA task costs for the rollout kernel (ops/kernel_costs.py
counterpart). Each factory returns (running(ctx, t) -> (K,),
terminal(ctx) -> (K,)) over StepContext views, with ctrl read from ctx.

Only `humanoid`, the main path's cost, is ported so far; the CUDA kernel
carries the same formula as a device function (csrc/rollout_body.cuh).
"""

from __future__ import annotations

import torch

from ..physics.model import PhysicsModel
from .kernel_math import asin as _asin
from .kernel_math import atan2 as _atan2
from .scalar_physics import StepContext

# Runtime cost-parameter slot layout (ctx.params, padded to 16 by the
# rollout kernel; solver/kernel_mppi.py reads the solver scales). Slots 4+
# are DELTAS added to the baked weights, so all-zero params reproduce the
# baked cost exactly.
PARAM_SLOTS = {
    0: "goal_x (absolute; param_target=True)",
    1: "goal_y",
    2: "goal_z",
    3: "goal-advance counter (collect_humanoid_jl loop state)",
    4: "d_target_vel_x   (+0.3)",
    5: "d_foot_offset    (+0.5 m swing-foot target ahead of root)",
    6: "d_swing_vel_w    (+0.15 swing-foot forward-velocity reward)",
    7: "d_height_w       (+5.0)",
    8: "d_goal_xy_w      (+12.5)",
    9: "d_clearance_w    (+2.0)",
    10: "d_orient_w      (+5.0 roll/pitch)",
    11: "d_log_sigma     (solver: sigma *= exp(p11))",
    12: "d_log_temperature (solver: lambda *= exp(p12))",
    13: "d_swing_x_w     (+8.0 swing-foot x-target)",
    14: "d_knee_x_w      (+3.0 swing-knee x-target)",
    15: "d_foot_lift_w   (+0.0 foot-lift-above-0.25m penalty)",
}


def _rpy(q):
    w, x, y, z = q
    roll = _atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = _asin(2 * (w * y - z * x))
    yaw = _atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def _sumsq(xs):
    acc = 0.0
    for x in xs:
        acc = acc + x * x
    return acc


def humanoid(model: PhysicsModel, target=(2.0, 0.0, 1.28), target_vel=(0.3, 0.0),
             param_target: bool = False, param_gait: bool = False,
             w_orient=5.0, w_goal_xy=12.5, w_height=5.0, w_swing_x=8.0,
             w_swing_vel=0.15, w_knee_x=3.0, w_clearance=2.0,
             w_foot_lift=0.0):
    """Humanoid walking cost (reference src/Humanoid_datacollection_v2.jl:90-160).

    param_target=True reads the goal from ctx.params[0:3]; param_gait=True
    adds the PARAM_SLOTS[4..10, 13..15] deltas to the baked w_* weights."""
    id_shin_l = model.body_id("shin_left")
    id_shin_r = model.body_id("shin_right")
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    tx0, ty0, tz0 = [float(v) for v in target]
    tvx, tvy = [float(v) for v in target_vel]

    def _run(ctx: StepContext, u):
        if param_target:
            tx, ty, tz = ctx.params[0], ctx.params[1], ctx.params[2]
        else:
            tx, ty, tz = tx0, ty0, tz0
        p = ctx.params
        if param_gait:
            tvx_e = tvx + p[4]
            foot_off = 0.5 + p[5]
            swing_vel_w = w_swing_vel + p[6]
            height_w = w_height + p[7]
            goal_xy_w = w_goal_xy + p[8]
            clearance_w = w_clearance + p[9]
            orient_w = w_orient + p[10]
            swing_x_w = w_swing_x + p[13]
            knee_x_w = w_knee_x + p[14]
            foot_lift_w = w_foot_lift + p[15]
        else:
            tvx_e, foot_off, swing_vel_w = tvx, 0.5, w_swing_vel
            height_w, goal_xy_w = w_height, w_goal_xy
            clearance_w, orient_w = w_clearance, w_orient
            swing_x_w, knee_x_w = w_swing_x, w_knee_x
            foot_lift_w = w_foot_lift
        q = ctx.qpos
        rx, ry, rz = q[0], q[1], q[2]
        roll, pitch, yaw = _rpy((q[3], q[4], q[5], q[6]))
        cost = orient_w * (roll * roll + pitch * pitch) + 0.075 * yaw * yaw

        dx, dy = rx - tx, ry - ty
        cost = cost + goal_xy_w * torch.sqrt(dx * dx + dy * dy + 1e-12)
        cost = cost + height_w * torch.abs(tz - rz)
        vx, vy = ctx.qvel[0] - tvx_e, ctx.qvel[1] - tvy
        cost = cost + 1.0 * torch.sqrt(vx * vx + vy * vy + 1e-12)

        vxl = ctx.body_com_linvel(model, id_shin_l)[0]
        vxr = ctx.body_com_linvel(model, id_shin_r)[0]
        left = (vxl > vxr).to(rx.dtype)

        def sel(a, b):
            return left * a + (1.0 - left) * b

        foot_tx = rx + foot_off
        fl, fr = ctx.xpos[id_foot_l], ctx.xpos[id_foot_r]
        swing_x = sel(fl[0], fr[0])
        swing_z = sel(fl[2], fr[2])
        stance_z = sel(fr[2], fl[2])
        cost = cost + swing_x_w * torch.abs(swing_x - foot_tx)

        vfl = ctx.body_com_linvel(model, id_foot_l)[0]
        vfr = ctx.body_com_linvel(model, id_foot_r)[0]
        cost = cost - swing_vel_w * sel(vfl, vfr)

        knee_x = sel(ctx.xpos[id_shin_l][0], ctx.xpos[id_shin_r][0])
        cost = cost + knee_x_w * (knee_x - foot_tx) ** 2

        clearance = swing_z - stance_z
        cost = cost + torch.where(clearance < 0.05, clearance_w * clearance**2, 0.0)
        leg_cl = fl[1] - fr[1]
        cost = cost + torch.where(leg_cl < 0.0, 0.5 * leg_cl**2, 0.0)
        liftl = torch.clamp_min(fl[2] - 0.25, 0.0)
        liftr = torch.clamp_min(fr[2] - 0.25, 0.0)
        cost = cost + foot_lift_w * (liftl * liftl + liftr * liftr)
        cost = cost + 0.01 * _sumsq(u)
        return cost

    def running(ctx, t):
        return _run(ctx, ctx.ctrl)

    def terminal(ctx):
        return 10.0 * _run(ctx, [0.0] * model.nu)

    return running, terminal


KERNEL_COSTS = {
    "humanoid": humanoid,
}
