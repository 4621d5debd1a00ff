"""Scalar-SoA task costs for the rollout kernel (ops/kernel_costs.py
counterpart). Each factory returns (running(ctx, t) -> (K,),
terminal(ctx) -> (K,)) over StepContext views, with ctrl read from ctx.

All of them: `humanoid`, `humanoid_v1` and `humanoid_hard` (the humanoid
tasks), `quadruped` and `quadruped_jl` (the Go1 tasks), `cartpole`,
`hopper` and `arm5`; the CUDA kernel carries the same formulas as device
functions (csrc/rollout_body.cuh).
"""

from __future__ import annotations

import numpy as np
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


def cartpole(model: PhysicsModel):
    """Cartpole swing-up cost (reference src/cartpole_mppi.py:44-53, see
    costs/cartpole.py); terminal = 10 x running at zero control."""

    def running_vals(x_pos, theta, x_vel, theta_vel, u):
        return (1.0 * x_pos ** 2 + 20.0 * (torch.cos(theta) - 1.0) ** 2
                + 0.1 * x_vel ** 2 + 0.1 * theta_vel ** 2 + 0.01 * _sumsq(u))

    def running(ctx: StepContext, t):
        return running_vals(ctx.qpos[0], ctx.qpos[1], ctx.qvel[0], ctx.qvel[1], ctx.ctrl)

    def terminal(ctx: StepContext):
        return 10.0 * running_vals(ctx.qpos[0], ctx.qpos[1], ctx.qvel[0], ctx.qvel[1], [0.0])

    return running, terminal


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


def humanoid_v1(model: PhysicsModel, target=(2.0, 0.0), target_vel=0.5,
                step_period: int = 100, horizon: int = 0):
    """Time-phased-gait cost (reference src/Humanoid_mppi.jl:31-121; the
    array oracle is costs/humanoid.make_costs_v1): a square-wave gait clock
    alternates the swing side every `step_period` rollout steps. `horizon`
    is injected by build_rollout_kernel, so that the terminal's gait clock
    reads t = T as the array solver's does."""
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    tx, ty = [float(v) for v in target]

    def running(ctx: StepContext, t):
        q, v, u = ctx.qpos, ctx.qvel, ctx.ctrl
        roll, pitch, yaw = _rpy((q[3], q[4], q[5], q[6]))
        cost = 5.0 * (roll * roll + pitch * pitch) + 0.1 * yaw * yaw
        dx, dy = q[0] - tx, q[1] - ty
        cost = cost + 10.0 * torch.sqrt(dx * dx + dy * dy + 1e-12)
        cost = cost + 5.0 * torch.abs(1.28 - q[2])
        cost = cost + 1.0 * torch.abs(v[0] - target_vel)

        left = float((int(t) // step_period) % 2 == 0)
        fl, fr = ctx.xpos[id_foot_l], ctx.xpos[id_foot_r]
        swing_z = left * fl[2] + (1.0 - left) * fr[2]
        stance_z = left * fr[2] + (1.0 - left) * fl[2]
        clearance = swing_z - stance_z
        cost = cost + torch.where(clearance < 0.05, 5.0 * (0.05 - clearance) ** 2, 0.0)
        cost = cost + 0.01 * _sumsq(u)
        return cost

    def terminal(ctx: StepContext):
        # the array oracle's terminal_fn(final_state, T) at zero control: the
        # gait clock reads the horizon
        saved = ctx.ctrl
        ctx.ctrl = [torch.zeros_like(ctx.qpos[0])] * model.nu
        c = 10.0 * running(ctx, horizon)
        ctx.ctrl = saved
        return c

    return running, terminal


def humanoid_hard(model: PhysicsModel, target=(2.0, 0.0, 1.28), target_vel=(0.3, 0.0)):
    """Hard-penalty gait cost (reference src/Humanoid_datacollection.py:57-186;
    array oracle costs/humanoid.make_costs_hard_penalty), with the
    reference's [sic] LINEAR height term and its [0.15, 0.21] lateral
    dead-zone bands."""
    id_shin_l = model.body_id("shin_left")
    id_shin_r = model.body_id("shin_right")
    id_foot_l = model.body_id("foot_left")
    id_foot_r = model.body_id("foot_right")
    tx, ty, tz = [float(v) for v in target]
    tvx, tvy = [float(v) for v in target_vel]

    def _run(ctx: StepContext, u):
        q, v = ctx.qpos, ctx.qvel
        roll, pitch, yaw = _rpy((q[3], q[4], q[5], q[6]))
        cost = 5.0 * (roll * roll + pitch * pitch) + 0.075 * yaw * yaw
        dx, dy = q[0] - tx, q[1] - ty
        cost = cost + 12.5 * torch.sqrt(dx * dx + dy * dy + 1e-12)
        cost = cost + 5.0 * (tz - q[2])          # [sic] linear, not abs
        vx, vy = v[0] - tvx, v[1] - tvy
        cost = cost + 1.0 * torch.sqrt(vx * vx + vy * vy + 1e-12)

        vxl = ctx.body_com_linvel(model, id_shin_l)[0]
        vxr = ctx.body_com_linvel(model, id_shin_r)[0]
        left = (vxl > vxr).to(q[0].dtype)

        def sel(a, b):
            return left * a + (1.0 - left) * b

        foot_tx = q[0] + 0.5
        fl, fr = ctx.xpos[id_foot_l], ctx.xpos[id_foot_r]
        sl, sr = ctx.xpos[id_shin_l], ctx.xpos[id_shin_r]
        swing_x = sel(fl[0], fr[0])
        swing_z = sel(fl[2], fr[2])
        stance_z = sel(fr[2], fl[2])
        cost = cost + 8.0 * torch.abs(swing_x - foot_tx)

        vfl = ctx.body_com_linvel(model, id_foot_l)[0]
        vfr = ctx.body_com_linvel(model, id_foot_r)[0]
        cost = cost - 1000.0 * sel(vfl, vfr)

        knee_x = sel(sl[0], sr[0])
        cost = cost + 3.0 * (knee_x - foot_tx) ** 2

        swing_knee_z = sel(sl[2], sr[2])
        cost = cost + torch.where(swing_z >= swing_knee_z - 0.3,
                                  10000.0 * (swing_z - swing_knee_z) ** 2, 0.0)
        clearance = swing_z - stance_z
        cost = cost + torch.where(clearance < 0.005, 100.0 * clearance ** 2, 0.0)

        leg_cl = torch.abs(fl[1] - fr[1])
        cost = cost + torch.where((leg_cl <= 0.15) | (leg_cl >= 0.21), 100.0 * leg_cl ** 2, 0.0)
        knee_cl = torch.abs(sl[1] - sr[1])
        cost = cost + torch.where((knee_cl <= 0.15) | (knee_cl >= 0.21),
                                  100.0 * knee_cl ** 2, 0.0)
        cost = cost + 0.01 * _sumsq(u)
        return cost

    def running(ctx: StepContext, t):
        return _run(ctx, ctx.ctrl)

    def terminal(ctx: StepContext):
        return 10.0 * _run(ctx, [torch.zeros_like(ctx.qpos[0])] * model.nu)

    return running, terminal


def _fmod(x: torch.Tensor, m: float):
    """x % m with the sign of m (jnp.remainder: fmod, then + m where the
    signs differ), exact where x >= 0."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def quadruped(model: PhysicsModel, goal_xy=(2.0, 0.0), param_goal: bool = False,
              param_gait: bool = False):
    """Go1 trot cost (reference src/quadruped_datacollection.py:57-138)
    verbatim, with its indexing quirks: q[2], q[5], q[8], q[11] as the
    "calf" angles, q[6:8] as the "knee" posture and q[0:12] regularized.

    param_goal=True reads the goal from ctx.params[0:2]; param_gait=True
    reads the deltas of slots 4..10: target-velocity and -height offsets,
    log-scales of the height, velocity, trot and goal weights, and the
    weight of a posture term on the true leg joints qpos[7:19] toward the
    `home` keyframe (zero deltas reproduce the reference cost)."""
    home12 = [float(x) for x in np.asarray(dict(model.keyframes)["home"])[7:19]]
    gx0, gy0 = [float(v) for v in goal_xy]

    def running(ctx: StepContext, t):
        gx, gy = (ctx.params[0], ctx.params[1]) if param_goal else (gx0, gy0)
        q, v, u = ctx.qpos, ctx.qvel, ctx.ctrl
        if param_gait:
            p = ctx.params
            d_vel, d_h = p[4], p[5]
            w_h = 500.0 * torch.exp(p[6])
            w_v = 30000.0 * torch.exp(p[7])
            w_tr = 34000.0 * torch.exp(p[8])
            w_g = 3000.0 * torch.exp(p[9])
            w_home = p[10]
        else:
            d_vel = d_h = 0.0
            w_h, w_v, w_tr, w_g = 500.0, 30000.0, 34000.0, 3000.0
            w_home = 0.0
        phase = _fmod(ctx.time, 0.5) / 0.5 * 2 * np.pi
        trot = torch.sin(phase)
        target_vel_x = 0.9 + d_vel + 0.1 * torch.sin(phase)

        FL_calf, FR_calf, RL_calf, RR_calf = q[2], q[5], q[8], q[11]
        cost = w_h * (q[2] - (0.4 + d_h)) ** 2
        cost = cost + w_v * (v[0] - target_vel_x) ** 2
        cost = cost + 500.0 * (q[6] ** 2 + q[7] ** 2)
        cost = cost + 20.0 * _sumsq(v[6:9])
        cost = cost + 50000.0 * (q[1] ** 2 + v[1] ** 2)
        cost = cost + 0.01 * _sumsq(u)
        cost = cost + w_g * ((q[0] - gx) ** 2 + (q[1] - gy) ** 2)
        f1 = (FL_calf - RR_calf) * trot
        f2 = (FR_calf - RL_calf) * (-trot)
        cost = cost + w_tr * (f1 * f1 + f2 * f2)
        cost = cost - 4400.0 * (u[1] ** 2 + u[4] ** 2)
        cost = cost + 4400.0 * (u[2] ** 2 + u[5] ** 2)
        cost = cost - 10000.0 * (u[7] ** 2 + u[10] ** 2)
        cost = cost + 10000.0 * (u[8] ** 2 + u[11] ** 2)
        nk = 0.5
        cost = cost + 2000.0 * ((FL_calf - nk) ** 2 + (FR_calf - nk) ** 2
                                + (RL_calf - nk) ** 2 + (RR_calf - nk) ** 2)
        cost = cost + 5.0 * _sumsq(q[0:12])
        if param_gait:
            ck = 0.0
            for k in range(12):
                ck = ck + (q[7 + k] - home12[k]) ** 2
            cost = cost + w_home * ck
        return cost

    def terminal(ctx):
        return torch.zeros_like(ctx.qpos[0])

    return running, terminal


def quadruped_jl(model: PhysicsModel, target_vel_x=0.5):
    """Go1 cost of reference src/mppi.jl:18-62: forward velocity, upright
    (roll/pitch), joint velocities and controls regularized."""

    def running(ctx: StepContext, t):
        q, v, u = ctx.qpos, ctx.qvel, ctx.ctrl
        cost = 1.0 * (v[0] - target_vel_x) ** 2 + 2.0 * v[1] ** 2
        roll, pitch, _ = _rpy((q[3], q[4], q[5], q[6]))
        cost = cost + 2.0 * (roll * roll + pitch * pitch)
        cost = cost + 0.1 * _sumsq(v[6:])
        cost = cost + 0.01 * _sumsq(u)
        return cost

    def terminal(ctx):
        return torch.zeros_like(ctx.qpos[0])

    return running, terminal


def hopper(model: PhysicsModel, target_vel_x=1.0, target_height=1.0,
           w_pitch=4.0, w_pitch_rate=0.3, param_gait: bool = False):
    """Planar hopper cost (see costs/hopper.py): forward speed, torso
    height and pitch, control. qpos = [rootx, rootz (offset from z = 1 m),
    rooty, waist, hip, knee, ankle].

    param_gait=True reads runtime shaping DELTAS from ctx.params (zero ==
    the baked cost exactly):
      4: d_target_vel_x
      5: w_land -- squared descent speed beyond 0.4 m/s, gated on the torso
         being below 0.85 m
      6: d_log_w_pitch (scales w_pitch and w_pitch_rate)
      7: d_knee_w -- knee-angle anchor toward 1.2 + slot 9 rad
      8: w_clock -- hop clock: torso height toward
         0.92 + 0.18 sin(2 pi t / 0.75 s) at the context's time
      9: d_knee_anchor -- shifts the knee anchor angle
    Terminal: 10 x running at zero control, at the terminal context's time."""

    def running(ctx: StepContext, t):
        q, v, u = ctx.qpos, ctx.qvel, ctx.ctrl
        if param_gait:
            p = ctx.params
            d_vel, w_land = p[4], p[5]
            pitch_scale = torch.exp(p[6])
            w_knee, w_clock, d_anchor = p[7], p[8], p[9]
        else:
            d_vel, w_land, pitch_scale, w_knee = 0.0, 0.0, 1.0, 0.0
            w_clock, d_anchor = 0.0, 0.0
        cost = 2.0 * (v[0] - (target_vel_x + d_vel)) ** 2
        cost = cost + 5.0 * torch.clamp_min(target_height - 0.3 - q[1] - 1.0, 0.0) ** 2
        cost = cost + (w_pitch * q[2] ** 2 + w_pitch_rate * v[2] ** 2) * pitch_scale
        cost = cost + 0.01 * _sumsq(u)
        if param_gait:
            gate = torch.clamp((0.85 - (q[1] + 1.0)) * 4.0, 0.0, 1.0)
            over = torch.clamp_min(-v[1] - 0.4, 0.0)
            cost = cost + w_land * gate * over * over
            cost = cost + w_knee * (q[5] - (1.2 + d_anchor)) ** 2
            zstar = 0.92 + 0.18 * torch.sin(ctx.time * (2 * np.pi / 0.75))
            cost = cost + w_clock * (q[1] + 1.0 - zstar) ** 2
        return cost

    def terminal(ctx):
        return 10.0 * running(ctx, 0)

    return running, terminal


def arm5(model: PhysicsModel, target=(0.35, 0.15, 0.55), w_reach=10.0, w_vel=0.05,
         w_ctrl=0.01):
    """The arm5 reach cost (costs/arm5.make_costs in scalar form): the
    hand's squared distance to `target`, the arm's seven dof velocities
    (shoulder ball, elbow, wrist ball) and the controls. Terminal: 10
    w_reach x the reach term."""
    hand = model.body_names.index("hand")
    tx, ty, tz = [float(v) for v in target]
    n_arm = 7

    def reach(ctx: StepContext):
        px, py, pz = ctx.xpos[hand]
        return (px - tx) ** 2 + (py - ty) ** 2 + (pz - tz) ** 2

    def running(ctx: StepContext, t):
        return (w_reach * reach(ctx) + w_vel * _sumsq(ctx.qvel[:n_arm])
                + w_ctrl * _sumsq(ctx.ctrl))

    def terminal(ctx: StepContext):
        return 10.0 * w_reach * reach(ctx)

    return running, terminal


KERNEL_COSTS = {
    "arm5": arm5,
    "cartpole": cartpole,
    "hopper": hopper,
    "humanoid": humanoid,
    "humanoid_hard": humanoid_hard,
    "humanoid_v1": humanoid_v1,
    "quadruped": quadruped,
    "quadruped_jl": quadruped_jl,
}
