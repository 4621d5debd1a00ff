"""Go1 quadruped costs (costs/quadruped.py counterpart), batched over K:
`running(state, u, t) -> (K,)` for a state whose fields carry a leading K
axis.

`make_costs` is reference src/quadruped_datacollection.py:57-138 verbatim,
with its state-indexing quirks: qpos[2], [5], [8], [11] as the "calf"
joints and qpos[6:9] as the "orientation", which for a free-joint model
are root z, quaternion components and the first leg joints. The published
gaits and datasets were made under exactly this cost, so the indices are
kept. `make_costs_mppi_jl` is the simpler cost of src/mppi.jl:18-62.
"""

import math

import torch

from .base import quat_rpy

# The kernel planner tier's runtime gait deltas for kernel_costs.quadruped
# (param_gait slots 4..12): w_height 500 -> 10k, home-posture shaping 3k on
# the true 12 leg joints, sigma x0.6 (slot 11, read by the solver). The
# reference cost verbatim (all-zero deltas) belly-crawls against the
# penalty planner model at large K; these restore a trot
# (scripts/dev_quad_gait.py).
GAIT_TUNED = (0.0, 0.0,            # d_target_vel_x, d_target_height
              3.0, 0.0, 0.0, 0.0,  # ln(w_h/500)=ln 20, w_v, w_tr, w_g logs
              3000.0,              # home-posture weight (true 12 joints)
              -0.5108256237659907,  # ln 0.6: sigma scale
              0.0)                 # temperature scale


def make_costs(model, goal_xy=(2.0, 0.0), **_unused):
    """The goal-reaching trot cost; no terminal term (the reference adds
    none)."""
    gx, gy = (float(v) for v in goal_xy)

    # weights: reference src/quadruped_datacollection.py:66-80
    w_pos, w_height, w_vel = 50000.0, 500.0, 30000.0
    w_ori, w_ang, w_ctrl = 500.0, 20.0, 0.01
    w_goal, w_trot = 3000.0, 34000.0
    w_front, w_back = 4400.0, 10000.0
    w_knee, w_posture = 2000.0, 5.0

    target_height = 0.4
    base_target_vel_x = 0.9
    osc_amp = 0.1
    neutral_knee = 0.5
    trot_period = 0.5

    def running(state, u, t):
        qpos, qvel = state.qpos, state.qvel
        # jnp.remainder: the sign of the divisor
        phase = torch.remainder(state.time, trot_period) / trot_period * 2 * math.pi
        trot_symmetry = torch.sin(phase)
        target_vel_x = base_target_vel_x + osc_amp * torch.sin(phase)

        FL_calf = qpos[:, 2]            # [sic] the reference's leg-joint indexing
        FR_calf = qpos[:, 5]
        RL_calf = qpos[:, 8]
        RR_calf = qpos[:, 11]

        height_cost = w_height * (qpos[:, 2] - target_height) ** 2
        vel_cost = w_vel * (qvel[:, 0] - target_vel_x) ** 2
        ori_cost = w_ori * (qpos[:, 6] ** 2 + qpos[:, 7] ** 2)   # [sic] qpos[6:9]
        ang_cost = w_ang * torch.sum(qvel[:, 6:9] ** 2, dim=-1)  # [sic]
        lateral_cost = w_pos * (qpos[:, 1] ** 2 + qvel[:, 1] ** 2)
        ctrl_cost = w_ctrl * torch.sum(u ** 2, dim=-1)
        goal_cost = w_goal * ((qpos[:, 0] - gx) ** 2 + (qpos[:, 1] - gy) ** 2)

        FL_RR_phase = (FL_calf - RR_calf) * trot_symmetry
        FR_RL_phase = (FR_calf - RL_calf) * -trot_symmetry
        trot_phase_cost = w_trot * (FL_RR_phase ** 2 + FR_RL_phase ** 2)

        front_hip_cost = -w_front * (u[:, 1] ** 2 + u[:, 4] ** 2)
        front_leg_cost = w_front * (u[:, 2] ** 2 + u[:, 5] ** 2)
        back_hip_cost = -w_back * (u[:, 7] ** 2 + u[:, 10] ** 2)
        back_leg_cost = w_back * (u[:, 8] ** 2 + u[:, 11] ** 2)

        knee_cost = w_knee * ((FL_calf - neutral_knee) ** 2 + (FR_calf - neutral_knee) ** 2
                              + (RL_calf - neutral_knee) ** 2 + (RR_calf - neutral_knee) ** 2)
        posture_cost = w_posture * torch.sum(qpos[:, 0:12] ** 2, dim=-1)

        return (height_cost + vel_cost + ori_cost + ang_cost
                + lateral_cost + ctrl_cost + goal_cost
                + trot_phase_cost + front_leg_cost + back_leg_cost
                + knee_cost + posture_cost + front_hip_cost + back_hip_cost)

    def terminal(state, t):
        return torch.zeros_like(state.qpos[:, 0])   # the reference adds none

    return running, terminal


def make_costs_mppi_jl(model, target_vel_x=0.5):
    """The simpler Go1 cost (reference src/mppi.jl:18-62): forward velocity,
    upright (roll and pitch of the quaternion), joint velocities and
    controls regularised; no terminal term."""
    tv = float(target_vel_x)

    def running(state, u, t):
        qpos, qvel = state.qpos, state.qvel
        cost = 1.0 * (qvel[:, 0] - tv) ** 2
        cost = cost + 2.0 * qvel[:, 1] ** 2
        roll, pitch, _ = quat_rpy(qpos[:, 3:7])
        cost = cost + 2.0 * (roll ** 2 + pitch ** 2)
        cost = cost + 0.1 * torch.sum(qvel[:, 6:] ** 2, dim=-1)
        return cost + 0.01 * torch.sum(u ** 2, dim=-1)

    def terminal(state, t):
        return torch.zeros_like(state.qpos[:, 0])

    return running, terminal
