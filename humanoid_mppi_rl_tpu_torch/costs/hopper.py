"""Planar hopper cost (costs/hopper.py counterpart), batched over K: hop
forward at a target speed, keep the torso's height and pitch, regularise
control. qpos = [rootx, rootz (offset from z = 1 m), rooty, waist, hip,
knee, ankle]."""

from __future__ import annotations

import torch


def make_costs(model, target_vel_x=1.0, target_height=1.0,
               w_pitch=4.0, w_pitch_rate=0.3, **_kernel_only):
    """(running, terminal) over a state whose qpos/qvel carry a leading K
    axis; terminal = 10 x running at zero control. `_kernel_only`
    (param_gait) is the kernel cost's (ops/kernel_costs.hopper) and is
    ignored here, as in the JAX oracle."""

    def running(state, u, t):
        q, v = state.qpos, state.qvel
        cost = 2.0 * (v[..., 0] - target_vel_x) ** 2
        cost = cost + 5.0 * torch.clamp_min(target_height - 0.3 - q[..., 1] - 1.0, 0.0) ** 2
        cost = cost + w_pitch * q[..., 2] ** 2
        cost = cost + w_pitch_rate * v[..., 2] ** 2
        return cost + 0.01 * torch.sum(u ** 2, dim=-1)

    def terminal(state, t):
        q = state.qpos
        return 10.0 * running(state, q.new_zeros(q.shape[:-1] + (model.nu,)), t)

    return running, terminal
