"""Cartpole swing-up cost (costs/cartpole.py counterpart; reference
src/cartpole_mppi.py:44-53), batched over K:

running = 1 x^2 + 20 (cos(theta) - 1)^2 + 0.1 xdot^2 + 0.1 thetadot^2 + 0.01 |u|^2
terminal = 10 x running at zero control
"""

from __future__ import annotations

import torch


def running_from_values(x_pos, theta, x_vel, theta_vel, u):
    """Elementwise over the leading axes; u (..., nu) is summed over its last."""
    return (1.0 * x_pos ** 2 + 20.0 * (torch.cos(theta) - 1.0) ** 2
            + 0.1 * x_vel ** 2 + 0.1 * theta_vel ** 2 + 0.01 * torch.sum(u ** 2, dim=-1))


def make_costs(model=None):
    """Costs over a state whose qpos = [x, theta] and qvel = [xdot, thetadot]
    carry a leading K axis: running(state, u (K, nu), t) -> (K,)."""

    def running(state, u, t):
        q, v = state.qpos, state.qvel
        return running_from_values(q[..., 0], q[..., 1], v[..., 0], v[..., 1], u)

    def terminal(state, t):
        q, v = state.qpos, state.qvel
        return 10.0 * running_from_values(q[..., 0], q[..., 1], v[..., 0], v[..., 1],
                                          torch.zeros_like(q[..., :1]))

    return running, terminal


def make_costs_flat(state_dim: int = 4):
    """The same costs over flat states [x, theta, xdot, thetadot] (..., 4):
    the learned-dynamics estimator path (reference
    src/cartpole_mppi_estimator.py:46-55)."""

    def running(x, u, t):
        return running_from_values(x[..., 0], x[..., 1], x[..., 2], x[..., 3], u)

    def terminal(x, t):
        return 10.0 * running_from_values(x[..., 0], x[..., 1], x[..., 2], x[..., 3],
                                          torch.zeros_like(x[..., :1]))

    return running, terminal
