"""arm5 reach cost (costs/arm5.py counterpart), batched over K: drive the
hand body to a world target point, regularise the arm's joint velocities
and the controls.

running = w_reach |hand - target|^2 + w_vel |qvel_arm|^2 + w_ctrl |u|^2
terminal = 10 w_reach |hand - target|^2
"""

from __future__ import annotations

import torch

from .._device import device_constant

TARGET = (0.35, 0.15, 0.55)
N_ARM_DOFS = 7  # shoulder ball (3) + elbow (1) + wrist ball (3)


def make_costs(model, target=TARGET, w_reach=10.0, w_vel=0.05, w_ctrl=0.01):
    """(running, terminal) over a state whose xpos/qvel carry a leading K
    axis (or none): running(state, u, t), terminal(state, t)."""
    hand = model.body_names.index("hand")
    tgt = tuple(float(x) for x in target)

    def reach(state):
        xp = state.xpos[..., hand, :]
        d = xp - device_constant(tgt, xp.dtype, xp.device)
        return torch.sum(d * d, dim=-1)

    def running(state, u, t):
        return (w_reach * reach(state)
                + w_vel * torch.sum(state.qvel[..., :N_ARM_DOFS] ** 2, dim=-1)
                + w_ctrl * torch.sum(u ** 2, dim=-1))

    def terminal(state, t):
        return 10.0 * w_reach * reach(state)

    return running, terminal
