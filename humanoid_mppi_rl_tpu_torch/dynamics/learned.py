"""Learned-surrogate dynamics for estimator MPPI (dynamics/learned.py
counterpart): rollouts step a neural state predictor
x_{t+1} = x_t + net([x_t; u_t]) over the whole (K, nx) batch at once."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..physics.state import PhysicsState


def make_learned_dynamics(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                          mode: str = "delta",
                          state_slice: Optional[int] = None,
                          ego_cols: Optional[Sequence[int]] = None):
    """dynamics(x, u, t) -> x' over flat state vectors (any leading dims).

    mode: "delta" (x + net(...)) or "raw" (the net's output is the next
    state). `state_slice` truncates the net output. `ego_cols` zeroes those
    state columns in the net input only (a copy; x itself is untouched), so
    deltas stay translation-invariant while the state keeps its absolute
    coordinates; the column index reaches each device once, not per call."""
    if mode not in ("delta", "raw"):
        raise ValueError(f"mode {mode!r}: expected 'delta' or 'raw'")
    ego = None if ego_cols is None else list(ego_cols)
    ego_index = {}   # device -> the columns as an index tensor there, made once

    def dynamics(x: torch.Tensor, u: torch.Tensor, t) -> torch.Tensor:
        x_in = x
        if ego is not None:
            if x.device not in ego_index:
                ego_index[x.device] = torch.as_tensor(ego, dtype=torch.long, device=x.device)
            x_in = x.index_fill(-1, ego_index[x.device], 0.0)
        out = apply_fn(torch.cat([x_in, u], dim=-1))
        if state_slice is not None:
            out = out[..., :state_slice]
        return x + out if mode == "delta" else out

    return dynamics


def flat_state_from_physics(state: PhysicsState) -> torch.Tensor:
    """[qpos; qvel] flat estimator state from a plant state."""
    return torch.cat([state.qpos, state.qvel])
