"""Trajectory replay tooling (viz/replay.py counterpart).

- load_trajectory: a logged run's states/actions/times CSVs.
- kinematic_replay: logged rows -> body positions per frame, by the
  engine's FK over all frames at once (the batched Engine.forward).
- open_loop_model_rollout: roll a learned surrogate forward from a logged
  initial state under the logged actions, for regression against the
  logged states.

The JAX package's render_video and viz/live.py draw through mujoco, which
the port does not use: they are not ported.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..physics.engine import Engine
from ..physics.model import PhysicsModel


def load_trajectory(run_dir: Optional[str] = None, states_csv: Optional[str] = None,
                    actions_csv: Optional[str] = None, times_csv: Optional[str] = None):
    """(states, actions, times) numpy arrays from a run dir
    (states/actions/times.csv) or explicit paths; a missing actions or
    times file gives None."""
    if run_dir is not None:
        states_csv = os.path.join(run_dir, "states.csv")
        actions_csv = os.path.join(run_dir, "actions.csv")
        times_csv = os.path.join(run_dir, "times.csv")
    states = np.loadtxt(states_csv, delimiter=",", ndmin=2)
    actions = (np.loadtxt(actions_csv, delimiter=",", ndmin=2)
               if actions_csv and os.path.exists(actions_csv) else None)
    times = (np.loadtxt(times_csv, delimiter=",")
             if times_csv and os.path.exists(times_csv) else None)
    return states, actions, times


def kinematic_replay(model: PhysicsModel, states: np.ndarray, stride: int = 1,
                     device="cuda") -> np.ndarray:
    """FK over every `stride`-th logged row -> body positions (n_frames,
    nbody, 3), computed on `device` in float64. Rows may carry extra
    columns (e.g. the humanoid collector's foot heights); only the first
    nq are read."""
    eng = Engine(model, device=device, dtype=torch.float64)
    qpos = torch.as_tensor(np.asarray(states)[::stride, : model.nq], dtype=torch.float64,
                           device=eng.device)
    qvel = torch.zeros(qpos.shape[0], model.nv, dtype=torch.float64, device=eng.device)
    return eng.forward(qpos, qvel).xpos.cpu().numpy()


@torch.no_grad()
def open_loop_model_rollout(module: torch.nn.Module, init_state: np.ndarray,
                            actions: np.ndarray, mode: str = "delta") -> np.ndarray:
    """Open-loop surrogate rollout x_{t+1} = x_t + net(x_t, u_t) ("delta")
    or net(x_t, u_t) ("raw"), in float32 on the module's device, the module
    in eval mode (its training flag is restored afterwards). Returns
    (T+1, state_dim), init_state first."""
    dev = next(module.parameters()).device
    training = module.training
    module.eval()
    try:
        x = torch.as_tensor(init_state, dtype=torch.float32, device=dev)
        xs = []
        for u in torch.as_tensor(actions, dtype=torch.float32, device=dev):
            out = module(torch.cat([x, u]))
            x = x + out if mode == "delta" else out
            xs.append(x)
    finally:
        module.train(training)
    return np.concatenate([np.asarray(init_state)[None], torch.stack(xs).cpu().numpy()], axis=0)
