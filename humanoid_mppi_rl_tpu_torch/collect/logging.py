"""Trajectory logging in the reference's CSV layouts (collect/logging.py
counterpart).

  states*.csv  -- rows of [qpos; qvel] (the humanoid collector appends the
                  two foot heights: 57 columns)
  actions*.csv -- rows of the executed plan head u
  times*.csv   -- the sim clock per control step

Rows are buffered in host numpy and written once per episode.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import List, Optional

import numpy as np

from ..utils.trajio import write_csv


class TrajectoryLogger:
    def __init__(self):
        self.states: List[np.ndarray] = []
        self.actions: List[np.ndarray] = []
        self.times: List[float] = []

    def log(self, state_row: np.ndarray, action: np.ndarray, time: float) -> None:
        self.states.append(np.asarray(state_row, dtype=np.float64))
        self.actions.append(np.asarray(action, dtype=np.float64))
        self.times.append(float(time))

    def reset(self) -> None:
        self.states, self.actions, self.times = [], [], []

    def __len__(self) -> int:
        return len(self.times)

    def arrays(self):
        return (np.stack(self.states) if self.states else np.zeros((0, 0)),
                np.stack(self.actions) if self.actions else np.zeros((0, 0)),
                np.asarray(self.times))

    def save_run_dir(self, run_dir: str, fmt: str = "csv") -> str:
        """<run_dir>/{states,actions,times}.csv (the reference quadruped
        layout), or trajectory.npz with fmt="npz"."""
        os.makedirs(run_dir, exist_ok=True)
        s, a, t = self.arrays()
        if fmt == "csv":
            write_csv(os.path.join(run_dir, "states.csv"), s)
            write_csv(os.path.join(run_dir, "actions.csv"), a)
            write_csv(os.path.join(run_dir, "times.csv"), t)
        else:
            np.savez(os.path.join(run_dir, "trajectory.npz"), states=s, actions=a, times=t)
        return run_dir

    def save_split_dirs(self, base: str, timestamp: Optional[str] = None,
                        suffix: str = "_ft") -> str:
        """<base>/{states,actions,times}<suffix>/{kind}_<timestamp>.csv (the
        reference humanoid-v2 layout). Returns the timestamp."""
        ts = timestamp or datetime.now().strftime("%Y-%m-%d_%H%M%S")
        s, a, t = self.arrays()
        for kind, arr in (("states", s), ("actions", a), ("times", t)):
            d = os.path.join(base, f"{kind}{suffix}")
            os.makedirs(d, exist_ok=True)
            write_csv(os.path.join(d, f"{kind}_{ts}.csv"), arr)
        return ts
