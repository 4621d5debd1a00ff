"""Trajectory datasets for supervised dynamics learning (learning/data.py
counterpart, numpy only).

The whole dataset lives in host arrays; minibatches are gathered by index
(the scanned trainer puts the arrays on the device once). The same
directory gives the same arrays and index sets as the JAX package's,
bit for bit:
- (state_t, action_t) -> next-state target as 'raw' | 'delta' | 'pct'
- within-trajectory pairing only
- random or sequential train/eval split
- optional z-normalization from train-split statistics
- optional rolling-mean smoothing
- optional gaussian input-noise augmentation
- state_idxes column subsetting
- rollout_k windows for multi-step rollout training
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.trajio import read_csv as _read_csv


def _smooth(arr: np.ndarray, window: int) -> np.ndarray:
    if window <= 1:
        return arr
    kernel = np.ones(window) / window
    out = np.copy(arr)
    for c in range(arr.shape[1]):
        out[:, c] = np.convolve(arr[:, c], kernel, mode="same")
    return out


class _PairDataset:
    """Common machinery: holds (inputs, targets) arrays + split indices."""

    def __init__(self):
        self.inputs: np.ndarray = None
        self.targets: np.ndarray = None
        self.train_idx: np.ndarray = None
        self.eval_idx: np.ndarray = None
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.noise_std: float = 0.0

    def _finalize(self, inputs, targets, eval_split, split, seed, normalize):
        n = len(inputs)
        if split == "random":
            rng = np.random.default_rng(seed)
            perm = rng.permutation(n)
        else:  # sequential
            perm = np.arange(n)
        n_eval = int(n * eval_split)
        self.eval_idx = perm[n - n_eval:] if n_eval else np.zeros(0, dtype=int)
        self.train_idx = perm[: n - n_eval]
        if normalize:
            tr_in = inputs[self.train_idx]
            self.mean = tr_in.mean(axis=0)
            self.std = tr_in.std(axis=0) + 1e-8
            inputs = (inputs - self.mean) / self.std
        self.inputs = inputs.astype(np.float32)
        self.targets = targets.astype(np.float32)

    def batches(self, batch_size: int, train: bool = True, seed: int = 0,
                drop_remainder: bool = True):
        idx = self.train_idx if train else self.eval_idx
        if train:
            rng = np.random.default_rng(seed)
            idx = rng.permutation(idx)
        n_full = len(idx) // batch_size * batch_size
        stop = n_full if drop_remainder else len(idx)
        for i in range(0, stop, batch_size):
            sel = idx[i : i + batch_size]
            x = self.inputs[sel]
            if train and self.noise_std > 0:
                x = x + np.random.default_rng(seed + i).normal(
                    0, self.noise_std, x.shape).astype(np.float32)
            yield x, self.targets[sel]

    def __len__(self):
        return len(self.inputs)


def _build_pairs(states, actions, return_type, state_idxes):
    if state_idxes is not None:
        states = states[:, list(state_idxes)]
    s_t, s_n = states[:-1], states[1:]
    a_t = actions[:-1]
    x = np.concatenate([s_t, a_t], axis=1)
    if return_type == "delta":
        y = s_n - s_t
    elif return_type == "pct":
        y = (s_n - s_t) / (np.abs(s_t) + 1e-8)
    else:
        y = s_n
    return x, y


class StateActionDataset(_PairDataset):
    """Single-trajectory CSV pair (reference data_loader.py:7-120)."""

    def __init__(self, states_csv: str, actions_csv: str,
                 return_type: str = "delta", eval_split: float = 0.1,
                 split: str = "random", normalize: bool = False,
                 smooth_window: int = 0, noise_std: float = 0.0,
                 state_idxes: Optional[Sequence[int]] = None, seed: int = 0):
        super().__init__()
        states = _read_csv(states_csv)
        actions = _read_csv(actions_csv)
        n = min(len(states), len(actions))
        states, actions = states[:n], actions[:n]
        if smooth_window:
            states = _smooth(states, smooth_window)
        x, y = _build_pairs(states, actions, return_type, state_idxes)
        self.noise_std = noise_std
        self._finalize(x, y, eval_split, split, seed, normalize)


class MultiTrajectoryDataset(_PairDataset):
    """Directory-of-trajectories dataset (reference data_loader.py:122-318).
    Pairs never cross trajectory boundaries."""

    def __init__(self, states_dir: str, actions_dir: str,
                 return_type: str = "delta", eval_split: float = 0.1,
                 split: str = "random", normalize: bool = False,
                 smooth_window: int = 0, noise_std: float = 0.0,
                 state_idxes: Optional[Sequence[int]] = None, seed: int = 0,
                 rollout_k: int = 1):
        """`rollout_k > 1` additionally builds within-trajectory
        windows for multi-step rollout training (TrainConfig.rollout_k):
        win_states (W, k+1, sdim) raw states and win_actions (W, k, adim),
        with their own random train/eval split. One-step-delta training
        gives models whose open-loop composition diverges; a k-step rollout
        loss trains the quantity the estimator MPPI consumes.
        Requires return_type='delta' (the loss composes x + net(x, u))."""
        super().__init__()
        if rollout_k > 1 and return_type != "delta":
            raise ValueError("rollout_k > 1 requires return_type='delta'")
        s_files = sorted(glob.glob(os.path.join(states_dir, "*.csv")))
        a_files = sorted(glob.glob(os.path.join(actions_dir, "*.csv")))
        if len(s_files) != len(a_files):
            raise ValueError(
                f"mismatched trajectory counts: {len(s_files)} vs {len(a_files)}")
        xs, ys = [], []
        wss, was = [], []
        for sf, af in zip(s_files, a_files):
            states = _read_csv(sf)
            actions = _read_csv(af)
            n = min(len(states), len(actions))
            if n < 2:
                continue
            states, actions = states[:n], actions[:n]
            if smooth_window:
                states = _smooth(states, smooth_window)
            x, y = _build_pairs(states, actions, return_type, state_idxes)
            xs.append(x)
            ys.append(y)
            if rollout_k > 1 and n > rollout_k:
                st = states[:, list(state_idxes)] if state_idxes is not None \
                    else states
                w = n - rollout_k
                widx = np.arange(w)[:, None]
                wss.append(st[widx + np.arange(rollout_k + 1)])
                was.append(actions[widx + np.arange(rollout_k)])
        if not xs:
            raise ValueError(f"no trajectories found in {states_dir}")
        self.n_trajectories = len(xs)
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        self.noise_std = noise_std
        self._finalize(x, y, eval_split, split, seed, normalize)
        self.rollout_k = rollout_k
        self.win_states = self.win_actions = None
        self.win_train_idx = self.win_eval_idx = None
        if rollout_k > 1:
            self.win_states = np.concatenate(wss).astype(np.float32)
            self.win_actions = np.concatenate(was).astype(np.float32)
            w = len(self.win_states)
            perm = np.random.default_rng(seed).permutation(w)
            n_eval = int(w * eval_split)
            self.win_eval_idx = perm[w - n_eval:] if n_eval else np.zeros(0, int)
            self.win_train_idx = perm[: w - n_eval]

    def sanity_check(self) -> dict:
        """NaN / all-zero-row scan (reference data_loader.py:320-333)."""
        return {
            "nan_inputs": int(np.isnan(self.inputs).sum()),
            "nan_targets": int(np.isnan(self.targets).sum()),
            "zero_rows": int((np.abs(self.inputs).sum(axis=1) == 0).sum()),
            "n_pairs": len(self.inputs),
            "n_trajectories": self.n_trajectories,
        }
