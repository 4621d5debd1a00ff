"""MPPI pieces the kernel planner uses (solver/mppi.py counterpart).

The algorithm per replan:

    noise   ~ N(0, sigma^2), shape (T, nu, K)  (the kernel's layout)
    costs_k = sum_t running_cost(step(x_t, clip(U_t + eps_t))) + terminal
    beta    = min_k costs_k
    w_k     = exp(-(costs_k - beta) / lambda);  w /= sum(w) (+eps)
    U      += sum_k w_k * noise_k          (or U := sum_k w_k * noise_k)
    action  = U[0];  U <- shift(U), tail decay

The JAX PRNG key becomes a torch.Generator held in MPPIState; it advances
in place when the planner draws noise. The two frameworks draw different
numbers from one seed, so parity tests inject the same noise into both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static MPPI hyperparameters (the fields the kernel planner reads)."""

    n_samples: int = 30          # K
    horizon: int = 100           # T
    temperature: float = 1.0     # lambda
    sigma: float = 1.0           # control noise std
    tail_decay: float = 0.1      # U[-1] = tail_decay * U[-2] after shift
    update_mode: str = "accumulate"   # "accumulate" | "replace"
    weight_eps: float = 0.0      # +eps in the weight normalizer
    ctrl_low: Optional[tuple] = None    # clamp for executed ctrl / plan update
    ctrl_high: Optional[tuple] = None
    clamp_plan: bool = False     # clamp U after update
    clamp_rollout_ctrl: bool = True  # clip perturbed ctrl inside rollouts
    noise_block: Optional[int] = None  # sharding-invariant noise (not ported)

    @property
    def K(self) -> int:
        return self.n_samples

    @property
    def T(self) -> int:
        return self.horizon


@dataclasses.dataclass
class MPPIState:
    """Per-controller state: the nominal plan and the noise generator."""

    U: torch.Tensor               # (T, nu)
    generator: torch.Generator

    @staticmethod
    def seeded(seed: int, horizon: int, nu: int, device="cuda",
               dtype=torch.float32) -> "MPPIState":
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return MPPIState(U=torch.zeros(horizon, nu, dtype=dtype, device=dev),
                         generator=gen)


@dataclasses.dataclass
class MPPIDiagnostics:
    """Per-replan observability."""

    beta: torch.Tensor            # min sampled cost
    mean_cost: torch.Tensor
    ess: torch.Tensor             # effective sample size 1/sum(w^2)
    weight_entropy: torch.Tensor
    update_norm: torch.Tensor


def _clip_ctrl(u: torch.Tensor, cfg: MPPIConfig) -> torch.Tensor:
    if cfg.ctrl_low is not None and cfg.ctrl_high is not None:
        lo = torch.as_tensor(cfg.ctrl_low, dtype=u.dtype, device=u.device)
        hi = torch.as_tensor(cfg.ctrl_high, dtype=u.dtype, device=u.device)
        return torch.clamp(u, lo, hi)
    return u


def mppi_weights(costs: torch.Tensor, temperature, weight_eps: float = 0.0):
    """Exponential weighting (reference src/cartpole_mppi.py:91-94)."""
    beta = torch.min(costs)
    w = torch.exp(-(costs - beta) / temperature)
    w = w / (torch.sum(w) + weight_eps)
    return w, beta


def weighted_noise_update(weights: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """sum_k w_k * noise[..., k] -> (T, nu), for the kernel's (T, nu, K)
    noise layout (the JAX function takes (K, T, nu))."""
    return noise @ weights


def shift_plan(U: torch.Tensor, tail_decay: float) -> torch.Tensor:
    """Receding-horizon shift (reference src/cartpole_mppi.py:102-103)."""
    return torch.cat([U[1:], tail_decay * U[-1:]], dim=0)
