"""MPPI planner backed by the fused rollout kernel (solver/kernel_mppi.py
counterpart): the K x T rollout + cost runs as ops/rollout_kernel's single
kernel; weighting, update and shift follow as plain tensor ops."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.rollout_kernel import build_rollout_kernel
from ..physics.model import PhysicsModel
from ..physics.state import PhysicsState
from .mppi import (MPPIConfig, MPPIDiagnostics, MPPIState, _clip_ctrl,
                   mppi_weights, shift_plan, weighted_noise_update)


def make_kernel_mppi(
    model: PhysicsModel,
    kernel_cost_factory: Callable,
    cfg: MPPIConfig,
    cost_kwargs: Optional[dict] = None,
    device="cuda",
):
    """plan(mppi_state, plant: PhysicsState, params=None, noise=None) ->
    (action, state', diag).

    `noise` (T, nu, K), when given, replaces the sigma-scaled draw from the
    state's generator: the matched-noise hook the parity tests use."""
    dev = resolve_device(device)
    if cfg.noise_block is not None:
        raise NotImplementedError("noise_block (sharding-invariant noise) is not ported")
    ctrl_low = None if cfg.ctrl_low is None else np.asarray(cfg.ctrl_low)
    ctrl_high = None if cfg.ctrl_high is None else np.asarray(cfg.ctrl_high)
    rollouts = build_rollout_kernel(
        model, kernel_cost_factory, cfg.T,
        ctrl_low=ctrl_low if cfg.clamp_rollout_ctrl else None,
        ctrl_high=ctrl_high if cfg.clamp_rollout_ctrl else None,
        cost_kwargs=cost_kwargs, device=dev,
    )
    K, T, nu = cfg.K, cfg.T, model.nu

    def plan(mppi_state: MPPIState, plant: PhysicsState, params=None, noise=None):
        U = mppi_state.U
        dtype, udev = U.dtype, U.device
        sigma = torch.tensor(cfg.sigma, dtype=dtype, device=udev)
        temperature = torch.tensor(cfg.temperature, dtype=dtype, device=udev)
        if params is not None:
            # runtime solver scales (kernel_costs.PARAM_SLOTS 11/12):
            # zero-padded params leave sigma/temperature at the config values
            pvec = torch.as_tensor(params, dtype=dtype, device=udev).reshape(-1)
            pvec = torch.nn.functional.pad(pvec, (0, max(0, 13 - pvec.shape[0])))
            sigma = sigma * torch.exp(pvec[11])
            temperature = temperature * torch.exp(pvec[12])
        if noise is None:
            noise = sigma * torch.randn((T, nu, K), generator=mppi_state.generator,
                                        dtype=dtype, device=udev)
        elif tuple(noise.shape) != (T, nu, K):
            raise ValueError(f"noise: shape {tuple(noise.shape)}, expected {(T, nu, K)}")

        qpK = plant.qpos.to(dtype)[:, None].expand(model.nq, K).contiguous()
        qvK = plant.qvel.to(dtype)[:, None].expand(model.nv, K).contiguous()
        t0 = torch.as_tensor(plant.time, dtype=dtype, device=udev).reshape(1, 1) \
            .expand(1, K).contiguous()
        costs, _, _ = rollouts(qpK, qvK, t0, U, noise, params=params)

        w, beta = mppi_weights(costs, temperature, cfg.weight_eps)
        update = weighted_noise_update(w, noise).to(dtype)
        U_new = update if cfg.update_mode == "replace" else U + update
        if cfg.clamp_plan:
            U_new = _clip_ctrl(U_new, cfg)
        action = _clip_ctrl(U_new[0], cfg)
        U_shifted = shift_plan(U_new, cfg.tail_decay)

        diag = MPPIDiagnostics(
            beta=beta,
            mean_cost=torch.mean(costs),
            ess=1.0 / torch.sum(w * w),
            weight_entropy=-torch.sum(
                w * torch.where(w > 0, torch.log(w + 1e-30), 0.0)),
            update_norm=torch.linalg.norm(update),
        )
        return action, MPPIState(U=U_shifted, generator=mppi_state.generator), diag

    plan.rollouts = rollouts
    return plan
