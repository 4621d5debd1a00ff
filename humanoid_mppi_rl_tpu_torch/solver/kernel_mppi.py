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
from .mppi import (WHOLE_K, KShard, MPPIConfig, MPPIState, _clip_ctrl, replan_seed,
                   sample_noise_blocked, shift_plan, weighted_noise_update)


def make_kernel_mppi(
    model: PhysicsModel,
    kernel_cost_factory: Callable,
    cfg: MPPIConfig,
    cost_kwargs: Optional[dict] = None,
    device="cuda",
    shard: KShard = WHOLE_K,
):
    """plan(mppi_state, plant: PhysicsState, params=None, noise=None) ->
    (action, state', diag).

    `noise` (T, nu, K), when given, replaces the sigma-scaled draw from the
    state's generator: the matched-noise hook the parity tests use. With
    cfg.noise_block the draw is `sample_noise_blocked`'s field, which the
    sharded planner (parallel/mesh) draws too. `shard` (parallel/mesh.
    make_sharded_kernel_mppi) rolls out its slice of K, one launch a
    replan, and reduces the weighting over the others: it draws whole
    blocks of the blocked field at its offset (one block of its slice
    without noise_block) and takes its slice of an injected `noise`."""
    dev = resolve_device(device)
    K, block, offset, sl = shard.part(cfg.K, cfg.noise_block)
    blocked = bool(cfg.noise_block) or shard.count > 1
    ctrl_low = None if cfg.ctrl_low is None else np.asarray(cfg.ctrl_low)
    ctrl_high = None if cfg.ctrl_high is None else np.asarray(cfg.ctrl_high)
    rollouts = build_rollout_kernel(
        model, kernel_cost_factory, cfg.T,
        ctrl_low=ctrl_low if cfg.clamp_rollout_ctrl else None,
        ctrl_high=ctrl_high if cfg.clamp_rollout_ctrl else None,
        cost_kwargs=cost_kwargs, device=dev,
    )
    T, nu = cfg.T, model.nu

    def plan(mppi_state: MPPIState, plant: PhysicsState, params=None, noise=None):
        U = mppi_state.U
        dtype, udev = U.dtype, U.device
        # filled on the device: a host tensor copied over would wait for it
        sigma = torch.full((), cfg.sigma, dtype=dtype, device=udev)
        temperature = torch.full((), cfg.temperature, dtype=dtype, device=udev)
        if params is not None:
            # runtime solver scales (kernel_costs.PARAM_SLOTS 11/12):
            # zero-padded params leave sigma/temperature at the config values
            pvec = torch.as_tensor(params, dtype=dtype, device=udev).reshape(-1)
            pvec = torch.nn.functional.pad(pvec, (0, max(0, 13 - pvec.shape[0])))
            sigma = sigma * torch.exp(pvec[11])
            temperature = temperature * torch.exp(pvec[12])
        if noise is None and blocked:
            noise = sigma * sample_noise_blocked(replan_seed(mppi_state.generator), T, nu, K,
                                                 block, offset, dtype, udev)
        elif noise is None:
            noise = sigma * torch.randn((T, nu, K), generator=mppi_state.generator,
                                        dtype=dtype, device=udev)
        elif tuple(noise.shape) != (T, nu, cfg.K):
            raise ValueError(f"noise: shape {tuple(noise.shape)}, expected {(T, nu, cfg.K)}")
        else:
            noise = noise[..., sl].contiguous()

        qpK = plant.qpos.to(dtype)[:, None].expand(model.nq, K).contiguous()
        qvK = plant.qvel.to(dtype)[:, None].expand(model.nv, K).contiguous()
        t0 = torch.as_tensor(plant.time, dtype=dtype, device=udev).reshape(1, 1) \
            .expand(1, K).contiguous()
        costs, _, _ = rollouts(qpK, qvK, t0, U, noise, params=params)

        w, beta = shard.weights(costs, temperature, cfg.weight_eps)
        update = shard.total(weighted_noise_update(w, noise)).to(dtype)
        U_new = update if cfg.update_mode == "replace" else U + update
        if cfg.clamp_plan:
            U_new = _clip_ctrl(U_new, cfg)
        action = _clip_ctrl(U_new[0], cfg)
        U_shifted = shift_plan(U_new, cfg.tail_decay)

        return (action, MPPIState(U=U_shifted, generator=mppi_state.generator),
                shard.diagnostics(costs, w, beta, update))

    plan.rollouts = rollouts
    return plan
