"""MPPI solver core (solver/mppi.py counterpart): the pieces the kernel
planner uses, and `make_mppi` for dynamics that step the whole K batch:
the learned surrogates on (K, nx) tensors, and the array engine's penalty
tier on a PhysicsState (or a GaitFDState) whose fields carry the K axis.

The algorithm per replan:

    noise   ~ N(0, sigma^2), shape (T, nu, K) for the kernel planner,
              (K, T, nu) for make_mppi (the JAX layouts)
    costs_k = sum_t running_cost(step(x_t, clip(U_t + eps_t))) + terminal
    beta    = min_k costs_k
    w_k     = exp(-(costs_k - beta) / lambda);  w /= sum(w) (+eps)
    U      += sum_k w_k * noise_k          (or U := sum_k w_k * noise_k)
    action  = U[0];  U <- shift(U), tail decay

The JAX PRNG key becomes a torch.Generator held in MPPIState; it advances
in place when the planner draws noise. The two frameworks draw different
numbers from one seed, so parity tests inject the same noise into both.
With cfg.noise_block the field is drawn in K-blocks, each from a generator
of its own seeded from the replan's seed and the block's index
(`sample_noise_blocked`): sample k's noise then depends on k // block
alone, so a planner sharded over K (parallel/mesh) draws the same field.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional

import torch

from .._device import device_constant, resolve_device


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static MPPI hyperparameters."""

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
    terminal_scale: float = 0.0  # if no terminal_fn, terminal = scale * running
    replans_per_step: int = 1    # sample/update passes per control step
    noise_block: Optional[int] = None  # draw K in blocks of this size (sample_noise_blocked)

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


def replan_seed(generator: torch.Generator) -> int:
    """A 63-bit seed for one replan's blocked noise, drawn from the state's
    generator on the host: a hash of the generator's state, which is then
    advanced by one draw. The generator's state lives on the host for a
    CUDA generator too, so nothing waits for the device."""
    state = generator.get_state().numpy().tobytes()
    seed = int.from_bytes(hashlib.blake2b(state, digest_size=8).digest(), "little") >> 1
    torch.empty(1, device=generator.device).normal_(generator=generator)
    return seed


def _block_seed(seed: int, index: int) -> int:
    """splitmix64 of (seed, block index), kept to 63 bits."""
    z = (seed + (index + 1) * 0x9E3779B97F4A7C15) % 2 ** 64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2 ** 64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2 ** 64
    return (z ^ (z >> 31)) >> 1


def sample_noise_blocked(seed: int, T: int, nu: int, n_local: int, block: int,
                         block_offset: int = 0, dtype=torch.float32,
                         device="cuda") -> torch.Tensor:
    """A standard-normal (T, nu, n_local) field drawn as n_local / block
    K-blocks, block b from a generator seeded from (seed, block_offset + b)
    (JAX sample_noise_blocked, fold_in per block). Sample k's noise depends
    only on (seed, k // block), never on how K is laid out over devices: a
    shard holding a whole number of blocks at its offset draws its slice of
    the single-device field."""
    if n_local % block:
        raise ValueError(f"n_local={n_local} not divisible by noise block {block}")
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    draws = []
    for b in range(n_local // block):
        gen.manual_seed(_block_seed(seed, block_offset + b))
        draws.append(torch.randn((T, nu, block), generator=gen, dtype=dtype, device=dev))
    return torch.cat(draws, dim=-1)


def _clip_ctrl(u: torch.Tensor, cfg: MPPIConfig) -> torch.Tensor:
    if cfg.ctrl_low is not None and cfg.ctrl_high is not None:
        return torch.clamp(u, device_constant(tuple(cfg.ctrl_low), u.dtype, u.device),
                           device_constant(tuple(cfg.ctrl_high), u.dtype, u.device))
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


def diagnostics(costs: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                update: torch.Tensor) -> MPPIDiagnostics:
    return MPPIDiagnostics(
        beta=beta,
        mean_cost=torch.mean(costs),
        ess=1.0 / torch.sum(w * w),
        weight_entropy=-torch.sum(w * torch.where(w > 0, torch.log(w + 1e-30), 0.0)),
        update_norm=torch.linalg.norm(update),
    )


def _whole(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class KShard:
    """One process's slice of a replan's K samples and the reductions that
    make its weighting the whole K's. The default is the whole K on one
    device, with nothing to reduce; parallel/mesh.k_shard builds one over a
    process group (equal slices, the slice of rank `index` of `count`).

    weights(costs, temperature, weight_eps) -> (w, beta), w normalized over
    every slice; total(x) sums x over the slices; diagnostics(costs, w,
    beta, update) -> MPPIDiagnostics over every slice."""

    index: int = 0
    count: int = 1
    weights: Callable = mppi_weights
    total: Callable = _whole
    diagnostics: Callable = diagnostics

    def part(self, K: int, noise_block: Optional[int]):
        """(k_local, block, block_offset, slice of K): this slice's sample
        count, the noise block it draws in (noise_block, else its whole
        slice) and its first block's index in the global field."""
        if K % self.count:
            raise ValueError(f"K={K} not divisible by the mesh's {self.count} ranks")
        k = K // self.count
        block = noise_block or k
        if k % block:
            raise ValueError(f"local K={k} not divisible by noise_block={block}")
        return k, block, self.index * (k // block), slice(self.index * k, (self.index + 1) * k)


WHOLE_K = KShard()


def broadcast_state(x0, K: int):
    """x0 with every tensor field broadcast over a leading K axis: a tensor,
    or a dataclass state (PhysicsState, GaitFDState) field by field, nested
    states included (JAX tree_map of broadcast_to)."""
    if x0 is None:
        return None
    if torch.is_tensor(x0):
        return x0.expand(K, *x0.shape)
    if dataclasses.is_dataclass(x0):
        return type(x0)(**{f.name: broadcast_state(getattr(x0, f.name), K)
                           for f in dataclasses.fields(x0)})
    raise TypeError(f"cannot broadcast a state of type {type(x0).__name__}")


def rollout_costs_batched(dynamics_fn: Callable, cost_fn: Callable,
                          terminal_fn: Optional[Callable], cfg: MPPIConfig,
                          x0, U: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """Cost of each of K perturbed plans, noise (K, T, nu) -> costs (K,).

    x0 is one state: a tensor (nx,) or a dataclass state, broadcast over K
    (`broadcast_state`). dynamics_fn(x, u (K, nu), t) -> x and cost_fn(x,
    u, t) -> (K,) take the K batch natively. The running cost is taken on
    the post-step state with the (clipped) applied control; the terminal
    cost at t = T."""
    K = noise.shape[0]
    x = broadcast_state(x0, K)
    acc = 0.0
    for t in range(cfg.T):
        u = U[t] + noise[:, t]
        if cfg.clamp_rollout_ctrl:
            u = _clip_ctrl(u, cfg)
        x = dynamics_fn(x, u, t)
        acc = acc + cost_fn(x, u, t)
    if terminal_fn is not None:
        acc = acc + terminal_fn(x, cfg.T)
    elif cfg.terminal_scale:
        acc = acc + cfg.terminal_scale * cost_fn(
            x, torch.zeros(K, U.shape[-1], dtype=U.dtype, device=U.device), cfg.T)
    return acc


def make_mppi(dynamics_fn: Callable, cost_fn: Callable, cfg: MPPIConfig,
              terminal_fn: Optional[Callable] = None,
              update_op: Optional[Callable] = None, shard: KShard = WHOLE_K):
    """plan(mppi_state, x0, noise=None) -> (action, state', diag).

    Rollouts go through `rollout_costs_batched`: the dynamics (a learned
    surrogate through ops/estimator_kernel, or the array engine's penalty
    step) and the costs take the K batch natively. `update_op(costs, noise) -> (update, (w, beta))`
    replaces the plain weighting. `noise` (K, T, nu), when given, replaces
    the sigma-scaled draw from the state's generator: the matched-noise
    hook the parity tests use; it requires replans_per_step=1. With
    cfg.noise_block the draw is `sample_noise_blocked`'s (T, nu, K) field,
    sample-major. `shard` (parallel/mesh.make_sharded_mppi) rolls out its
    slice of K and reduces the weighting over the others: it draws whole
    blocks of the blocked field at its offset (one block of its slice
    without noise_block) and takes its slice of an injected `noise`."""
    k_local, block, offset, sl = shard.part(cfg.K, cfg.noise_block)
    blocked = bool(cfg.noise_block) or shard.count > 1

    def plan(mppi_state: MPPIState, x0, noise: Optional[torch.Tensor] = None):
        if noise is not None and cfg.replans_per_step != 1:
            raise ValueError("noise injection requires replans_per_step=1")
        U = mppi_state.U
        nu = U.shape[-1]
        injected = noise
        # one or more sample -> weight -> update passes before acting; only
        # the last pass's diagnostics survive
        for _ in range(cfg.replans_per_step):
            if injected is None:
                sigma = (float(cfg.sigma) if isinstance(cfg.sigma, (int, float))
                         else device_constant(tuple(cfg.sigma), U.dtype, U.device))
                if blocked:
                    noise = sigma * sample_noise_blocked(
                        replan_seed(mppi_state.generator), cfg.T, nu, k_local, block,
                        offset, U.dtype, U.device).movedim(-1, 0)
                else:
                    noise = sigma * torch.randn((cfg.K, cfg.T, nu),
                                                generator=mppi_state.generator,
                                                dtype=U.dtype, device=U.device)
            elif tuple(injected.shape) != (cfg.K, cfg.T, nu):
                raise ValueError(f"noise: shape {tuple(injected.shape)}, "
                                 f"expected {(cfg.K, cfg.T, nu)}")
            else:
                noise = injected[sl]
            costs = rollout_costs_batched(dynamics_fn, cost_fn, terminal_fn, cfg, x0, U, noise)
            if update_op is not None:
                update, (w, beta) = update_op(costs, noise)
            else:
                update, (w, beta) = weighted_update(costs, noise, cfg, shard)
            # contain cost-side dtype drift (e.g. f64 cost constants)
            update = update.to(U.dtype)
            U = update if cfg.update_mode == "replace" else U + update
            if cfg.clamp_plan:
                U = _clip_ctrl(U, cfg)
        action = _clip_ctrl(U[0], cfg)
        return (action,
                MPPIState(U=shift_plan(U, cfg.tail_decay), generator=mppi_state.generator),
                shard.diagnostics(costs, w, beta, update))

    return plan


def weighted_update(costs: torch.Tensor, noise: torch.Tensor, cfg: MPPIConfig,
                    shard: KShard = WHOLE_K):
    """make_mppi's plain weighting of (K, T, nu) noise, reduced over the
    shard's group: (update (T, nu), (w, beta))."""
    w, beta = shard.weights(costs, cfg.temperature, cfg.weight_eps)
    return shard.total(torch.einsum("k,ktu->tu", w, noise.to(w.dtype))), (w, beta)
