"""Supervised dynamics training (learning/train.py counterpart): PyTorch
autograd on the port's surrogates (models/predictors: FeatureAttention,
cross-attention, and the MLP without BatchNorm: the JAX trainer's step
carries no batch statistics, so neither package trains BatchNorm).

Loop parity with the JAX trainer:
- Adam (torch.optim.Adam computes optax's scale_by_adam: eps outside the
  square root, both bias corrections) on optax's cosine_decay_schedule(lr,
  epochs * steps_per_epoch, alpha=lr_min/lr), read at the step count
  before each update; with `grad_clip`, optax's clip_by_global_norm first
  (g * max_norm/||g|| where ||g|| >= max_norm, no epsilon)
- MSE on next-state deltas, or the k-step open-loop rollout loss; eval
  mean/max abs diff, pct diffs, per-column diffs
- best-by-eval-loss, periodic and final checkpoints (`torch.save`
  state_dicts, read back with weights_only=True), a resumable train state,
  JSONL metrics always, TensorBoard scalars when it is installed,
  train_summary.json

`scan_epochs` keeps the dataset on the device and runs an epoch with no
host sync per step: the epoch's batch indices go up once (from pinned
memory, asynchronously) and its mean loss comes back once. Dropout masks
and the noise augmentation are drawn from a torch.Generator on the device,
seeded per epoch from (seed + 1, epoch); the JAX PRNG streams cannot be
reproduced, so runs with dropout differ from the JAX package's in their
draws only.

Task presets mirror the three reference trainers:
  humanoid  FeatureAttention(30,21,512,8,7), Adam 1e-3 cosine->1e-6,
            200 epochs, batch 64, state_idxes=[0..27,55,56]
  cartpole  FeatureAttention(4,1,64,4,2), Adam 1e-4, 50 epochs, batch 32
  quadruped FeatureAttention(37,12,512,4,2), Adam 1e-4, 50 epochs, batch 64
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..models.predictors import seeded_model
from ..utils.metrics import JSONLWriter, Timer
from .data import MultiTrajectoryDataset


@dataclasses.dataclass
class TrainConfig:
    model_preset: str = "humanoid_attention"
    lr: float = 1e-3
    lr_min: float = 1e-6
    epochs: int = 200
    batch_size: int = 64
    return_type: str = "delta"
    state_idxes: Optional[Sequence[int]] = None
    eval_split: float = 0.1
    ckpt_dir: str = "checkpoints/run"
    ckpt_every: int = 25
    seed: int = 0
    log_path: Optional[str] = None
    # the module's dtype, weights and compute: float32 or float64
    compute_dtype: Any = torch.float32
    # resume from a save_train_state snapshot (params, Adam's moments, the
    # step and the epoch)
    resume_from: Optional[str] = None
    # train/eval loss-curve PNG written after the run; None -> skip
    plot_path: Optional[str] = None
    # the dataset on the device, one host sync per epoch (no per-step
    # TensorBoard scalars in this mode)
    scan_epochs: bool = False
    # multi-step rollout loss over rollout_k composed steps; requires
    # scan_epochs and return_type='delta'
    rollout_k: int = 1
    # constructor overrides for the preset model (e.g. state_dim=19)
    model_overrides: Optional[dict] = None
    # state columns zeroed in every net input (rollout_k > 1 only)
    ego_xy_cols: Optional[Sequence[int]] = None
    # global-norm gradient clip (0 = off)
    grad_clip: float = 0.0


PRESET_CONFIGS = {
    "humanoid": TrainConfig(
        model_preset="humanoid_attention", lr=1e-3, lr_min=1e-6, epochs=200,
        batch_size=64, state_idxes=tuple(range(28)) + (55, 56),
        ckpt_dir="checkpoints/state_only_v2",
    ),
    "cartpole": TrainConfig(
        model_preset="cartpole_attention", lr=1e-4, lr_min=1e-6, epochs=50,
        batch_size=32, ckpt_dir="checkpoints_cartpole",
    ),
    "quadruped": TrainConfig(
        model_preset="quadruped_attention", lr=1e-4, lr_min=1e-6, epochs=50,
        batch_size=64, ckpt_dir="checkpoints_quadruped",
    ),
}


def cosine_decay(count: int, decay_steps: int, alpha: float) -> float:
    """optax.cosine_decay_schedule's factor at `count`: the learning rate
    is init_value times it."""
    count = min(count, decay_steps)
    return (1 - alpha) * (0.5 * (1 + math.cos(math.pi * count / decay_steps))) + alpha


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: each g becomes (g / ||g||) *
    max_norm unless ||g|| < max_norm, with ||g|| the norm over all of them.
    No host sync. Returns ||g||."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    """The module, Adam and its schedule; `step` counts applied updates."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    grad_clip: float = 0.0

    @property
    def step(self) -> int:
        return self.scheduler.last_epoch

    def apply_gradients(self) -> None:
        """Clip (when set), update, advance the schedule, clear the grads."""
        if self.grad_clip:   # (a parameter that the loss does not reach has no grad)
            clip_by_global_norm_([p.grad for p in self.model.parameters() if p.grad is not None],
                                 self.grad_clip)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)

    def set_step(self, count: int) -> None:
        """Put the schedule at `count` updates: the next update's learning
        rate is the schedule's at `count`."""
        self.scheduler.last_epoch = count
        lrs = [base * lam(count) for base, lam in zip(self.scheduler.base_lrs,
                                                      self.scheduler.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            group["lr"] = lr
        self.scheduler._last_lr = lrs


def create_train_state(cfg: TrainConfig, sample_input: np.ndarray, steps_per_epoch: int,
                       device="cuda"):
    """(model, state): the preset module with cfg.model_overrides, drawn
    from PyTorch's initialisers under torch.manual_seed(cfg.seed) (the
    global generator is left as it was), on `device` in cfg.compute_dtype."""
    dev = resolve_device(device)
    if cfg.compute_dtype not in (torch.float32, torch.float64):
        raise ValueError(f"compute_dtype {cfg.compute_dtype}: the trainer takes "
                         "torch.float32 or torch.float64")
    model = seeded_model(cfg.model_preset, cfg.seed, **(cfg.model_overrides or {}))
    if getattr(model, "use_batch_norm", False):
        raise ValueError(f"{cfg.model_preset}: an MLP with BatchNorm does not train here, as "
                         "in the JAX trainer, whose step carries no batch statistics")
    model = model.to(device=dev, dtype=cfg.compute_dtype)
    if np.shape(sample_input)[-1] != model.input_dim:
        raise ValueError(f"inputs have {np.shape(sample_input)[-1]} columns; "
                         f"{cfg.model_preset} takes {model.input_dim}")
    decay_steps = max(1, cfg.epochs * steps_per_epoch)
    alpha = cfg.lr_min / cfg.lr
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: cosine_decay(count, decay_steps, alpha))
    return model, TrainState(model, opt, sched, cfg.grad_clip)


def _mse(pred, y):
    return torch.mean((pred - y) ** 2)


def _eval_stats(pred, y, loss=None):
    """(loss, mean |diff|, max |diff|, mean pct diff, per-column |diff|)."""
    diff = (pred - y).abs()
    pct = diff / (y.abs() + 1e-8)
    return (_mse(pred, y) if loss is None else loss, diff.mean(), diff.max(), pct.mean(),
            diff.mean(dim=0))


def _stack(rows):
    return tuple(torch.stack(col) for col in zip(*rows))


def make_steps():
    """train_step(state, x, y, generator) -> (state, loss) and
    eval_step(model, x, y) -> (loss, mean_abs, max_abs, mean_pct, col_diff),
    one batch each (the host loop's steps)."""

    def train_step(state: TrainState, x, y, generator):
        loss = _mse(state.model.train()(x, generator), y)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    @torch.no_grad()
    def eval_step(model, x, y):
        return _eval_stats(model.eval()(x), y)

    return train_step, eval_step


def make_scanned_steps(X: torch.Tensor, Y: torch.Tensor, noise_std: float = 0.0):
    """Whole-epoch programs over a device-resident dataset.

    train_epoch(state, idx, generator): idx (steps, B) batch indices on the
    device -> (state, mean loss as a device scalar); no host sync.
    eval_all(model, idx) over (n_eval_batches, B) -> stacked per-batch
    (loss, mean_abs, max_abs, mean_pct, col_diff)."""

    def train_epoch(state: TrainState, idx, generator):
        model = state.model.train()
        losses = []
        for bidx in idx:
            x, y = X.index_select(0, bidx), Y.index_select(0, bidx)
            if noise_std > 0:   # dataset augmentation, on the device
                x = x + noise_std * torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                                device=x.device)
            loss = _mse(model(x, generator), y)
            loss.backward()
            state.apply_gradients()
            losses.append(loss.detach())
        return state, torch.stack(losses).mean()

    @torch.no_grad()
    def eval_all(model, idx):
        model.eval()
        return _stack([_eval_stats(model(X.index_select(0, b)), Y.index_select(0, b))
                       for b in idx])

    return train_epoch, eval_all


def make_scanned_rollout_steps(S: torch.Tensor, A: torch.Tensor, k: int,
                               ego_cols: Optional[Sequence[int]] = None):
    """Whole-epoch programs over device-resident rollout windows: S (W, k+1,
    sdim) raw states, A (W, k, adim). The loss rolls the model open-loop,
    x <- x + net([x with the ego columns zeroed; u_j]), and averages the k
    per-step MSEs; eval reports the last step's errors.

    `ego_cols`: state columns zeroed in every net input only (egocentric
    root x/y); the composition stays absolute."""
    ego = (None if ego_cols is None
           else torch.as_tensor(list(ego_cols), dtype=torch.long, device=S.device))

    def _rollout_loss(model, s_seq, a_seq, generator=None):
        x = s_seq[:, 0]
        tot = 0.0
        for j in range(k):
            x_in = x if ego is None else x.index_fill(-1, ego, 0.0)
            x = x + model(torch.cat([x_in, a_seq[:, j]], dim=-1), generator)
            tot = tot + _mse(x, s_seq[:, j + 1])
        return tot / k, x

    def train_epoch(state: TrainState, idx, generator):
        model = state.model.train()
        losses = []
        for bidx in idx:
            loss, _ = _rollout_loss(model, S.index_select(0, bidx), A.index_select(0, bidx),
                                    generator)
            loss.backward()
            state.apply_gradients()
            losses.append(loss.detach())
        return state, torch.stack(losses).mean()

    @torch.no_grad()
    def eval_all(model, idx):
        model.eval()
        rows = []
        for b in idx:
            s_seq = S.index_select(0, b)
            loss, x = _rollout_loss(model, s_seq, A.index_select(0, b))
            rows.append(_eval_stats(x, s_seq[:, -1], loss))
        return _stack(rows)

    return train_epoch, eval_all


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The dropout and noise generator of one epoch, on `device`: a function
    of (seed + 1, epoch) only, so a resumed run draws what an uninterrupted
    one does."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed + 1, epoch]).generate_state(1, np.uint64)[0]))
    return gen


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a card through pinned memory, without
    making the host wait."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def save_checkpoint(ckpt_dir: str, name: str, model: torch.nn.Module) -> str:
    """<ckpt_dir>/<name>.pt: the module's state_dict on the host."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}.pt"))
    _save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def load_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a save_checkpoint file into `model` (on its device); returns it."""
    dev = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=dev, weights_only=True))
    return model


def save_train_state(ckpt_dir: str, name: str, state: TrainState, epoch: int) -> str:
    """Full resumable snapshot: params, Adam's moments and counts, the step
    and the epoch."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}.pt"))
    _save({"params": state.model.state_dict(), "opt_state": state.optimizer.state_dict(),
           "step": state.step, "epoch": epoch}, path)
    return path


def load_train_state(path: str, state: TrainState):
    """Restore (state, next_epoch) from a save_train_state snapshot; the
    schedule continues from the saved step."""
    dev = next(state.model.parameters()).device
    got = torch.load(path, map_location=dev, weights_only=True)
    state.model.load_state_dict(got["params"])
    state.optimizer.load_state_dict(got["opt_state"])
    state.set_step(int(got["step"]))
    return state, int(got["epoch"]) + 1


def _save(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_loss_curve(path: str, history) -> Optional[str]:
    """Train/eval loss-curve PNG. Returns the path, or None when matplotlib
    is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    epochs = [h[0] for h in history]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(epochs, [h[1] for h in history], label="train loss")
    ax.plot(epochs, [h[2] for h in history], label="eval loss")
    ax.set_xlabel("epoch")
    ax.set_ylabel("MSE loss")
    ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def _batch_index(pool, n_batches: int, batch_size: int, device) -> Optional[torch.Tensor]:
    """pool[: n_batches * batch_size] as an (n_batches, batch_size) index
    tensor on the device; None without a full batch."""
    if not n_batches:
        return None
    idx = np.asarray(pool, np.int64)[: n_batches * batch_size]
    return to_device(idx.reshape(n_batches, batch_size), device)


def train_model(
    states_dir: str,
    actions_dir: str,
    cfg: TrainConfig,
    max_steps_per_epoch: Optional[int] = None,
    device="cuda",
) -> dict:
    """Full training run; returns summary metrics and the trained `model`."""
    dev = resolve_device(device)
    ds = MultiTrajectoryDataset(
        states_dir, actions_dir, return_type=cfg.return_type,
        eval_split=cfg.eval_split, state_idxes=cfg.state_idxes, seed=cfg.seed,
        rollout_k=cfg.rollout_k)
    log = JSONLWriter(cfg.log_path or os.path.join(cfg.ckpt_dir, "metrics.jsonl"))
    tb = None
    try:  # TensorBoard scalars when it is installed
        from torch.utils.tensorboard import SummaryWriter
        tb = SummaryWriter(os.path.join(cfg.ckpt_dir, "tb"))
    except ImportError:
        pass

    x0, _ = next(ds.batches(min(cfg.batch_size, len(ds.train_idx)), seed=cfg.seed))
    train_pool = (ds.win_train_idx if cfg.rollout_k > 1 else ds.train_idx)
    steps_per_epoch = max(1, len(train_pool) // cfg.batch_size)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)
    model, state = create_train_state(cfg, x0, steps_per_epoch, device=dev)
    train_step, eval_step = make_steps()

    if cfg.rollout_k > 1 and not cfg.scan_epochs:
        raise ValueError("rollout_k > 1 requires scan_epochs=True")

    scanned = None
    if cfg.scan_epochs and len(ds.train_idx) < cfg.batch_size:
        # a sub-batch training set cannot fill one (nb, batch_size) index
        # array; the host loop's ds.batches handles short sets
        cfg = dataclasses.replace(cfg, scan_epochs=False)
    B = cfg.batch_size
    if cfg.scan_epochs and cfg.rollout_k > 1:
        fns = make_scanned_rollout_steps(
            torch.as_tensor(ds.win_states, device=dev), torch.as_tensor(ds.win_actions, device=dev),
            cfg.rollout_k, ego_cols=cfg.ego_xy_cols)
        scanned = (*fns, _batch_index(ds.win_eval_idx, len(ds.win_eval_idx) // B, B, dev))
    elif cfg.scan_epochs:
        fns = make_scanned_steps(torch.as_tensor(ds.inputs, device=dev),
                                 torch.as_tensor(ds.targets, device=dev),
                                 noise_std=float(ds.noise_std or 0.0))
        scanned = (*fns, _batch_index(ds.eval_idx, len(ds.eval_idx) // B, B, dev))

    start_epoch = 0
    if cfg.resume_from:
        state, start_epoch = load_train_state(cfg.resume_from, state)
        log.write(kind="resume", path=cfg.resume_from, epoch=start_epoch)

    as_dev = lambda a: torch.as_tensor(a, device=dev)
    best_eval = np.inf
    best_path = None
    global_step = state.step
    train_loss = float("nan")
    history = []  # (epoch, train_loss, eval_loss) for the loss-curve plot
    for epoch in range(start_epoch, cfg.epochs):
        gen = epoch_generator(cfg.seed, epoch, dev)
        with Timer() as t_ep:
            if scanned is not None:
                train_epoch_fn = scanned[0]
                perm = np.random.default_rng(cfg.seed + epoch).permutation(len(train_pool))
                nb = steps_per_epoch
                idx = _batch_index(np.asarray(train_pool, np.int64)[perm], nb, B, dev)
                state, mean_loss = train_epoch_fn(state, idx, gen)
                train_loss = float(mean_loss)   # the epoch's one host sync
                global_step += nb
            else:
                losses = []
                for i, (x, y) in enumerate(
                    ds.batches(B, train=True, seed=cfg.seed + epoch)
                ):
                    if max_steps_per_epoch and i >= max_steps_per_epoch:
                        break
                    state, loss = train_step(state, as_dev(x), as_dev(y), gen)
                    losses.append(float(loss))
                    if tb:
                        tb.add_scalar("train/loss_step", losses[-1], global_step)
                    global_step += 1
                train_loss = float(np.mean(losses)) if losses else float("nan")

        if scanned is not None and scanned[2] is not None:
            ls, ma, xa, pc, cd_ = (t.cpu().numpy() for t in scanned[1](model, scanned[2]))
            eval_loss = float(ls.mean())
            mean_abs = float(ma.mean())
            max_abs = float(xa.max())
            mean_pct = float(pc.mean())
            col_diff = cd_.mean(axis=0)
        else:
            ev = [[t.cpu().numpy() for t in eval_step(model, as_dev(x), as_dev(y))]
                  for x, y in ds.batches(B, train=False)]
            if ev:
                eval_loss = float(np.mean([float(e[0]) for e in ev]))
                mean_abs = float(np.mean([float(e[1]) for e in ev]))
                max_abs = float(np.max([float(e[2]) for e in ev]))
                mean_pct = float(np.mean([float(e[3]) for e in ev]))
                col_diff = np.mean([e[4] for e in ev], axis=0)
            else:
                eval_loss, mean_abs, max_abs, mean_pct = train_loss, 0.0, 0.0, 0.0
                col_diff = np.zeros(1)

        history.append((epoch, train_loss, eval_loss))
        log.write(kind="epoch", epoch=epoch, train_loss=train_loss,
                  eval_loss=eval_loss, mean_abs=mean_abs, max_abs=max_abs,
                  mean_pct=mean_pct, seconds=t_ep.seconds)
        if tb:
            tb.add_scalar("train/loss", train_loss, epoch)
            tb.add_scalar("eval/loss", eval_loss, epoch)
            tb.add_scalar("eval/mean_abs", mean_abs, epoch)
            tb.add_scalar("eval/max_abs", max_abs, epoch)
            for c, v in enumerate(col_diff):
                tb.add_scalar(f"eval/col_{c}_abs", float(v), epoch)

        if eval_loss < best_eval:
            best_eval = eval_loss
            best_path = save_checkpoint(cfg.ckpt_dir, "model_best", model)
        if cfg.ckpt_every and (epoch + 1) % cfg.ckpt_every == 0:
            save_checkpoint(cfg.ckpt_dir, f"model_epoch_{epoch + 1}", model)
            save_train_state(cfg.ckpt_dir, "state_last", state, epoch)

    final_path = save_checkpoint(cfg.ckpt_dir, "model_final", model)
    if cfg.plot_path and history:
        save_loss_curve(cfg.plot_path, history)
    if tb:
        tb.close()
    log.close()
    summary = {
        "best_eval_loss": best_eval,
        "final_train_loss": train_loss,
        "best_checkpoint": best_path,
        "final_checkpoint": final_path,
        "n_pairs": len(ds),
        "epochs": cfg.epochs,
        "rollout_k": cfg.rollout_k,
    }
    with open(os.path.join(cfg.ckpt_dir, "train_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return {**summary, "model": model}
