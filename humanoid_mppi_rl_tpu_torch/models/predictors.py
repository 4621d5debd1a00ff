"""Learned-dynamics surrogates as PyTorch modules (models/predictors.py
counterpart): the three families of the reference's learning/model.py.

FeatureAttentionStatePredictor: each scalar feature of [state; action] is a
token (shared Linear(1,H) encoding, LayerNorm, ReLU, learned positional
embedding), pre-LN transformer blocks (multi-head self-attention, FFN 4H
with ReLU), a per-token scalar head, output cut to state_dim. The numerics
are the flax module's: LayerNorm eps 1e-6, computed in the weights' dtype
(f32, or f64 after `.double()`), the output cast to f32. Parameter names
are those of the reference's PyTorch model (learning/model.py there), so
models.convert carries flax weights across and back.

Training mode (`module.train()`) applies flax's dropouts: on the attention
weights after the softmax, one (F, F) mask shared by every sample and head
(flax's broadcast_dropout), and elementwise on the attention residual,
after the FFN's ReLU and on the FFN residual; kept values are scaled by
1/keep. The masks come from the `generator` passed to forward. Eval mode
runs nn.MultiheadAttention and no dropout.

MLPStatePredictor: (hidden_layers + 1) x (Linear, optional BatchNorm, ReLU,
optional Dropout), then a Linear head. BatchNorm is flax's: eps 1e-5,
momentum 0.99 (torch's momentum 0.01, the weight of the new batch); eval
mode normalises with the running statistics, training mode with the
batch's and updates the running ones (torch's rule: the batch variance
unbiased, where flax keeps it biased).

CrossAttentionStatePredictor: qpos, qvel and action encoders (the action
is encoded and unused, as in the reference's forward), attention qpos ->
qvel and qvel -> qpos over sequences of length 1, concatenation, then
LayerNorm, ReLU, Linear, ReLU, Linear. In training mode each attention
draws flax's one broadcast dropout mask of shape (1, 1).

Every family computes in its weights' dtype and returns float32, and
takes `generator` in forward (training-mode dropout draws).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)
BN_EPS, BN_MOMENTUM = 1e-5, 0.01  # flax BatchNorm: epsilon 1e-5, momentum 0.99


def _attention_train(mha: nn.MultiheadAttention, q_in, kv_in, rate: float, gen):
    """nn.MultiheadAttention written out with flax's attention dropout: one
    (Lq, Lk) mask shared by every sample and head (broadcast_dropout),
    kept weights scaled by 1/keep."""
    H = q_in.shape[-1]
    hd = H // mha.num_heads
    W, b = mha.in_proj_weight, mha.in_proj_bias
    if q_in is kv_in:   # self-attention: one projection for q, k and v
        q, k, v = nn.functional.linear(q_in, W, b).split(H, dim=-1)
    else:
        q = nn.functional.linear(q_in, W[:H], b[:H])
        k, v = nn.functional.linear(kv_in, W[H:], b[H:]).split(H, dim=-1)
    q, k, v = (t.unflatten(-1, (mha.num_heads, hd)).transpose(-2, -3)
               for t in (q, k, v))                                # (..., nh, L, hd)
    w = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
    if rate > 0:
        keep = torch.rand(w.shape[-2:], generator=gen, dtype=w.dtype, device=w.device) < 1 - rate
        w = w * (keep.to(w.dtype) / (1 - rate))
    return mha.out_proj((w @ v).transpose(-2, -3).flatten(-2))


class _TransformerBlock(nn.Module):
    def __init__(self, hidden_dim: int, num_heads: int, dropout_rate: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.attention = nn.MultiheadAttention(hidden_dim, num_heads, batch_first=True)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.ffn = nn.Sequential(nn.Linear(hidden_dim, 4 * hidden_dim), nn.ReLU(),
                                 nn.Dropout(dropout_rate),
                                 nn.Linear(4 * hidden_dim, hidden_dim))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.training:
            return self._train_forward(x, generator)
        y = self.norm1(x).reshape(-1, *x.shape[-2:])
        a = self.attention(y, y, y, need_weights=False)[0].reshape(x.shape)
        x = x + self.dropout(a)
        return x + self.dropout(self.ffn(self.norm2(x)))

    def _train_forward(self, x, gen):
        """The attention written out, flax's dropouts in flax's places."""
        rate = self.dropout.p
        y = self.norm1(x)
        x = x + _dropout(_attention_train(self.attention, y, y, rate, gen), rate, gen)
        h = _dropout(torch.relu(self.ffn[0](self.norm2(x))), rate, gen)
        return x + _dropout(self.ffn[3](h), rate, gen)


def _dropout(x: torch.Tensor, rate: float, gen) -> torch.Tensor:
    """flax nn.Dropout: keep with probability 1 - rate, scaled by 1/keep."""
    if rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=gen, dtype=x.dtype, device=x.device) < 1 - rate
    return torch.where(keep, x / (1 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class FeatureAttentionStatePredictor(nn.Module):
    def __init__(self, state_dim: int = 55, action_dim: int = 21,
                 hidden_dim: int = 128, num_heads: int = 4,
                 attn_layers: int = 2, dropout_rate: float = 0.1):
        super().__init__()
        self.state_dim, self.action_dim = state_dim, action_dim
        self.hidden_dim, self.num_heads = hidden_dim, num_heads
        self.attn_layers, self.dropout_rate = attn_layers, dropout_rate
        F = state_dim + action_dim
        self.feature_encoding = nn.Sequential(
            nn.Linear(1, hidden_dim), nn.LayerNorm(hidden_dim, eps=LN_EPS), nn.ReLU())
        self.pos_embedding = nn.Parameter(torch.empty(1, F, hidden_dim))
        nn.init.xavier_uniform_(self.pos_embedding[0])
        self.layers = nn.ModuleList(
            _TransformerBlock(hidden_dim, num_heads, dropout_rate)
            for _ in range(attn_layers))
        self.output_layer = nn.Linear(hidden_dim, 1)

    @property
    def input_dim(self) -> int:
        return self.state_dim + self.action_dim

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (..., state_dim + action_dim) -> (..., state_dim), f32 (the flax
        module's output cast). `generator` draws the training-mode dropout
        masks; eval mode draws nothing."""
        h = self.feature_encoding(x.to(self.pos_embedding.dtype)[..., None]) + self.pos_embedding[0]
        for layer in self.layers:
            h = layer(h, generator)
        return self.output_layer(h)[..., 0][..., : self.state_dim].float()


class MLPStatePredictor(nn.Module):
    def __init__(self, state_dim: int = 55, action_dim: int = 21,
                 hidden_dim: int = 128, hidden_layers: int = 2,
                 use_batch_norm: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.state_dim, self.action_dim = state_dim, action_dim
        self.hidden_dim, self.hidden_layers = hidden_dim, hidden_layers
        self.use_batch_norm, self.dropout_rate = use_batch_norm, dropout_rate
        layers, d = [], self.input_dim
        for _ in range(hidden_layers + 1):
            layers.append(nn.Linear(d, hidden_dim))
            if use_batch_norm:
                layers.append(nn.BatchNorm1d(hidden_dim, eps=BN_EPS, momentum=BN_MOMENTUM))
            layers.append(nn.ReLU())
            if dropout_rate > 0:
                layers.append(nn.Dropout(dropout_rate))
            d = hidden_dim
        layers.append(nn.Linear(d, state_dim))
        self.network = nn.Sequential(*layers)

    @property
    def input_dim(self) -> int:
        return self.state_dim + self.action_dim

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (..., state_dim + action_dim) -> (..., state_dim), f32."""
        x = x.to(self.network[0].weight.dtype)
        for layer in self.network:
            if isinstance(layer, nn.Dropout):
                x = _dropout(x, layer.p, generator) if self.training else x
            elif isinstance(layer, nn.BatchNorm1d):   # over every leading axis
                x = layer(x.reshape(-1, x.shape[-1])).reshape(x.shape)
            else:
                x = layer(x)
        return x.float()


class CrossAttentionStatePredictor(nn.Module):
    def __init__(self, qpos_dim: int = 28, qvel_dim: int = 27, action_dim: int = 21,
                 hidden_dim: int = 128, num_heads: int = 6, dropout_rate: float = 0.18):
        super().__init__()
        self.qpos_dim, self.qvel_dim, self.action_dim = qpos_dim, qvel_dim, action_dim
        self.hidden_dim, self.num_heads, self.dropout_rate = hidden_dim, num_heads, dropout_rate
        H = hidden_dim
        self.qpos_encoder = nn.Linear(qpos_dim, H)
        self.qvel_encoder = nn.Linear(qvel_dim, H)
        self.action_encoder = nn.Linear(action_dim, H)
        self.attn_qpos_to_qvel = nn.MultiheadAttention(H, num_heads, batch_first=True)
        self.attn_qvel_to_qpos = nn.MultiheadAttention(H, num_heads, batch_first=True)
        self.fusion_layer = nn.Sequential(
            nn.LayerNorm(2 * H, eps=LN_EPS), nn.ReLU(), nn.Linear(2 * H, H), nn.ReLU(),
            nn.Linear(H, self.state_dim))

    @property
    def state_dim(self) -> int:
        return self.qpos_dim + self.qvel_dim

    @property
    def input_dim(self) -> int:
        return self.state_dim + self.action_dim

    def _attend(self, mha, q, kv, gen):
        """mha over sequences of length 1: (..., H) -> (..., H)."""
        if self.training:
            return _attention_train(mha, q[..., None, :], kv[..., None, :],
                                    self.dropout_rate, gen)[..., 0, :]
        q3, kv3 = q.reshape(-1, 1, q.shape[-1]), kv.reshape(-1, 1, kv.shape[-1])
        return mha(q3, kv3, kv3, need_weights=False)[0].reshape(q.shape)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (..., qpos_dim + qvel_dim + action_dim) -> (..., state_dim), f32."""
        x = x.to(self.qpos_encoder.weight.dtype)
        sd = self.state_dim
        q_feat = self.qpos_encoder(x[..., : self.qpos_dim])
        v_feat = self.qvel_encoder(x[..., self.qpos_dim: sd])
        self.action_encoder(x[..., sd:])   # encoded and unused, as in the reference
        q_attn = self._attend(self.attn_qpos_to_qvel, q_feat, v_feat, generator)
        v_attn = self._attend(self.attn_qvel_to_qpos, v_feat, q_feat, generator)
        return self.fusion_layer(torch.cat([q_attn, v_attn], dim=-1)).float()


PRESETS = {
    # (module class, kwargs) per reference deployment (models/predictors.py PRESETS)
    "cartpole_attention": (FeatureAttentionStatePredictor,
                           dict(state_dim=4, action_dim=1, hidden_dim=64,
                                num_heads=4, attn_layers=2)),
    "quadruped_attention": (FeatureAttentionStatePredictor,
                            dict(state_dim=37, action_dim=12, hidden_dim=512,
                                 num_heads=4, attn_layers=2)),
    "humanoid_attention": (FeatureAttentionStatePredictor,
                           dict(state_dim=30, action_dim=21, hidden_dim=512,
                                num_heads=8, attn_layers=7)),
    # deployed with 4 heads (the class default 6 does not divide 128)
    "humanoid_cross": (CrossAttentionStatePredictor,
                       dict(qpos_dim=28, qvel_dim=27, action_dim=21, num_heads=4)),
}


def make_model(name: str, **overrides) -> nn.Module:
    """A preset's module in eval mode (dropout off), with f32 weights from
    PyTorch's default initialisers; load trained or seeded weights with
    load_state_dict (models.convert carries flax weights across)."""
    cls, kw = PRESETS[name]
    return cls(**{**kw, **overrides}).eval()


def seeded_model(name: str, seed: int, **overrides) -> nn.Module:
    """make_model with PyTorch's initialisers drawn from a generator seeded
    with `seed` (the global one's state is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return make_model(name, **overrides)
