"""Learned-dynamics surrogates as PyTorch modules (models/predictors.py
counterpart).

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

The MLP and cross-attention predictors are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

LN_EPS = 1e-6  # flax LayerNorm's epsilon (torch's default is 1e-5)


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
        mha, rate = self.attention, self.dropout.p
        Fn, H = x.shape[-2:]
        hd = H // mha.num_heads
        qkv = nn.functional.linear(self.norm1(x), mha.in_proj_weight, mha.in_proj_bias)
        q, k, v = (t.unflatten(-1, (mha.num_heads, hd)).transpose(-2, -3)
                   for t in qkv.split(H, dim=-1))                 # (..., nh, F, hd)
        w = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
        if rate > 0:
            keep = torch.rand((Fn, Fn), generator=gen, dtype=w.dtype, device=w.device) < 1 - rate
            w = w * (keep.to(w.dtype) / (1 - rate))
        a = mha.out_proj((w @ v).transpose(-2, -3).flatten(-2))
        x = x + _dropout(a, rate, gen)
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


PRESETS = {
    # kwargs per reference deployment (models/predictors.py PRESETS)
    "cartpole_attention": dict(state_dim=4, action_dim=1, hidden_dim=64,
                               num_heads=4, attn_layers=2),
    "quadruped_attention": dict(state_dim=37, action_dim=12, hidden_dim=512,
                                num_heads=4, attn_layers=2),
    "humanoid_attention": dict(state_dim=30, action_dim=21, hidden_dim=512,
                               num_heads=8, attn_layers=7),
}


def make_model(name: str, **overrides) -> FeatureAttentionStatePredictor:
    """A preset's module in eval mode (dropout off), with f32 weights from
    PyTorch's default initialisers; load trained or seeded weights with
    load_state_dict (models.convert carries flax weights across)."""
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return FeatureAttentionStatePredictor(**kw).eval()
