"""Flax surrogate weights -> the port's modules.

`params_from_flax` is the exact inverse of the JAX package's
learning/torch_import.{feature_attention,cross_attention,mlp}_params: a
flax variable tree (of numpy arrays) becomes a state_dict with the
reference PyTorch model's names, for each of the three families.

Layouts (flax -> torch):
  Dense kernel (in, out)                 -> Linear.weight (out, in) = kernel.T
  attention query/key/value kernel (H, nh, hd), bias (nh, hd)
                                         -> in_proj_weight rows [Wq; Wk; Wv],
                                            each kernel.reshape(H, H).T
  attention out kernel (nh, hd, H)       -> out_proj.weight = kernel.reshape(H, H).T
  LayerNorm scale/bias                   -> LayerNorm weight/bias
  BatchNorm scale/bias, batch_stats mean/var
                                         -> weight/bias, running_mean/var
  pos_embedding (F, H)                   -> pos_embedding (1, F, H)

Trained weights ship as state_dicts in assets/ (TRAINED), converted once
from the JAX package's orbax checkpoints so that no orbax is needed to
load them.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from .._device import resolve_device
from .predictors import (CrossAttentionStatePredictor, FeatureAttentionStatePredictor,
                         MLPStatePredictor, make_model)

# assets/<name>.pt: (preset, constructor overrides) of the module it fits
TRAINED = {
    # scripts/quad_pipeline.py's best checkpoint: the position-only Go1
    # surrogate (artifacts/quad_pipeline/ckpt/model_best)
    "quad_pipeline_best": ("quadruped_attention", {"state_dim": 19}),
    # the rollout_k humanoid surrogate on [qpos; foot z] (30 + 21 tokens,
    # 7 layers; artifacts/rollout_k_surrogate/ckpt/model_best)
    "rollout_k_surrogate_best": ("humanoid_attention", {}),
}


def trained_path(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets", f"{name}.pt")


def load_trained(name: str, device="cuda") -> FeatureAttentionStatePredictor:
    """The module of TRAINED[name] with its committed weights, on `device`,
    in eval mode."""
    preset, overrides = TRAINED[name]
    module = make_model(preset, **overrides)
    module.load_state_dict(torch.load(trained_path(name), map_location="cpu", weights_only=True))
    return module.to(resolve_device(device))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, prefix, dense):
    sd[f"{prefix}.weight"] = _t(np.asarray(dense["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(dense["bias"])


def _layernorm(sd, prefix, ln):
    sd[f"{prefix}.weight"] = _t(ln["scale"])
    sd[f"{prefix}.bias"] = _t(ln["bias"])


def _mha(sd, prefix, mha, H):
    sd[f"{prefix}.in_proj_weight"] = torch.cat(
        [_t(np.asarray(mha[n]["kernel"]).reshape(H, H).T) for n in ("query", "key", "value")])
    sd[f"{prefix}.in_proj_bias"] = torch.cat(
        [_t(np.asarray(mha[n]["bias"]).reshape(H)) for n in ("query", "key", "value")])
    sd[f"{prefix}.out_proj.weight"] = _t(np.asarray(mha["out"]["kernel"]).reshape(H, H).T)
    sd[f"{prefix}.out_proj.bias"] = _t(mha["out"]["bias"])


def params_from_flax(params: Dict[str, Any], module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """flax variables ({"params": ..., "batch_stats": ...} or the inner
    params tree) -> module.state_dict(), for any of the three families. An
    MLP with BatchNorm needs the variables with their batch_stats."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, torch.Tensor] = {}
    if isinstance(module, MLPStatePredictor):
        stats = params.get("batch_stats")
        n_dense = n_bn = 0
        for i, layer in enumerate(module.network):
            if isinstance(layer, torch.nn.Linear):
                _linear(sd, f"network.{i}", p[f"Dense_{n_dense}"])
                n_dense += 1
            elif isinstance(layer, torch.nn.BatchNorm1d):
                if stats is None:
                    raise ValueError("an MLP with BatchNorm needs the flax variables with "
                                     "their batch_stats")
                bn, st = p[f"BatchNorm_{n_bn}"], stats[f"BatchNorm_{n_bn}"]
                sd[f"network.{i}.weight"] = _t(bn["scale"])
                sd[f"network.{i}.bias"] = _t(bn["bias"])
                sd[f"network.{i}.running_mean"] = _t(st["mean"])
                sd[f"network.{i}.running_var"] = _t(st["var"])
                sd[f"network.{i}.num_batches_tracked"] = torch.tensor(0)
                n_bn += 1
        return sd
    H = module.hidden_dim
    if isinstance(module, CrossAttentionStatePredictor):
        _linear(sd, "qpos_encoder", p["Dense_0"])
        _linear(sd, "qvel_encoder", p["Dense_1"])
        _linear(sd, "action_encoder", p["Dense_2"])
        _mha(sd, "attn_qpos_to_qvel", p["MultiHeadDotProductAttention_0"], H)
        _mha(sd, "attn_qvel_to_qpos", p["MultiHeadDotProductAttention_1"], H)
        _layernorm(sd, "fusion_layer.0", p["LayerNorm_0"])
        _linear(sd, "fusion_layer.2", p["Dense_3"])
        _linear(sd, "fusion_layer.4", p["Dense_4"])
        return sd
    _linear(sd, "feature_encoding.0", p["Dense_0"])
    _layernorm(sd, "feature_encoding.1", p["LayerNorm_0"])
    sd["pos_embedding"] = _t(p["pos_embedding"])[None]
    for i in range(module.attn_layers):
        blk = p[f"_TransformerBlock_{i}"]
        pre = f"layers.{i}"
        _layernorm(sd, f"{pre}.norm1", blk["LayerNorm_0"])
        _mha(sd, f"{pre}.attention", blk["MultiHeadDotProductAttention_0"], H)
        _layernorm(sd, f"{pre}.norm2", blk["LayerNorm_1"])
        _linear(sd, f"{pre}.ffn.0", blk["Dense_0"])
        _linear(sd, f"{pre}.ffn.3", blk["Dense_1"])
    _linear(sd, "output_layer", p["Dense_1"])
    return sd
