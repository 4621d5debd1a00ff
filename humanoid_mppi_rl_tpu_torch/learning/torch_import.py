"""Load the reference's trained PyTorch checkpoints (learning/torch_import.py
counterpart).

The reference deploys its estimator MPPI from `.pth` state_dicts (its
src/cartpole_mppi_estimator.py loads checkpoints_cartpole/model_best.pth
into FeatureAttentionStatePredictor(4, 1, 64, 4, 2); its
Visualization/vis.ipynb loads checkpoints/model_cross.pth into
CrossAttentionStatePredictor). The port's modules carry the reference
model's parameter names, so a FeatureAttention or cross-attention
state_dict loads as it is (pos_embedding (1, F, H) included) and an MLP's
through a renaming of its Linear indices only.

The numerics stay the JAX package's, not the reference module's: the
port's LayerNorms keep flax's epsilon 1e-6 (the reference's is 1e-5).

As in the JAX importer (`mlp_params`), an MLP state_dict is read as a
plain Sequential of Linears and ReLUs. A state_dict with BatchNorm layers
(`running_mean`) is refused: the JAX importer would take their weights
for Linears and build a different network.
"""

from __future__ import annotations

from typing import Dict

import torch

from .._device import resolve_device
from ..models.predictors import MLPStatePredictor, make_model


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A .pth state_dict on the host, floating tensors in float32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().float() if v.is_floating_point() else v.detach()
            for k, v in sd.items()}


def mlp_state_dict(sd: Dict[str, torch.Tensor],
                   module: MLPStatePredictor) -> Dict[str, torch.Tensor]:
    """A reference MLP state_dict renamed for `module`: its Linears, in the
    order of their Sequential indices, become the module's."""
    if any(k.endswith("running_mean") for k in sd):
        raise ValueError("the state_dict holds BatchNorm layers: reference MLPs are read as "
                         "plain Linear/ReLU stacks (as the JAX importer's mlp_params), which "
                         "would load a different network")
    src = sorted({int(k.split(".")[1]) for k in sd if k.endswith(".weight")})
    dst = [i for i, layer in enumerate(module.network) if isinstance(layer, torch.nn.Linear)]
    if len(src) != len(dst):
        raise ValueError(f"the state_dict has {len(src)} Linear layers; the module has "
                         f"{len(dst)}")
    return {f"network.{j}.{name}": sd[f"network.{i}.{name}"]
            for i, j in zip(src, dst) for name in ("weight", "bias")}


def load_reference_checkpoint(path: str, preset: str, device="cuda") -> torch.nn.Module:
    """The module of a models.predictors PRESETS name with a reference .pth
    state_dict loaded, on `device`, in eval mode."""
    dev = resolve_device(device)
    module = make_model(preset)
    sd = load_torch_state_dict(path)
    if isinstance(module, MLPStatePredictor):
        sd = mlp_state_dict(sd, module)
    module.load_state_dict(sd)
    return module.to(dev).eval()
