"""The MLP and cross-attention surrogates and the reference-checkpoint
importer of the PyTorch port against the JAX package's (models/predictors,
learning/torch_import), on the CPU.

Weights come across with models.convert.params_from_flax; reference-layout
state_dicts are seeded with numpy and written with torch.save. Tolerances:
f32 rtol 1e-5 with atol 1e-6 of the output's largest magnitude (GEMM
rounding scales with it), f64 rtol 1e-10 (both families cast their output
to f32, as flax's do, so the f64 case holds the two f32 outputs alike).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu.learning import torch_import as jax_import
from humanoid_mppi_rl_tpu.models import predictors as jax_pred
from humanoid_mppi_rl_tpu_torch.learning import torch_import as port_import
from humanoid_mppi_rl_tpu_torch.learning.train import TrainConfig, train_model
from humanoid_mppi_rl_tpu_torch.models import predictors as port_pred
from humanoid_mppi_rl_tpu_torch.models.convert import params_from_flax
from humanoid_mppi_rl_tpu_torch.utils.trajio import write_csv

MLP_KW = dict(state_dim=6, action_dim=2, hidden_dim=16, hidden_layers=2)
CROSS_SMALL = dict(qpos_dim=5, qvel_dim=4, action_dim=3, hidden_dim=16, num_heads=4)
CROSS_SQUARE = dict(qpos_dim=4, qvel_dim=4, action_dim=2, hidden_dim=16, num_heads=2)
TOL = {"float32": (1e-5, 1e-6), "float64": (1e-10, 0.0)}   # rtol, atol / max|ref|
JDT = {"float32": jnp.float32, "float64": jnp.float64}


def _seeded(tree, seed):
    """A variable tree of shapes filled from a seeded normal (f32 values);
    BatchNorm variances positive."""
    rng = np.random.default_rng(seed)

    def draw(path, shape):
        v = rng.normal(0.0, 0.4, shape).astype(np.float32)
        if any(getattr(k, "key", None) == "var" for k in path):
            v = (np.abs(v) + 0.5).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(draw, tree, is_leaf=lambda a: isinstance(a, tuple))


def _flax_pair(jax_cls, port_module, kw, dtype, seed=0):
    """(flax module, its seeded variables in `dtype`, the port module with
    the same weights in `dtype`)."""
    net = jax_cls(**kw, compute_dtype=JDT[dtype])
    F = port_module.input_dim
    like = jax.eval_shape(net.init, jax.random.PRNGKey(seed), jnp.zeros((1, F), jnp.float32))
    variables = _seeded(jax.tree_util.tree_map(lambda a: a.shape, like), seed)
    port_module.load_state_dict(params_from_flax(variables, port_module))
    port_module = port_module.to(getattr(torch, dtype)).eval()
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, JDT[dtype]), variables)
    return net, variables, port_module


def _x(B, F, seed=1):
    return np.random.default_rng(seed).normal(size=(B, F)).astype(np.float32)


def _port(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


def _close(got, ref, dtype):
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("batch_norm", [False, True], ids=["plain", "batchnorm"])
def test_mlp_matches_flax(batch_norm, dtype):
    """Eval mode; with BatchNorm the running statistics are seeded."""
    kw = dict(MLP_KW, use_batch_norm=batch_norm)
    net, variables, mod = _flax_pair(jax_pred.MLPStatePredictor,
                                     port_pred.MLPStatePredictor(**kw), kw, dtype)
    x = _x(16, mod.input_dim)
    ref = np.asarray(net.apply(variables, jnp.asarray(x), deterministic=True))
    got = _port(mod, x)
    assert got.shape == ref.shape == (16, MLP_KW["state_dim"]) and got.dtype == np.float32
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("config", ["small", "humanoid_cross"])
def test_cross_attention_matches_flax(config, dtype):
    kw = CROSS_SMALL if config == "small" else dict(jax_pred.PRESETS["humanoid_cross"][1])
    net, variables, mod = _flax_pair(jax_pred.CrossAttentionStatePredictor,
                                     port_pred.CrossAttentionStatePredictor(**kw), kw, dtype)
    x = _x(16, mod.input_dim)
    ref = np.asarray(net.apply(variables, jnp.asarray(x), deterministic=True))
    got = _port(mod, x)
    assert got.shape == ref.shape == (16, mod.state_dim)
    _close(got, ref, dtype)


@pytest.mark.parametrize("swap", [("Dense_0", "Dense_1"),
                                  ("MultiHeadDotProductAttention_0",
                                   "MultiHeadDotProductAttention_1")],
                         ids=["encoders", "attentions"])
def test_cross_attention_holds_its_two_directions_apart(swap):
    """Over a length-1 sequence the softmax weight is 1, so only the value
    and out projections carry a direction: with qpos and qvel of one width,
    the flax model with the two encoders (or attentions) exchanged is
    another function, and the port matches the unswapped one only."""
    net, variables, mod = _flax_pair(jax_pred.CrossAttentionStatePredictor,
                                     port_pred.CrossAttentionStatePredictor(**CROSS_SQUARE),
                                     CROSS_SQUARE, "float32")
    x = _x(16, mod.input_dim)
    p = dict(variables["params"])
    p[swap[0]], p[swap[1]] = p[swap[1]], p[swap[0]]
    swapped = np.asarray(net.apply({"params": p}, jnp.asarray(x), deterministic=True))
    ref = np.asarray(net.apply(variables, jnp.asarray(x), deterministic=True))
    got = _port(mod, x)
    _close(got, ref, "float32")
    assert np.abs(got - swapped).max() > 1e-2 * np.abs(ref).max()


def test_cross_attention_training_draws_one_mask_per_attention():
    """Training mode: each attention's flax dropout mask has shape (1, 1),
    shared by every sample and head, so its output is 0 or 1/keep times the
    eval one (the weight of a length-1 softmax is 1)."""
    torch.manual_seed(0)
    mod = port_pred.CrossAttentionStatePredictor(**CROSS_SQUARE, dropout_rate=0.5)
    x = torch.from_numpy(_x(8, mod.input_dim))
    H = mod.hidden_dim
    q_feat = mod.qpos_encoder(x[:, :4])
    v_feat = mod.qvel_encoder(x[:, 4:8])

    def attend(mha, kv, scale):
        v = torch.nn.functional.linear(kv, mha.in_proj_weight[2 * H:], mha.in_proj_bias[2 * H:])
        return mha.out_proj(scale * v)

    seen = set()
    for seed in range(6):
        got = mod.train()(x, torch.Generator().manual_seed(seed))
        matches = [(sq, sv) for sq in (0.0, 2.0) for sv in (0.0, 2.0)
                   if torch.allclose(got, mod.fusion_layer(torch.cat(
                       [attend(mod.attn_qpos_to_qvel, v_feat, sq),
                        attend(mod.attn_qvel_to_qpos, q_feat, sv)], -1)), atol=1e-6)]
        assert len(matches) == 1
        seen.add(matches[0])
    assert len(seen) > 1


def _ref_state_dict(module, seed, linear_index=None):
    """A seeded state_dict with the reference model's names (the port's
    own); `linear_index` renumbers an MLP's Linears (a reference Sequential
    with Dropouts between them)."""
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.normal(0.0, 0.3, tuple(v.shape)).astype(np.float32))
          for k, v in module.state_dict().items()}
    if linear_index is not None:
        lin = sorted({int(k.split(".")[1]) for k in sd})
        sd = {f"network.{linear_index[lin.index(int(k.split('.')[1]))]}.{k.split('.')[2]}": v
              for k, v in sd.items()}
    return sd


@pytest.mark.parametrize("family", ["mlp", "cross"])
def test_params_from_flax_inverts_the_jax_importer(family):
    """params_from_flax o torch_import.{mlp,cross_attention}_params is the
    identity on a seeded reference-layout state_dict."""
    if family == "mlp":
        mod = port_pred.MLPStatePredictor(**MLP_KW)
        sd = _ref_state_dict(mod, 3)
        flax_params = jax_import.mlp_params({k: v.numpy() for k, v in sd.items()})
    else:
        mod = port_pred.make_model("humanoid_cross")
        sd = _ref_state_dict(mod, 4)
        flax_params = jax_import.cross_attention_params(
            {k: v.numpy() for k, v in sd.items()}, mod.num_heads)
    back = params_from_flax(flax_params, mod)
    assert set(back) == set(sd) == set(mod.state_dict())
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


@pytest.fixture
def mlp_preset(monkeypatch):
    """An MLP preset in both registries (neither package ships one)."""
    monkeypatch.setitem(jax_pred.PRESETS, "mlp_test", (jax_pred.MLPStatePredictor, MLP_KW))
    monkeypatch.setitem(port_pred.PRESETS, "mlp_test", (port_pred.MLPStatePredictor, MLP_KW))
    return "mlp_test"


@pytest.mark.parametrize("preset", ["cartpole_attention", "humanoid_cross", "mlp"])
def test_reference_checkpoint_loads_as_in_jax(preset, mlp_preset, tmp_path):
    if preset == "mlp":
        preset = mlp_preset
        sd = _ref_state_dict(port_pred.make_model(preset), 5, linear_index=[0, 3, 6, 9])
    else:
        sd = _ref_state_dict(port_pred.make_model(preset), 6)
    path = str(tmp_path / "model.pth")
    torch.save(sd, path)
    net, params = jax_import.load_reference_checkpoint(path, preset)
    mod = port_import.load_reference_checkpoint(path, preset, device="cpu")
    x = _x(12, mod.input_dim, seed=7)
    ref = np.asarray(net.apply(params, jnp.asarray(x), deterministic=True))
    _close(_port(mod, x), ref, "float32")


def test_reference_checkpoint_with_batch_norm_is_refused(mlp_preset, tmp_path):
    """The JAX importer reads an MLP as a Linear/ReLU stack and would take
    BatchNorm weights for Linears; the port refuses such a state_dict."""
    sd = _ref_state_dict(port_pred.MLPStatePredictor(**MLP_KW, use_batch_norm=True), 8)
    path = str(tmp_path / "bn.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="BatchNorm"):
        port_import.load_reference_checkpoint(path, mlp_preset, device="cpu")


def test_reference_checkpoint_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    path = str(tmp_path / "model.pth")
    torch.save(port_pred.make_model("cartpole_attention").state_dict(), path)
    with pytest.raises(RuntimeError, match="cuda"):
        port_import.load_reference_checkpoint(path, "cartpole_attention")


@pytest.fixture
def tiny_runs(tmp_path, monkeypatch):
    """Two seeded 4-column trajectories with 1-column actions, as
    states/ and actions/ CSV dirs. TensorBoard, which the trainer writes
    to when it imports, is left out: its import takes seconds."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    rng = np.random.default_rng(9)
    for kind, cols in (("states", 4), ("actions", 1)):
        (tmp_path / kind).mkdir()
        for i in range(2):
            write_csv(str(tmp_path / kind / f"{kind}_{i}.csv"),
                      np.cumsum(rng.normal(0, 0.1, (30, cols)), axis=0))
    return str(tmp_path / "states"), str(tmp_path / "actions"), str(tmp_path / "ckpt")


@pytest.mark.parametrize("scan_epochs", [False, True], ids=["host", "scanned"])
@pytest.mark.parametrize("preset", ["humanoid_cross", "mlp"])
def test_trainer_takes_the_new_presets(preset, scan_epochs, mlp_preset, tiny_runs):
    """The cross model (dropout 0.18 in its attentions, an action encoder
    that the loss does not reach, clipped gradients) and the MLP (with
    dropout) train on the port's trainer."""
    overrides = ({"qpos_dim": 2, "qvel_dim": 2, "action_dim": 1, "hidden_dim": 8,
                  "num_heads": 2} if preset == "humanoid_cross"
                 else {"state_dim": 4, "action_dim": 1, "dropout_rate": 0.1})
    preset = mlp_preset if preset == "mlp" else preset
    sdir, adir, ck = tiny_runs
    cfg = TrainConfig(model_preset=preset, model_overrides=overrides, epochs=2, batch_size=8,
                      lr=1e-3, ckpt_dir=ck, ckpt_every=0, grad_clip=1.0,
                      scan_epochs=scan_epochs)
    out = train_model(sdir, adir, cfg, device="cpu")
    assert np.isfinite(out["final_train_loss"]) and np.isfinite(out["best_eval_loss"])
    assert out["model"].action_encoder.weight.grad is None if preset == "humanoid_cross" else True


def test_trainer_refuses_batch_norm(monkeypatch, tiny_runs):
    """JAX's train step carries no batch statistics, so neither trainer
    trains an MLP with BatchNorm."""
    kw = dict(MLP_KW, state_dim=4, action_dim=1, use_batch_norm=True)
    monkeypatch.setitem(port_pred.PRESETS, "mlp_bn", (port_pred.MLPStatePredictor, kw))
    sdir, adir, ck = tiny_runs
    with pytest.raises(ValueError, match="BatchNorm"):
        train_model(sdir, adir, TrainConfig(model_preset="mlp_bn", epochs=1, batch_size=8,
                                            ckpt_dir=ck), device="cpu")
