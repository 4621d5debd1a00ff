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
