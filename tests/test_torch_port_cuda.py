"""PyTorch port: the CUDA rollout kernel against its plain PyTorch version,
on the card. Skips without one.

The card's machine has no jax, and tests/conftest.py imports it, so run
this file there without the conftest and without the xdist options:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from chip_smoke import seeded_inputs
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
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
