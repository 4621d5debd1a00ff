"""PyTorch port, slice 15: the graft entry points
(humanoid_mppi_rl_tpu_torch/graft_entry.py, the JAX repo's
__graft_entry__.py) on the CPU.

- `entry`'s replan (humanoid_collect on make_mppi at K=64, H=16) against
  JAX `__graft_entry__.entry()`'s on the same injected noise, f64:
  action, plan and beta at tests/test_torch_port_array_planner.py's 1e-9.
- `dryrun_multichip(2)` on a gloo group of two processes: every part's
  action finite, the ranks' data-parallel train step equal to one
  process's step on the whole batch (f32, 1e-6: the loss, the averaged
  gradients, the parameters where the gradient is not near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from humanoid_mppi_rl_tpu_torch import graft_entry

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)


def test_entry_replan_matches_jax_entry():
    """JAX's plan in f64 throughout: its MPPIState keeps the plan in f32,
    so the plan is cast as the port's f64 entry makes it."""
    jplan, (jms, jinit) = jax_graft.entry()
    assert jms.U.dtype == jnp.float32 and not np.asarray(jms.U).any()
    jms = jms.replace(U=jms.U.astype(jnp.float64))
    plan, (ms, init) = graft_entry.entry(device="cpu", dtype=torch.float64)
    K, T, nu = 64, ms.U.shape[0], ms.U.shape[1]
    assert (T, nu) == (16, 21) and tuple(jms.U.shape) == (T, nu)
    np.testing.assert_array_equal(init.qpos.numpy(), np.asarray(jinit.qpos))
    noise = 0.3 * np.random.default_rng(0).normal(size=(K, T, nu))
    ja, jms2, jdiag = jax.jit(jplan)(jms, jinit, jnp.asarray(noise))
    a, ms2, diag = plan(ms, init, noise=torch.tensor(noise))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ms2.U.numpy(), np.asarray(jms2.U), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(diag.beta), float(jdiag.beta), rtol=1e-9)
    assert np.abs(a.numpy()).max() > 1e-3


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_on_two_gloo_ranks(dryrun):
    assert len(dryrun) == 2
    for rank in dryrun:
        for part, width in (("array", 21), ("kernel", 1), ("estimator", 12), ("flash", 12)):
            assert rank[part].shape == (width,) and bool(torch.isfinite(rank[part]).all())
    # the ranks of a sharded replan compute the same action
    for part in ("array", "kernel", "estimator", "flash"):
        torch.testing.assert_close(dryrun[0][part], dryrun[1][part], rtol=0, atol=0)
    # the surrogate's forward and the estimator kernel's plain version, f32
    torch.testing.assert_close(dryrun[0]["flash"], dryrun[0]["estimator"], rtol=0, atol=1e-5)


def test_data_parallel_train_step_equals_the_whole_batch_step(dryrun):
    """The ranks' loss and averaged gradients equal one process's on the
    whole batch; so do the parameters after the Adam step, wherever the
    gradient is not near zero: Adam's first step divides each gradient by
    its own magnitude, so there a rounding difference of the gradient moves
    the parameter by up to the learning rate."""
    net, opt = graft_entry.train_net()
    x, y = graft_entry.train_inputs(4)
    loss = graft_entry.data_parallel_train_step(net, opt, x, y)
    grads = {k: p.grad for k, p in net.named_parameters()}
    params = net.state_dict()
    big = {k: g.abs() > 1e-4 for k, g in grads.items()}
    assert sum(int(b.sum()) for b in big.values()) > 0.5 * sum(b.numel() for b in big.values())
    for rank in dryrun:
        torch.testing.assert_close(rank["loss"], loss, rtol=0, atol=1e-6)
        for k, g in grads.items():
            torch.testing.assert_close(rank["grads"][k], g, rtol=0, atol=1e-6)
            torch.testing.assert_close(rank["params"][k][big[k]], params[k][big[k]], rtol=0,
                                       atol=1e-6)
    moved = [float((v - graft_entry.train_net()[0].state_dict()[k]).abs().max())
             for k, v in params.items()]
    assert max(moved) > 1e-4
