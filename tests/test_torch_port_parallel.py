"""PyTorch port, slice 13: K-sharded MPPI over torch.distributed
(parallel/{distributed,mesh}.py) and blocked noise (solver/mppi.
sample_noise_blocked), on the CPU.

The card is one H100, so multi-rank runs are gloo groups of 2 and 4
processes here (tests/torch_port_parallel_ranks.py; the 2-rank group
initializes through maybe_initialize's environment variables). Against
the JAX package: sharded_update_op under shard_map on the conftest's
virtual mesh of 2 and 4 devices, same per-shard costs and noise, f64:
update, beta and weights to 1e-12; the distributed helpers in one
process. Against the port's single-device planners (cartpole, K=16, T=3,
f64, the rollout kernel's plain version): the sharded kernel planner and
the sharded array planner with the same injected noise, and with
noise_block=4 and no noise (the blocked field independent of the rank
count), to 1e-12."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from humanoid_mppi_rl_tpu.parallel import distributed as jdist
from humanoid_mppi_rl_tpu.parallel import mesh as jmesh
from humanoid_mppi_rl_tpu.solver.mppi import MPPIConfig as JConfig
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.parallel import distributed as tdist
from humanoid_mppi_rl_tpu_torch.parallel.mesh import make_mesh
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
from humanoid_mppi_rl_tpu_torch.solver.mppi import (MPPIConfig, MPPIState, make_mppi,
                                                    replan_seed, sample_noise_blocked)
from torch_port_parallel_ranks import (BLOCK, F64, K, T, array_noise, join_group,
                                       kernel_noise, kernel_params, planner_configs, start_group,
                                       update_config, update_inputs)

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

RANKS = (2, 4)
PLANNER_OUTPUTS = ("action", "U", "beta", "mean_cost", "ess", "weight_entropy", "update_norm")


@pytest.fixture(scope="module")
def groups():
    """rank outputs of a 2-rank group (environment rendezvous) and of a
    4-rank group (file rendezvous), run side by side."""
    two, four = start_group(2, from_env=True), start_group(4)
    return {2: join_group(two), 4: join_group(four)}


@pytest.fixture(scope="module")
def single():
    """The single-device planners' outputs on the same inputs."""
    spec, model, dyn, running, terminal, init, cfg = load_task("cartpole", device="cpu",
                                                               dtype=F64)
    seeded = lambda: MPPIState.seeded(3, T, model.nu, device="cpu", dtype=F64)
    cfg_k, cfg_kb = planner_configs(cfg)
    out = {}
    for key, c, noise in (("kernel", cfg_k, torch.tensor(kernel_noise(model.nu))),
                          ("kernel_blocked", cfg_kb, None)):
        plan = make_kernel_mppi(model, spec.kernel_cost_factory, c, spec.cost_kwargs,
                                device="cpu")
        a, st, d = plan(seeded(), init, params=kernel_params(), noise=noise)
        out[key] = dict(action=a, U=st.U, **dataclasses.asdict(d))
    for key, c, noise in (("array", cfg_k, torch.tensor(array_noise(model.nu))),
                          ("array_blocked", cfg_kb, None)):
        a, st, d = make_mppi(dyn, running, c, terminal_fn=terminal)(seeded(), init, noise=noise)
        out[key] = dict(action=a, U=st.U, **dataclasses.asdict(d))
    return out


@pytest.mark.parametrize("n", RANKS)
def test_sharded_update_op_matches_jax_shard_map(n, groups):
    """Each rank's update and beta, and its slice of the weights, equal
    JAX's shard_map of sharded_update_op over n virtual devices: 1e-12."""
    costs, noise = update_inputs()
    mesh = jmesh.make_mesh(n)
    op = jmesh.sharded_update_op(mesh, update_config(JConfig))
    f = jax.jit(jmesh.shard_map(op, mesh=mesh, in_specs=(P("k"), P("k")),
                                out_specs=(P(), (P("k"), P())), check_vma=False))
    update, (w, beta) = f(jnp.asarray(costs), jnp.asarray(noise))
    for r, out in enumerate(groups[n]):
        got = out["update_op"]
        sl = slice(r * K // n, (r + 1) * K // n)
        np.testing.assert_allclose(got["update"].numpy(), np.asarray(update), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(w)[sl], rtol=0, atol=1e-12)
        assert abs(float(got["beta"]) - float(beta)) < 1e-12


def _same(got: dict, want: dict, what: str):
    for k in PLANNER_OUTPUTS:
        np.testing.assert_allclose(torch.as_tensor(got[k]).numpy(),
                                   torch.as_tensor(want[k]).numpy(), rtol=1e-12, atol=1e-12,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("n", RANKS)
def test_sharded_kernel_mppi_matches_make_kernel_mppi(n, groups, single):
    """The rollout-kernel planner sharded over n ranks with the global
    (T, nu, K) noise injected, params' slots 11/12 set: every rank's
    action, plan and diagnostics equal make_kernel_mppi's, 1e-12."""
    for out in groups[n]:
        _same(out["kernel"], single["kernel"], f"{n} ranks")


@pytest.mark.parametrize("n", RANKS)
def test_sharded_mppi_matches_make_mppi(n, groups, single):
    """The array planner (the cartpole's penalty engine over K) sharded
    over n ranks with the global (K, T, nu) noise injected equals
    make_mppi: 1e-12."""
    for out in groups[n]:
        _same(out["array"], single["array"], f"{n} ranks")


@pytest.mark.parametrize("n", RANKS)
def test_noise_block_field_does_not_depend_on_the_rank_count(n, groups, single):
    """noise_block=4 and no injected noise: each rank draws its blocks of
    the field from the same seeded state, so both sharded planners equal
    the single-device ones drawing the whole field, 1e-12."""
    for out in groups[n]:
        _same(out["kernel_blocked"], single["kernel_blocked"], f"kernel, {n} ranks")
        _same(out["array_blocked"], single["array_blocked"], f"array, {n} ranks")


def test_sample_noise_blocked_is_layout_independent():
    """A field drawn whole equals the same blocks drawn in any split at
    their offsets; the replan's seed advances the state's generator."""
    gen = torch.Generator().manual_seed(11)
    seed = replan_seed(gen)
    assert replan_seed(gen) != seed
    whole = sample_noise_blocked(seed, T, 3, K, BLOCK, 0, F64, "cpu")
    for n in (2, 4):
        kl = K // n
        parts = [sample_noise_blocked(seed, T, 3, kl, BLOCK, r * kl // BLOCK, F64, "cpu")
                 for r in range(n)]
        assert torch.equal(torch.cat(parts, -1), whole)
    assert whole.shape == (T, 3, K) and abs(float(whole.std()) - 1.0) < 0.25
    with pytest.raises(ValueError):
        sample_noise_blocked(seed, T, 3, K, 5, 0, F64, "cpu")


def test_noise_block_is_accepted_and_shared_by_both_planners():
    """make_mppi and make_kernel_mppi take noise_block (both refused it
    before) and draw sample_noise_blocked's field, one sample-major, one
    (T, nu, K): make_mppi with zero costs updates by the field's mean; the
    kernel planner's draw equals that field injected."""
    cfg = MPPIConfig(n_samples=K, horizon=T, sigma=0.3, noise_block=BLOCK)
    zero_cost = lambda x, u, t: torch.zeros(u.shape[0], dtype=u.dtype)
    plan = make_mppi(lambda x, u, t: x, zero_cost, cfg)
    _, st, _ = plan(MPPIState.seeded(4, T, 2, device="cpu", dtype=F64), torch.zeros(1, dtype=F64))
    field = sample_noise_blocked(replan_seed(torch.Generator().manual_seed(4)), T, 2, K, BLOCK,
                                 0, F64, "cpu")
    torch.testing.assert_close(st.U[:-1], 0.3 * field.mean(-1)[1:], rtol=1e-12, atol=1e-12)
    spec, model, _, _, _, init, tcfg = load_task("cartpole", device="cpu", dtype=F64)
    kcfg = dataclasses.replace(tcfg, n_samples=K, horizon=T, noise_block=BLOCK)
    kplan = make_kernel_mppi(model, spec.kernel_cost_factory, kcfg, spec.cost_kwargs,
                             device="cpu")
    drawn = kplan(MPPIState.seeded(4, T, 1, device="cpu", dtype=F64), init)
    field = sample_noise_blocked(replan_seed(torch.Generator().manual_seed(4)), T, 1, K, BLOCK,
                                 0, F64, "cpu")
    injected = kplan(MPPIState.seeded(4, T, 1, device="cpu", dtype=F64), init,
                     noise=kcfg.sigma * field)
    assert torch.equal(drawn[0], injected[0]) and torch.equal(drawn[1].U, injected[1].U)


def test_distributed_helpers_match_jax(groups):
    """Without launcher variables maybe_initialize does nothing in both
    packages; process_info and episode_shard give JAX's answers in one
    process, and in the groups each rank its own id and share."""
    assert tdist.maybe_initialize(device="cpu") is False and jdist.maybe_initialize() is False
    ji, ti = jdist.process_info(), tdist.process_info()
    assert set(ti) == set(ji)
    assert (ti["process_id"], ti["num_processes"]) == (ji["process_id"], ji["num_processes"])
    for n_ep, idx, n in ((10, 0, 3), (10, 2, 3), (7, 1, 4), (4, None, None)):
        assert list(tdist.episode_shard(n_ep, idx, n)) == list(jdist.episode_shard(n_ep, idx, n))
    for n, outs in groups.items():
        assert [o["info"]["process_id"] for o in outs] == list(range(n))
        assert all(o["info"]["num_processes"] == n for o in outs)
        assert sorted(e for o in outs for e in o["shard"]) == list(range(10))
    with pytest.raises(RuntimeError):
        make_mesh(device="cpu")
