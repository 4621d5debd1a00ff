"""PyTorch port: the array planner (solver/mppi.make_mppi over the penalty
engine batched over K, EpisodeRunner(use_kernel=False)) on the CPU in f64.

- Against the kernel planner (solver/kernel_mppi, the rollout kernel's
  plain version) on the same injected noise, with the kernel's own cost
  evaluated on the array engine's states (chip_smoke.kernel_cost_on_states),
  so that the two planners differ only by their physics: costs rtol 1e-9,
  actions and plans atol 1e-9, K=8, T=3, for the humanoid's three costs.
- EpisodeRunner("humanoid_collect", use_kernel=False) against a JAX loop of
  JAX make_mppi (penalty dynamics, make_costs) and the JAX coupled plant at
  matched noise: rows, actions and times at qpos-level 1e-10 and
  velocity-level 1e-9 (tests/test_kernel.py's)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import kernel_cost_on_states
from humanoid_mppi_rl_tpu.envs.tasks import load_task as jax_load_task
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu.solver.mppi import MPPIState as JMPPIState
from humanoid_mppi_rl_tpu.solver.mppi import make_mppi as jax_make_mppi
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState, make_mppi, rollout_costs_batched

ROOT = os.path.join(os.path.dirname(__file__), "..")
F64 = torch.float64
K, T, STEPS = 8, 3, 3


def _start(model, seed):
    """A perturbed standing pose sunk 5 cm into the floor, moving."""
    rng = np.random.default_rng(seed)
    qpos = np.asarray(model.qpos0) + rng.normal(0, 0.05, model.nq)
    qpos[3:7] /= np.linalg.norm(qpos[3:7])
    qpos[2] -= 0.05
    return qpos, rng.normal(0, 0.3, model.nv)


@pytest.mark.parametrize("task", ["humanoid_collect", "humanoid", "humanoid_hard"])
def test_array_planner_matches_kernel_planner(task):
    spec, model, dyn, *_, cfg = load_task(task, device="cpu", dtype=F64)
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=T)
    qpos, qvel = _start(model, seed=1)
    x0 = dyn.engine.forward(torch.tensor(qpos), torch.tensor(qvel), torch.tensor(0.0, dtype=F64))
    rng = np.random.default_rng(2)
    U = torch.tensor(rng.normal(0, 0.3, (T, model.nu)))
    noise = torch.tensor(cfg.sigma * rng.normal(size=(T, model.nu, K)))
    running, terminal = kernel_cost_on_states(model, spec.kernel_cost_factory,
                                              spec.cost_kwargs, T)
    kplan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, spec.cost_kwargs,
                             device="cpu")
    costs_k, _, _ = kplan.rollouts(x0.qpos[:, None].expand(-1, K).contiguous(),
                                   x0.qvel[:, None].expand(-1, K).contiguous(),
                                   torch.zeros(1, K, dtype=F64), U, noise)
    costs_a = rollout_costs_batched(dyn, running, terminal, cfg, x0, U, noise.permute(2, 0, 1))
    torch.testing.assert_close(costs_a, costs_k, rtol=1e-9, atol=0)

    aplan = make_mppi(dyn, running, cfg, terminal_fn=terminal)
    st = lambda: MPPIState(U=U.clone(), generator=torch.Generator())
    a_k, ms_k, d_k = kplan(st(), x0, noise=noise)
    a_a, ms_a, d_a = aplan(st(), x0, noise=noise.permute(2, 0, 1))
    torch.testing.assert_close(a_a, a_k, rtol=0, atol=1e-9)
    torch.testing.assert_close(ms_a.U, ms_k.U, rtol=0, atol=1e-9)
    torch.testing.assert_close(d_a.beta, d_k.beta, rtol=1e-9, atol=0)


@pytest.fixture(scope="module")
def jax_loop_parts():
    """JAX load_task("humanoid_collect") at K, T with its plan jitted, and
    the JAX coupled plant step jitted: built once."""
    spec, model, dyn, running, terminal, _, cfg = jax_load_task("humanoid_collect")
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=T)
    plan = jax.jit(jax_make_mppi(dyn, running, cfg, terminal_fn=terminal))
    jpm = build_from_mjcf(os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets",
                                       "humanoid.xml"), include_self_collisions=True)
    return model, cfg, plan, jpm, jax.jit(lambda s, u: jeng.step(jpm, s, u))


def test_episode_runner_array_planner_matches_jax_loop(jax_loop_parts):
    jm, cfg, jplan, jpm, jstep = jax_loop_parts
    qpos, qvel = _start(jm, seed=3)
    rng = np.random.default_rng(4)
    noises = [cfg.sigma * rng.normal(size=(T, jm.nu, K)) for _ in range(STEPS)]

    plant = jeng.forward(jpm, jnp.asarray(qpos), jnp.asarray(qvel))
    ms = JMPPIState(U=jnp.zeros((T, jm.nu)), key=jax.random.PRNGKey(0))
    rows, actions, times = [], [], []
    for noise in noises:
        rows.append(np.concatenate([np.asarray(plant.qpos), np.asarray(plant.qvel)]))
        times.append(float(plant.time))
        action, ms, _ = jplan(ms, plant, jnp.asarray(np.moveaxis(noise, 2, 0)))
        actions.append(np.asarray(action))
        plant = jstep(plant, action)

    runner = EpisodeRunner("humanoid_collect", mppi_override=dict(n_samples=K, horizon=T),
                           device="cpu", dtype=F64)
    assert not runner.use_kernel
    init = runner.plant_dyn.engine.forward(torch.tensor(qpos), torch.tensor(qvel))
    res = runner.run(max_steps=STEPS, chunk=STEPS, init_state=init,
                     noise_fn=lambda i: torch.tensor(noises[i]))
    states, acts, ts = res.logger.arrays()
    assert states.shape == (STEPS, 55) and acts.shape == (STEPS, 21)
    np.testing.assert_allclose(states[:, :28], np.stack(rows)[:, :28], atol=1e-10)
    np.testing.assert_allclose(states[:, 28:], np.stack(rows)[:, 28:], atol=1e-9)
    np.testing.assert_allclose(acts, np.stack(actions), atol=1e-9)
    np.testing.assert_allclose(ts, times, atol=1e-12)
    np.testing.assert_allclose(res.final_qpos, np.asarray(plant.qpos), atol=1e-10)
