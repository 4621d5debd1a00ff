"""PyTorch port: the humanoid_collect_v2py task and collect_humanoid_v2py
(reference src/Humanoid_datacollection_v2.py) on the CPU.

- The control loop at matched noise against a JAX loop (JAX load_task's
  wrapped penalty dynamics and v2py cost under JAX make_mppi, the wrapped
  JAX coupled plant, advance_goal_v2py) in f64. Noise injection needs one
  replan a control step, so both run with replans_per_step=1: the 56-column
  rows, the actions, the gait state and the goal at qpos-level 1e-10 and
  velocity-level 1e-9.
- The two-replan path by its behaviour: one plan call equals two sample,
  weight and update passes on the generator's two draws, then one shift.
- collect_humanoid_v2py's layout (JAX tests/test_collect.py:101-122): 56
  columns, the first row's FD velocity zero, the next rows' the FD of qpos."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu.costs.humanoid import advance_goal_v2py as jax_advance_goal
from humanoid_mppi_rl_tpu.envs.tasks import load_plant as jax_load_plant
from humanoid_mppi_rl_tpu.envs.tasks import load_task as jax_load_task
from humanoid_mppi_rl_tpu.solver.mppi import MPPIState as JMPPIState
from humanoid_mppi_rl_tpu.solver.mppi import make_mppi as jax_make_mppi
from humanoid_mppi_rl_tpu_torch.collect import runner as prunner
from humanoid_mppi_rl_tpu_torch.costs.humanoid import GaitFDState
from humanoid_mppi_rl_tpu_torch.envs.tasks import load_task
from humanoid_mppi_rl_tpu_torch.solver.mppi import (MPPIState, make_mppi, mppi_weights,
                                                    rollout_costs_batched, shift_plan)
from humanoid_mppi_rl_tpu_torch.utils.trajio import read_csv

F64 = torch.float64
K, T, STEPS = 6, 3, 3
TASK = "humanoid_collect_v2py"


def test_v2py_loop_matches_jax():
    spec, jm, jdyn, jrun, jterm, jinit, cfg = jax_load_task(TASK)
    assert cfg.replans_per_step == 2 and (cfg.K, cfg.T) == (30, 75)
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=T, replans_per_step=1)
    jplan = jax.jit(jax_make_mppi(jdyn, jrun, cfg, terminal_fn=jterm))
    _, jplant_dyn = jax_load_plant(TASK, jinit)
    jstep = jax.jit(lambda s, u: jax_advance_goal(jplant_dyn(s, u, jnp.asarray(0))))
    rng = np.random.default_rng(5)
    noises = [cfg.sigma * rng.normal(size=(T, jm.nu, K)) for _ in range(STEPS)]
    inv_dt = 1.0 / jm.timestep

    plant = jinit
    ms = JMPPIState(U=jnp.zeros((T, jm.nu)), key=jax.random.PRNGKey(0))
    rows, actions, gait = [], [], []
    for noise in noises:
        rows.append(np.concatenate([np.asarray(plant.phys.qpos),
                                    (np.asarray(plant.phys.qpos)
                                     - np.asarray(plant.prev_qpos)) * inv_dt]))
        action, ms, _ = jplan(ms, plant, jnp.asarray(np.moveaxis(noise, 2, 0)))
        actions.append(np.asarray(action))
        plant = jstep(plant, action)
        gait.append([float(plant.committed_left), float(plant.last_left), float(plant.count)])

    runner = prunner.EpisodeRunner(TASK, mppi_override=dict(n_samples=K, horizon=T,
                                                            replans_per_step=1),
                                   device="cpu", dtype=F64)
    assert isinstance(runner.init_state, GaitFDState)
    seen = []
    update = lambda plant, params: (seen.append(plant), prunner._v2py_plant_update(plant,
                                                                                  params))[1]
    res = runner.run(max_steps=STEPS, chunk=STEPS, state_row_fn=prunner._v2py_state_row(inv_dt),
                     plant_update_fn=update, noise_fn=lambda i: torch.tensor(noises[i]))
    states, acts, _ = res.logger.arrays()
    assert states.shape == (STEPS, 56)
    np.testing.assert_allclose(states[:, :28], np.stack(rows)[:, :28], atol=1e-10)
    np.testing.assert_allclose(states[:, 28:], np.stack(rows)[:, 28:], atol=1e-9)
    np.testing.assert_allclose(acts, np.stack(actions), atol=1e-9)
    assert [[float(s.committed_left), float(s.last_left), float(s.count)]
            for s in seen] == gait
    np.testing.assert_allclose(res.final_qpos, np.asarray(plant.phys.qpos), atol=1e-10)


def test_two_replans_a_control_step():
    """replans_per_step=2: one plan call makes two sample, weight and update
    passes (the generator's first and second draws), acts on the second
    plan's first control, and shifts once; noise injection is refused."""
    spec, model, dyn, running, terminal, init, cfg = load_task(TASK, device="cpu", dtype=F64)
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=T)
    plan = make_mppi(dyn, running, cfg, terminal_fn=terminal)
    U0 = torch.tensor(np.random.default_rng(6).normal(0, 0.2, (T, model.nu)))
    gen = torch.Generator().manual_seed(7)
    action, ms, _ = plan(MPPIState(U=U0.clone(), generator=gen), init)

    draws = torch.Generator().manual_seed(7)
    U = U0
    for _ in range(2):
        noise = cfg.sigma * torch.randn((K, T, model.nu), generator=draws, dtype=F64)
        costs = rollout_costs_batched(dyn, running, terminal, cfg, init, U, noise)
        w, _ = mppi_weights(costs, cfg.temperature)
        U = U + torch.einsum("k,ktu->tu", w, noise)
    assert torch.equal(action, U[0]) and torch.equal(ms.U, shift_plan(U, cfg.tail_decay))
    with pytest.raises(ValueError, match="replans_per_step=1"):
        plan(ms, init, noise=torch.zeros(K, T, model.nu, dtype=F64))


def test_collect_humanoid_v2py_layout(tmp_path):
    out = prunner.collect_humanoid_v2py(n_episodes=2, out_dir=str(tmp_path), max_steps=4,
                                        mppi_override=dict(n_samples=4, horizon=2), chunk=2,
                                        shard_index=1, num_shards=2, device="cpu")
    assert out == [(1, 4)]
    (run,) = os.listdir(tmp_path)
    assert run.endswith("_001")
    arrays = {k: read_csv(os.path.join(tmp_path, run, f"{k}.csv")).reshape(4, -1)
              for k in ("states", "actions", "times")}
    assert {k: v.shape[1] for k, v in arrays.items()} == {"states": 56, "actions": 21,
                                                           "times": 1}
    st = arrays["states"]
    # qpos (28) then the FD velocity of qpos (28, not qvel's 27)
    np.testing.assert_array_equal(st[0, 28:], 0.0)
    for i in (1, 2, 3):
        np.testing.assert_allclose(st[i, 28:], (st[i, :28] - st[i - 1, :28]) / 0.005,
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(arrays["times"][:, 0], 0.005 * np.arange(4), atol=1e-6)
