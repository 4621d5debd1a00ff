"""PyTorch port: the coupled constraint tier over a leading K axis
(physics/engine.step(solver="coupled") on a batch, physics/newton and
physics/contact batched) and the planner on it (EpisodeRunner(
planner_solver="coupled"): make_mppi over make_physics_dynamics(
solver="coupled")), against the JAX package and the reference loop on
the CPU in f64.

- The batched step against jax.vmap of JAX step(solver="coupled") on the
  cartpole, hopper, Go1 and arm5 planner snapshots, two chained steps over
  K=8 (qpos 1e-10, qvel 1e-9, tests/test_torch_port_plant.py's).
- The batched step against the port's one-sample step, sample by sample,
  on all five robots (rtol = atol = 1e-12; the Newton loop stops near
  round-off, so a sample's iteration count can differ by batching), and
  the masked loop against the early exit, bit for bit.
- The planner against JAX make_mppi over the coupled tier on the hopper,
  K=8, T=3, the same injected noise (action and plan 1e-9).
- The cartpole planner against tests/test_trajectory_parity.py's
  CartpoleOracle (the reference loop over MuJoCo C), K=8, T=100: the
  oracle's plan, state and noise at each of its first 12 replans, from
  the cart half-way to its slider limit (x = 0.5, the pole down), so that
  replans 8-11 have samples on the limit (|du| < 1e-9 on each; at least 3
  limit-active)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import arm5_states, cartpole_inputs, go1_states, hopper_states, seeded_inputs
from humanoid_mppi_rl_tpu.dynamics.physics import make_physics_dynamics as jax_dynamics
from humanoid_mppi_rl_tpu.envs.tasks import load_task as jax_load_task
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.solver.mppi import MPPIState as JState
from humanoid_mppi_rl_tpu.solver.mppi import make_mppi as jax_make_mppi
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState

torch.set_num_threads(1)

F64 = torch.float64
K = 8
ROBOTS = ("cartpole", "hopper", "go1", "arm5")


def batch_states(model, robot: str, n: int, seed: int = 0):
    """numpy qpos (n, nq), qvel (n, nv), ctrl (n, nu) from the repo's
    shared inputs: the cartpole past and inside its slider limit, the
    hopper's four foot poses, the Go1's seven poses, arm5's five, the
    humanoid's seeded states (feet in the floor)."""
    if robot == "cartpole":
        qpos, qvel = (x.numpy() for x in cartpole_inputs(model, n, 1, F64, seed, "cpu")[:2])
    elif robot == "hopper":
        qpos, qvel = hopper_states(model, n, seed)
    elif robot == "go1":
        qpos, qvel = go1_states(model, n, seed)
    elif robot == "arm5":
        qpos, qvel = arm5_states(model, n, seed)
    else:
        qpos, qvel = (x.numpy() for x in seeded_inputs(model, n, 1, F64, seed, "cpu")[:2])
    ctrl = np.random.default_rng(seed + 7).normal(0, 0.5, (n, model.nu))
    return np.ascontiguousarray(qpos.T), np.ascontiguousarray(qvel.T), ctrl


def port_batch(eng, qpos, qvel):
    return eng.forward(torch.tensor(qpos), torch.tensor(qvel),
                       torch.zeros(qpos.shape[0], dtype=F64))


@pytest.mark.parametrize("robot", ROBOTS)
def test_batched_coupled_step_matches_jax_vmap(robot):
    """Two chained batched coupled steps equal jax.vmap of JAX's."""
    pm = load_model(robot)
    jm = jax_load_task({"go1": "go1", "arm5": "arm5_reach"}.get(robot, robot))[1]
    eng = Engine(pm, "cpu", F64)
    qpos, qvel, ctrl = batch_states(pm, robot, K, seed=1)
    jstep = jax.jit(jax.vmap(lambda s, u: jeng.step(jm, s, u, solver="coupled")))
    js = jax.vmap(lambda q, v: jeng.forward(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel))
    ps = port_batch(eng, qpos, qvel)
    for i in range(2):
        js = jstep(js, jnp.asarray(ctrl))
        ps = eng.step(ps, torch.tensor(ctrl), solver="coupled")
        np.testing.assert_allclose(ps.qpos.numpy(), np.asarray(js.qpos), atol=1e-10,
                                   err_msg=f"{robot} step {i}")
        np.testing.assert_allclose(ps.qvel.numpy(), np.asarray(js.qvel), atol=1e-9,
                                   err_msg=f"{robot} step {i}")


@pytest.mark.parametrize("robot", ROBOTS + ("humanoid",))
def test_batched_coupled_step_equals_one_sample(robot):
    """Each sample of a batched step equals its one-sample step; the
    masked Newton loop (the card's default) and the early exit give the
    same bits; the iteration counts come per sample."""
    pm = load_model(robot)
    eng = Engine(pm, "cpu", F64)
    qpos, qvel, ctrl = batch_states(pm, robot, K, seed=2)
    info = {}
    masked = eng.step(port_batch(eng, qpos, qvel), torch.tensor(ctrl), early_exit=False,
                      info=info)
    early = eng.step(port_batch(eng, qpos, qvel), torch.tensor(ctrl), early_exit=True)
    assert torch.equal(masked.qpos, early.qpos) and torch.equal(masked.qvel, early.qvel)
    assert info["iterations"].shape == (K,) and int(info["iterations"].max()) <= 25
    for k in range(K):
        one = eng.step(eng.forward(torch.tensor(qpos[k]), torch.tensor(qvel[k])),
                       torch.tensor(ctrl[k]))
        for name in ("qpos", "qvel", "xpos", "body_vel"):
            torch.testing.assert_close(getattr(early, name)[k], getattr(one, name),
                                       rtol=1e-12, atol=1e-12, msg=f"{robot} {name} {k}")


def test_coupled_planner_matches_jax_make_mppi():
    """EpisodeRunner(planner_solver="coupled") plans the hopper with
    make_mppi over the batched coupled step; JAX's runner builds the same
    from make_physics_dynamics(model, solver="coupled"). Same plan, state
    and noise: the same action and shifted plan."""
    cfg_over = dict(n_samples=K, horizon=3)
    runner = EpisodeRunner("hopper", planner_solver="coupled", mppi_override=cfg_over,
                           device="cpu", dtype=F64)
    spec, jm, _, running, terminal, init, cfg = jax_load_task("hopper")
    cfg = dataclasses.replace(cfg, **cfg_over)
    jplan = jax.jit(jax_make_mppi(jax_dynamics(jm, solver="coupled"), running, cfg,
                                  terminal_fn=terminal))
    rng = np.random.default_rng(5)
    qpos, qvel, _ = batch_states(runner.model, "hopper", 1, seed=5)
    U = rng.normal(0, 0.3, (cfg.T, jm.nu))
    noise = rng.normal(0, cfg.sigma, (K, cfg.T, jm.nu))
    js = jeng.forward(jm, jnp.asarray(qpos[0]), jnp.asarray(qvel[0]))
    ja, jms, _ = jplan(JState(U=jnp.asarray(U), key=jax.random.PRNGKey(0)), js,
                       noise=jnp.asarray(noise))
    ps = runner.plant_dyn.engine.forward(torch.tensor(qpos[0]), torch.tensor(qvel[0]))
    ms = MPPIState.seeded(0, cfg.T, jm.nu, device="cpu", dtype=F64)
    pa, pms, _ = runner.plan(MPPIState(U=torch.tensor(U), generator=ms.generator), ps,
                             torch.tensor(noise))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), atol=1e-9)
    np.testing.assert_allclose(pms.U.numpy(), np.asarray(jms.U), atol=1e-9)


def test_cartpole_coupled_planner_matches_reference_loop():
    """The reference loop's first 12 replans (tests/test_trajectory_parity.py
    CartpoleOracle, MuJoCo C, K=8, T=100) from x = 0.5: the port's coupled
    planner, handed the oracle's state, plan and noise, gives its action
    to 1e-9, on replans where samples hit the slider's limit too (from x =
    0 none of the first 12 does at K=8)."""
    from test_trajectory_parity import CartpoleOracle, mujoco

    runner = EpisodeRunner("cartpole", planner_solver="coupled",
                           mppi_override=dict(n_samples=K), device="cpu", dtype=F64)
    cfg, eng = runner.cfg, runner.plant_dyn.engine
    assert (cfg.T, cfg.temperature, cfg.sigma) == (100, 1.0, 1.0)
    oracle = CartpoleOracle(K, cfg.T, cfg.temperature, cfg.sigma, cfg.tail_decay)
    oracle.data.qpos[0] = 0.5
    mujoco.mj_forward(oracle.model, oracle.data)
    gen = MPPIState.seeded(0, cfg.T, 1, device="cpu", dtype=F64).generator
    rng = np.random.default_rng(1234)
    limit_active = 0
    for i in range(12):
        noise = rng.normal(size=(1, cfg.T, K)) * cfg.sigma
        state = eng.forward(torch.tensor(oracle.data.qpos.copy()),
                            torch.tensor(oracle.data.qvel.copy()))
        ms = MPPIState(U=torch.tensor(oracle.U.T.copy()), generator=gen)
        action, _, _ = runner.plan(ms, state, torch.tensor(noise.transpose(2, 1, 0).copy()))
        ref = oracle.control_step(noise)
        limit_active += bool(oracle.last_limit_hit)
        du = float(np.max(np.abs(action.numpy() - ref)))
        assert du < 1e-9, f"replan {i} (limit {oracle.last_limit_hit}): |du| {du}"
    assert limit_active >= 3, f"only {limit_active} limit-active replans"
