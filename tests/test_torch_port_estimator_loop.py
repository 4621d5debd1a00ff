"""PyTorch port: the closed estimator loop (collect/estimator.EstimatorRunner)
against the JAX package on the CPU, on the Go1 coupled plant.

JAX's EstimatorRunner has no noise hook, so the reference is its own
control_step recipe (collect/estimator.py:396-415): make_learned_dynamics
-> make_fd_time_augmented -> make_mppi(...).plan(noise=...) ->
physics.step, with the same noise fed to the port's runner through
noise_fn. Both run a small surrogate (quadruped_attention at width 32, one
layer, the head scaled by 0.01 so that its deltas are small) in f64 on
both sides, and the plant in f64. Two constructions: scripts/quad_pipeline.py's
(qpos state, FD/time augmentation, ego columns, accumulate update, ctrl
clamp, home-seeded plan, the FD gait cost) and the default one ([qpos;
qvel] state, replace update, quadruped_estimator_costs).

Tolerances as tests/test_torch_port_go1_plant.py's: qpos 1e-10, qvel and
actions 1e-9, times 1e-15.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu.collect import estimator as jest
from humanoid_mppi_rl_tpu.dynamics.learned import (
    flat_state_from_physics as jax_flat_state, make_learned_dynamics as jax_learned)
from humanoid_mppi_rl_tpu.models.predictors import make_model as jax_make_model
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu.solver import mppi as jmppi
from humanoid_mppi_rl_tpu_torch.collect import estimator as pest
from humanoid_mppi_rl_tpu_torch.models.convert import params_from_flax
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GO1_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "go1.xml")
K, T, STEPS, CHUNK = 8, 3, 5, 2
SMALL = dict(hidden_dim=32, attn_layers=1, dropout_rate=0.0)


@pytest.fixture(scope="module")
def jax_plant():
    m = build_from_mjcf(GO1_XML, include_self_collisions=True)
    return (m, jax.jit(lambda q, v: jeng.forward(m, q, v)),
            jax.jit(lambda s, u: jeng.step(m, s, u)))


def _surrogate(state_dim, seed=0):
    """(flax module in f64, its f64 params, the port module in f64): the
    same weights, every bias and LayerNorm term nonzero, the head x 0.01."""
    net = jax_make_model("quadruped_attention", state_dim=state_dim, compute_dtype=jnp.float64,
                         **SMALL)
    F = net.state_dim + net.action_dim
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, F)), deterministic=True)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)
    head = params["params"]["Dense_1"]
    head["kernel"] = head["kernel"] * np.float32(0.01)
    head["bias"] = head["bias"] * np.float32(0.01)
    mod = make_model("quadruped_attention", state_dim=state_dim, **SMALL)
    mod.load_state_dict(params_from_flax(params, mod))
    return net, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params), mod.double()


def _construction(case, m):
    """(cfg, costs, runner kwargs, run kwargs) of one construction, both
    sides' costs: quad_pipeline.py:233-270's, or the default."""
    home = np.asarray(dict(m.keyframes)["home"])
    base = dataclasses.replace(jest.ESTIMATOR_CONFIGS["quadruped"], n_samples=K, horizon=T)
    if case == "pipeline":
        lo = tuple(float(a.ctrlrange[0]) for a in m.actuators)
        hi = tuple(float(a.ctrlrange[1]) for a in m.actuators)
        cfg = dataclasses.replace(base, update_mode="accumulate", sigma=0.3 * 0.6,
                                  tail_decay=0.0, ctrl_low=lo, ctrl_high=hi,
                                  clamp_rollout_ctrl=True)
        costs = (jest.quadruped_fd_gait_estimator_costs(home[7:19], dt=float(m.timestep)),
                 pest.quadruped_fd_gait_estimator_costs(home[7:19], dt=float(m.timestep)))
        runner = dict(fd_time_augment=19, ego_cols=(0, 1), state_dim=19)
        run = dict(init_qpos=home, init_plan=home[7:19])
    else:
        cfg = base
        costs = (jest.quadruped_estimator_costs(), pest.quadruped_estimator_costs())
        runner = dict(fd_time_augment=None, ego_cols=None, state_dim=37)
        run = dict(init_qpos=None, init_plan=None)
    return cfg, costs, runner, run


def _noise(cfg, nu, seed=11):
    rng = np.random.default_rng(seed)
    return [cfg.sigma * rng.normal(size=(K, T, nu)) for _ in range(STEPS)]


def _jax_reference(jax_plant, case, net, params, noises):
    """quad_pipeline's construction through JAX's control_step recipe, the
    injected noise in place of the key's draw: rows, actions, times."""
    m, jfwd, jstep = jax_plant
    cfg, (jcosts, _), rk, run = _construction(case, m)
    dyn = jax_learned(net.apply, params, ego_cols=rk["ego_cols"])
    if case == "pipeline":
        extract = lambda plant: plant.qpos
        dyn, augment = jest.make_fd_time_augmented(dyn, rk["fd_time_augment"], float(m.timestep))
        state_of = lambda plant: augment(extract(plant), plant.time)
    else:
        state_of = jax_flat_state
    make_plan = jmppi.make_mppi(dyn, jcosts[0], cfg, terminal_fn=jcosts[1],
                                batched_dynamics=case == "pipeline")
    plan = jax.jit(lambda ms, x, noise: make_plan(ms, x, noise=noise))
    qpos = m.qpos0 if run["init_qpos"] is None else run["init_qpos"]
    plant = jfwd(jnp.asarray(qpos), jnp.zeros(m.nv))
    ms = jmppi.MPPIState.seeded(0, cfg.T, m.nu)
    if run["init_plan"] is not None:
        ms = ms.replace(U=jnp.tile(jnp.asarray(run["init_plan"], jnp.float32), (cfg.T, 1)))
    rows, actions, times = [], [], []
    for noise in noises:
        rows.append(np.concatenate([np.asarray(plant.qpos), np.asarray(plant.qvel)]))
        times.append(float(plant.time))
        action, ms, _ = plan(ms, state_of(plant), jnp.asarray(noise))
        actions.append(np.asarray(action, np.float64))
        plant = jstep(plant, action)
    return np.stack(rows), np.stack(actions), np.array(times)


@pytest.mark.parametrize("case", ["pipeline", "default"])
def test_estimator_runner_matches_jax(jax_plant, case):
    """5 control steps, K=8, T=3, f64, matched noise, rows fetched in
    chunks of 2."""
    m = jax_plant[0]
    cfg, (_, pcosts), rk, run = _construction(case, m)
    net, params, mod = _surrogate(rk["state_dim"])
    noises = _noise(cfg, m.nu)
    want = _jax_reference(jax_plant, case, net, params, noises)
    runner = pest.EstimatorRunner(
        "go1_collect", mod, cfg, *pcosts,
        state_fn=(lambda plant: plant.qpos) if case == "pipeline" else None,
        fd_time_augment=rk["fd_time_augment"], ego_cols=rk["ego_cols"],
        device="cpu", dtype=torch.float64)
    log = runner.run(n_steps=STEPS, seed=0, chunk=CHUNK,
                     noise_fn=lambda i: torch.from_numpy(noises[i]), **run)
    states, actions, times = log.arrays()
    assert states.shape == (STEPS, 37) and actions.shape == (STEPS, 12)
    np.testing.assert_allclose(states[:, :19], want[0][:, :19], atol=1e-10)
    np.testing.assert_allclose(states[:, 19:], want[0][:, 19:], atol=1e-9)
    np.testing.assert_allclose(actions, want[1], atol=1e-9)
    np.testing.assert_allclose(times, want[2], atol=1e-15)
    # the loop moved the robot and the plan acted
    assert np.abs(np.diff(states[:, 7:19], axis=0)).max() > 1e-6
    assert np.abs(actions).max() > 1e-3


def test_jax_estimator_runner_log_shapes_and_times_match(jax_plant):
    """JAX's own EstimatorRunner.run, once (its own noise): the log's shapes
    and times are the port's."""
    m = jax_plant[0]
    cfg, (jcosts, pcosts), rk, run = _construction("pipeline", m)
    cfg = dataclasses.replace(cfg, n_samples=4, horizon=2)
    net, params, mod = _surrogate(19)
    jr = jest.EstimatorRunner(GO1_XML, net.apply, params, cfg, *jcosts,
                              state_fn=lambda plant: plant.qpos, fd_time_augment=19,
                              ego_cols=(0, 1))
    want = jr.run(n_steps=3, init_qpos=run["init_qpos"], init_plan=run["init_plan"]).arrays()
    pr = pest.EstimatorRunner("go1_collect", mod, cfg, *pcosts,
                              state_fn=lambda plant: plant.qpos, fd_time_augment=19,
                              ego_cols=(0, 1), device="cpu", dtype=torch.float64)
    got = pr.run(n_steps=3, chunk=2, **run).arrays()
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_allclose(got[2], want[2], atol=1e-15)
    np.testing.assert_allclose(got[0][0], want[0][0], atol=1e-15)   # the start state
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()


def test_batched_dynamics_plans_through_the_estimator_kernel_wrapper(monkeypatch):
    """batched_dynamics=True wraps the module in make_flash_feature_attention
    (on CPU tensors its plain version): T forwards of the (K, F) batch per
    control step."""
    m = build_from_mjcf(GO1_XML, include_self_collisions=True)
    cfg, (_, pcosts), rk, run = _construction("pipeline", m)
    _, _, mod = _surrogate(19)
    runner = pest.EstimatorRunner("go1_collect", mod.float(), cfg, *pcosts,
                                  state_fn=lambda plant: plant.qpos, batched_dynamics=True,
                                  fd_time_augment=19, ego_cols=(0, 1), device="cpu")
    shapes = []
    plain = ek.forward_plain

    def counted(w, x, *a):
        shapes.append(tuple(x.shape))
        return plain(w, x, *a)
    monkeypatch.setattr(ek, "forward_plain", counted)
    assert hasattr(runner.apply, "plain")
    ms, plant = runner.start(init_qpos=run["init_qpos"], init_plan=run["init_plan"])
    n0 = ek.launches
    action, ms, plant2, _ = runner.control_step(ms, plant)
    assert shapes == [(K, 31)] * T and ek.launches == n0
    assert torch.isfinite(action).all() and torch.isfinite(plant2.qpos).all()


def test_cartpole_estimator_waits_for_slide_joints():
    """It waits no more: with slide joints in the plant (slice 9),
    make_cartpole_estimator builds the cartpole loop on the CPU -- the
    cartpole plant, ESTIMATOR_CONFIGS["cartpole"], the module's own forward
    -- and its control steps run (at K=16, T=3 by mppi_override). Its
    parity with JAX is in tests/test_torch_port_cartpole.py."""
    module = make_model("cartpole_attention", hidden_dim=8)
    runner = pest.make_cartpole_estimator(module, device="cpu")
    assert (runner.plant_model.nq, runner.plant_model.joints[0].jtype) == (2, 2)
    assert (runner.cfg.K, runner.cfg.T, runner.cfg.update_mode) == (2048, 100, "replace")
    assert not hasattr(runner.apply, "plain")
    runner = pest.make_cartpole_estimator(module, device="cpu",
                                          mppi_override=dict(n_samples=16, horizon=3))
    assert (runner.cfg.K, runner.cfg.T, runner.cfg.update_mode) == (16, 3, "replace")
    states, actions, _ = runner.run(n_steps=2, init_qpos=(0.0, np.pi)).arrays()
    assert states.shape == (2, 4) and np.isfinite(actions).all()


def test_estimator_runner_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = pest.ESTIMATOR_CONFIGS["quadruped"]
    with pytest.raises(RuntimeError, match="cuda"):
        pest.EstimatorRunner("go1_collect", make_model("quadruped_attention", hidden_dim=8),
                             cfg, *pest.quadruped_estimator_costs())
