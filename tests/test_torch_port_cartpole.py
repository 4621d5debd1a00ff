"""PyTorch port, slice 9: the cartpole (a slide joint with a limit, no
contacts) against the JAX package on the CPU.

Inputs are numpy arrays from a seed (chip_smoke.cartpole_inputs: the cart
in [-1.15, 1.15], past the slider's +-1 limit in some samples) and go
through both sides. Tolerances: the JAX kernel tests' qpos 1e-10 / qvel
1e-8 for a step in f64; costs rtol 1e-10 in f64 and 2e-4 in f32; the
rollout against the Pallas kernel in interpret mode rtol 1e-9 (costs) and
atol 1e-10 / 1e-9 (final qpos / qvel); the loops' rows, actions and times
at 1e-10 / 1e-9 / 1e-15 (tests/test_torch_port_collect.py's)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import cartpole_inputs
from humanoid_mppi_rl_tpu.collect import estimator as jest
from humanoid_mppi_rl_tpu.costs import cartpole as jcost
from humanoid_mppi_rl_tpu.dynamics.learned import (
    flat_state_from_physics as jax_flat_state, make_learned_dynamics as jax_learned)
from humanoid_mppi_rl_tpu.envs.tasks import TASKS as JTASKS
from humanoid_mppi_rl_tpu.models.predictors import make_model as jax_make_model
from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.ops.rollout_kernel import build_rollout_kernel as jax_rollout_kernel
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.solver import mppi as jmppi
from humanoid_mppi_rl_tpu_torch.collect import estimator as pest
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
from humanoid_mppi_rl_tpu_torch.costs import cartpole as pcost
from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS, load_task
from humanoid_mppi_rl_tpu_torch.models.convert import params_from_flax
from humanoid_mppi_rl_tpu_torch.models.predictors import make_model
from humanoid_mppi_rl_tpu_torch.ops import estimator_kernel as ek
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as tkc
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as tsph
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json, snapshot_path)
from humanoid_mppi_rl_tpu_torch.physics.state import PhysicsState
from torch_port_small_robots import (host_library, host_rollout, j, jax_episode, jax_models,
                                     stack, t, xml)

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

K, T = 16, 3


@pytest.fixture(scope="module")
def models():
    jm, jpm = jax_models("cartpole")
    return jm, jpm, load_model("cartpole"), load_model("cartpole_plant")


@pytest.mark.parametrize("name, plant", [("cartpole", False), ("cartpole_plant", True)])
def test_cartpole_snapshots_equal_fresh_mjcf_export(name, plant):
    """assets/cartpole{,_plant}.json equal a fresh export of build_from_mjcf
    and survive a round trip: the slide joint and its limit, no geom pair."""
    jm = build = jax_models("cartpole")[int(plant)]
    fresh = snapshot_json(export_model_arrays(build, plant=True))
    with open(snapshot_path(name)) as f:
        assert f.read() == fresh, (
            f"assets/{name}.json is stale: regenerate it with snapshot_json(export_model_arrays("
            f"build_from_mjcf(cartpole.xml, include_self_collisions={plant}), plant=True))")
    m = load_model(name)
    assert snapshot_json(export_model_arrays(model_from_arrays(
        export_model_arrays(m, plant=True)), plant=True)) == fresh
    assert (m.nq, m.nv, m.nu, m.nbody) == (2, 2, 1, 3) and not m.contact_pairs
    assert [jt.jtype for jt in m.joints] == [2, 3] and m.joints[0].limited
    np.testing.assert_array_equal(m.joints[0].range, [-1.0, 1.0])
    assert jm.nq == m.nq


def _plant_states():
    """The slider inside, at and past both limits, moving into them."""
    qpos = np.array([[0.2, 1.0, 1.03, -1.0, -1.05], [np.pi, 0.3, -2.0, 2.5, 1.0]])
    qvel = np.array([[0.5, 0.8, 0.4, -0.9, -0.2], [-1.0, 2.0, 0.1, -1.5, 3.0]])
    ctrl = np.array([0.4, 0.9, -0.3, -1.0, 0.7])
    return qpos, qvel, ctrl


@pytest.mark.parametrize("case", range(5))
def test_cartpole_coupled_plant_step_matches_jax(models, case):
    """Three coupled plant steps (step(solver="coupled"): the slider's
    limit row through the Newton solver, no contact rows), f64."""
    _, jpm, _, pm = models
    qpos, qvel, ctrl = (a[..., case] for a in _plant_states())
    js = jeng.forward(jpm, jnp.asarray(qpos), jnp.asarray(qvel))
    eng = Engine(pm, "cpu", torch.float64)
    ts = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    u = np.atleast_1d(ctrl)
    for _ in range(3):
        js = jeng.step(jpm, js, jnp.asarray(u), solver="coupled")
        ts = eng.step(ts, torch.tensor(u))
        np.testing.assert_allclose(ts.qpos.numpy(), np.asarray(js.qpos), atol=1e-10)
        np.testing.assert_allclose(ts.qvel.numpy(), np.asarray(js.qvel), atol=1e-8)
    np.testing.assert_allclose(ts.xpos.numpy(), np.asarray(js.xpos), atol=1e-10)
    np.testing.assert_allclose(ts.S.numpy(), np.asarray(js.S), atol=1e-10)


def test_cartpole_scalar_step_matches_jax(models):
    """One penalty-tier step of the plain version against JAX scalar_step,
    f64, with samples past the slider's limit."""
    jm, _, pm, _ = models
    x = cartpole_inputs(pm, K, 1, torch.float64, seed=3, device="cpu")
    qpos, qvel = x[0].numpy(), x[1].numpy()
    assert (np.abs(qpos[0]) > 1.0).any()
    ctrl = np.random.default_rng(3).uniform(-1.2, 1.2, (pm.nu, K))
    jq, jv, _ = jsph.scalar_step(jm, j(qpos), j(qvel), j(ctrl), jnp.zeros(K))
    tq, tv, _ = tsph.scalar_step(pm, t(qpos), t(qvel), t(ctrl),
                                 torch.zeros(K, dtype=torch.float64))
    assert tsph.unsupported_features(pm) == []
    np.testing.assert_allclose(stack(tq, K), stack(jq, K), atol=1e-10)
    np.testing.assert_allclose(stack(tv, K), stack(jv, K), atol=1e-8)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cartpole_costs_match_jax(models, dtype):
    """The kernel cost (StepContext) and the array costs (costs/cartpole:
    state, flat), running and terminal, against JAX's."""
    jm, _, pm, _ = models
    rtol = 1e-10 if dtype == np.float64 else 2e-4
    x = cartpole_inputs(pm, K, 1, torch.float64, seed=5, device="cpu")
    qpos, qvel = x[0].numpy().astype(dtype), x[1].numpy().astype(dtype)
    ctrl = np.random.default_rng(5).uniform(-1, 1, (pm.nu, K)).astype(dtype)
    tt = lambda a: [torch.tensor(a[i]) for i in range(a.shape[0])]
    jf = jsph.scalar_forward(jm, j(qpos), j(qvel))
    tf = tsph.scalar_forward(pm, tt(qpos), tt(qvel))
    jctx = jsph.ctx_from(jm, jf, j(qpos), j(qvel), j(ctrl), jnp.full(K, 0.7, dtype))
    tctx = tsph.ctx_from(pm, tf, tt(qpos), tt(qvel), tt(ctrl), torch.full((K,), 0.7))
    jrun, jterm = jkc.cartpole(jm)
    trun, tterm = tkc.cartpole(pm)
    np.testing.assert_allclose(trun(tctx, 0).numpy(), np.asarray(jrun(jctx, 0)), rtol=rtol)
    np.testing.assert_allclose(tterm(tctx).numpy(), np.asarray(jterm(jctx)), rtol=rtol)
    # the array oracles, batched over K here and vmapped there
    jr, jtm = jcost.make_costs(jm)
    state = PhysicsState(torch.tensor(qpos.T), torch.tensor(qvel.T), torch.zeros(K))
    jstate = jeng.forward(jm, jnp.asarray(qpos[:, 0]), jnp.asarray(qvel[:, 0]))
    want_r = [float(jr(jstate.replace(qpos=jnp.asarray(qpos[:, k]), qvel=jnp.asarray(qvel[:, k])),
                       jnp.asarray(ctrl[:, k]), 0)) for k in range(K)]
    want_t = [float(jtm(jstate.replace(qpos=jnp.asarray(qpos[:, k]),
                                       qvel=jnp.asarray(qvel[:, k])), 0)) for k in range(K)]
    pr, ptm = pcost.make_costs(pm)
    np.testing.assert_allclose(pr(state, torch.tensor(ctrl.T), 0).numpy(), want_r, rtol=rtol)
    np.testing.assert_allclose(ptm(state, 0).numpy(), want_t, rtol=rtol)
    flat = np.concatenate([qpos, qvel]).T
    jfr, jft = jcost.make_costs_flat()
    pfr, pft = pcost.make_costs_flat()
    np.testing.assert_allclose(pfr(torch.tensor(flat), torch.tensor(ctrl.T), 0).numpy(),
                               np.asarray(jax.vmap(lambda a, b: jfr(a, b, 0))(flat, ctrl.T)),
                               rtol=rtol)
    np.testing.assert_allclose(pft(torch.tensor(flat), 0).numpy(),
                               np.asarray(jax.vmap(lambda a: jft(a, 0))(flat)), rtol=rtol)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("host_rollout_cartpole"))


def test_cartpole_rollout_matches_the_pallas_kernel(models, host_lib):
    """The plain rollout and the host-built CUDA body against the JAX
    package's Pallas kernel itself (build_rollout_kernel(..., block_k=16,
    interpret=True)) on the same inputs and noise, f64, K=16, T=3: costs
    and final states."""
    jm, _, pm, _ = models
    x = cartpole_inputs(pm, K, T, torch.float64, seed=7, device="cpu")
    params = torch.zeros(16, dtype=torch.float64)
    pallas = jax_rollout_kernel(jm, jkc.cartpole, T, block_k=16, interpret=True)
    want = [np.asarray(a) for a in pallas(*[jnp.asarray(a.numpy()) for a in x],
                                          np.zeros(16))]
    ro = rk.build_rollout_kernel(pm, tkc.cartpole, T, device="cpu")
    got = [a.numpy() for a in ro(*x, params=params)]
    host = host_rollout(host_lib, pm, tkc.cartpole, {}, x, params, T)
    for name, out in (("plain", got), ("host body", host)):
        np.testing.assert_allclose(out[0], want[0], rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(out[1], want[1], atol=1e-10, err_msg=name)
        np.testing.assert_allclose(out[2], want[2], atol=1e-9, err_msg=name)
    assert (np.abs(want[1][0]) > 1.0).any()    # the limit acted on some sample


def test_cartpole_tables():
    """The cartpole in the kernel's tables: a slide then a hinge, the
    slider's limit and its solref-derived constants, no pair, the
    cartpole cost's id and no constants."""
    spec, model, *_, cfg = load_task("cartpole", device="cpu", dtype=torch.float64)
    tab = rk.tables_struct(torch.float64).from_buffer_copy(
        rk.pack_tables(model, spec.kernel_cost_factory, {}, None, None, True, torch.float64))
    assert list(tab.jnt_type[:2]) == [2, 3] and (tab.npair, tab.nxpair, tab.nten) == (0, 0, 0)
    assert list(tab.jnt_limited[:2]) == [1, 0] and list(tab.jnt_range[0]) == [-1.0, 1.0]
    assert tab.jnt_kbase[0] > 0 and tab.jnt_meff[0] > 0
    assert (tab.cost_id, tab.cost_flags) == (3, 0) and list(tab.cost_w) == [0.0] * 16
    assert (tab.ndlvl, tab.ntop) == (2, 2) and list(tab.dof_jnt[:2]) == [0, 1]


def test_cartpole_task_registry_matches_jax():
    """cartpole, cartpole_collect and cartpole_pr1: the JAX registry's MPPI
    constants, cost and start (0, pi) (envs/tasks.py:72-77, 143-146)."""
    for name in ("cartpole", "cartpole_collect", "cartpole_pr1"):
        spec, model, _, _, _, init, cfg = load_task(name, device="cpu", dtype=torch.float64)
        js = JTASKS[name]
        for f in ("n_samples", "horizon", "temperature", "sigma", "tail_decay"):
            assert getattr(cfg, f) == getattr(js.mppi, f), (name, f)
        assert spec.kernel_cost == js.kernel_cost == "cartpole" and spec.plant == "cartpole_plant"
        np.testing.assert_array_equal(init.qpos.numpy(), js.init_qpos)
        assert cfg.ctrl_low is None and not cfg.clamp_plan


@pytest.mark.parametrize("task", ["cartpole", "cartpole_collect"])
def test_cartpole_episode_runner_matches_jax(models, task):
    """EpisodeRunner(task, use_kernel=True) on the CPU in f64 against the
    JAX loop (torch_port_small_robots.jax_episode: the kernel replan as a
    plain loop, the coupled plant) at matched noise: 4 control steps in
    chunks of 2 from (0, pi), K=8, T=3."""
    jm, jpm, _, _ = models
    cfg = dataclasses.replace(TASKS[task].mppi, n_samples=8, horizon=3)
    rng = np.random.default_rng(11)
    noises = [cfg.sigma * rng.normal(size=(3, 1, 8)) for _ in range(4)]
    want = jax_episode(jm, jpm, "cartpole", {}, cfg, (0.0, np.pi), noises, np.zeros(16))
    runner = EpisodeRunner(task, use_kernel=True, mppi_override=dict(n_samples=8, horizon=3),
                           device="cpu", dtype=torch.float64)
    res = runner.run(max_steps=4, chunk=2, noise_fn=lambda i: torch.tensor(noises[i]))
    states, actions, times = res.logger.arrays()
    assert states.shape == (4, 4) and actions.shape == (4, 1)
    np.testing.assert_allclose(states[:, :2], want[0][:, :2], atol=1e-10)
    np.testing.assert_allclose(states[:, 2:], want[0][:, 2:], atol=1e-9)
    np.testing.assert_allclose(actions, want[1], atol=1e-9)
    np.testing.assert_allclose(times, want[2], atol=1e-15)
    assert np.abs(np.diff(states[:, 0])).max() > 1e-6


SMALL = dict(hidden_dim=16, attn_layers=1, dropout_rate=0.0)
LSTEPS = 4
LK, LT = 8, 3


def _surrogate(seed=0):
    """(flax module in f64, its f64 params, the port module in f64): the
    same cartpole_attention weights, every term nonzero, the head x 0.01."""
    net = jax_make_model("cartpole_attention", compute_dtype=jnp.float64, **SMALL)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 5)), deterministic=True)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)
    head = params["params"]["Dense_1"]
    head["kernel"] = head["kernel"] * np.float32(0.01)
    head["bias"] = head["bias"] * np.float32(0.01)
    mod = make_model("cartpole_attention", **SMALL)
    mod.load_state_dict(params_from_flax(params, mod))
    return net, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params), mod.double()


def test_make_cartpole_estimator_matches_jax(models):
    """make_cartpole_estimator (the module's own forward, f64) against JAX's
    make_cartpole_estimator recipe (collect/estimator.py:444-449: the flat
    cartpole costs, ESTIMATOR_CONFIGS["cartpole"]) through its control step
    (make_learned_dynamics -> make_mppi(...).plan(noise=...) ->
    step(solver="coupled")) at matched noise, 4 steps from (0, pi). The
    runner's default config is ESTIMATOR_CONFIGS["cartpole"] (K=2048,
    T=100); the loop runs it with K and T cut to LK, LT by mppi_override."""
    _, jpm, _, _ = models
    net, params, mod = _surrogate()
    assert dataclasses.asdict(pest.make_cartpole_estimator(mod, device="cpu").cfg) == \
        dataclasses.asdict(jest.ESTIMATOR_CONFIGS["cartpole"])
    cfg = dataclasses.replace(jest.ESTIMATOR_CONFIGS["cartpole"], n_samples=LK, horizon=LT)
    rng = np.random.default_rng(13)
    noises = [cfg.sigma * rng.normal(size=(cfg.K, cfg.T, 1)) for _ in range(LSTEPS)]
    running, terminal = jcost.make_costs_flat()
    make_plan = jmppi.make_mppi(jax_learned(net.apply, params), running, cfg,
                                terminal_fn=terminal)
    plan = jax.jit(lambda ms, x, noise: make_plan(ms, x, noise=noise))
    step = jax.jit(lambda s, u: jeng.step(jpm, s, u))
    plant = jeng.forward(jpm, jnp.asarray([0.0, np.pi]), jnp.zeros(2))
    ms = jmppi.MPPIState.seeded(0, cfg.T, 1)
    rows, actions = [], []
    for noise in noises:
        rows.append(np.concatenate([np.asarray(plant.qpos), np.asarray(plant.qvel)]))
        action, ms, _ = plan(ms, jax_flat_state(plant), jnp.asarray(noise))
        actions.append(np.asarray(action, np.float64))
        plant = step(plant, action)
    runner = pest.make_cartpole_estimator(mod, device="cpu", dtype=torch.float64,
                                          mppi_override=dict(n_samples=LK, horizon=LT))
    assert dataclasses.asdict(runner.cfg) == dataclasses.asdict(cfg)
    log = runner.run(n_steps=LSTEPS, init_qpos=(0.0, np.pi), chunk=2,
                     noise_fn=lambda i: torch.from_numpy(noises[i]))
    states, acts, times = log.arrays()
    np.testing.assert_allclose(states[:, :2], np.stack(rows)[:, :2], atol=1e-10)
    np.testing.assert_allclose(states[:, 2:], np.stack(rows)[:, 2:], atol=1e-9)
    np.testing.assert_allclose(acts, np.stack(actions), atol=1e-9)
    np.testing.assert_allclose(times, 0.01 * np.arange(LSTEPS), atol=1e-15)
    assert np.abs(acts).max() > 1e-3


def test_cartpole_estimator_kernel_route(monkeypatch):
    """The kernel route of the cartpole loop, EstimatorRunner("cartpole",
    ..., batched_dynamics=True) with the flat cartpole costs: the rollouts
    go through the estimator kernel's wrapper (its plain version on CPU
    tensors), T forwards of the (K, 5) batch a control step, and JAX's
    EstimatorRunner(batched_dynamics=True) logs the same shapes and times."""
    net, params, mod = _surrogate()
    cfg = dataclasses.replace(jest.ESTIMATOR_CONFIGS["cartpole"], n_samples=LK, horizon=LT)
    runner = pest.EstimatorRunner("cartpole", mod.float(), cfg, *pcost.make_costs_flat(),
                                  batched_dynamics=True, device="cpu")
    shapes = []
    plain = ek.forward_plain

    def counted(w, x, *a):
        shapes.append(tuple(x.shape))
        return plain(w, x, *a)
    monkeypatch.setattr(ek, "forward_plain", counted)
    n0 = ek.launches
    got = runner.run(n_steps=2, init_qpos=(0.0, np.pi), chunk=2).arrays()
    assert shapes == [(LK, 5)] * (2 * LT) and ek.launches == n0
    jr = jest.EstimatorRunner(xml("cartpole"), net.apply, params, cfg,
                              *jcost.make_costs_flat(), batched_dynamics=True)
    want = jr.run(n_steps=2, init_qpos=np.array([0.0, np.pi])).arrays()
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_allclose(got[2], want[2], atol=1e-15)
    np.testing.assert_allclose(got[0][0], want[0][0], atol=1e-15)
    assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
