"""PyTorch port, slice 9: the planar hopper (a root body with slide, slide
and hinge; floor contacts; the hopper cost with its param_gait terms)
against the JAX package on the CPU.

Inputs are numpy arrays from a seed (chip_smoke.hopper_states /
hopper_inputs: four poses, the foot in the floor standing and crouched, a
fast fall and a flight) and go through both sides; start times are
nonzero, since the hop clock reads them. Tolerances as
tests/test_torch_port_cartpole.py's: a step qpos 1e-10 / qvel 1e-8 in f64;
costs rtol 1e-10 (f64) and 2e-4 (f32); the rollout against the Pallas
kernel in interpret mode rtol 1e-9 (costs), atol 1e-10 / 1e-9 (final
qpos / qvel); the loop's rows, actions and times 1e-10 / 1e-9 / 1e-15."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (HOPPER_POSES, hopper_foot_low, hopper_gait_params, hopper_gait_terms,
                        hopper_inputs, hopper_states)
from humanoid_mppi_rl_tpu.costs import hopper as jcost
from humanoid_mppi_rl_tpu.envs.tasks import TASKS as JTASKS
from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.ops.rollout_kernel import build_rollout_kernel as jax_rollout_kernel
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
from humanoid_mppi_rl_tpu_torch.costs import hopper as pcost
from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS, load_task
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as tkc
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as tsph
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json, snapshot_path)
from humanoid_mppi_rl_tpu_torch.physics.state import PhysicsState
from torch_port_small_robots import (host_library, host_rollout, j, jax_episode, jax_models,
                                     stack, t)

K, T = 16, 3
GAIT = dict(param_gait=True)


@pytest.fixture(scope="module")
def models():
    jm, jpm = jax_models("hopper")
    return jm, jpm, load_model("hopper"), load_model("hopper_plant")


@pytest.mark.parametrize("name, plant", [("hopper", False), ("hopper_plant", True)])
def test_hopper_snapshots_equal_fresh_mjcf_export(name, plant):
    """assets/hopper{,_plant}.json equal a fresh export of build_from_mjcf
    and survive a round trip: rootx, rootz (slides) and rooty (hinge) on
    the torso, 6 floor pairs (15 pairs with the self pairs)."""
    jm = jax_models("hopper")[int(plant)]
    fresh = snapshot_json(export_model_arrays(jm, plant=True))
    with open(snapshot_path(name)) as f:
        assert f.read() == fresh, (
            f"assets/{name}.json is stale: regenerate it with snapshot_json(export_model_arrays("
            f"build_from_mjcf(hopper.xml, include_self_collisions={plant}), plant=True))")
    m = load_model(name)
    assert snapshot_json(export_model_arrays(model_from_arrays(
        export_model_arrays(m, plant=True)), plant=True)) == fresh
    assert (m.nq, m.nv, m.nu, m.nbody) == (7, 7, 4, 6)
    assert [jt.jtype for jt in m.joints] == [2, 2, 3, 3, 3, 3, 3]
    assert m.body_joints[1] == (0, 1, 2) and len(m.contact_pairs) == (15 if plant else 6)


def test_hopper_states_switch_on_every_term(models):
    """hopper_states' poses: the foot in the floor standing and crouched,
    above it falling and flying; after three plain steps each param_gait
    term is nonzero in some sample (the landing term needs the torso below
    0.85 m and a descent past 0.4 m/s)."""
    _, _, pm, _ = models
    qpos, qvel = hopper_states(pm, 8, seed=1)
    low = hopper_foot_low(pm, qpos)
    names = [p[0] for p in HOPPER_POSES]
    for k in range(8):
        np.testing.assert_allclose(low[k], HOPPER_POSES[k % 4][4], atol=1e-12)
    assert (qpos[1, [names.index("crouch"), names.index("falling")]] + 1.0 < 0.85).all()
    params = hopper_gait_params()
    x = hopper_inputs(pm, K, T, torch.float64, seed=1, device="cpu")
    ro = rk.build_rollout_kernel(pm, tkc.hopper, T, cost_kwargs=GAIT, device="cpu")
    _, qT, vT = ro(*x, params=torch.tensor(params))
    terms = hopper_gait_terms(qT.numpy(), vT.numpy(), (x[2][0] + T * pm.timestep).numpy(), params)
    assert all((v > 0).any() for v in terms.values()), terms


@pytest.mark.parametrize("pose", range(4))
def test_hopper_coupled_plant_step_matches_jax(models, pose):
    """Three coupled plant steps of each pose (floor and self pairs, joint
    limits, Newton), f64."""
    _, jpm, _, pm = models
    qpos, qvel = hopper_states(pm, 4, seed=2)
    qpos, qvel = qpos[:, pose], qvel[:, pose]
    ctrl = np.random.default_rng(pose).uniform(-1, 1, pm.nu)
    js = jeng.forward(jpm, jnp.asarray(qpos), jnp.asarray(qvel))
    eng = Engine(pm, "cpu", torch.float64)
    ts = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    for _ in range(3):
        js = jeng.step(jpm, js, jnp.asarray(ctrl), solver="coupled")
        ts = eng.step(ts, torch.tensor(ctrl))
        np.testing.assert_allclose(ts.qpos.numpy(), np.asarray(js.qpos), atol=1e-10)
        np.testing.assert_allclose(ts.qvel.numpy(), np.asarray(js.qvel), atol=1e-8)
    np.testing.assert_allclose(ts.xpos.numpy(), np.asarray(js.xpos), atol=1e-10)
    np.testing.assert_allclose(ts.S.numpy(), np.asarray(js.S), atol=1e-10)


def test_hopper_scalar_step_matches_jax(models):
    """One penalty-tier step of the plain version against JAX scalar_step
    on the four poses, f64."""
    jm, _, pm, _ = models
    qpos, qvel = hopper_states(pm, 8, seed=3)
    ctrl = np.random.default_rng(3).uniform(-1.2, 1.2, (pm.nu, 8))
    jq, jv, _ = jsph.scalar_step(jm, j(qpos), j(qvel), j(ctrl), jnp.zeros(8))
    tq, tv, _ = tsph.scalar_step(pm, t(qpos), t(qvel), t(ctrl),
                                 torch.zeros(8, dtype=torch.float64))
    assert tsph.unsupported_features(pm) == []
    np.testing.assert_allclose(stack(tq, 8), stack(jq, 8), atol=1e-10)
    np.testing.assert_allclose(stack(tv, 8), stack(jv, 8), atol=1e-8)
    assert (np.abs(stack(tv, 8) - qvel).max(axis=0) > 1e-3).all()


@pytest.mark.parametrize("kw", [{}, GAIT, dict(GAIT, target_vel_x=0.6, w_pitch=2.0)],
                         ids=["baked", "param_gait", "param_gait_constants"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_hopper_costs_match_jax(models, kw, dtype):
    """The kernel cost, running and terminal, at start times in [0.3, 10] s
    with the check's gait params; and the array cost (costs/hopper)
    against JAX's."""
    jm, _, pm, _ = models
    rtol = 1e-10 if dtype == np.float64 else 2e-4
    qpos, qvel = (a.astype(dtype) for a in hopper_states(pm, 8, seed=5))
    ctrl = np.random.default_rng(5).uniform(-1, 1, (pm.nu, 8)).astype(dtype)
    time = np.random.default_rng(6).uniform(0.3, 10.0, 8).astype(dtype)
    params = hopper_gait_params().astype(dtype)
    tt = lambda a: [torch.tensor(a[i]) for i in range(a.shape[0])]
    jctx = jsph.ctx_from(jm, jsph.scalar_forward(jm, j(qpos), j(qvel)), j(qpos), j(qvel),
                         j(ctrl), jnp.asarray(time))
    jctx.params = [jnp.asarray(p) for p in params]
    tctx = tsph.ctx_from(pm, tsph.scalar_forward(pm, tt(qpos), tt(qvel)), tt(qpos), tt(qvel),
                         tt(ctrl), torch.tensor(time))
    tctx.params = [torch.tensor(p) for p in params]
    jrun, jterm = jkc.hopper(jm, **kw)
    trun, tterm = tkc.hopper(pm, **kw)
    want = np.asarray(jrun(jctx, 0))
    np.testing.assert_allclose(trun(tctx, 0).numpy(), want, rtol=rtol)
    np.testing.assert_allclose(tterm(tctx).numpy(), np.asarray(jterm(jctx)), rtol=rtol)
    if kw.get("param_gait"):   # the clock matters: the same states at t = 0 cost otherwise
        tctx.time = torch.zeros(8, dtype=tctx.time.dtype)
        assert not np.allclose(trun(tctx, 0).numpy(), want, rtol=1e-3)
    base = {k: v for k, v in kw.items() if k != "param_gait"}
    jr, jtm = jcost.make_costs(jm, **base)
    pr, ptm = pcost.make_costs(pm, **base)
    js = jeng.forward(jm, jnp.asarray(qpos[:, 0]), jnp.asarray(qvel[:, 0]))
    row = lambda k: js.replace(qpos=jnp.asarray(qpos[:, k]), qvel=jnp.asarray(qvel[:, k]))
    state = PhysicsState(torch.tensor(qpos.T), torch.tensor(qvel.T), torch.tensor(time))
    np.testing.assert_allclose(pr(state, torch.tensor(ctrl.T), 0).numpy(),
                               [float(jr(row(k), jnp.asarray(ctrl[:, k]), 0)) for k in range(8)],
                               rtol=rtol)
    np.testing.assert_allclose(ptm(state, 0).numpy(),
                               [float(jtm(row(k), 0)) for k in range(8)], rtol=rtol)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("host_rollout_hopper"))


def test_hopper_rollout_matches_the_pallas_kernel(models, host_lib):
    """The plain rollout and the host-built CUDA body against the JAX
    package's Pallas kernel itself (build_rollout_kernel(..., block_k=16,
    interpret=True), param_gait with the check's params, t0 in [0.3, 10]
    s) on the same inputs and noise, f64, K=16, T=3: costs (the terminal
    reads the clock at t0 + T h) and final states."""
    jm, _, pm, _ = models
    x = hopper_inputs(pm, K, T, torch.float64, seed=7, device="cpu")
    params = hopper_gait_params()
    pallas = jax_rollout_kernel(jm, jkc.hopper, T, block_k=16, interpret=True, cost_kwargs=GAIT)
    want = [np.asarray(a) for a in pallas(*[jnp.asarray(a.numpy()) for a in x], params)]
    ro = rk.build_rollout_kernel(pm, tkc.hopper, T, cost_kwargs=GAIT, device="cpu")
    got = [a.numpy() for a in ro(*x, params=torch.tensor(params))]
    host = host_rollout(host_lib, pm, tkc.hopper, GAIT, x, torch.tensor(params), T)
    for name, out in (("plain", got), ("host body", host)):
        np.testing.assert_allclose(out[0], want[0], rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(out[1], want[1], atol=1e-10, err_msg=name)
        np.testing.assert_allclose(out[2], want[2], atol=1e-9, err_msg=name)


def test_hopper_tables():
    """The hopper in the kernel's tables: three joints on the torso (slide,
    slide, hinge), seven dofs in one chain (six in the top block), 6
    capsule floor pairs, limits on the four leg hinges, the hopper cost's
    id, param_gait flag and constants."""
    spec, model, *_, cfg = load_task("hopper", device="cpu", dtype=torch.float64)
    tab = rk.tables_struct(torch.float64).from_buffer_copy(
        rk.pack_tables(model, spec.kernel_cost_factory, dict(GAIT, target_vel_x=0.7), None, None, True,
                       torch.float64))
    assert list(tab.jnt_type[:7]) == [2, 2, 3, 3, 3, 3, 3]
    assert (tab.body_jnt_adr[1], tab.body_jnt_num[1]) == (0, 3)
    assert list(tab.jnt_limited[:7]) == [0, 0, 0, 1, 1, 1, 1]
    assert (tab.npair, tab.nxpair) == (6, 1) and list(tab.pair_type[:6]) == [1] * 6
    assert (tab.ndlvl, tab.ntop) == (7, 6)
    assert (tab.cost_id, tab.cost_flags) == (4, 2)
    np.testing.assert_array_equal(list(tab.cost_w[:4]), [0.7, 1.0, 4.0, 0.3])


def test_hopper_task_registry_matches_jax():
    spec, model, _, _, _, init, cfg = load_task("hopper", device="cpu", dtype=torch.float64)
    js = JTASKS["hopper"]
    for f in ("n_samples", "horizon", "temperature", "sigma", "tail_decay"):
        assert getattr(cfg, f) == getattr(js.mppi, f), f
    assert spec.kernel_cost == js.kernel_cost == "hopper" and spec.plant == "hopper_plant"
    np.testing.assert_array_equal(init.qpos.numpy(), np.zeros(7))


@pytest.mark.parametrize("gait", [False, True], ids=["baked", "param_gait"])
def test_hopper_episode_runner_matches_jax(models, gait):
    """EpisodeRunner("hopper", use_kernel=True) on the CPU in f64 against
    the JAX loop (torch_port_small_robots.jax_episode) at matched noise: 4
    control steps in chunks of 2 from qpos0, K=8, T=3; with param_gait the
    gait params ride in the runtime params."""
    jm, jpm, _, _ = models
    kw = GAIT if gait else {}
    params = hopper_gait_params() if gait else np.zeros(16)
    cfg = dataclasses.replace(TASKS["hopper"].mppi, n_samples=8, horizon=3)
    rng = np.random.default_rng(17)
    noises = [cfg.sigma * rng.normal(size=(3, 4, 8)) for _ in range(4)]
    want = jax_episode(jm, jpm, "hopper", kw, cfg, np.zeros(7), noises, params)
    runner = EpisodeRunner("hopper", use_kernel=True, mppi_override=dict(n_samples=8, horizon=3),
                           cost_kwargs_override=kw, device="cpu", dtype=torch.float64)
    res = runner.run(max_steps=4, chunk=2, params=params,
                     noise_fn=lambda i: torch.tensor(noises[i]))
    states, actions, times = res.logger.arrays()
    assert states.shape == (4, 14) and actions.shape == (4, 4)
    np.testing.assert_allclose(states[:, :7], want[0][:, :7], atol=1e-10)
    np.testing.assert_allclose(states[:, 7:], want[0][:, 7:], atol=1e-9)
    np.testing.assert_allclose(actions, want[1], atol=1e-9)
    np.testing.assert_allclose(times, want[2], atol=1e-15)
    assert np.abs(states[-1, 7:]).max() > 1e-3
