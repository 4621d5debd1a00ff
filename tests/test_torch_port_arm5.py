"""PyTorch port, slice 11: arm5 (two ball joints with quaternion springs
and a rotation-angle limit, a limited elbow hinge, ball and free motors
with gear vectors, two plane-vs-mesh pairs, a welded pedestal and a free
crate: two trees of dofs) against the JAX package on the CPU, in f64.

Inputs are numpy arrays from a seed (chip_smoke.arm5_states /
arm5_inputs: the crate in the air, the shoulder past its 70 deg limit, the
crate resting with a few vertices in the floor, face down with six in it,
and both springs loaded with the elbow past its limit). Tolerances as the
JAX tests' (tests/test_kernel.py:104-105): a step's qpos 1e-10, qvel 5e-8;
costs rtol 1e-10 (f64) and 2e-4 (f32); the rollout against the Pallas
kernel in interpret mode rtol 1e-9 (costs), atol 1e-10 (final state); the
loops' rows, actions and times 1e-10 / 1e-9 / 1e-12. Each JAX reference is
computed once, in a module-scoped fixture."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ARM5_LIMIT, ARM5_POSES, arm5_inputs, arm5_states, arm5_terms
from humanoid_mppi_rl_tpu.costs import arm5 as jcost
from humanoid_mppi_rl_tpu.envs.tasks import TASKS as JTASKS
from humanoid_mppi_rl_tpu.envs.tasks import load_task as jax_load_task
from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.ops.rollout_kernel import build_rollout_kernel as jax_rollout_kernel
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu.solver.mppi import MPPIState as JMPPIState
from humanoid_mppi_rl_tpu.solver.mppi import make_mppi as jax_make_mppi
from humanoid_mppi_rl_tpu_torch.collect.runner import EpisodeRunner
from humanoid_mppi_rl_tpu_torch.costs import arm5 as pcost
from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS, load_task
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as tkc
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as tsph
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json, snapshot_path)
from torch_port_small_robots import (host_library, host_rollout, j, jax_episode, jax_models,
                                     stack, t)

F64 = torch.float64
NS = 10        # two samples of each pose
K, T = 16, 3   # the rollout check (tests/test_kernel.py's arm5 shape)
LOOP_K, LOOP_STEPS = 8, 3


@pytest.fixture(scope="module")
def models():
    jm, jpm = jax_models("arm5")
    return jm, jpm, load_model("arm5"), load_model("arm5_plant")


@pytest.fixture(scope="module")
def poses(models):
    _, _, pm, _ = models
    qpos, qvel = arm5_states(pm, NS, seed=1)
    ctrl = np.random.default_rng(3).uniform(-3, 3, (pm.nu, NS))
    return qpos, qvel, ctrl


@pytest.fixture(scope="module")
def jax_coupled_step(models):
    _, jpm, _, _ = models
    return jax.jit(lambda s, u: jeng.step(jpm, s, u))


@pytest.mark.parametrize("name, plant", [("arm5", False), ("arm5_plant", True)])
def test_arm5_snapshots_equal_fresh_mjcf_export(name, plant):
    """assets/arm5{,_plant}.json equal a fresh export of build_from_mjcf and
    survive a round trip: two ball joints (shoulder with spring and limit,
    wrist with spring), the elbow hinge, the crate's free joint, three
    multi-dof motors, two plane-vs-mesh pairs of 12 vertices each."""
    jm = jax_models("arm5")[int(plant)]
    fresh = snapshot_json(export_model_arrays(jm, plant=True))
    with open(snapshot_path(name)) as f:
        assert f.read() == fresh, (
            f"assets/{name}.json is stale: regenerate it with snapshot_json(export_model_arrays("
            f"build_from_mjcf(arm5.xml, include_self_collisions={plant}), plant=True))")
    m = load_model(name)
    assert snapshot_json(export_model_arrays(model_from_arrays(
        export_model_arrays(m, plant=True)), plant=True)) == fresh
    assert (m.nq, m.nv, m.nu, m.nbody) == (16, 13, 4, 6)
    assert [jt.jtype for jt in m.joints] == [1, 3, 1, 0]
    assert [a.ndof for a in m.actuators] == [3, 1, 3, 6]
    assert [d for d, *_ in m.ball_springs] == [0, 4] and [d for d, *_ in m.ball_limits] == [0]
    meshes = [m.geoms[p.geom2] for p in m.contact_pairs]
    assert len(meshes) == 2 and all(g.gtype == 7 and g.mesh_verts.shape == (12, 3)
                                    and g.mesh_hull.shape == (20, 4) for g in meshes)


def test_arm5_states_switch_on_every_term(models):
    """arm5_states' poses: the shoulder past its limit ("limit"), the crate
    with 1-4 vertices in the floor ("rest") and with six ("deep": more
    than the array tiers' 4 rows), both springs loaded ("springs", the
    elbow past its upper limit), the crate clear of the floor ("air")."""
    _, _, pm, _ = models
    qpos, _ = arm5_states(pm, NS, seed=1)
    terms = arm5_terms(pm, qpos)
    pose = np.array([ARM5_POSES[k % 5] for k in range(NS)])
    assert (terms["shoulder_past_limit"] == (pose == "limit")).all()
    assert (terms["shoulder_angle"][pose == "limit"] > ARM5_LIMIT + 0.05).all()
    assert (terms["crate_vertices_in"][pose == "deep"] == 6).all()
    assert ((terms["crate_vertices_in"][pose == "rest"] >= 1)
            & (terms["crate_vertices_in"][pose == "rest"] <= 4)).all()
    assert (terms["crate_vertices_in"][pose == "air"] == 0).all()
    assert (qpos[4, pose == "springs"] > pm.joints[1].range[1]).all()
    assert (terms["hand_vertices_in"] == 0).all()


def test_arm5_scalar_step_matches_jax(models, poses):
    """One penalty-tier step of the plain version against JAX scalar_step:
    ball FK, S rows and Sdot, quaternion springs, the shoulder limit and
    its implicit damping, ball and free motors, ball integration and every
    mesh vertex as a contact point."""
    jm, _, pm, _ = models
    qpos, qvel, ctrl = poses
    jq, jv, _ = jsph.scalar_step(jm, j(qpos), j(qvel), j(ctrl), jnp.zeros(NS))
    tq, tv, _ = tsph.scalar_step(pm, t(qpos), t(qvel), t(ctrl), torch.zeros(NS, dtype=F64))
    assert tsph.unsupported_features(pm) == []
    np.testing.assert_allclose(stack(tq, NS), stack(jq, NS), atol=1e-10)
    np.testing.assert_allclose(stack(tv, NS), stack(jv, NS), atol=5e-8)
    assert (np.abs(stack(tv, NS) - qvel).max(axis=0) > 1e-2).all()


def test_arm5_penalty_engine_matches_jax(models, poses):
    """The penalty tier over a K batch against vmapped JAX step(solver=
    "penalty"): the 4 deepest vertices of each mesh, ranked with the lower
    index first among equals, the ball limit with the elbow's."""
    jm, _, pm, _ = models
    qpos, qvel, ctrl = poses
    st = jax.vmap(lambda qp, qv: jeng.forward(jm, qp, qv))(jnp.asarray(qpos.T),
                                                          jnp.asarray(qvel.T))
    want = jax.jit(jax.vmap(lambda s, u: jeng.step(jm, s, u, solver="penalty")))(
        st, jnp.asarray(ctrl.T))
    eng = Engine(pm, "cpu", F64)
    got = eng.step(eng.forward(torch.tensor(qpos.T), torch.tensor(qvel.T),
                               torch.zeros(NS, dtype=F64)), torch.tensor(ctrl.T), solver="penalty")
    np.testing.assert_allclose(got.qpos.numpy(), np.asarray(want.qpos), atol=1e-10)
    np.testing.assert_allclose(got.qvel.numpy(), np.asarray(want.qvel), atol=5e-8)
    np.testing.assert_allclose(got.S.numpy(), np.asarray(want.S), atol=1e-10)
    # a row of the batch equals its one-sample call
    one = eng.step(eng.forward(torch.tensor(qpos[:, 3]), torch.tensor(qvel[:, 3])),
                   torch.tensor(ctrl[:, 3]), solver="penalty")
    np.testing.assert_allclose(one.qvel.numpy(), got.qvel[3].numpy(), atol=1e-12)


def test_arm5_mesh_rows_rank_ties_as_jax(models):
    """Ties among a mesh's plane distances: the rows kept are jax.lax.top_k's
    (the lower vertex index first among equals), on distances with ties at
    the 4th and 5th place, and on the crate unrotated, where its vertices'
    distances tie exactly in pairs (the rows equal the JAX engine's)."""
    from humanoid_mppi_rl_tpu_torch.physics import contact as pcontact

    phi = np.array([[-1.0, -2.0, -2.0, -3.0, -2.0, -2.0, 0.5] + [1.0] * 5,
                    [-2.0] * 6 + [-1.0] * 6])
    ct = Engine(load_model("arm5"), "cpu", F64).contact
    a = ct.segments[1][0]
    full = torch.zeros(2, 24, dtype=F64)
    full[:, a:a + 12] = torch.tensor(phi)
    pts = torch.zeros(2, 24, 3, dtype=F64)
    pts[..., 0] = torch.arange(24, dtype=F64)   # each candidate's index
    got, _ = pcontact._keep_deepest(ct, pts, full)
    _, idx = jax.lax.top_k(jnp.asarray(-phi), 4)
    np.testing.assert_array_equal(got[:, 4:, 0].numpy() - a, np.asarray(idx))
    np.testing.assert_array_equal(np.asarray(idx), [[3, 1, 2, 4], [0, 1, 2, 3]])
    jm, _, pm, _ = models
    qpos = np.asarray(pm.qpos0, dtype=np.float64).copy()
    qpos[11] = 0.05
    eng = Engine(pm, "cpu", F64)
    st = eng.forward(torch.tensor(qpos), torch.zeros(pm.nv, dtype=F64))
    rows = pcontact.collect_contact_rows(eng.contact, st, st.S, penalty=True)
    js = jeng.forward(jm, jnp.asarray(qpos), jnp.zeros(pm.nv))
    from humanoid_mppi_rl_tpu.physics.contact import collect_contact_rows as jrows
    want = jrows(jm, js, js.S)
    np.testing.assert_allclose(rows["pen"].numpy(), np.asarray(want["pen"]), atol=1e-15)
    np.testing.assert_allclose(rows["JpN"].numpy(), np.asarray(want["JpN"]), atol=1e-12)
    pen = rows["pen"].numpy()[4:]
    assert (pen > 0).sum() == 4 and len(set(np.round(pen, 12))) == 2


@pytest.mark.parametrize("pose", range(5), ids=list(ARM5_POSES))
def test_arm5_coupled_plant_step_matches_jax(models, poses, jax_coupled_step, pose):
    """Three coupled plant steps of each pose against JAX step (Newton, the
    4 deepest vertices of each mesh as pyramid rows, the elbow's limit
    row). From the pose past the shoulder's limit the coupled tier applies
    no ball limit, as in JAX: the same steps without the model's ball
    limits give the same state."""
    _, _, _, ppm = models
    qpos, qvel, ctrl = (a[:, pose] for a in poses)
    js = jeng.forward(models[1], jnp.asarray(qpos), jnp.asarray(qvel))
    eng = Engine(ppm, "cpu", F64)
    ts = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    for _ in range(3):
        js = jax_coupled_step(js, jnp.asarray(ctrl))
        ts = eng.step(ts, torch.tensor(ctrl))
        np.testing.assert_allclose(ts.qpos.numpy(), np.asarray(js.qpos), atol=1e-10)
        np.testing.assert_allclose(ts.qvel.numpy(), np.asarray(js.qvel), atol=5e-8)
    if ARM5_POSES[pose] == "limit":
        free = Engine(dataclasses.replace(ppm, ball_limits=()), "cpu", F64)
        fs = free.forward(torch.tensor(qpos), torch.tensor(qvel))
        for _ in range(3):
            fs = free.step(fs, torch.tensor(ctrl))
        assert torch.equal(fs.qvel, ts.qvel)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_arm5_costs_match_jax(models, poses, dtype):
    """The kernel cost (ops/kernel_costs.arm5), running and terminal, and
    the array cost (costs/arm5) against the JAX package's."""
    jm, _, pm, _ = models
    rtol = 1e-10 if dtype == np.float64 else 2e-4
    qpos, qvel, ctrl = (a.astype(dtype) for a in poses)
    tt = lambda a: [torch.tensor(a[i]) for i in range(a.shape[0])]
    jctx = jsph.ctx_from(jm, jsph.scalar_forward(jm, j(qpos), j(qvel)), j(qpos), j(qvel),
                         j(ctrl), jnp.zeros(NS, dtype))
    tctx = tsph.ctx_from(pm, tsph.scalar_forward(pm, tt(qpos), tt(qvel)), tt(qpos), tt(qvel),
                         tt(ctrl), torch.zeros(NS, dtype=torch.tensor(qpos).dtype))
    for kw in ({}, dict(target=(0.2, -0.1, 0.4), w_vel=0.2)):
        jrun, jterm = jkc.arm5(jm, **kw)
        trun, tterm = tkc.arm5(pm, **kw)
        np.testing.assert_allclose(trun(tctx, 0).numpy(), np.asarray(jrun(jctx, 0)), rtol=rtol)
        np.testing.assert_allclose(tterm(tctx).numpy(), np.asarray(jterm(jctx)), rtol=rtol)
        jr, jtm = jcost.make_costs(jm, **kw)
        pr, ptm = pcost.make_costs(pm, **kw)
        st = Engine(pm, "cpu", torch.tensor(qpos).dtype).forward(torch.tensor(qpos.T),
                                                                 torch.tensor(qvel.T))
        want_r, want_t = [], []
        for k in range(NS):
            s = jeng.forward(jm, jnp.asarray(qpos[:, k]), jnp.asarray(qvel[:, k]))
            want_r.append(float(jr(s, jnp.asarray(ctrl[:, k]), 0)))
            want_t.append(float(jtm(s, 0)))
        np.testing.assert_allclose(pr(st, torch.tensor(ctrl.T), 0).numpy(), want_r, rtol=rtol)
        np.testing.assert_allclose(ptm(st, 0).numpy(), want_t, rtol=rtol)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library(tmp_path_factory.mktemp("host_rollout_arm5"))


def test_arm5_rollout_matches_the_pallas_kernel(models, host_lib):
    """The plain rollout and the host-built CUDA body against the JAX
    package's Pallas kernel itself (build_rollout_kernel(pm, arm5, 3,
    block_k=16, interpret=True)) on the same inputs and noise, f64, K=16,
    T=3: costs and final states."""
    jm, _, pm, _ = models
    x = arm5_inputs(pm, K, T, F64, seed=7, device="cpu")
    pallas = jax_rollout_kernel(jm, jkc.arm5, T, block_k=16, interpret=True)
    want = [np.asarray(a) for a in pallas(*[jnp.asarray(a.numpy()) for a in x])]
    ro = rk.build_rollout_kernel(pm, tkc.arm5, T, device="cpu")
    got = [a.numpy() for a in ro(*x)]
    host = host_rollout(host_lib, pm, tkc.arm5, {}, x, torch.zeros(16, dtype=F64), T)
    for name, out in (("plain", got), ("host body", host)):
        np.testing.assert_allclose(out[0], want[0], rtol=1e-9, err_msg=name)
        np.testing.assert_allclose(out[1], want[1], atol=1e-10, err_msg=name)
        np.testing.assert_allclose(out[2], want[2], atol=1e-10, err_msg=name)
    assert np.abs(got[2] - x[1].numpy()).max() > 1e-2


def test_arm5_tables():
    """arm5 in the kernel's tables: two ball joints (the shoulder's limit
    as range[1] = 70 deg with its m_eff), the pedestal with no joint, three
    multi-dof transmissions with their gear vectors, two mesh pairs of 12
    vertices, the arm5 cost's id and constants, two dof trees (no top
    block)."""
    spec, model, *_ = load_task("arm5_reach", device="cpu", dtype=F64)
    tab = rk.tables_struct(F64).from_buffer_copy(
        rk.pack_tables(model, spec.kernel_cost_factory, {}, None, None, True, F64))
    assert list(tab.jnt_type[:4]) == [1, 3, 1, 0] and tab.body_jnt_num[1] == 0
    assert (tab.nball, list(tab.ball_jnt[:2])) == (2, [0, 2])
    assert list(tab.jnt_limited[:4]) == [1, 1, 0, 0]
    np.testing.assert_allclose(tab.jnt_range[0][1], np.radians(70), rtol=1e-12)
    assert list(tab.jnt_stiffness[:3]) == [8.0, 0.0, 2.0]
    assert tab.ntrn == 3 and list(tab.act_trn[:4]) == [0, -1, 1, 2]
    assert list(tab.trn_kind[:3]) == [1, 1, 1]
    np.testing.assert_allclose(list(tab.trn_gear[2]), [0, 0, 1, 0, 0, 0.1])
    np.testing.assert_allclose(list(tab.trn_gear[0]), [1, 0.5, 0.2, 0, 0, 0])
    assert [bin(tab.dof_acts[d]).count("1") for d in range(13)] == [1] * 7 + [0, 0, 1, 0, 0, 1]
    assert tab.npair == 2 and list(tab.pair_type[:2]) == [4, 4]
    assert list(tab.pair_npt[:2]) == [12, 12] and list(tab.pair_vadr[:2]) == [0, 12]
    assert (tab.cost_id, tab.cost_body[0]) == (7, model.body_id("hand"))
    np.testing.assert_allclose(list(tab.cost_w[:6]), [0.35, 0.15, 0.55, 10.0, 0.05, 0.01])
    assert (tab.ndlvl, tab.ntop) == (7, 0)
    off, size = rk.workspace_layout(model, tab.nten)
    assert tab.ws_size == size and off["trn"] + 21 <= size and off["ball"] + 14 <= size


def test_arm5_task_registry_matches_jax():
    spec, model, _, _, _, init, cfg = load_task("arm5_reach", device="cpu", dtype=F64)
    js = JTASKS["arm5_reach"]
    for f in ("n_samples", "horizon", "temperature", "sigma", "tail_decay"):
        assert getattr(cfg, f) == getattr(js.mppi, f), f
    assert (cfg.K, cfg.T, cfg.temperature, cfg.sigma) == (64, 40, 0.5, 0.8)
    assert spec.kernel_cost == js.kernel_cost == "arm5" and spec.plant == "arm5_plant"
    assert cfg.ctrl_low is None and not cfg.clamp_plan
    np.testing.assert_array_equal(init.qpos.numpy(), model.qpos0)


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernel", "array"])
def test_arm5_episode_runner_matches_jax(models, jax_coupled_step, use_kernel):
    """EpisodeRunner("arm5_reach") on the CPU in f64 against the JAX loop at
    matched noise, 3 control steps from qpos0, K=8, T=3: on the kernel
    planner the rollout kernel's body (torch_port_small_robots.jax_episode),
    on the array planner JAX make_mppi over the penalty dynamics; both step
    the JAX coupled plant."""
    jm, jpm, _, _ = models
    cfg = dataclasses.replace(TASKS["arm5_reach"].mppi, n_samples=LOOP_K, horizon=T)
    rng = np.random.default_rng(17)
    noises = [cfg.sigma * rng.normal(size=(T, jm.nu, LOOP_K)) for _ in range(LOOP_STEPS)]
    qpos0 = np.asarray(jm.qpos0)
    if use_kernel:
        want = jax_episode(jm, jpm, "arm5", {}, cfg, qpos0, noises, np.zeros(16))
    else:
        _, _, dyn, running, terminal, _, jcfg = jax_load_task("arm5_reach")
        jcfg = dataclasses.replace(jcfg, n_samples=LOOP_K, horizon=T)
        plan = jax.jit(jax_make_mppi(dyn, running, jcfg, terminal_fn=terminal))
        plant = jeng.forward(jpm, jnp.asarray(qpos0), jnp.zeros(jm.nv))
        ms = JMPPIState(U=jnp.zeros((T, jm.nu)), key=jax.random.PRNGKey(0))
        rows, actions, times = [], [], []
        for noise in noises:
            rows.append(np.concatenate([np.asarray(plant.qpos), np.asarray(plant.qvel)]))
            times.append(float(plant.time))
            action, ms, _ = plan(ms, plant, jnp.asarray(np.moveaxis(noise, 2, 0)))
            actions.append(np.asarray(action))
            plant = jax_coupled_step(plant, action)
        want = (np.stack(rows), np.stack(actions), np.array(times))
    runner = EpisodeRunner("arm5_reach", use_kernel=use_kernel,
                           mppi_override=dict(n_samples=LOOP_K, horizon=T), device="cpu",
                           dtype=F64)
    res = runner.run(max_steps=LOOP_STEPS, chunk=LOOP_STEPS,
                     noise_fn=lambda i: torch.tensor(noises[i]))
    states, acts, ts = res.logger.arrays()
    assert states.shape == (LOOP_STEPS, 29) and acts.shape == (LOOP_STEPS, 4)
    np.testing.assert_allclose(states[:, :16], want[0][:, :16], atol=1e-10)
    np.testing.assert_allclose(states[:, 16:], want[0][:, 16:], atol=1e-9)
    np.testing.assert_allclose(acts, want[1], atol=1e-9)
    np.testing.assert_allclose(ts, want[2], atol=1e-12)
    assert np.abs(acts).max() > 1e-2
