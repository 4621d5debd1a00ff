"""PyTorch port, slice 6: the Go1 planner (model snapshot, the plain step's
new terms, the quadruped costs, the go1 replans and the kernel body on the
host) against the JAX package on the CPU.

Inputs are numpy arrays from a seed (chip_smoke.go1_states / go1_inputs:
seven poses that between them put every new term of the step in play) and
go through both sides. Tolerances: the JAX kernel tests' qpos 1e-10 / qvel
1e-8 for one step in f64, rtol 1e-10 for the costs, the slice test's 1e-8
for plans, and rtol 1e-9 for the kernel body on the host against the plain
rollout. Start times are nonzero throughout: the quadruped cost reads the
clock."""

import ctypes
import dataclasses
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import GO1_POSES, go1_inputs, go1_states
from humanoid_mppi_rl_tpu.ops import kernel_costs as jkc
from humanoid_mppi_rl_tpu.ops import scalar_physics as jsph
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.costs.quadruped import GAIT_TUNED
from humanoid_mppi_rl_tpu_torch.envs.tasks import TASKS, load_task
from humanoid_mppi_rl_tpu_torch.ops import kernel_costs as tkc
from humanoid_mppi_rl_tpu_torch.ops import rollout_kernel as rk
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as tsph
from humanoid_mppi_rl_tpu_torch.physics import contact as pcontact
from humanoid_mppi_rl_tpu_torch.physics import spatial as psp
from humanoid_mppi_rl_tpu_torch.physics.engine import Engine
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json, snapshot_path)
from humanoid_mppi_rl_tpu_torch.physics.state import PhysicsState
from humanoid_mppi_rl_tpu_torch.solver.kernel_mppi import make_kernel_mppi
from humanoid_mppi_rl_tpu_torch.solver.mppi import MPPIState

ROOT = os.path.join(os.path.dirname(__file__), "..")
GO1_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "go1.xml")
CSRC = Path(rk.__file__).resolve().parent / "csrc"
T0S = (0.0, 0.37, 1.234, 23.9)


@pytest.fixture(scope="module")
def models():
    return build_from_mjcf(GO1_XML), load_model("go1")


def _gait_params(goal=(3.0, 0.5)):
    p = np.zeros(16)
    p[0:2] = goal
    p[4:13] = np.asarray(GAIT_TUNED, np.float32)
    return p


def _j(a):
    return [jnp.asarray(a[i]) for i in range(a.shape[0])]


def _t(a):
    return [torch.tensor(a[i]) for i in range(a.shape[0])]


def _np(xs, B):
    return np.stack([np.broadcast_to(np.asarray(x), (B,)) for x in xs])


@pytest.mark.parametrize("name, plant", [("go1", False), ("go1_plant", True)])
def test_go1_snapshots_equal_fresh_mjcf_export(name, plant):
    """assets/go1.json (planner: 42 floor pairs) and assets/go1_plant.json
    (plant: 697 candidate pairs) equal a fresh export of build_from_mjcf,
    the `home` keyframe included, and survive a round trip."""
    jm = build_from_mjcf(GO1_XML, include_self_collisions=plant)
    fresh = snapshot_json(export_model_arrays(jm, plant=True))
    with open(snapshot_path(name)) as f:
        assert f.read() == fresh, (
            f"assets/{name}.json is stale: regenerate it with snapshot_json(export_model_arrays("
            f"build_from_mjcf(go1.xml, include_self_collisions={plant}), plant=True))")
    m = load_model(name)
    assert snapshot_json(export_model_arrays(model_from_arrays(
        export_model_arrays(m, plant=True)), plant=True)) == fresh
    assert (m.nq, m.nv, m.nu, m.nbody) == (19, 18, 12, 14)
    assert len(m.contact_pairs) == (697 if plant else 42)
    assert [k for k, _ in m.keyframes] == ["home"]
    np.testing.assert_array_equal(dict(m.keyframes)["home"], dict(jm.keyframes)["home"])
    assert float(np.max(m.dof_frictionloss)) == 0.2


def _rows_by_pose(pm_plant, qpos):
    """Per sample: the floor rows' phi and the cylinder rows' |d| (the
    cap's downhill direction) through the plant's contact tables, whose
    floor geometry is the planner's."""
    eng = Engine(pm_plant, device="cpu", dtype=torch.float64)
    ct = eng.contact
    out = []
    for k in range(qpos.shape[1]):
        st = eng.forward(torch.tensor(qpos[:, k]), torch.zeros(pm_plant.nv, dtype=torch.float64))
        gpos, gR = pcontact.geom_world(ct, st)
        p_pos, n = gpos[ct.row_plane], gR[ct.row_plane][:, :, 2]
        g_pos, gRr = gpos[ct.row_geom], gR[ct.row_geom]
        axis = gRr[:, :, 2]
        c = g_pos + torch.einsum("pij,pj->pi", gRr, ct.row_off)
        d = -(n - torch.sum(axis * n, -1, keepdim=True) * axis)
        dn = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        dhat = torch.where(dn > 1e-6, d / torch.clamp(dn, min=1e-30), gRr[:, :, 0])
        dhat = dhat / torch.linalg.vector_norm(dhat, dim=-1, keepdim=True)
        c = c + ct.row_rim[:, 0:1] * dhat + ct.row_rim[:, 1:2] * psp.cross(axis, dhat)
        phi = (torch.sum(n * (c - p_pos), -1) - ct.row_radius).numpy()
        out.append((phi, dn[:, 0].numpy()))
    return out, ct.row_kind, float(pm_plant.contact_pairs[0].margin)


def test_go1_states_switch_on_every_new_term():
    """The poses of go1_states: box corners in contact ("belly", "tilted"),
    cylinder rims in contact lying, tilted and standing ("roll90": |d| <=
    1e-6, the x-axis branch; "pitch90" takes the branch clear of the
    floor), feet inside the margin but not touching ("margin"), and fast
    leg joints ("moving": friction loss)."""
    pm = load_model("go1_plant")
    qpos, qvel = go1_states(pm, 7, seed=3)
    rows, kind, margin = _rows_by_pose(pm, qpos)
    names = [p[0] for p in GO1_POSES]
    box, cyl, sphere = kind == 2, kind == 3, kind == 0
    touching = {name: phi < margin for name, (phi, _) in zip(names, rows)}
    for name in ("belly", "tilted"):
        assert touching[name][box].any() and touching[name][cyl].any(), name
    for name, contact in (("pitch90", False), ("roll90", True)):
        phi, dn = rows[names.index(name)]
        standing = cyl & (dn <= 1e-6)
        assert standing.any() and (touching[name] & standing).any() == contact, name
        assert (touching[name] & cyl).any(), name
    phi, _ = rows[names.index("margin")]
    feet = phi[sphere]
    assert ((feet > 0) & (feet < margin)).all()
    assert np.abs(qvel[6:, names.index("moving")]).max() > 1.0


@pytest.mark.parametrize("seed", [3, 4])
def test_go1_scalar_step_matches_jax(models, seed):
    """One penalty-tier step of the seven poses, f64: frictionloss on all
    12 leg dofs, box corners, exact cylinder rims (both branches of the rim
    direction), margin-active contacts."""
    jm, pm = models
    assert tsph.unsupported_features(pm) == []
    qpos, qvel = go1_states(pm, 7, seed)
    ctrl = np.random.default_rng(seed).uniform(-1.0, 1.0, (pm.nu, 7))
    jq, jv, _ = jsph.scalar_step(jm, _j(qpos), _j(qvel), _j(ctrl), jnp.zeros(7))
    tq, tv, _ = tsph.scalar_step(pm, _t(qpos), _t(qvel), _t(ctrl),
                                 torch.zeros(7, dtype=torch.float64))
    np.testing.assert_allclose(_np(tq, 7), _np(jq, 7), atol=1e-10)
    np.testing.assert_allclose(_np(tv, 7), _np(jv, 7), atol=1e-8)
    assert (np.abs(_np(tv, 7) - qvel).max(axis=0) > 0.1).all()


_COST_CASES = {
    "quadruped_zero_params": ("quadruped", dict(), None),
    "quadruped_gait_tuned": ("quadruped", dict(param_gait=True), "gait"),
    "quadruped_param_goal": ("quadruped", dict(param_goal=True, param_gait=True), "gait"),
    "quadruped_goal_xy": ("quadruped", dict(goal_xy=(3.5, -0.4)), None),
    "quadruped_jl": ("quadruped_jl", dict(), None),
}


@pytest.mark.parametrize("case", list(_COST_CASES))
def test_go1_costs_match_jax(models, case):
    """Running and terminal costs at the times T0S (one per sample): the
    trot phase reads the clock."""
    jm, pm = models
    name, kw, pkind = _COST_CASES[case]
    qpos, qvel = go1_states(pm, 7, seed=5)
    qpos, qvel = qpos[:, :4], qvel[:, :4]
    ctrl = np.random.default_rng(6).uniform(-1.0, 1.0, (pm.nu, 4))
    params = _gait_params() if pkind else np.zeros(16)
    jf = jsph.scalar_forward(jm, _j(qpos), _j(qvel))
    tf = tsph.scalar_forward(pm, _t(qpos), _t(qvel))
    jctx = jsph.ctx_from(jm, jf, _j(qpos), _j(qvel), _j(ctrl), jnp.asarray(T0S))
    jctx.params = [jnp.asarray(p) for p in params]
    tctx = tsph.ctx_from(pm, tf, _t(qpos), _t(qvel), _t(ctrl),
                          torch.tensor(T0S, dtype=torch.float64))
    tctx.params = [torch.tensor(p) for p in params]
    jrun, jterm = getattr(jkc, name)(jm, **kw)
    trun, tterm = tkc.KERNEL_COSTS[name](pm, **kw)
    want = np.asarray(jrun(jctx, 0))
    np.testing.assert_allclose(trun(tctx, 0).numpy(), want, rtol=1e-10)
    np.testing.assert_allclose(tterm(tctx).numpy(), np.asarray(jterm(jctx)), rtol=1e-10)
    if name == "quadruped":  # the clock matters: the same states at t = 0 cost otherwise
        tctx.time = torch.zeros(4, dtype=torch.float64)
        assert not np.allclose(trun(tctx, 0).numpy()[1:], want[1:], rtol=1e-6)


def _jax_plan(jm, cost, kw, cfg, qpos, qvel, t0, U, noise, params):
    """JAX reference: the rollout kernel's body (ops/rollout_kernel.py:
    86-126: clip(U + noise), time = t0 + t h, the cost at time + h) as a
    plain loop, then solver/kernel_mppi.py:80-100 with clamp_plan."""
    running, terminal = getattr(jkc, cost)(jm, **kw)
    T, nu = U.shape
    K = noise.shape[-1]
    h = jm.timestep
    lo, hi = np.asarray(cfg.ctrl_low), np.asarray(cfg.ctrl_high)
    qp = [jnp.full(K, qpos[i]) for i in range(jm.nq)]
    qv = [jnp.full(K, qvel[i]) for i in range(jm.nv)]
    t0 = jnp.full(K, t0)
    prm = [jnp.asarray(x) for x in params]
    fwd = jsph.scalar_forward(jm, qp, qv)
    cost_acc = jnp.zeros(K)
    for t in range(T):
        u = [jnp.clip(U[t, i] + jnp.asarray(noise[t, i]), lo[i], hi[i]) for i in range(nu)]
        time = t0 + t * h
        qp, qv, _ = jsph.scalar_step(jm, qp, qv, u, time, fwd=fwd)
        fwd = jsph.scalar_forward(jm, qp, qv)
        ctx = jsph.ctx_from(jm, fwd, qp, qv, u, time + h)
        ctx.params = prm
        cost_acc = cost_acc + running(ctx, t)
    ctx = jsph.ctx_from(jm, fwd, qp, qv, [0.0] * nu, t0 + T * h)
    ctx.params = prm
    costs = cost_acc + terminal(ctx)
    temperature = cfg.temperature * np.exp(params[12])
    beta = jnp.min(costs)
    w = jnp.exp(-(costs - beta) / temperature)
    w = w / (jnp.sum(w) + cfg.weight_eps)
    update = jnp.einsum("tuk,k->tu", jnp.asarray(noise), w)
    U_new = jnp.clip(U + update, lo, hi)
    action = jnp.clip(U_new[0], lo, hi)
    U_shifted = jnp.concatenate([U_new[1:], cfg.tail_decay * U_new[-1:]], axis=0)
    return costs, action, U_shifted, dict(beta=beta, ess=1.0 / jnp.sum(w * w),
                                          update_norm=jnp.linalg.norm(update))


# task, cost kwargs, params: go1_collect with the goal and gait in the
# params (the actuator ctrlrange clamp); go1 (the +-10 clamp)
_PLAN_CASES = {"go1_collect": (dict(param_goal=True, param_gait=True), "gait"),
               "go1": (dict(), None)}


@pytest.mark.parametrize("task", list(_PLAN_CASES))
def test_go1_kernel_mppi_plan_matches_jax_reference(models, task):
    """make_kernel_mppi(...).plan on the CPU against the JAX loop with the
    same noise, from a plant at t = 1.234 s (nonzero start time) with a
    plan large enough that both clamps bind: costs, action, U' and the
    weights' diagnostics to 1e-8."""
    jm, _ = models
    kw, pkind = _PLAN_CASES[task]
    spec, model, _, _, _, init, cfg = load_task(task, device="cpu", dtype=torch.float64)
    kw = dict(spec.cost_kwargs, **kw)
    K, T = 16, 3
    cfg = dataclasses.replace(cfg, n_samples=K, horizon=T)
    rng = np.random.default_rng(21)
    qpos = init.qpos.numpy().copy()
    qpos[7:] += rng.normal(0, 0.05, 12)
    qvel = rng.normal(0, 0.3, model.nv)
    scale = 12.0 if task == "go1" else 1.0      # past +-10 / past the ctrlrange
    U = rng.normal(0, scale, (T, model.nu))
    params = _gait_params() if pkind else np.zeros(16)
    noise = cfg.sigma * np.exp(params[11]) * rng.normal(0, scale, (T, model.nu, K))
    t0 = 1.234
    plan = make_kernel_mppi(model, spec.kernel_cost_factory, cfg, kw, device="cpu")
    st = MPPIState(U=torch.tensor(U), generator=torch.Generator())
    plant = PhysicsState(torch.tensor(qpos), torch.tensor(qvel),
                         torch.tensor(t0, dtype=torch.float64))
    action, st2, diag = plan(st, plant, params=torch.tensor(params), noise=torch.tensor(noise))
    costs, _, _ = plan.rollouts(
        plant.qpos[:, None].expand(model.nq, K).contiguous(),
        plant.qvel[:, None].expand(model.nv, K).contiguous(),
        torch.full((1, K), t0, dtype=torch.float64), torch.tensor(U),
        torch.tensor(noise), params=torch.tensor(params))
    jc, ja, jU, jd = _jax_plan(jm, spec.kernel_cost, kw, cfg, qpos, qvel, t0, U, noise, params)
    np.testing.assert_allclose(costs.numpy(), np.asarray(jc), rtol=1e-8)
    np.testing.assert_allclose(action.numpy(), np.asarray(ja), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(st2.U.numpy(), np.asarray(jU), rtol=1e-8, atol=1e-12)
    for name, v in jd.items():
        np.testing.assert_allclose(float(getattr(diag, name)), float(v), rtol=1e-8,
                                   err_msg=name)
    lo, hi = np.asarray(cfg.ctrl_low), np.asarray(cfg.ctrl_high)
    assert ((U + noise.mean(-1) < lo) | (U + noise.mean(-1) > hi)).any()   # the clamp binds
    assert ((np.asarray(jU)[:-1] == lo) | (np.asarray(jU)[:-1] == hi)).any()


def test_go1_task_registry_matches_jax():
    """go1 and go1_collect: the JAX registry's MPPI constants, costs, start
    keyframe and control clamps (envs/tasks.py:123-133, 166-175)."""
    from humanoid_mppi_rl_tpu.envs.tasks import TASKS as JTASKS

    for name, clamp in (("go1", "abs"), ("go1_collect", "range")):
        spec, model, _, _, _, init, cfg = load_task(name, device="cpu", dtype=torch.float64)
        js = JTASKS[name]
        for f in ("n_samples", "horizon", "temperature", "sigma", "tail_decay"):
            assert getattr(cfg, f) == getattr(js.mppi, f), (name, f)
        assert spec.kernel_cost == js.kernel_cost and spec.init_keyframe == "home"
        np.testing.assert_array_equal(init.qpos.numpy(), dict(model.keyframes)["home"])
        assert cfg.clamp_plan
        if clamp == "abs":
            assert cfg.ctrl_low == (-10.0,) * 12 and cfg.ctrl_high == (10.0,) * 12
        else:
            lo, hi = model.ctrl_range()
            assert cfg.ctrl_low == tuple(lo) and cfg.ctrl_high == tuple(hi)
    assert TASKS["go1"].plant == "go1_plant"


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("host_rollout_go1") / "libhost_rollout.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
                    str(CSRC / "host_rollout.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.hmr_rollout_host_f64.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
    lib.hmr_rollout_host_f64.restype = None
    lib.hmr_tables_size.argtypes = [ctypes.c_int]
    lib.hmr_tables_size.restype = ctypes.c_int
    return lib


_HOST_CASES = [("go1_collect", 16), ("go1", 16), ("go1_collect", 9)]


@pytest.mark.parametrize("task, K", _HOST_CASES, ids=[f"{t}-K{k}" for t, k in _HOST_CASES])
def test_go1_kernel_body_on_host_matches_plain_rollout(host_lib, task, K):
    """csrc/rollout_body.cuh built with g++ (one lane per sample) against
    rollouts_plain, f64, T=3, on go1_inputs (the seven poses, t0 in [0, 24]
    s), with the task's clamp; K=9 is ragged against the seven poses."""
    kw, pkind = _PLAN_CASES[task]
    spec, model, *_, cfg = load_task(task, device="cpu", dtype=torch.float64)
    kw = dict(spec.cost_kwargs, **kw)
    T = 3
    x = go1_inputs(model, K, T, torch.float64, seed=7, device="cpu")
    p = torch.tensor(_gait_params() if pkind else np.zeros(16))
    ro = rk.build_rollout_kernel(model, spec.kernel_cost_factory, T, ctrl_low=cfg.ctrl_low,
                                 ctrl_high=cfg.ctrl_high, cost_kwargs=kw, device="cpu")
    cost, qpos_T, qvel_T = ro(*x, params=p)
    tables = rk.pack_tables(model, spec.kernel_cost_factory, kw, cfg.ctrl_low, cfg.ctrl_high, True,
                            torch.float64)
    assert host_lib.hmr_tables_size(1) == len(tables)
    buf = ctypes.create_string_buffer(tables, len(tables))
    ins = [np.ascontiguousarray(a.numpy()) for a in (*x, p)]
    outs = [np.zeros(K), np.zeros((model.nq, K)), np.zeros((model.nv, K))]
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    host_lib.hmr_rollout_host_f64(ctypes.cast(buf, ctypes.c_void_p),
                                  *[ptr(a) for a in ins + outs], K, T)
    np.testing.assert_allclose(outs[0], cost.numpy(), rtol=1e-9)
    np.testing.assert_allclose(outs[1], qpos_T.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(outs[2], qvel_T.numpy(), rtol=1e-9, atol=1e-9)


def test_go1_tables_and_workspace():
    """The Go1 in the kernel's tables: 42 floor pairs (per-body pair lists)
    with their point kinds (2 boxes, 12 cylinders, 24 capsules, 4
    spheres: 140 points), frictionloss on the 12 leg dofs, the quadruped
    cost's id, flags and constants, and a workspace with its start-time
    slot inside ws_size."""
    spec, model, *_, cfg = load_task("go1_collect", device="cpu", dtype=torch.float64)
    kw = dict(spec.cost_kwargs, param_goal=True, param_gait=True)
    t = rk.tables_struct(torch.float64).from_buffer_copy(
        rk.pack_tables(model, spec.kernel_cost_factory, kw, cfg.ctrl_low, cfg.ctrl_high, True,
                       torch.float64))
    kinds = list(t.pair_type[:t.npair])
    points = {0: 1, 1: 2, 2: 6, 3: 8}     # sphere, capsule, cylinder, box
    assert t.npair == 42 and sum(points[k] for k in kinds) == 140
    assert [kinds.count(k) for k in range(4)] == [4, 24, 12, 2]
    # per-body pair lists: the first pair, then the further pairs' scratch
    # slots grouped by body, in pair order
    trunk = model.body_id("trunk")
    assert t.body_pair0[trunk] == 0 and t.body_xadr[trunk + 1] - t.body_xadr[trunk] == 7
    firsts = [p for p in t.body_pair0[:model.nbody] if p >= 0]
    slots = list(t.xpair[:t.nxpair])
    assert sorted(firsts + slots) == list(range(42)) and t.body_xadr[model.nbody] == 29
    for b in range(model.nbody):
        mine = slots[t.body_xadr[b]:t.body_xadr[b + 1]]
        assert mine == sorted(mine) and all(t.pair_body[i] == b for i in mine)
        assert all(i > t.body_pair0[b] for i in mine)
    np.testing.assert_array_equal(list(t.dof_frictionloss[:18]), [0.0] * 6 + [0.2] * 12)
    assert (t.cost_id, t.cost_flags) == (1, 3)
    np.testing.assert_array_equal(list(t.cost_w[2:14]), dict(model.keyframes)["home"][7:19])
    off, size = rk.workspace_layout(model, t.nten)
    assert t.ws_size == size and 0 <= off["time"] < size
    assert size >= 27 * t.nxpair and t.nxpair == 29


REFSITE_XML = """
<mujoco>
  <worldbody>
    <site name="anchor" pos="0 0 1"/>
    <body pos="0 0 1">
      <freejoint/>
      <geom type="box" size="0.1 0.1 0.1" mass="1"/>
      <site name="thruster" pos="0.1 0 0"/>
    </body>
  </worldbody>
  <actuator>
    <motor site="thruster" refsite="anchor" gear="1 0 0 0 0 0"/>
  </actuator>
</mujoco>
"""


def test_go1_unported_costs_and_features_still_raise(models):
    """What the port leaves out stays refused, as the JAX package refuses
    it on the kernel path: a cost the kernel does not carry, spatial
    tendons (the snapshot export), a mesh in a pair without a plane
    (mesh-vs-box), a site transmission with a refsite (the model build) and
    a plane on a moving body."""
    from test_engine_generality import MESH_ON_BOX_XML, SPATIAL_TENDON_XML

    _, pm = models
    with pytest.raises(NotImplementedError, match="carries"):
        rk._cost_constants(lambda model: None, pm, {})
    with pytest.raises(NotImplementedError, match="spatial tendons"):
        export_model_arrays(build_from_mjcf(xml=SPATIAL_TENDON_XML), plant=True)
    mesh_on_box = model_from_arrays(export_model_arrays(
        build_from_mjcf(xml=MESH_ON_BOX_XML, include_self_collisions=True), plant=True))
    with pytest.raises(NotImplementedError, match="mesh-vs-primitive"):
        rk.check_kernel_supported(mesh_on_box)
    with pytest.raises(NotImplementedError, match="refsite"):
        build_from_mjcf(xml=REFSITE_XML)
    plane = pm.contact_pairs[0].geom1
    moving = dataclasses.replace(pm, geoms=tuple(
        dataclasses.replace(g, bodyid=1) if i == plane else g for i, g in enumerate(pm.geoms)))
    with pytest.raises(NotImplementedError, match="moving planes"):
        rk.check_kernel_supported(moving)