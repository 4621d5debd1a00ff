"""PyTorch port: the coupled plant (physics/{spatial,engine,contact,newton}.py
and the plant snapshot) against the JAX engine on the CPU.

Inputs are numpy arrays from a seed. The JAX side is the JAX package's own
engine, jitted once per module. Tolerances in f64 are the JAX package's
(tests/test_physics_parity.py: xpos 1e-10, mass matrix 1e-9, bias 1e-8;
tests/test_kernel.py: qpos 1e-10) with qvel at 1e-9; f32 holds the measured
agreement of two f32 programs that sum in other orders (stated at
test_coupled_step_float32)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics import newton as jnewton
from chip_smoke import plant_state
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.physics import contact as pcontact
from humanoid_mppi_rl_tpu_torch.physics import engine as peng
from humanoid_mppi_rl_tpu_torch.physics import newton as pnewton
from humanoid_mppi_rl_tpu_torch.physics import spatial as psp
from humanoid_mppi_rl_tpu_torch.physics.model import (
    export_model_arrays, load_model, model_from_arrays, snapshot_json, snapshot_path)

ROOT = os.path.join(os.path.dirname(__file__), "..")
HUMANOID_XML = os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", "humanoid.xml")
WALK_SEED0 = os.path.join(ROOT, "artifacts", "walk_seeds", "seed0.npz")

@pytest.fixture(scope="module")
def jax_plant():
    m = build_from_mjcf(HUMANOID_XML, include_self_collisions=True)
    return m, jax.jit(lambda q, v: jeng.forward(m, q, v)), jax.jit(lambda s, u: jeng.step(m, s, u))


@pytest.fixture(scope="module")
def port_model():
    return load_model("humanoid_plant")


def _engine(model, dtype=torch.float64):
    return peng.Engine(model, device="cpu", dtype=dtype)


def _np(x):
    return np.asarray(x, dtype=np.float64)


def test_plant_snapshot_equals_fresh_mjcf_export():
    fresh = snapshot_json(export_model_arrays(
        build_from_mjcf(HUMANOID_XML, include_self_collisions=True), plant=True))
    with open(snapshot_path("humanoid_plant")) as f:
        assert f.read() == fresh, (
            "assets/humanoid_plant.json is stale: regenerate it with snapshot_json("
            "export_model_arrays(build_from_mjcf(..., include_self_collisions=True), plant=True))")
    m = load_model("humanoid_plant")
    assert snapshot_json(export_model_arrays(m, plant=True)) == fresh
    assert snapshot_json(export_model_arrays(model_from_arrays(
        export_model_arrays(m, plant=True)), plant=True)) == fresh
    assert (m.cone, m.impratio, len(m.contact_pairs)) == (0, 1.0, 164)


def test_spatial_algebra_matches_jax():
    from humanoid_mppi_rl_tpu.physics import spatial as jsp

    rng = np.random.default_rng(3)
    q = rng.normal(size=(5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = rng.normal(size=(5, 4))
    v, w = rng.normal(size=(5, 3)), rng.normal(size=(5, 3))
    m6, n6 = rng.normal(size=(5, 6)), rng.normal(size=(5, 6))
    t = torch.tensor
    cases = {
        "quat_mul": (psp.quat_mul(t(q), t(p)), jsp.quat_mul(q, p)),
        "quat_conj": (psp.quat_conj(t(p)), jsp.quat_conj(jnp.asarray(p))),
        "quat_normalize": (psp.quat_normalize(t(p)), jsp.quat_normalize(p)),
        "quat_rotate": (psp.quat_rotate(t(q), t(v)), jsp.quat_rotate(q, v)),
        "quat_rotate_inv": (psp.quat_rotate_inv(t(q), t(v)), jsp.quat_rotate_inv(jnp.asarray(q), v)),
        "quat_from_axis_angle": (psp.quat_from_axis_angle(t(v), t(w[:, 0])),
                                 jsp.quat_from_axis_angle(v, w[:, 0])),
        "quat_log": (psp.quat_log(t(q)), jsp.quat_log(q)),
        "quat_sub": (psp.quat_sub(t(q), t(q[::-1].copy())),
                     jsp.quat_sub(jnp.asarray(q), jnp.asarray(q[::-1]))),
        "quat_to_mat": (psp.quat_to_mat(t(q)), jsp.quat_to_mat(q)),
        "quat_integrate": (psp.quat_integrate(t(q), t(v), 0.005),
                           jsp.quat_integrate(q, v, jnp.asarray(0.005))),
        "skew": (psp.skew(t(v)), jsp.skew(v)),
        "motion_cross": (psp.motion_cross(t(m6), t(n6)), jsp.motion_cross(m6, n6)),
        "motion_cross_force": (psp.motion_cross_force(t(m6), t(n6)),
                               jsp.motion_cross_force(m6, n6)),
        "spatial_inertia_origin": (
            psp.spatial_inertia_origin(t(w[:, 0] ** 2), t(v ** 2), t(w), psp.quat_to_mat(t(q))),
            jsp.spatial_inertia_origin(w[:, 0] ** 2, v ** 2, w, jsp.quat_to_mat(q))),
        "force_at_point": (psp.force_at_point(t(v), t(w)), jsp.force_at_point(v, w)),
    }
    for name, (got, want) in cases.items():
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-12, atol=1e-14, err_msg=name)


@pytest.mark.parametrize("case", ["free_fall", "sunk", "self_contact"])
def test_kinematics_mass_matrix_and_bias_match_jax(jax_plant, port_model, case):
    jm, jfwd, _ = jax_plant
    qpos, qvel, _ = plant_state(jm, case, seed=1)
    js = jfwd(jnp.asarray(qpos), jnp.asarray(qvel))
    eng = _engine(port_model)
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    np.testing.assert_allclose(ps.xpos.numpy(), _np(js.xpos), atol=1e-10)
    np.testing.assert_allclose(ps.xquat.numpy(), _np(js.xquat), atol=1e-10)
    np.testing.assert_allclose(ps.S.numpy(), _np(js.S), atol=1e-10)
    np.testing.assert_allclose(ps.body_vel.numpy(), _np(js.body_vel), atol=1e-10)
    I, xipos = peng.spatial_inertias(eng, ps.xpos, ps.xquat)
    jI, jxipos = jeng._spatial_inertias(jm, js.xpos, js.xquat, jnp.float64)
    np.testing.assert_allclose(xipos.numpy(), _np(jxipos), atol=1e-10)
    M = peng.mass_matrix(eng, ps.S, I)
    np.testing.assert_allclose(M.numpy(), _np(jeng.mass_matrix(jm, js.S, jI)), atol=1e-9)
    bias = peng.bias_forces(eng, ps.S, I, ps.body_vel, ps.qvel)
    np.testing.assert_allclose(bias.numpy(), _np(jeng.bias_forces(jm, js.S, jI, js.body_vel,
                                                                   js.qvel)), atol=1e-8)
    for b in (1, 7, 16):
        np.testing.assert_allclose(ps.body_linvel(b).numpy(), _np(js.body_linvel(b)), atol=1e-10)


def _self_rows_all(eng, ps):
    """Every self candidate's penetration, in candidate order."""
    ct = eng.contact
    keep = ct.n_self
    ct.n_self = ct.s["b1"].shape[0]
    try:
        pens = pcontact._self_rows(ct, ps, ps.S)["pen"]
    finally:
        ct.n_self = keep
    return np.sort(pens.numpy())[::-1]


@pytest.mark.parametrize("case", ["free_fall", "sunk", "self_contact"])
def test_coupled_step_matches_jax(jax_plant, port_model, case):
    """One coupled step in f64: qpos 1e-10, qvel 1e-9; the constraint rows
    (count, J, aref, R, active: the top-k selection and its ties) and the
    constraint force J^T f against the JAX Newton solve."""
    jm, jfwd, jstep = jax_plant
    qpos, qvel, ctrl = plant_state(jm, case)
    js = jfwd(jnp.asarray(qpos), jnp.asarray(qvel))
    jnext = jstep(js, jnp.asarray(ctrl))
    eng = _engine(port_model)
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    info = {}
    pnext = eng.step(ps, torch.tensor(ctrl), info=info)
    np.testing.assert_allclose(pnext.qpos.numpy(), _np(jnext.qpos), atol=1e-10)
    np.testing.assert_allclose(pnext.qvel.numpy(), _np(jnext.qvel), atol=1e-9)
    assert float(pnext.time) == float(jnext.time)

    jr = jnewton.build_rows(jm, js, js.S, jnp.float64)
    pr = pnewton.build_rows(eng.rows, ps, ps.S)
    assert pr.J.shape == jr.J.shape and info["rows"] == jr.J.shape[0] == 171
    assert (pr.n_ineq, pr.n_fric, len(pr.blocks)) == (jr.n_ineq, jr.n_fric, len(jr.blocks))
    np.testing.assert_allclose(pr.J.numpy(), _np(jr.J), atol=1e-12)
    np.testing.assert_allclose(pr.aref.numpy(), _np(jr.aref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(pr.R.numpy(), _np(jr.R), rtol=1e-12)
    np.testing.assert_array_equal(pr.active.numpy(), _np(jr.active))
    assert float(info["active_rows"]) == float(jnp.sum(jr.active))

    I, _ = peng.spatial_inertias(eng, ps.xpos, ps.xquat)
    M = peng.mass_matrix(eng, ps.S, I)
    a0 = torch.linalg.solve(M, torch.tensor(np.random.default_rng(2).normal(0, 5, jm.nv)))
    tau = pnewton.newton_constraint_forces(eng, ps, ps.S, a0, M, n_iter=25)
    jtau = jnewton.newton_constraint_forces(jm, js, js.S, jnp.asarray(a0.numpy()),
                                            jnp.asarray(M.numpy()), n_iter=25)
    np.testing.assert_allclose(tau.numpy(), _np(jtau), rtol=1e-9, atol=1e-7)

    n_self = eng.contact.n_self
    self_active = pr.active.numpy()[:n_self]      # the self rows lead (frictionless)
    if case == "sunk":
        assert pr.active.numpy()[n_self:n_self + 140].sum() > 0   # floor facets
    if case == "self_contact":
        assert self_active.sum() >= 2
        pens = _self_rows_all(eng, ps)
        live = pens[pens > 0]
        assert len(set(live.tolist())) < len(live), "no two candidates tie"


def test_coupled_step_float32(jax_plant, port_model):
    """f32 against the JAX engine in f32 on the three states: two f32
    programs summing in other orders, through 25 Newton iterations that
    never reach the 1e-12 stopping rule. Measured here: qpos <= 1.5e-6,
    qvel <= 3e-4 (sunk); held at qpos 1e-5, qvel 3e-3."""
    jm, jfwd, jstep = jax_plant
    eng = _engine(port_model, torch.float32)
    for case in ("free_fall", "sunk", "self_contact"):
        qpos, qvel, ctrl = plant_state(jm, case)
        js = jfwd(jnp.asarray(qpos, jnp.float32), jnp.asarray(qvel, jnp.float32))
        jnext = jstep(js, jnp.asarray(ctrl, jnp.float32))
        f32 = lambda a: torch.tensor(a, dtype=torch.float32)
        info = {}
        pnext = eng.step(eng.forward(f32(qpos), f32(qvel)), f32(ctrl), info=info)
        assert pnext.qpos.dtype == torch.float32 and int(info["iterations"]) == 25
        np.testing.assert_allclose(pnext.qpos.numpy(), _np(jnext.qpos), atol=1e-5, err_msg=case)
        np.testing.assert_allclose(pnext.qvel.numpy(), _np(jnext.qvel), atol=3e-3, err_msg=case)


def _variant(jm, **changes):
    """A JAX plant model with other solver settings, and its port model."""
    jv = dataclasses.replace(jm, **changes)
    return jv, model_from_arrays(export_model_arrays(jv, plant=True))


_VARIANTS = {
    # elliptic friction cones (the plane pairs become condim-3 blocks)
    "elliptic": dict(cone=1, impratio=10.0),
    # dof friction loss on every hinge: Huber rows
    "frictionloss": dict(dof_frictionloss=np.r_[np.zeros(6), np.full(21, 0.4)]),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_newton_variants_match_jax(jax_plant, variant):
    """The solver's row classes the humanoid does not use: elliptic blocks
    and frictionloss rows, on the sunk state, f64 (qpos 1e-10, qvel 1e-9)."""
    jm, _, _ = jax_plant
    jv, pv = _variant(jm, **_VARIANTS[variant])
    qpos, qvel, ctrl = plant_state(jm, "sunk", seed=4)
    js = jeng.forward(jv, jnp.asarray(qpos), jnp.asarray(qvel))
    jnext = jax.jit(lambda s, u: jeng.step(jv, s, u))(js, jnp.asarray(ctrl))
    eng = _engine(pv)
    ps = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    pnext = eng.step(ps, torch.tensor(ctrl))
    jr = jnewton.build_rows(jv, js, js.S, jnp.float64)
    pr = pnewton.build_rows(eng.rows, ps, ps.S)
    assert (pr.n_ineq, pr.n_fric, [b["dim"] for b in pr.blocks]) == (
        jr.n_ineq, jr.n_fric, [b["dim"] for b in jr.blocks])
    assert pr.n_fric == (21 if variant == "frictionloss" else 0)
    assert len(pr.blocks) == (1 if variant == "elliptic" else 0)
    np.testing.assert_allclose(pnext.qpos.numpy(), _np(jnext.qpos), atol=1e-10)
    np.testing.assert_allclose(pnext.qvel.numpy(), _np(jnext.qvel), atol=1e-9)


def test_one_step_replay_of_walk_seed(jax_plant, port_model):
    """One-step predictions from recorded humanoid_walk states and actions
    (artifacts/walk_seeds/seed0.npz, 57-column rows): port vs JAX plant,
    f64, at 6 points of the episode."""
    if not os.path.exists(WALK_SEED0):
        pytest.skip("artifacts/walk_seeds/seed0.npz is absent")
    jm, jfwd, jstep = jax_plant
    d = np.load(WALK_SEED0)
    states, actions = d["states"], d["actions"]
    eng = _engine(port_model)
    for i in np.linspace(0, len(states) - 2, 6).astype(int):
        qpos, qvel, u = states[i, :jm.nq], states[i, jm.nq:jm.nq + jm.nv], actions[i]
        qpos = qpos.copy()
        qpos[3:7] /= np.linalg.norm(qpos[3:7])
        jnext = jstep(jfwd(jnp.asarray(qpos), jnp.asarray(qvel)), jnp.asarray(u))
        pnext = eng.step(eng.forward(torch.tensor(qpos), torch.tensor(qvel)), torch.tensor(u))
        np.testing.assert_allclose(pnext.qpos.numpy(), _np(jnext.qpos), atol=1e-10, err_msg=str(i))
        np.testing.assert_allclose(pnext.qvel.numpy(), _np(jnext.qvel), atol=1e-9, err_msg=str(i))


def test_unported_solvers_and_features_raise(port_model):
    """Every solver and feature of the JAX engine steps: coupled_pgs on the
    humanoid plant (finite, the qpos0 state sunk 0.2 m), a K batch on the
    coupled tier (each sample its one-sample step), a mesh-vs-primitive
    pair (tests/test_torch_port_mesh_pairs.py holds it against JAX); an
    unknown solver raises, and a model without the engine's fields cannot
    step (the planner snapshots carry them since the penalty tier plans on
    them)."""
    eng = _engine(port_model)
    st = eng.forward(torch.tensor(port_model.qpos0), torch.zeros(port_model.nv))
    qpos = np.asarray(port_model.qpos0, dtype=np.float64).copy()
    qpos[2] -= 0.2
    f64 = torch.float64
    rest = eng.forward(torch.tensor(port_model.qpos0), torch.zeros(port_model.nv, dtype=f64))
    sunk = eng.forward(torch.tensor(qpos), torch.zeros(port_model.nv, dtype=f64))
    pgs = eng.step(sunk, torch.zeros(port_model.nu, dtype=f64), solver="coupled_pgs")
    assert torch.isfinite(pgs.qvel).all() and float(pgs.qvel[2]) > 0.0
    batch = eng.forward(torch.tensor(np.stack([port_model.qpos0, qpos])),
                        torch.zeros(2, port_model.nv, dtype=f64), torch.zeros(2, dtype=f64))
    stepped = eng.step(batch, torch.zeros(2, port_model.nu, dtype=f64))
    for k, one in enumerate((rest, sunk)):
        torch.testing.assert_close(stepped.qvel[k],
                                   eng.step(one, torch.zeros(21, dtype=f64)).qvel,
                                   rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="unknown solver"):
        eng.step(st, torch.zeros(port_model.nu), solver="pgs")
    no_fields = dataclasses.replace(load_model("humanoid"), pred_mask=None)
    with pytest.raises(ValueError, match="engine's fields"):
        peng.Engine(no_fields, device="cpu", dtype=torch.float64).step(st, torch.zeros(21))
    meshed = _engine(load_model("mesh_on_box_plant"))
    assert meshed.contact.mesh_pairs and meshed.contact.n_plane == 8
    q = np.asarray(meshed.model.qpos0, dtype=np.float64).copy()
    q[2] -= 0.06
    out = meshed.step(meshed.forward(torch.tensor(q), torch.zeros(6, dtype=f64)),
                      torch.zeros(0, dtype=f64))
    assert torch.isfinite(out.qpos).all() and float(out.qvel[2]) > 0.0
