"""PyTorch port: the array engine's penalty tier over a K batch
(physics/engine.step(solver="penalty") with contact.contact_terms and the
limit law) and dynamics/physics.make_scalar_plant_dynamics, against the JAX
package on the CPU in f64.

The penalty step is held against jax.vmap of JAX step(solver="penalty") and
against the port's plain scalar_step (ops/scalar_physics, the rollout
kernel's math) on the humanoid, the Go1, the cartpole and the hopper,
three chained steps from states that put feet in the floor and joints past
their limits. Sample 0 of the humanoid is JAX tests/test_restitution_cap.py's
release 0.35 m below the floor, and sample 0 of the cartpole its release
0.3 m past the slider's limit: the restitution cap binds there. Tolerances:
qpos 1e-10, qvel 1e-8 (tests/test_kernel.py:61-62)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanoid_mppi_rl_tpu.dynamics.physics import (
    make_scalar_plant_dynamics as jax_scalar_plant_dynamics)
from chip_smoke import hopper_foot_low
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu_torch.dynamics.physics import (make_physics_dynamics,
                                                         make_scalar_plant_dynamics)
from humanoid_mppi_rl_tpu_torch.ops import scalar_physics as psph
from humanoid_mppi_rl_tpu_torch.physics import contact as pcontact
from humanoid_mppi_rl_tpu_torch.physics import engine as peng
from humanoid_mppi_rl_tpu_torch.physics.model import FREE, load_model

ROOT = os.path.join(os.path.dirname(__file__), "..")
ROBOTS = ("humanoid", "go1", "cartpole", "hopper")
K, STEPS = 6, 3
F64 = torch.float64


def _xml(robot):
    return os.path.join(ROOT, "humanoid_mppi_rl_tpu", "assets", f"{robot}.xml")


@pytest.fixture(scope="module")
def jax_steps():
    """Per robot: the JAX planner model and jit(vmap(step penalty)), built
    once for the module."""
    out = {}
    for robot in ROBOTS:
        jm = build_from_mjcf(_xml(robot))
        out[robot] = (jm, jax.jit(jax.vmap(lambda s, u, jm=jm: jeng.step(jm, s, u,
                                                                          solver="penalty"))))
    return out


def _states(model, robot: str, seed: int = 0):
    """K states (numpy qpos (K, nq), qvel (K, nv), ctrl (K, nu)): class k % 3
    keeps the joints inside their ranges (0), pushes the limited hinge and
    slide joints past their upper (1) or lower (2) limits; the root sinks
    into the floor by 2 to 12 cm; sample 0 is the restitution-cap release."""
    rng = np.random.default_rng(seed)
    base = (np.asarray(dict(model.keyframes)["home"]) if robot == "go1"
            else np.asarray(model.qpos0, dtype=np.float64))
    qpos = np.tile(base, (K, 1)) + rng.normal(0, 0.05, (K, model.nq))
    qvel = rng.normal(0, 0.5, (K, model.nv))
    ctrl = rng.normal(0, 0.5, (K, model.nu))
    hs = [j for j in model.joints if j.jtype != FREE and j.limited]
    for k in range(K):
        sink = 0.02 + 0.1 * k / (K - 1)
        for j in hs[::2]:
            if k % 3 == 1:
                qpos[k, j.qposadr] = j.range[1] + 0.05 + 0.1 * rng.random()
            elif k % 3 == 2:
                qpos[k, j.qposadr] = j.range[0] - 0.05 - 0.1 * rng.random()
        if robot in ("humanoid", "go1"):
            qpos[k, 3:7] /= np.linalg.norm(qpos[k, 3:7])
            qpos[k, 2] -= sink
        elif robot == "hopper":   # the foot's lowest point `sink` into the floor
            qpos[k, 1] -= hopper_foot_low(model, qpos[k][:, None])[0] + sink
    if robot == "humanoid":       # released 0.35 m below the floor, at rest
        qpos[0], qvel[0], ctrl[0] = base, 0.0, 0.0
        qpos[0, 2] -= 0.35
    elif robot == "cartpole":     # released 0.3 m past the slider's limit
        qpos[0], qvel[0], ctrl[0] = (1.3, 0.0), 0.0, 0.0
    return qpos, qvel, ctrl


def _port_state(eng, qpos, qvel):
    return eng.forward(torch.tensor(qpos), torch.tensor(qvel),
                       torch.zeros(qpos.shape[0], dtype=F64))


def _raw_and_capped_contact(eng, st):
    """The penalty normal forces before and after the restitution cap."""
    rows = pcontact.collect_contact_rows(eng.contact, st, st.S, penalty=True)
    raw = torch.clamp(rows["meff"] * rows["d_r"] * (rows["d_r"] * rows["k_base"] * rows["pen"]
                                                   - rows["b_ref"] * rows["vn"]), min=0.0) \
        * rows["active"]
    cap = rows["meff"] * torch.clamp(pcontact.RESTITUTION_VCAP - rows["vn"], min=0.0) / eng.h
    return rows, raw, torch.minimum(raw, cap)


@pytest.mark.parametrize("robot", ROBOTS)
def test_penalty_step_matches_jax_and_the_plain_step(jax_steps, robot):
    jm, jstep = jax_steps[robot]
    pm = load_model(robot)
    eng = peng.Engine(pm, device="cpu", dtype=F64)
    qpos, qvel, ctrl = _states(pm, robot)
    st = _port_state(eng, qpos, qvel)
    # what the states switch on: floor contacts (the cap binding somewhere
    # on the humanoid), joint limits, and for the cartpole its limit release
    if eng.contact is not None:
        rows, raw, capped = _raw_and_capped_contact(eng, st)
        assert int((rows["pen"] > 0).sum()) >= K
        if robot == "humanoid":
            assert bool((capped[0] < raw[0]).any())
    hs = [j for j in pm.joints if j.jtype != FREE and j.limited]
    q_hs = qpos[:, [j.qposadr for j in hs]]
    lo, hi = np.array([j.range[0] for j in hs]), np.array([j.range[1] for j in hs])
    assert ((q_hs > hi) | (q_hs < lo)).any(axis=1).sum() >= K // 2

    js = jax.vmap(lambda q, v: jeng.forward(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel))
    u = torch.tensor(ctrl)
    qp = [torch.tensor(qpos[:, i]) for i in range(pm.nq)]
    qv = [torch.tensor(qvel[:, i]) for i in range(pm.nv)]
    uu = [u[:, i] for i in range(pm.nu)]
    for s in range(STEPS):
        st = eng.step(st, u, solver="penalty")
        js = jstep(js, jnp.asarray(ctrl))
        qp, qv, _ = psph.scalar_step(pm, qp, qv, uu, torch.full((K,), s * pm.timestep, dtype=F64))
        np.testing.assert_allclose(st.qpos.numpy(), np.asarray(js.qpos), atol=1e-10,
                                   err_msg=f"{robot} step {s}: qpos vs JAX")
        np.testing.assert_allclose(st.qvel.numpy(), np.asarray(js.qvel), atol=1e-8,
                                   err_msg=f"{robot} step {s}: qvel vs JAX")
        np.testing.assert_allclose(st.qpos.numpy(), torch.stack(qp, -1).numpy(), atol=1e-10,
                                   err_msg=f"{robot} step {s}: qpos vs scalar_step")
        np.testing.assert_allclose(st.qvel.numpy(), torch.stack(qv, -1).numpy(), atol=1e-8,
                                   err_msg=f"{robot} step {s}: qvel vs scalar_step")
        np.testing.assert_allclose(st.time.numpy(), np.asarray(js.time), rtol=0, atol=1e-15)
    assert np.isfinite(st.qpos.numpy()).all()


@pytest.mark.parametrize("robot", ROBOTS)
def test_penalty_pieces_of_a_batch_equal_their_one_sample_calls(robot):
    """Each batched function of the penalty step, row by row, against its
    one-sample call on that row: bit for bit where the ops are the same
    elementwise ones (actuator forces), to rounding where a batched product
    replaces an unbatched one."""
    pm = load_model(robot)
    eng = peng.Engine(pm, device="cpu", dtype=F64)
    qpos, qvel, ctrl = _states(pm, robot, seed=1)
    st = _port_state(eng, qpos, qvel)
    u = torch.tensor(ctrl)

    def pieces(s, uk):
        I, xipos = peng.spatial_inertias(eng, s.xpos, s.xquat)
        out = dict(I=I, xipos=xipos, M=peng.mass_matrix(eng, s.S, I),
                   bias=peng.bias_forces(eng, s.S, I, s.body_vel, s.qvel),
                   act=peng.actuator_forces(eng, s.qpos, s.qvel, uk),
                   passive=peng.passive_forces(eng, s.qpos, s.qvel)[0],
                   passive_G=peng.passive_forces(eng, s.qpos, s.qvel)[1],
                   limit=peng.limit_constraint_forces(eng, s.qpos, s.qvel)[0],
                   limit_G=peng.limit_constraint_forces(eng, s.qpos, s.qvel)[1],
                   integrate=peng.integrate_qpos(eng, s.qpos, s.qvel, eng.h),
                   next_qpos=eng.step(s, uk, solver="penalty").qpos)
        if eng.contact is not None:
            tau, G = pcontact.contact_terms(eng.contact, s, s.S, eng.h)
            rows = pcontact.collect_contact_rows(eng.contact, s, s.S, penalty=True)
            out.update(contact=tau, contact_G=G, pen=rows["pen"], vn=rows["vn"],
                       JpN=rows["JpN"], Jp=rows["Jp"], vt_norm=rows["vt_norm"])
        return out

    batch = pieces(st, u)
    for k in range(K):
        single = pieces(eng.forward(torch.tensor(qpos[k]), torch.tensor(qvel[k])), u[k])
        for name, b in batch.items():
            torch.testing.assert_close(single[name], b[k], rtol=1e-13, atol=1e-12,
                                       msg=f"{robot} {name} row {k}")
        assert torch.equal(single["act"], batch["act"][k])


def test_penalty_dynamics_and_the_planner_tier_of_load_task():
    """make_physics_dynamics(solver="penalty") steps a batch; so does the
    coupled tier, each sample its one-sample step."""
    pm = load_model("hopper")
    dyn = make_physics_dynamics(pm, substeps=2, solver="penalty", device="cpu", dtype=F64)
    qpos, qvel, ctrl = _states(pm, "hopper", seed=2)
    st = _port_state(dyn.engine, qpos, qvel)
    two = dyn(st, torch.tensor(ctrl))
    once = dyn.engine.step(dyn.engine.step(st, torch.tensor(ctrl), solver="penalty"),
                           torch.tensor(ctrl), solver="penalty")
    assert torch.equal(two.qpos, once.qpos) and two.qpos.shape == (K, pm.nq)
    coupled = make_physics_dynamics(load_model("hopper_plant"), device="cpu", dtype=F64)
    batch = coupled(_port_state(coupled.engine, qpos, qvel), torch.tensor(ctrl))
    assert batch.qpos.shape == (K, pm.nq)
    for k in (0, K - 1):
        one = coupled(coupled.engine.forward(torch.tensor(qpos[k]), torch.tensor(qvel[k])),
                      torch.tensor(ctrl[k]))
        torch.testing.assert_close(batch.qvel[k], one.qvel, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("robot", ["humanoid", "hopper"])
def test_scalar_plant_dynamics_matches_jax(robot):
    """make_scalar_plant_dynamics (the kernel's math plus the engine's
    kinematics) against JAX's on one state, two substeps; and a batch of
    that state equals it."""
    jm = build_from_mjcf(_xml(robot))
    pm = load_model(robot)
    qpos, qvel, ctrl = _states(pm, robot, seed=3)
    q, v, u = qpos[3], qvel[3], ctrl[3]
    jdyn = jax_scalar_plant_dynamics(jm, substeps=2)
    jst = jdyn(jeng.forward(jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(0.25)),
               jnp.asarray(u), 0)
    pdyn = make_scalar_plant_dynamics(pm, substeps=2, device="cpu", dtype=F64)
    st = pdyn(pdyn.engine.forward(torch.tensor(q), torch.tensor(v),
                                  torch.tensor(0.25, dtype=F64)), torch.tensor(u))
    np.testing.assert_allclose(st.qpos.numpy(), np.asarray(jst.qpos), atol=1e-10)
    np.testing.assert_allclose(st.qvel.numpy(), np.asarray(jst.qvel), atol=1e-8)
    np.testing.assert_allclose(st.xpos.numpy(), np.asarray(jst.xpos), atol=1e-10)
    np.testing.assert_allclose(float(st.time), float(jst.time), atol=1e-15)
    batch = pdyn(pdyn.engine.forward(torch.tensor(qpos), torch.tensor(qvel),
                                     torch.full((K,), 0.25, dtype=F64)), torch.tensor(ctrl))
    torch.testing.assert_close(batch.qpos[3], st.qpos, rtol=0, atol=1e-13)
