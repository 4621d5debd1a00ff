"""PyTorch port, slice 13: LQR (solver/lqr.py) and the engine functions it
reads (inverse dynamics, transmission moments, CoM jacobians), against
the JAX package on the CPU in f64.

Tolerances: inverse dynamics rtol=atol=1e-8; transmission moments and CoM
jacobians atol 1e-10; the tangent maps 1e-12; A and B from `linearize`
against JAX's jitted linearize (jacfwd through its Newton while_loop)
1e-7 relative to the largest entry; the DARE gain 1e-10 relative; the
stand set-point's u_vert and ctrl0 atol 1e-8 (the same sweep index);
the balance Q atol 1e-9. JAX's humanoid linearization is not called (its
compile alone outgrows a test); the port's humanoid A and B are held
against central differences of the port's own f64 coupled step instead
(itself held against JAX's by tests/test_torch_port_plant.py), along
random directions through every column: rtol 1e-5. The humanoid's closed
loop runs on the card (tests/test_torch_port_cuda.py, chip_smoke main_lqr);
here the cartpole's 400 steps hold JAX's gate."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hopper_states
from humanoid_mppi_rl_tpu.physics import engine as jeng
from humanoid_mppi_rl_tpu.physics.model import build_from_mjcf
from humanoid_mppi_rl_tpu.solver import lqr as jlqr
from humanoid_mppi_rl_tpu_torch.physics import engine as peng
from humanoid_mppi_rl_tpu_torch.physics import newton
from humanoid_mppi_rl_tpu_torch.physics.model import load_model
from humanoid_mppi_rl_tpu_torch.solver import lqr as tlqr
from test_engine_generality import SITE_ACT_XML, TENDON_ACT_XML
from torch_port_small_robots import jax_models

# One intra-op thread: the suite runs in several worker processes on shared
# cores, and PyTorch's default of a thread per core in each of them
# oversubscribes the cores (one trainer test took 35x longer, six at once).
torch.set_num_threads(1)

F64 = torch.float64
ASSETS = os.path.join(os.path.dirname(__file__), "..", "humanoid_mppi_rl_tpu", "assets")
CARTPOLE_Q = np.diag([10.0, 100.0, 1.0, 1.0])
CARTPOLE_R = 0.1 * np.eye(1)
N_HEIGHTS = 101


def _eng(model):
    return peng.Engine(model, device="cpu", dtype=F64)


def _states(jm, eng, qpos, qvel):
    """JAX's forward under jax.jit (op by op, its first call compiles every
    primitive: 10 s on the humanoid against 2.5 s) and the port's."""
    return (jax.jit(lambda q, v: jeng.forward(jm, q, v))(jnp.asarray(qpos), jnp.asarray(qvel)),
            eng.forward(torch.tensor(qpos), torch.tensor(qvel)))


@pytest.fixture(scope="module")
def humanoid():
    return build_from_mjcf(os.path.join(ASSETS, "humanoid.xml")), _eng(load_model("humanoid"))


@pytest.fixture(scope="module")
def cartpole():
    return jax_models("cartpole")[1], _eng(load_model("cartpole_plant"))


@pytest.fixture(scope="module")
def hopper():
    return jax_models("hopper")[1], _eng(load_model("hopper_plant"))


@pytest.fixture(scope="module")
def jax_linearize():
    """JAX's linearize under jax.jit, one compile per model (the state is
    traced)."""
    cache = {}

    def run(jm, qpos0, qvel0, ctrl0):
        if id(jm) not in cache:
            cache[id(jm)] = jax.jit(lambda q, v, u: jlqr.linearize(jm, q, v, u))
        A, B = cache[id(jm)](jnp.asarray(qpos0), jnp.asarray(qvel0), jnp.asarray(ctrl0))
        return np.asarray(A), np.asarray(B)

    return run


@pytest.fixture(scope="module")
def jax_inverse_dynamics():
    """JAX's forward + inverse_dynamics under jax.jit, one compile per
    model. qacc=None is JAX's qacc = 0 without the M qacc term, which adds
    exact zeros: it runs as qacc = 0."""
    cache = {}

    def run(jm, qpos, qvel, qacc=None):
        if id(jm) not in cache:
            cache[id(jm)] = jax.jit(
                lambda q, v, a: jeng.inverse_dynamics(jm, jeng.forward(jm, q, v), a))
        qacc = np.zeros(jm.nv) if qacc is None else qacc
        return np.asarray(cache[id(jm)](*(jnp.asarray(a) for a in (qpos, qvel, qacc))))

    return run


@pytest.fixture(scope="module")
def setpoints(humanoid):
    """JAX's and the port's stand_setpoint at N_HEIGHTS. JAX's is taken by
    the steps of its stand_setpoint (solver/lqr.py:110) in one jitted call
    (it runs all but the sweep op by op: 20 s of its 28 here): the vmapped
    sweep over the heights, which also returns each height's qfrc0 and
    moment rows; the argmin; ctrl0 by lstsq at the calibrated height."""
    jm, eng = humanoid
    zvel = jnp.zeros(jm.nv)
    key = jnp.asarray(dict(jm.keyframes)["stand_on_left_leg"])
    heights = jnp.linspace(-1e-3, 1e-3, N_HEIGHTS)

    def at(h):
        st = jeng.forward(jm, key.at[2].add(h), zvel)
        return jeng.inverse_dynamics(jm, st), jeng.actuator_moment(jm, st)

    qfrc, moments = jax.jit(jax.vmap(at))(heights)
    u_vert = qfrc[:, 2]
    best = int(jnp.argmin(jnp.abs(u_vert)))
    qfrc0, M_act = qfrc[best], moments[best]
    ctrl0, *_ = jnp.linalg.lstsq(M_act.T, qfrc0)
    info = dict(height=float(heights[best]), u_vert=np.asarray(u_vert),
                heights=np.asarray(heights), qfrc0=np.asarray(qfrc0),
                residual=np.asarray(M_act.T @ ctrl0 - qfrc0))
    return ((np.asarray(key.at[2].add(heights[best])), np.asarray(ctrl0), info),
            tlqr.stand_setpoint(eng, n_heights=N_HEIGHTS))


def _humanoid_cases(jm):
    """(name, qpos, qvel, qacc): the one-leg stand lowered 2 mm (floor
    rows active) and a crouch with the right knee past its range (a limit
    row active), each at a random velocity and acceleration."""
    rng = np.random.default_rng(0)
    stand = dict(jm.keyframes)["stand_on_left_leg"].copy()
    stand[2] -= 0.002
    crouch = stand.copy()
    knee = next(j for j, n in zip(jm.joints, jm.joint_names) if n == "knee_right")
    crouch[knee.qposadr] = knee.range[0] - 0.05
    return [(name, q, 0.1 * rng.normal(size=jm.nv), rng.normal(size=jm.nv))
            for name, q in (("stand", stand), ("knee_limit", crouch))]


@pytest.mark.parametrize("with_qacc", [False, True])
@pytest.mark.parametrize("robot", ["humanoid", "cartpole", "hopper"])
def test_inverse_dynamics_matches_jax(robot, with_qacc, request, jax_inverse_dynamics):
    """bias - passive - limits - contacts (+ M qacc) in the inverse (r_form)
    reading: the humanoid with floor rows and a knee past its limit, the
    cartpole's cart past its slider range, the hopper's foot in the floor."""
    jm, eng = request.getfixturevalue(robot)
    rng = np.random.default_rng(1)
    if robot == "humanoid":
        cases = _humanoid_cases(jm)
    elif robot == "cartpole":
        cases = [("slider_limit", np.array([1.05, 0.3]), rng.normal(size=2), rng.normal(size=2))]
    else:
        qpos, qvel = hopper_states(eng.model, 2, seed=3)
        cases = [(f"foot_{k}", qpos[:, k], qvel[:, k], rng.normal(size=jm.nv)) for k in range(2)]
    for name, qpos, qvel, qacc in cases:
        want = jax_inverse_dynamics(jm, qpos, qvel, qacc if with_qacc else None)
        ts = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
        got = peng.inverse_dynamics(eng, ts, torch.tensor(qacc) if with_qacc else None).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8, err_msg=name)


def test_inverse_dynamics_root_force_vanishes_at_the_calibrated_height(
        humanoid, setpoints, jax_inverse_dynamics):
    """Both sides' root-z force at their calibrated stand is small beside
    the robot's weight (tests/test_lqr.py's gate), and they agree."""
    jm, eng = humanoid
    (jq, _, _), (tq, _, _) = setpoints
    weight = float(jm.body_mass.sum() * 9.81)
    zero = np.zeros(jm.nv)
    want = float(jax_inverse_dynamics(jm, jq, zero)[2])
    got = float(peng.inverse_dynamics(eng, eng.forward(torch.tensor(tq),
                                                       torch.tensor(zero)))[2])
    assert abs(want) < 0.02 * weight and abs(got) < 0.02 * weight, (want, got)
    assert abs(got - want) < 1e-8


@pytest.mark.parametrize("name", ["humanoid", "site_act_plant", "tendon_act_plant"])
def test_actuator_moment_matches_jax(name, humanoid):
    """Joint rows (the humanoid), site rows at a turned state (three site
    motors, one on a child body) and fixed-tendon rows: atol 1e-10."""
    if name == "humanoid":
        jm, eng = humanoid
    else:
        xml = SITE_ACT_XML if name == "site_act_plant" else TENDON_ACT_XML
        jm, eng = build_from_mjcf(xml=xml, include_self_collisions=True), _eng(load_model(name))
    rng = np.random.default_rng(2)
    qpos = np.asarray(jm.qpos0, dtype=np.float64) + 0.3 * rng.normal(size=jm.nq)
    for qa in jm.free_qposadr:
        qpos[qa + 3:qa + 7] /= np.linalg.norm(qpos[qa + 3:qa + 7])
    js, ts = _states(jm, eng, qpos, rng.normal(size=jm.nv))
    np.testing.assert_allclose(peng.actuator_moment(eng, ts).numpy(),
                               np.asarray(jeng.actuator_moment(jm, js)), rtol=0, atol=1e-10)


def test_com_jacobians_match_jax(humanoid):
    """Every body's CoM jacobian and the torso and world subtrees' at a
    random pose: atol 1e-10."""
    jm, eng = humanoid
    rng = np.random.default_rng(4)
    qpos = np.asarray(jm.qpos0) + 0.2 * rng.normal(size=jm.nq)
    qpos[3:7] /= np.linalg.norm(qpos[3:7])
    js, ts = _states(jm, eng, qpos, np.zeros(jm.nv))
    for b in range(jm.nbody):
        np.testing.assert_allclose(peng.body_com_jacobian(eng, ts, b).numpy(),
                                   np.asarray(jeng.body_com_jacobian(jm, js, b)),
                                   rtol=0, atol=1e-10)
    for root in (0, jm.body_id("torso")):
        np.testing.assert_allclose(peng.subtree_com_jacobian(eng, ts, root).numpy(),
                                   np.asarray(jeng.subtree_com_jacobian(jm, js, root)),
                                   rtol=0, atol=1e-10)


def test_tangent_maps_match_jax_and_are_smooth_at_the_identity(humanoid):
    """_apply_tangent and _tangent_diff against JAX's at a random dq and at
    dq = 0 (the identity quaternion); d/d(dq) of diff(apply(q0, dq), q0) at
    0 is the identity on both sides (the quaternion log's 1e-24 guard:
    finite, not NaN)."""
    jm, eng = humanoid
    rng = np.random.default_rng(5)
    q0 = dict(jm.keyframes)["stand_on_left_leg"]
    japply = jax.jit(lambda q, d: jlqr._apply_tangent(jm, q, d))
    jdiff = jax.jit(lambda q, q0: jlqr._tangent_diff(jm, q, q0))
    for dq in (0.1 * rng.normal(size=jm.nv), np.zeros(jm.nv)):
        jq = np.asarray(japply(jnp.asarray(q0), jnp.asarray(dq)))
        tq = tlqr._apply_tangent(eng, torch.tensor(q0), torch.tensor(dq))
        np.testing.assert_allclose(tq.numpy(), jq, rtol=0, atol=1e-12)
        jd = np.asarray(jdiff(jnp.asarray(jq), jnp.asarray(q0)))
        td = tlqr._tangent_diff(eng, tq, torch.tensor(q0)).numpy()
        np.testing.assert_allclose(td, jd, rtol=0, atol=1e-12)
        np.testing.assert_allclose(td, dq, rtol=0, atol=1e-12)
    jac = torch.autograd.functional.jacobian(
        lambda d: tlqr._tangent_diff(eng, tlqr._apply_tangent(eng, torch.tensor(q0), d),
                                     torch.tensor(q0)),
        torch.zeros(jm.nv, dtype=F64))
    jjac = np.asarray(jax.jit(jax.jacfwd(lambda d: jdiff(japply(jnp.asarray(q0), d),
                                                          jnp.asarray(q0))))(jnp.zeros(jm.nv)))
    np.testing.assert_allclose(jac.numpy(), np.eye(jm.nv), rtol=0, atol=1e-12)
    np.testing.assert_allclose(jjac, np.eye(jm.nv), rtol=0, atol=1e-12)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("robot", ["cartpole", "hopper"])
def test_linearize_matches_jax(robot, request, jax_linearize):
    """A and B against JAX's jitted linearize, 1e-7 relative: the cartpole
    past its slider's limit (a limit row in the Newton solve) and the
    hopper standing with its foot in the floor (contact rows)."""
    jm, eng = request.getfixturevalue(robot)
    if robot == "cartpole":
        qpos0, qvel0 = np.array([1.05, 0.3]), np.array([0.2, -0.1])
    else:
        qpos, qvel = hopper_states(eng.model, 1, seed=3)
        qpos0, qvel0 = qpos[:, 0], qvel[:, 0]
    ctrl0 = 0.1 * np.ones(jm.nu)
    info = {}
    eng.step(eng.forward(torch.tensor(qpos0), torch.tensor(qvel0)), torch.tensor(ctrl0),
             info=info)
    assert int(info["active_rows"]) > 0 and int(info["iterations"]) > 0
    A, B = tlqr.linearize(eng, qpos0, qvel0, ctrl0)
    jA, jB = jax_linearize(jm, qpos0, qvel0, ctrl0)
    assert A.shape == (2 * jm.nv, 2 * jm.nv) and B.shape == (2 * jm.nv, jm.nu)
    assert _rel(A.numpy(), jA) < 1e-7 and _rel(B.numpy(), jB) < 1e-7, \
        (_rel(A.numpy(), jA), _rel(B.numpy(), jB))


def test_linearize_through_the_frozen_newton_iterations_is_the_same(cartpole):
    """`linearize` differentiates only the Newton iterations taken at x = 0;
    through all 25, the converged x frozen by torch.where as on the card
    (early_exit off), the derivative is the same: 1e-12 relative."""
    _, eng = cartpole
    qpos0, qvel0, ctrl0 = np.array([1.05, 0.3]), np.array([0.2, -0.1]), np.array([0.1])
    A, B = tlqr.linearize(eng, qpos0, qvel0, ctrl0)
    full = peng.Engine(eng.model, device="cpu", dtype=F64)
    step = full.step
    full.step = lambda st, u, solver="coupled", n_iter=25, info=None: step(
        st, u, solver, 25, info, early_exit=False)
    Af, Bf = tlqr.linearize(full, qpos0, qvel0, ctrl0)
    assert _rel(A.numpy(), Af.numpy()) < 1e-12 and _rel(B.numpy(), Bf.numpy()) < 1e-12


@pytest.mark.parametrize("robot", ["cartpole", "hopper"])
def test_newton_early_exit_equals_the_masked_loop(robot, cartpole, hopper):
    """newton.solve_qacc with early_exit (the CPU's Engine.step) and without
    (the card's: all n_iter, x frozen by torch.where once converged) give
    the same qacc, row forces and iteration count, bit for bit, on a state
    with active rows; the masked loop took fewer than n_iter."""
    _, eng = {"cartpole": cartpole, "hopper": hopper}[robot]
    if robot == "cartpole":
        qpos, qvel = np.array([1.05, 0.3]), np.array([0.2, -0.1])
    else:
        qpos, qvel = (a[:, 0] for a in hopper_states(eng.model, 1, seed=3))
    st = eng.forward(torch.tensor(qpos), torch.tensor(qvel))
    rows = newton.build_rows(eng.rows, st, st.S)
    assert int(rows.active.sum()) > 0
    I, _ = peng.spatial_inertias(eng, st.xpos, st.xquat)
    M = peng.mass_matrix(eng, st.S, I)
    a0 = torch.linalg.solve(M, torch.tensor(np.random.default_rng(1).normal(0, 5, eng.model.nv)))
    masked = newton.solve_qacc(eng.rows, M, a0, rows, n_iter=25)
    early = newton.solve_qacc(eng.rows, M, a0, rows, n_iter=25, early_exit=True)
    for got, want in zip(early, masked):
        assert torch.equal(got, want)
    assert 0 < int(masked[2]) < 25


def test_solve_dare_matches_jax(cartpole, jax_linearize):
    """The cartpole's upright gain from both packages' Riccati iteration
    on the same (A, B): 1e-10 relative."""
    jm, _ = cartpole
    A, B = jax_linearize(jm, np.zeros(2), np.zeros(2), np.zeros(1))
    want = np.asarray(jlqr.solve_dare(jnp.asarray(A), jnp.asarray(B), jnp.asarray(CARTPOLE_Q),
                                      jnp.asarray(CARTPOLE_R)))
    got = tlqr.solve_dare(*(torch.tensor(x) for x in (A, B, CARTPOLE_Q, CARTPOLE_R))).numpy()
    assert _rel(got, want) < 1e-10


def test_cartpole_lqr_holds_the_pole_up(cartpole, jax_linearize):
    """tests/test_lqr.py:19: LQR about the upright from (0.1, 0.15), 400
    coupled steps: |theta| < 0.02 and |x| < 0.1 at the end; the gain
    equals JAX's (from JAX's jitted linearize) to 1e-7 relative."""
    jm, eng = cartpole
    ctrl, (A, B, K) = tlqr.make_lqr_controller(eng, np.zeros(2), Q=CARTPOLE_Q, R=CARTPOLE_R)
    jA, jB = jax_linearize(jm, np.zeros(2), np.zeros(2), np.zeros(1))
    jK = np.asarray(jlqr.solve_dare(jnp.asarray(jA), jnp.asarray(jB), jnp.asarray(CARTPOLE_Q),
                                    jnp.asarray(CARTPOLE_R)))
    assert _rel(K.numpy(), jK) < 1e-7
    st = eng.forward(torch.tensor([0.1, 0.15], dtype=F64), torch.zeros(2, dtype=F64))
    for _ in range(400):
        st = eng.step(st, ctrl(st))
    assert abs(float(st.qpos[1])) < 0.02, float(st.qpos[1])
    assert abs(float(st.qpos[0])) < 0.1


def test_stand_setpoint_matches_jax(humanoid, setpoints):
    """tests/test_lqr.py:44 at n_heights=101: the same sweep index and
    height, u_vert and ctrl0 atol 1e-8, and JAX's gates (a sign change in
    the sweep, the actuated rows of qfrc0 matched, |ctrl0| <= 1)."""
    jm, _ = humanoid
    (jq, jc, ji), (tq, tc, ti) = setpoints
    assert int(np.argmin(np.abs(ti["u_vert"]))) == int(np.argmin(np.abs(ji["u_vert"])))
    assert abs(ti["height"] - ji["height"]) < 1e-15
    np.testing.assert_allclose(ti["u_vert"], ji["u_vert"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-15)
    weight = float(jm.body_mass.sum() * 9.81)
    assert np.abs(ti["u_vert"]).min() < 0.02 * weight
    assert ti["u_vert"].min() < 0 < ti["u_vert"].max()
    assert np.abs(ti["residual"][6:]).max() < 1e-8
    assert np.abs(tc).max() <= 1.0


def test_humanoid_balance_Q_matches_jax(humanoid, setpoints):
    """The balance Q at the calibrated stand (joint names from the
    snapshot pick the abdomen and left-leg dofs): atol 1e-9."""
    jm, eng = humanoid
    (jq, _, _), _ = setpoints
    np.testing.assert_allclose(tlqr.humanoid_balance_Q(eng, jq), jlqr.humanoid_balance_Q(jm, jq),
                               rtol=0, atol=1e-9)


def test_humanoid_linearization_matches_central_differences(humanoid, setpoints):
    """At the calibrated one-leg stand: J v from the port's (A, B) against
    (f(h v) - f(-h v)) / 2h of the port's f64 coupled step, h = 1e-6, along
    six random directions of (dq, dv, du) (each a combination of every
    column): rtol 1e-5 of |J v|. Then tests/test_lqr.py:64's spectral
    gates: open loop > 1.01, closed loop with the DARE gain of the balance
    Q and R = I < 1.001."""
    jm, eng = humanoid
    _, (qpos0, ctrl0, _) = setpoints
    nv, nu = jm.nv, jm.nu
    A, B = tlqr.linearize(eng, qpos0, np.zeros(nv), ctrl0)
    q0, u0 = torch.tensor(qpos0), torch.tensor(ctrl0)
    nxt0 = eng.step(eng.forward(q0, torch.zeros(nv, dtype=F64)), u0)

    def f(x, u):
        st = eng.step(eng.forward(tlqr._apply_tangent(eng, q0, x[:nv]), x[nv:]), u0 + u)
        return torch.cat([tlqr._tangent_diff(eng, st.qpos, nxt0.qpos), st.qvel - nxt0.qvel])

    rng = np.random.default_rng(6)
    h = 1e-6
    for _ in range(6):
        v = torch.tensor(rng.normal(size=2 * nv + nu))
        vx, vu = v[:2 * nv], v[2 * nv:]
        fd = (f(h * vx, h * vu) - f(-h * vx, -h * vu)) / (2 * h)
        jv = A @ vx + B @ vu
        assert float((fd - jv).abs().max()) < 1e-5 * float(jv.abs().max()), \
            float((fd - jv).abs().max() / jv.abs().max())
    Q = tlqr.humanoid_balance_Q(eng, qpos0)
    K = tlqr.solve_dare(A, B, torch.tensor(Q), torch.eye(nu, dtype=F64))
    sr_open = np.abs(np.linalg.eigvals(A.numpy())).max()
    sr_closed = np.abs(np.linalg.eigvals((A - B @ K).numpy())).max()
    assert sr_open > 1.01 and sr_closed < 1.001, (sr_open, sr_closed)
