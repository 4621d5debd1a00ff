"""LQR baseline (solver/lqr.py counterpart): the cartpole held upright, and
the humanoid's one-leg stand (reference src/humanoid_lqr.jl).

The coupled plant step is linearized exactly by reverse-mode autograd in a
quaternion-aware tangent space (mj_differentiatePos's analog), and the
discrete Riccati equation is solved by fixed-point iteration. The Newton
solve inside the step runs its fixed n_iter iterations and freezes x with
torch.where once converged, so the derivative is the one through the
iterations that moved x, as JAX's jacfwd through its while_loop.

Dtype: every function here runs in the Engine's dtype, and the entry
points `make_lqr_controller` / `make_humanoid_lqr` build a float64 Engine
by default (the H100 has full-rate f64): the linearization, the Riccati
iteration, the controller and the plant the caller steps with it all in
float64, as the JAX tests run under x64.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..physics import spatial as sp
from ..physics.engine import (Engine, actuator_moment, body_com_jacobian,
                              inverse_dynamics, subtree_com_jacobian)
from ..physics.model import FREE
from ..physics.state import PhysicsState


def _engine(model, device, dtype) -> Engine:
    return model if isinstance(model, Engine) else Engine(model, device=device, dtype=dtype)


def _lap(eng: Engine, seconds: Optional[dict], name: str, t0: float) -> float:
    """Record the seconds since t0 under `name` (after the device is done)."""
    if seconds is None:
        return t0
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    now = time.perf_counter()
    seconds[name] = now - t0
    return now


def _apply_tangent(eng: Engine, qpos0: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """qpos0 (+) dq: hinges and slides add; a free joint's position adds and
    its orientation turns by the local exponential map."""
    qpos = qpos0
    if eng.hs_qposadr.shape[0]:
        qpos = qpos.index_add(0, eng.hs_qposadr, dq[eng.hs_dofadr])
    for qa, da in eng.free_adr:
        quat = sp.quat_integrate(qpos0[qa + 3:qa + 7], dq[da + 3:da + 6], 1.0)
        qpos = torch.cat([qpos[:qa], qpos[qa:qa + 3] + dq[da:da + 3], quat, qpos[qa + 7:]])
    return qpos


def _tangent_diff(eng: Engine, qpos: torch.Tensor, qpos0: torch.Tensor) -> torch.Tensor:
    """dq = qpos (-) qpos0 in the tangent space (mj_differentiatePos)."""
    dq = torch.zeros(eng.model.nv, dtype=qpos.dtype, device=qpos.device)
    if eng.hs_qposadr.shape[0]:
        q = eng.hs_qposadr
        dq = dq.index_copy(0, eng.hs_dofadr, qpos[q] - qpos0[q])
    for qa, da in eng.free_adr:
        dquat = sp.quat_mul(sp.quat_conj(qpos0[qa + 3:qa + 7]), qpos[qa + 3:qa + 7])
        # the quaternion log, AD-safe at the identity (vec = 0, where a plain
        # norm's gradient is NaN): dq = [2 atan2(|v|, w) / |v|] v, the
        # bracket an even, smooth function of |v| (-> 2/w at 0)
        w, vec = dquat[0], dquat[1:]
        n = torch.sqrt(torch.sum(vec * vec) + 1e-24)
        rot = (2.0 * torch.atan2(n, w) / n) * vec
        dq = torch.cat([dq[:da], qpos[qa:qa + 3] - qpos0[qa:qa + 3], rot, dq[da + 6:]])
    return dq


def linearize(eng: Engine, qpos0, qvel0, ctrl0, n_iter: int = 25):
    """Exact discrete linearization of the coupled step about (qpos0,
    qvel0, ctrl0): A (2nv, 2nv) and B (2nv, nu) in tangent coordinates
    x = [dq; dv], by reverse-mode autograd through Engine.step(
    solver="coupled") (one backward pass per output row, batched by vmap)."""
    nv = eng.model.nv
    qpos0, qvel0, ctrl0 = eng.t(qpos0), eng.t(qvel0), eng.t(ctrl0)
    info = {}
    nxt0 = eng.step(eng.forward(qpos0, qvel0), ctrl0, solver="coupled", n_iter=n_iter,
                    info=info)
    # the differentiated step stops where the Newton solve converged at
    # x = 0: the same x, and the same derivative, as through the frozen
    # iterations, at a fraction of their backward passes
    taken = int(info["iterations"]) if "iterations" in info else n_iter

    def f(x, u):
        qpos = _apply_tangent(eng, qpos0, x[:nv])
        st = eng.step(eng.forward(qpos, qvel0 + x[nv:]), ctrl0 + u, solver="coupled",
                      n_iter=taken)
        return torch.cat([_tangent_diff(eng, st.qpos, nxt0.qpos), st.qvel - nxt0.qvel])

    zx = torch.zeros(2 * nv, dtype=eng.dtype, device=eng.device)
    zu = torch.zeros(eng.model.nu, dtype=eng.dtype, device=eng.device)
    A, B = torch.autograd.functional.jacobian(f, (zx, zu), vectorize=True)
    return A, B


def solve_dare(A: torch.Tensor, B: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
               iters: int = 300) -> torch.Tensor:
    """Discrete algebraic Riccati equation by fixed-point iteration (the
    reference's `ared`); returns the gain K of u = -K x."""
    P = Q
    for _ in range(iters):
        BtP = B.T @ P
        G = torch.linalg.solve(R + BtP @ B, BtP @ A)
        P = Q + A.T @ P @ A - A.T @ P @ B @ G
    BtP = B.T @ P
    return torch.linalg.solve(R + BtP @ B, BtP @ A)


# ---------------------------------------------------------------------------
# the humanoid's one-leg stand (reference src/humanoid_lqr.jl)
# ---------------------------------------------------------------------------

def stand_setpoint(eng: Engine, keyframe: str = "stand_on_left_leg", span: float = 1e-3,
                   n_heights: int = 2001):
    """Control set-point calibration (reference src/humanoid_lqr.jl:19-65):
    sweep root-height offsets in [-span, span] in one batched inverse
    dynamics call, keep the one whose root-z force is smallest, then map
    qfrc0 = inverse_dynamics(qpos0, qacc=0) to actuator space by least
    squares on the transmission moment, M_act^T ctrl0 = qfrc0.

    Returns (qpos0, ctrl0, info) as numpy, info = dict(height, u_vert,
    heights, qfrc0, residual)."""
    m = eng.model
    key_qpos = eng.t(dict(m.keyframes)[keyframe])
    heights_np = np.linspace(-span, span, n_heights)
    heights = eng.t(heights_np)
    e_z = eng.t(np.eye(m.nq)[2])
    st = eng.forward(key_qpos + heights[:, None] * e_z, eng.t(np.zeros((n_heights, m.nv))))
    u_vert = inverse_dynamics(eng, st)[:, 2]        # the root-z dof
    best = int(torch.argmin(torch.abs(u_vert)))
    height = heights[best]
    qpos0 = key_qpos + height * e_z
    st0 = eng.forward(qpos0, eng.t(np.zeros(m.nv)))
    qfrc0 = inverse_dynamics(eng, st0)
    M_act = actuator_moment(eng, st0)               # (nu, nv)
    ctrl0 = torch.linalg.lstsq(M_act.T, qfrc0[:, None]).solution[:, 0]
    residual = M_act.T @ ctrl0 - qfrc0
    info = dict(height=float(heights_np[best]), u_vert=u_vert.cpu().numpy(),
                heights=heights_np, qfrc0=qfrc0.cpu().numpy(),
                residual=residual.cpu().numpy())
    return qpos0.cpu().numpy(), ctrl0.cpu().numpy(), info


def humanoid_balance_Q(eng: Engine, qpos0, balance_cost: float = 1000.0,
                       balance_joint_cost: float = 3.0, other_joint_cost: float = 0.3,
                       stance_foot: str = "foot_left") -> np.ndarray:
    """Balance-aware Q (reference src/humanoid_lqr.jl:81-136): the
    horizontal offset between the torso subtree's CoM jacobian and the
    stance foot's, abdomen and stance-leg joints stiff, the rest nearly
    free, no cost on velocities. Dofs are chosen by dof address (the
    reference indexes by joint id there, as JAX's docstring records)."""
    m = eng.model
    nv = m.nv
    st0 = eng.forward(eng.t(qpos0), eng.t(np.zeros(nv)))
    jac_com = subtree_com_jacobian(eng, st0, m.body_id("torso")).cpu().numpy()
    jac_foot = body_com_jacobian(eng, st0, m.body_id(stance_foot)).cpu().numpy()
    jac_diff = jac_com - jac_foot
    Qbalance = jac_diff.T @ jac_diff

    side = "left" if "left" in stance_foot else "right"
    balance_dofs = [j.dofadr for j, name in zip(m.joints, m.joint_names)
                    if j.jtype != FREE and ("abdomen" in name or (
                        side in name and any(p in name for p in ("hip", "knee", "ankle"))))]
    free_dofs = list(range(6))
    other_dofs = [d for d in range(6, nv) if d not in balance_dofs]

    Qjoint = np.eye(nv)
    Qjoint[free_dofs, free_dofs] = 0.0
    Qjoint[balance_dofs, balance_dofs] = balance_joint_cost
    Qjoint[other_dofs, other_dofs] = other_joint_cost

    Q = np.zeros((2 * nv, 2 * nv))
    Q[:nv, :nv] = balance_cost * Qbalance + Qjoint
    Q += 1e-10 * np.eye(2 * nv)
    return Q


def make_humanoid_lqr(model, keyframe: str = "stand_on_left_leg", n_heights: int = 2001,
                      device="cuda", dtype=torch.float64):
    """The reference pipeline end to end: set-point calibration, balance
    Q, exact linearization, DARE gain, the tangent-space controller.
    `model` is a PhysicsModel (an Engine is built on `device` in `dtype`)
    or an Engine. Returns (controller, dict(qpos0, ctrl0, Q, info, mats,
    seconds)), seconds by stage: setpoint, balance_Q, linearize, dare."""
    eng = _engine(model, device, dtype)
    seconds = {}
    t0 = time.perf_counter()
    qpos0, ctrl0, info = stand_setpoint(eng, keyframe, n_heights=n_heights)
    t0 = _lap(eng, seconds, "setpoint", t0)
    Q = humanoid_balance_Q(eng, qpos0)
    _lap(eng, seconds, "balance_Q", t0)
    controller, mats = make_lqr_controller(eng, qpos0, ctrl0=ctrl0, Q=Q,
                                           R=np.eye(eng.model.nu), seconds=seconds)
    return controller, dict(qpos0=qpos0, ctrl0=ctrl0, Q=Q, info=info, mats=mats,
                            seconds=seconds)


def make_lqr_controller(model, qpos0, qvel0=None, ctrl0=None, Q=None, R=None,
                        device="cuda", dtype=torch.float64, seconds: Optional[dict] = None):
    """controller(state: PhysicsState) -> ctrl, stabilizing (qpos0, qvel0).
    `model` is a PhysicsModel (an Engine is built on `device` in `dtype`)
    or an Engine. Returns (controller, (A, B, K)) as tensors on the
    Engine's device; `seconds`, when a dict, receives the seconds of the
    linearization and of the Riccati iteration."""
    eng = _engine(model, device, dtype)
    nv, nu = eng.model.nv, eng.model.nu
    qvel0 = np.zeros(nv) if qvel0 is None else qvel0
    ctrl0 = np.zeros(nu) if ctrl0 is None else ctrl0
    Qm = eng.t(np.eye(2 * nv) if Q is None else Q)
    Rm = eng.t(np.eye(nu) if R is None else R)

    t0 = time.perf_counter()
    A, B = linearize(eng, qpos0, qvel0, ctrl0)
    t0 = _lap(eng, seconds, "linearize", t0)
    K = solve_dare(A, B, Qm, Rm)
    _lap(eng, seconds, "dare", t0)
    qpos0_t, qvel0_t, ctrl0_t = eng.t(qpos0), eng.t(qvel0), eng.t(ctrl0)

    def controller(state: PhysicsState) -> torch.Tensor:
        qpos, qvel = state.qpos.to(eng.dtype), state.qvel.to(eng.dtype)
        x = torch.cat([_tangent_diff(eng, qpos, qpos0_t), qvel - qvel0_t])
        return (ctrl0_t - K @ x).to(state.qpos.dtype)

    return controller, (A, B, K)

