"""Rigid-body dynamics for one sample (physics/engine.py counterpart): the
environment plant that the collection loop steps. The kinematics (`fk`,
`body_velocities`, `Engine.forward`) also take a leading K batch, for
costs scored on K predicted states.

Formulation as in the JAX engine: world-frame ("origin" Plucker) algebra.
Forward kinematics walks the body tree one depth level at a time and gives
body poses and the per-dof motion subspace S (nv, 6); with the static
ancestor mask A (nbody, nv) everything downstream is dense tensor algebra:

- Mass matrix:  M = sum_b (A_b A_b^T) o (S I^O_b S^T) + diag(armature)
- Bias force:   origin-frame Newton-Euler with qacc = 0
- Integration:  semi-implicit Euler with implicit joint damping (MuJoCo's
  Euler integrator); quaternions by the local-frame exponential map.

`step(solver="coupled")` resolves contacts, joint and tendon limits and dof
friction jointly by the primal Newton solver of physics/newton.py, as the
JAX environment tier does.

An `Engine` holds every constant of one model on one device in one dtype,
built once. A step copies nothing from the host and reads nothing back: the
only decisions on the host are the static ones the JAX engine also takes on
numpy model fields. Covered: free, slide and hinge joints, single-dof
joint actuators, damping, springs, frictionloss, joint and fixed-tendon
limits, plane-vs-sphere/capsule/box/cylinder and sphere/capsule/cylinder
self contacts (the humanoid's, the Go1's, the cartpole's and the hopper's).
The rest raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import contact
from . import newton
from . import spatial as sp
from .model import FREE, HINGE, SLIDE, PhysicsModel
from .newton import cho_solve
from .state import PhysicsState


def _refuse(model: PhysicsModel) -> None:
    bad = sorted({f"joint type {j.jtype}" for j in model.joints
                  if j.jtype not in (FREE, SLIDE, HINGE)})
    if bad:
        raise NotImplementedError(
            "the array engine covers free, slide and hinge joints only, not "
            + ", ".join(bad) + " (ROADMAP A7)")


@contextlib.contextmanager
def _full_f32():
    """Float32 products at full precision: TF32 off for the duration (the
    JAX engine's _full_f32_matmuls). The stiff constraint solve diverges
    with reduced-precision products."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Engine:
    """The engine's constants for `model` on `device` in `dtype`.

    Kinematics (`forward`) needs only a planner snapshot; dynamics (`step`)
    needs a plant snapshot (physics/model.py: `plant=True`)."""

    def __init__(self, model: PhysicsModel, device="cuda", dtype=torch.float32):
        _refuse(model)
        self.model = model
        self.device = dev = resolve_device(device)
        self.dtype = dtype
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)
        ix = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
        self.t, self.ix = t, ix
        self.A = t(model.ancestor_mask)
        self.body_ipos, self.body_iquat = t(model.body_ipos), t(model.body_iquat)
        self.body_mass, self.body_inertia = t(model.body_mass), t(model.body_inertia)
        self.armature = t(model.dof_armature)
        self.damping = t(model.dof_damping)
        self._build_fk(model)
        self.has_dynamics = model.pred_mask is not None
        if self.has_dynamics:
            self._build_dynamics(model)
        self.h = float(model.timestep)

    # ---- constants ---------------------------------------------------------

    def _build_fk(self, model: PhysicsModel) -> None:
        """The level-synchronous kinematics plan (the JAX model's fk_levels):
        bodies grouped by tree depth, joints by (level, slot, type)."""
        t, ix = self.t, self.ix
        nb, nv = model.nbody, model.nv
        parent = list(model.body_parent)
        depth = [0] * nb
        for b in range(1, nb):
            depth[b] = depth[parent[b]] + 1
        self.levels = []
        for d in range(1, max(depth) + 1 if nb > 1 else 1):
            bids = [b for b in range(nb) if depth[b] == d]
            if not bids:
                continue
            stages = []
            for slot in range(max(len(model.body_joints[b]) for b in bids)):
                for jt in (FREE, SLIDE, HINGE):
                    rows, js = [], []
                    for r, b in enumerate(bids):
                        if slot < len(model.body_joints[b]):
                            jnt = model.joints[model.body_joints[b][slot]]
                            if jnt.jtype == jt:
                                rows.append(r)
                                js.append(jnt)
                    if not rows:
                        continue
                    qadr = np.array([j.qposadr for j in js])
                    stages.append(dict(
                        jtype=jt, rows=ix(rows),
                        qpos3=ix(qadr[:, None] + np.arange(3)),
                        qpos4=ix(qadr[:, None] + 3 + np.arange(4)),
                        qposadr=ix(qadr), dofadr=ix([j.dofadr for j in js]),
                        axis=t([j.axis for j in js]), jpos=t([j.pos for j in js]),
                        ref=t([model.qpos0[j.qposadr] if jt != FREE else 0.0 for j in js])))
            self.levels.append(dict(
                body_ids=ix(bids), parent_ids=ix([parent[b] for b in bids]),
                body_pos=t(model.body_pos[bids]), body_quat=t(model.body_quat[bids]),
                stages=stages))
        hinge, slide, freet, freer = (np.zeros(nv) for _ in range(4))
        init_axis = np.zeros((nv, 3))
        self.free = []
        for jnt in model.joints:
            if jnt.jtype == HINGE:
                hinge[jnt.dofadr] = 1.0
            elif jnt.jtype == SLIDE:
                slide[jnt.dofadr] = 1.0
            else:
                for i in range(3):
                    freet[jnt.dofadr + i] = freer[jnt.dofadr + 3 + i] = 1.0
                    init_axis[jnt.dofadr + i, i] = 1.0
                self.free.append((jnt.qposadr, jnt.dofadr, jnt.bodyid))
        self.init_axis = t(init_axis)
        xquat0 = np.zeros((nb, 4))
        xquat0[0, 0] = 1.0       # the world body; the rest are set level by level
        self.xquat0 = t(xquat0)
        self.rot_mask = t(hinge + freer)[:, None]
        self.lin_mask = t(slide + freet)[:, None]

    def _build_dynamics(self, model: PhysicsModel) -> None:
        t, ix = self.t, self.ix
        acts = model.actuators
        if any(getattr(a, "ndof", 1) != 1 for a in acts):
            raise NotImplementedError("multi-dof actuator transmissions (ROADMAP A7)")
        inf = np.inf
        self.P = t(model.pred_mask)
        self.live = t(1.0 - model.sdot_zero)
        self.a_g = t(np.concatenate([np.zeros(3), -np.asarray(model.gravity)]))
        self.act_dofadr = ix([a.dofadr for a in acts])
        self.act_qposadr = ix([a.qposadr for a in acts])
        self.act_gear = t([a.gear for a in acts])
        self.act_gain = t([a.gain for a in acts])
        self.act_bias = t(np.reshape([a.bias for a in acts], (-1, 3)))
        self.act_ctrl_lo = t([a.ctrlrange[0] if a.ctrllimited else -inf for a in acts])
        self.act_ctrl_hi = t([a.ctrlrange[1] if a.ctrllimited else inf for a in acts])
        self.act_force_lo = t([a.forcerange[0] if a.forcelimited else -inf for a in acts])
        self.act_force_hi = t([a.forcerange[1] if a.forcelimited else inf for a in acts])
        hs = [j for j in model.joints if j.jtype in (SLIDE, HINGE)]
        self.hs_qposadr, self.hs_dofadr = ix(model.hs_qposadr), ix(model.hs_dofadr)
        self.hs_stiffness = t([j.stiffness for j in hs])
        self.hs_springref = t([j.springref for j in hs])
        self.frictionloss = t(model.dof_frictionloss)
        self.free_adr = [(int(q), int(d)) for q, d in zip(model.free_qposadr, model.free_dofadr)]
        has_limits = bool(any(j.limited for j in hs) or np.any(model.tendon_limited))
        has_fl = bool(np.any(np.asarray(model.dof_frictionloss) > 0))
        self.newton_mode = bool(model.contact_pairs) or has_limits or has_fl
        self.contact = (contact.ContactTables(model, self.device, self.dtype)
                        if model.contact_pairs else None)
        self.rows = newton.RowTables(model, self.contact, self.device, self.dtype)

    # ---- kinematics --------------------------------------------------------

    def forward(self, qpos: torch.Tensor, qvel: torch.Tensor,
                time: Optional[torch.Tensor] = None) -> PhysicsState:
        """Kinematics caches for (qpos, qvel): mujoco mj_forward analog.
        One sample (nq,), (nv,) or a batch (K, nq), (K, nv) with time (K,)
        (JAX forward vmapped): every field of the state gains the K axis."""
        with _full_f32():
            xpos, xquat, S = fk(self, qpos)
            V = body_velocities(self, S, qvel)
        if time is None:
            time = torch.zeros(qpos.shape[:-1], dtype=qpos.dtype, device=qpos.device)
        return PhysicsState(qpos=qpos, qvel=qvel, time=time, xpos=xpos, xquat=xquat,
                            S=S, body_vel=V)

    # ---- one step ----------------------------------------------------------

    def step(self, state: PhysicsState, ctrl: torch.Tensor, solver: str = "coupled",
             n_iter: int = 25, info: Optional[dict] = None) -> PhysicsState:
        """One physics step (mujoco mj_step analog): forward dynamics and
        Euler. solver="coupled": the smooth acceleration qacc0 first, then
        the constraint rows resolved jointly by primal Newton
        (newton.newton_constraint_forces), then the damped system solved
        again. `info`, when a dict, receives the Newton solve's iteration
        count and row counts (device tensors)."""
        if solver in ("penalty", "coupled_pgs"):
            raise NotImplementedError(
                f'solver="{solver}" is not ported yet (ROADMAP A3)')
        if solver != "coupled":
            raise ValueError(f"unknown solver {solver!r}")
        if not self.has_dynamics:
            raise ValueError("step needs a plant snapshot (export_model_arrays(plant=True))")
        with _full_f32():
            return self._step(state, ctrl, n_iter, info)

    def _step(self, state, ctrl, n_iter, info):
        h = self.h
        qpos, qvel, S = state.qpos, state.qvel, state.S
        I, _ = spatial_inertias(self, state.xpos, state.xquat)
        M = mass_matrix(self, S, I)
        bias = bias_forces(self, S, I, state.body_vel, qvel)
        tau = actuator_forces(self, qpos, qvel, ctrl)
        # the Newton tier resolves dof frictionloss as Huber rows, so the
        # smooth tanh approximation is left out there
        tau_p, G_p = passive_forces(self, qpos, qvel, frictionloss=not self.newton_mode)
        tau = tau + tau_p
        Mh = M + h * torch.diag(self.damping) + h * G_p
        f = tau - bias
        if self.newton_mode:
            qacc0 = cho_solve(M, f)
            f = f + newton.newton_constraint_forces(self, state, S, qacc0, M,
                                                    n_iter=n_iter, info=info)
        qacc = cho_solve(Mh, f)
        qvel_new = qvel + h * qacc
        qpos_new = integrate_qpos(self, qpos, qvel_new, h)
        return self.forward(qpos_new, qvel_new, state.time + h)


# ---------------------------------------------------------------------------
# the engine's pieces (engine.py functions of the same names)
# ---------------------------------------------------------------------------

def fk(eng: Engine, qpos: torch.Tensor):
    """Forward kinematics: xpos (..., nbody,3), xquat (..., nbody,4), S
    (..., nv,6) for qpos (..., nq). Body frame = parent frame * (body_pos,
    body_quat), then the body's joints in order, each about its anchor
    (mj_kinematics). Leading axes run the same ops on every sample, so a
    batch row equals its one-sample call."""
    m, dtype, dev = eng.model, qpos.dtype, qpos.device
    lead = qpos.shape[:-1]
    xpos = torch.zeros(lead + (m.nbody, 3), dtype=dtype, device=dev)
    xquat = eng.xquat0.expand(lead + eng.xquat0.shape).clone()
    jaxis_w = eng.init_axis.expand(lead + eng.init_axis.shape).clone()
    janchor_w = torch.zeros(lead + (m.nv, 3), dtype=dtype, device=dev)
    for level in eng.levels:
        pq = xquat[..., level["parent_ids"], :]
        pp = xpos[..., level["parent_ids"], :]
        quat = sp.quat_mul(pq, level["body_quat"])
        pos = pp + sp.quat_rotate(pq, level["body_pos"])
        for st in level["stages"]:
            rows = st["rows"]
            if st["jtype"] == FREE:
                pos[..., rows, :] = qpos[..., st["qpos3"]]
                quat[..., rows, :] = sp.quat_normalize(qpos[..., st["qpos4"]])
                continue
            if st["jtype"] == SLIDE:
                # a translation along the axis in the body's current frame
                qv = qpos[..., st["qposadr"]] - st["ref"]
                a_w = sp.quat_rotate(quat[..., rows, :], st["axis"])
                pos[..., rows, :] = pos[..., rows, :] + a_w * qv[..., None]
                jaxis_w[..., st["dofadr"], :] = a_w
                continue
            qv = qpos[..., st["qposadr"]] - st["ref"]
            qr, pr, jpos, axis = quat[..., rows, :], pos[..., rows, :], st["jpos"], st["axis"]
            anchor = pr + sp.quat_rotate(qr, jpos)
            qnew = sp.quat_mul(qr, sp.quat_from_axis_angle(axis, qv))
            quat[..., rows, :] = qnew
            pos[..., rows, :] = anchor - sp.quat_rotate(qnew, jpos)
            jaxis_w[..., st["dofadr"], :] = sp.quat_rotate(qnew, axis)
            janchor_w[..., st["dofadr"], :] = anchor
        xpos[..., level["body_ids"], :] = pos
        xquat[..., level["body_ids"], :] = quat
    # free-joint rotational dofs: axis = R e_i (body-local angular velocity),
    # anchor = body origin
    for _, da, bid in eng.free:
        jaxis_w[..., da + 3:da + 6, :] = sp.quat_to_mat(xquat[..., bid, :]).transpose(-1, -2)
        janchor_w[..., da + 3:da + 6, :] = xpos[..., bid, None, :]
    S_ang = jaxis_w * eng.rot_mask
    S_lin = sp.cross(janchor_w, jaxis_w) * eng.rot_mask + jaxis_w * eng.lin_mask
    return xpos, xquat, torch.cat([S_ang, S_lin], dim=-1)


def spatial_inertias(eng: Engine, xpos, xquat):
    """Per-body spatial inertia about the world origin: (I (nbody,6,6),
    xipos (nbody,3))."""
    R_b = sp.quat_to_mat(xquat)
    xipos = xpos + torch.einsum("bij,bj->bi", R_b, eng.body_ipos)
    iR = sp.quat_to_mat(sp.quat_mul(xquat, eng.body_iquat))
    return sp.spatial_inertia_origin(eng.body_mass, eng.body_inertia, xipos, iR), xipos


def mass_matrix(eng: Engine, S: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """Joint-space mass matrix (nv, nv), through (nbody, nv, 6) masked body
    jacobians J_b = diag(A_b) S."""
    J = eng.A[:, :, None] * S[None, :, :]
    JI = torch.einsum("bni,bij->bnj", J, I)
    M = torch.einsum("bnj,bmj->nm", JI, J)
    return M + torch.diag(eng.armature)


def body_velocities(eng: Engine, S: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Body spatial velocities (nbody, 6), or (K, nbody, 6) for a batch."""
    if qvel.dim() == 1:
        return torch.einsum("bn,n,ni->bi", eng.A, qvel, S)
    return torch.einsum("bn,kn,kni->kbi", eng.A, qvel, S)


def bias_forces(eng: Engine, S, I, V, qvel) -> torch.Tensor:
    """qfrc_bias (nv,): Coriolis/centrifugal + gravity (M qacc + bias = f).
    Sdot_j qd_j = (V_pred(j) x S_j) qd_j, V_pred(j) the velocity of the frame
    S_j is fixed in; free-translation dofs have world-fixed S."""
    V_pred = torch.einsum("jd,d,di->ji", eng.P, qvel, S)
    W = sp.motion_cross(V_pred, S) * (qvel * eng.live)[:, None]
    a_bias = torch.einsum("bn,ni->bi", eng.A, W) + eng.a_g
    IV = torch.einsum("bij,bj->bi", I, V)
    F = torch.einsum("bij,bj->bi", I, a_bias) + sp.motion_cross_force(V, IV)
    return project_forces(eng, S, F)


def project_forces(eng: Engine, S: torch.Tensor, F_body: torch.Tensor) -> torch.Tensor:
    """Per-body origin-frame spatial forces into joint space:
    tau_n = S_n . sum_b A_bn F_b."""
    return torch.einsum("bn,bi,ni->n", eng.A, F_body, S)


def actuator_forces(eng: Engine, qpos, qvel, ctrl) -> torch.Tensor:
    """qfrc_actuator of single-dof joint transmissions (mujoco gain/bias)."""
    qfrc = torch.zeros(eng.model.nv, dtype=qpos.dtype, device=qpos.device)
    if eng.model.nu == 0:
        return qfrc
    gear = eng.act_gear
    u = torch.clamp(ctrl, eng.act_ctrl_lo, eng.act_ctrl_hi)
    length = gear * qpos[eng.act_qposadr]
    velocity = gear * qvel[eng.act_dofadr]
    bias = eng.act_bias
    force = (eng.act_gain * u + bias[:, 0] + bias[:, 1] * length + bias[:, 2] * velocity)
    force = torch.clamp(force, eng.act_force_lo, eng.act_force_hi)
    return qfrc.index_add(0, eng.act_dofadr, gear * force)


def passive_forces(eng: Engine, qpos, qvel, frictionloss: bool = True):
    """Damping, smooth friction loss (frictionloss=True: the penalty tier's
    tanh) and joint springs. Returns (tau, G) with G (nv, nv) the
    velocity-derivative of the friction term, for the implicit Euler matrix."""
    tau = -eng.damping * qvel
    g_diag = torch.zeros_like(qvel)
    if frictionloss:
        w_fl = 0.05
        tau = tau - eng.frictionloss * torch.tanh(qvel / w_fl)
        sech2 = 1.0 - torch.tanh(qvel / w_fl) ** 2
        g_diag = g_diag + eng.frictionloss / w_fl * sech2
    if eng.hs_qposadr.shape[0]:
        f = -eng.hs_stiffness * (qpos[eng.hs_qposadr] - eng.hs_springref)
        tau = tau.index_add(0, eng.hs_dofadr, f)
    return tau, torch.diag(g_diag)


def integrate_qpos(eng: Engine, qpos, qvel, h: float) -> torch.Tensor:
    """qpos advanced by qvel over h: slides and hinges linearly, free joints' position
    linearly and quaternion by the local exponential map."""
    out = qpos.clone()
    if eng.hs_qposadr.shape[0]:
        out[eng.hs_qposadr] = qpos[eng.hs_qposadr] + h * qvel[eng.hs_dofadr]
    for qa, da in eng.free_adr:
        out[qa:qa + 3] = qpos[qa:qa + 3] + h * qvel[da:da + 3]
        out[qa + 3:qa + 7] = sp.quat_integrate(qpos[qa + 3:qa + 7], qvel[da + 3:da + 6], h)
    return out
