"""Rigid-body dynamics (physics/engine.py counterpart): the environment
plant that the collection loop steps (`step(solver="coupled")`), and the
planner tiers that the array planner rolls out (`step(solver="penalty")`
by default, `step(solver="coupled")` when the planner plans on the plant's
tier). Every step, the kinematics (`fk`, `body_velocities`,
`Engine.forward`) and every piece of a step take one sample or a leading
K batch.

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
JAX environment tier does; `step(solver="coupled_pgs")` is the JAX
engine's legacy dual solver (physics/pgs.py). `step(solver="penalty")` is the decoupled
per-row law that the rollout kernel implements (ops/scalar_physics): limit
and contact forces with their implicit damping folded into the Euler
matrix, no a0 compensation, no coupling between rows. `inverse_dynamics`
reads the same laws inversely (JAX r_form: the force that realises a
given acceleration), for solver/lqr with `actuator_moment` and the CoM
jacobians. Spatial (site-chain) tendons have a length and a moment row
that depend on the state (`spatial_tendon_geometry`); they reach the
transmissions, both limit tiers and `inverse_dynamics`, while coupled_pgs
refuses their limits, as in the JAX engine.

An `Engine` holds every constant of one model on one device in one dtype,
built once. A step copies nothing from the host and reads nothing back: the
only decisions on the host are the static ones the JAX engine also takes on
numpy model fields. Covered: free, ball, slide and hinge joints; joint,
multi-dof (ball/free motor), fixed- and spatial-tendon and site actuator
transmissions; damping, joint and ball-joint quaternion springs,
frictionloss; joint, ball rotation-angle, fixed- and spatial-tendon
limits; plane-vs-sphere/capsule/box/cylinder/mesh,
mesh-vs-sphere/capsule/box/mesh and sphere/capsule/cylinder self contacts
-- every robot of the JAX registry. As in the JAX engine, the coupled tier enforces no ball
limit (no Newton row), and the penalty tier adds limits only when a
single-dof joint or a tendon is limited. A model with anything else
raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from . import contact
from . import newton
from . import pgs
from . import spatial as sp
from .model import BALL, FREE, HINGE, SLIDE, PhysicsModel
from .newton import cho_solve
from .state import PhysicsState


def _refuse(model: PhysicsModel) -> None:
    bad = sorted({f"joint type {j.jtype}" for j in model.joints
                  if j.jtype not in (FREE, BALL, SLIDE, HINGE)})
    if bad:
        raise NotImplementedError(
            "the array engine covers free, ball, slide and hinge joints, not "
            + ", ".join(bad))


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

    Kinematics (`forward`) needs only the scalar step's fields; dynamics
    (`step`) needs the engine's too (physics/model.py: `plant=True`, which
    every committed snapshot carries)."""

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
        # per spatial tendon: its sites' body ids, body-local positions and
        # the ancestor rows of those bodies
        self.spatial = [(ix(bodies), t(lpos), t(model.ancestor_mask[list(bodies)]))
                        for _, bodies, lpos in model.spatial_tendons]
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
                for jt in (FREE, BALL, SLIDE, HINGE):
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
                        qball=ix(qadr[:, None] + np.arange(4)),
                        drows=ix(np.array([j.dofadr for j in js])[:, None] + np.arange(3)),
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
            elif jnt.jtype == BALL:
                # rotational rows with the free joint's rotational semantics
                freer[jnt.dofadr:jnt.dofadr + 3] = 1.0
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
        self.single = [i for i, a in enumerate(model.actuators) if a.ndof == 1]
        acts = [model.actuators[i] for i in self.single]
        self.act_single_idx = ix(self.single)
        self._build_transmissions(model)
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
        self.ball_adr = [(j.qposadr, j.dofadr) for j in model.joints if j.jtype == BALL]
        self.ball_springs = [(d, q, float(k), t(qref)) for d, q, k, qref in model.ball_springs]
        # as in the JAX engine: limits (ball limits included) only when a
        # single-dof joint or a tendon is limited
        self.has_limits = bool(any(j.limited for j in hs) or np.any(model.tendon_limited))
        has_fl = bool(np.any(np.asarray(model.dof_frictionloss) > 0))
        self.newton_mode = bool(model.contact_pairs) or self.has_limits or has_fl
        self.lim_sp = None
        if self.has_limits:
            self._build_limits(model, hs)
        self.contact = (contact.ContactTables(model, self.device, self.dtype)
                        if model.contact_pairs else None)
        self.rows = newton.RowTables(
            model, self.contact, self.device, self.dtype,
            spatial=None if self.lim_sp is None
            else (functools.partial(spatial_tendon_geometry, self), self.lim_sp))

    @functools.cached_property
    def pgs(self) -> pgs.PGSTables:
        """coupled_pgs's static tables, built on its first step."""
        return pgs.PGSTables(self)

    def _build_transmissions(self, model: PhysicsModel) -> None:
        """Per-actuator constants of the transmissions beyond a single-dof
        joint's (JAX _actuator_forces' loop): (kind, actuator, tensors)."""
        t = self.t
        self.trn = []
        spatial = model.spatial_tendon_ids
        for i, a in enumerate(model.actuators):
            if a.tendon_id in spatial:
                self.trn.append(("spatial", i, dict(idx=spatial.index(a.tendon_id))))
            elif a.site_bodyid >= 0:
                g = t(a.gear6)
                self.trn.append(("site", i, dict(
                    body=a.site_bodyid, pos=t(a.site_pos), R=sp.quat_to_mat(t(a.site_quat)),
                    g_f=g[:3], g_t=g[3:], anc=t(model.ancestor_mask[a.site_bodyid]))))
            elif a.tendon_id >= 0:
                self.trn.append(("tendon", i, dict(coef=t(model.tendon_coef[a.tendon_id]))))
            elif a.ndof > 1:
                self.trn.append(("multi", i, dict(gv=t(a.gear6[:a.ndof]))))

    def _build_limits(self, model: PhysicsModel, hs) -> None:
        """The penalty tier's joint- and tendon-limit constants (JAX
        _limit_constraint_forces reads them from the model). Spatial
        tendons are masked out of the fixed tendons' rows (their coef row is
        zero) and have rows of their own."""
        t = self.t
        self.lim_hs = dict(lo=t([j.range[0] for j in hs]), hi=t([j.range[1] for j in hs]),
                           lim=t([float(j.limited) for j in hs]),
                           meff=t(model.hs_limit_meff),
                           **_solref_tables([j.solref for j in hs], [j.solimp for j in hs],
                                            self.device, self.dtype)) if hs else None
        nt = model.tendon_coef.shape[0]
        self.lim_ten = None
        if nt:
            self.lim_ten = dict(coef=t(model.tendon_coef), lo=t(model.tendon_range[:, 0]),
                                hi=t(model.tendon_range[:, 1]),
                                lim=t(model.fixed_tendon_limited),
                                meff=t(model.tendon_limit_meff),
                                **_solref_tables(model.tendon_limit_solref,
                                                 model.tendon_limit_solimp,
                                                 self.device, self.dtype))
        # the spatial tendons' rows, here and in the coupled tiers' row tables
        # (newton.RowTables): invw is their regularizer's meff
        sids = model.spatial_tendon_ids
        if np.any(model.tendon_limited[sids]):
            self.lim_sp = dict(lo=t(model.tendon_range[sids, 0]), hi=t(model.tendon_range[sids, 1]),
                               lim=t(np.asarray(model.tendon_limited[sids], dtype=np.float64)),
                               meff=t(model.tendon_limit_meff[sids]),
                               invw=t(np.maximum(model.tendon_invweight0[sids], 1e-12)),
                               **_solref_tables(model.tendon_limit_solref[sids],
                                                model.tendon_limit_solimp[sids],
                                                self.device, self.dtype))
        self.lim_ball = [(d, q, float(ang), dict(
            lim=t(1.0), meff=t(meff), **_solref_tables([sr], [si], self.device, self.dtype)))
            for d, q, ang, sr, si, meff in model.ball_limits]

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
             n_iter: int = 25, info: Optional[dict] = None,
             early_exit: Optional[bool] = None) -> PhysicsState:
        """One physics step (mujoco mj_step analog): forward dynamics and
        Euler, for one sample or a state whose fields carry a leading K axis
        with ctrl (K, nu). solver="coupled": the smooth acceleration qacc0
        first, then the constraint rows resolved jointly by primal Newton
        (newton.newton_constraint_forces), then the damped system solved
        again. solver="coupled_pgs": the same with the rows resolved by
        the legacy dual solver (pgs.pgs_constraint_forces; the dof
        frictionloss stays the passive tanh). solver="penalty": the
        decoupled per-row limit and contact law (the rollout kernel's).
        `info`, when a dict, receives the Newton solve's iteration count
        (per sample for a batch) and row counts (device tensors).
        `early_exit` ends the Newton loop at convergence (newton.solve_qacc;
        for a batch when no sample goes on); by default it does so on the
        CPU, where reading the flag costs no device wait, and runs all
        n_iter masked on the card."""
        if solver not in ("coupled", "coupled_pgs", "penalty"):
            raise ValueError(f"unknown solver {solver!r}")
        if not self.has_dynamics:
            raise ValueError("step needs a snapshot with the engine's fields "
                             "(export_model_arrays(plant=True))")
        with _full_f32():
            if solver == "penalty":
                return self._step_penalty(state, ctrl)
            if early_exit is None:
                early_exit = self.device.type == "cpu"
            return self._step(state, ctrl, n_iter, info, early_exit, solver)

    def _step(self, state, ctrl, n_iter, info, early_exit, solver="coupled"):
        h = self.h
        qpos, qvel, S = state.qpos, state.qvel, state.S
        I, _ = spatial_inertias(self, state.xpos, state.xquat)
        M = mass_matrix(self, S, I)
        bias = bias_forces(self, S, I, state.body_vel, qvel)
        tau = actuator_forces(self, qpos, qvel, ctrl, state)
        # the Newton tier resolves dof frictionloss as Huber rows, so the
        # smooth tanh approximation is left out there
        newton_mode = solver == "coupled" and self.newton_mode
        tau_p, G_p = passive_forces(self, qpos, qvel, frictionloss=not newton_mode)
        tau = tau + tau_p
        Mh = M + h * torch.diag(self.damping) + h * G_p
        f = tau - bias
        if newton_mode:
            qacc0 = cho_solve(M, f)
            f = f + newton.newton_constraint_forces(self, state, S, qacc0, M,
                                                    n_iter=n_iter, info=info,
                                                    early_exit=early_exit)
        elif solver == "coupled_pgs" and (self.contact is not None or self.has_limits):
            L0 = torch.linalg.cholesky_ex(M).L
            qacc0 = pgs._solve(L0, f[..., None])[..., 0]
            f = f + pgs.pgs_constraint_forces(self, state, S, L0, qacc0, n_iter=n_iter)
        qacc = cho_solve(Mh, f)
        qvel_new = qvel + h * qacc
        qpos_new = integrate_qpos(self, qpos, qvel_new, h)
        return self.forward(qpos_new, qvel_new, state.time + h)

    def _step_penalty(self, state, ctrl):
        """JAX step(solver="penalty"): the smooth terms with the tanh
        frictionloss, then the limit and contact forces, each with its
        implicit damping h G added to the Euler matrix, one Cholesky."""
        h = self.h
        qpos, qvel, S = state.qpos, state.qvel, state.S
        I, _ = spatial_inertias(self, state.xpos, state.xquat)
        M = mass_matrix(self, S, I)
        bias = bias_forces(self, S, I, state.body_vel, qvel)
        tau = actuator_forces(self, qpos, qvel, ctrl, state)
        tau_p, G_p = passive_forces(self, qpos, qvel, frictionloss=True)
        tau = tau + tau_p
        Mh = M + h * torch.diag(self.damping) + h * G_p
        f = tau - bias
        if self.has_limits:
            tau_l, G_l = limit_constraint_forces(self, qpos, qvel, state=state)
            f = f + tau_l
            Mh = Mh + h * G_l
        if self.contact is not None:
            tau_ct, G_c = contact.contact_terms(self.contact, state, S, h)
            f = f + tau_ct
            Mh = Mh + h * G_c
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
            if st["jtype"] == BALL:
                # a quaternion about the anchor; the S rows are the columns
                # of the post-joint rotation, anchored there
                qr, pr, jpos = quat[..., rows, :], pos[..., rows, :], st["jpos"]
                anchor = pr + sp.quat_rotate(qr, jpos)
                qnew = sp.quat_mul(qr, sp.quat_normalize(qpos[..., st["qball"]]))
                quat[..., rows, :] = qnew
                pos[..., rows, :] = anchor - sp.quat_rotate(qnew, jpos)
                n = rows.shape[0]
                flat = st["drows"].reshape(-1)
                jaxis_w[..., flat, :] = sp.quat_to_mat(qnew).transpose(-1, -2).reshape(
                    lead + (3 * n, 3))
                janchor_w[..., flat, :] = anchor[..., :, None, :].expand(
                    lead + (n, 3, 3)).reshape(lead + (3 * n, 3))
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
    """Per-body spatial inertia about the world origin: (I (..., nbody,6,6),
    xipos (..., nbody,3))."""
    R_b = sp.quat_to_mat(xquat)
    xipos = xpos + torch.einsum("...bij,bj->...bi", R_b, eng.body_ipos)
    iR = sp.quat_to_mat(sp.quat_mul(xquat, eng.body_iquat))
    return sp.spatial_inertia_origin(eng.body_mass, eng.body_inertia, xipos, iR), xipos


def mass_matrix(eng: Engine, S: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """Joint-space mass matrix (..., nv, nv), through (..., nbody, nv, 6)
    masked body jacobians J_b = diag(A_b) S."""
    J = eng.A[:, :, None] * S[..., None, :, :]
    JI = torch.einsum("...bni,...bij->...bnj", J, I)
    M = torch.einsum("...bnj,...bmj->...nm", JI, J)
    return M + torch.diag(eng.armature)


def body_velocities(eng: Engine, S: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """Body spatial velocities (nbody, 6), or (K, nbody, 6) for a batch."""
    if qvel.dim() == 1:
        return torch.einsum("bn,n,ni->bi", eng.A, qvel, S)
    return torch.einsum("bn,kn,kni->kbi", eng.A, qvel, S)


def bias_forces(eng: Engine, S, I, V, qvel) -> torch.Tensor:
    """qfrc_bias (..., nv): Coriolis/centrifugal + gravity (M qacc + bias =
    f). Sdot_j qd_j = (V_pred(j) x S_j) qd_j, V_pred(j) the velocity of the
    frame S_j is fixed in; free-translation dofs have world-fixed S."""
    V_pred = torch.einsum("jd,...d,...di->...ji", eng.P, qvel, S)
    W = sp.motion_cross(V_pred, S) * (qvel * eng.live)[..., :, None]
    a_bias = torch.einsum("bn,...ni->...bi", eng.A, W) + eng.a_g
    IV = torch.einsum("...bij,...bj->...bi", I, V)
    F = torch.einsum("...bij,...bj->...bi", I, a_bias) + sp.motion_cross_force(V, IV)
    return project_forces(eng, S, F)


def project_forces(eng: Engine, S: torch.Tensor, F_body: torch.Tensor) -> torch.Tensor:
    """Per-body origin-frame spatial forces into joint space:
    tau_n = S_n . sum_b A_bn F_b."""
    return torch.einsum("bn,...bi,...ni->...n", eng.A, F_body, S)


def spatial_tendon_geometry(eng: Engine, state: PhysicsState):
    """(L (..., nst), moment (..., nst, nv)) of the straight site-chain
    tendons (JAX spatial_tendon_geometry; mj_tendon's site wraps without
    geom wraps): L is the sum of the segments' lengths, the moment dL/dqvel
    the sum over segments of the unit segment direction dotted into the
    difference of its end points' jacobians. One sample or a leading K
    axis; the sites of a tendon are placed together, the segments are
    summed in order."""
    S_ang, S_lin = state.S[..., :, None, :3], state.S[..., :, None, 3:]   # (..., nv, 1, 3)
    Ls, Ms = [], []
    for bodies, lpos, anc in eng.spatial:
        R_b = sp.quat_to_mat(state.xquat[..., bodies, :])
        pts = state.xpos[..., bodies, :] + (R_b @ lpos[..., None])[..., 0]   # (..., n, 3)
        # the point jacobians, (..., nv, n, 3), each on its body's chain
        Jp = (S_lin + sp.cross(S_ang, pts[..., None, :, :])) * anc.T[:, :, None]
        L = torch.zeros(pts.shape[:-2], dtype=pts.dtype, device=pts.device)
        mom = torch.zeros(state.qvel.shape, dtype=pts.dtype, device=pts.device)
        for i in range(pts.shape[-2] - 1):
            d = pts[..., i + 1, :] - pts[..., i, :]
            ln = torch.sqrt(torch.sum(d * d, -1) + 1e-24)
            dh = d / ln[..., None]
            L = L + ln
            mom = mom + torch.sum(Jp[..., i + 1, :] * dh[..., None, :], -1)
            mom = mom - torch.sum(Jp[..., i, :] * dh[..., None, :], -1)
        Ls.append(L)
        Ms.append(mom)
    return torch.stack(Ls, -1), torch.stack(Ms, -2)


def actuator_forces(eng: Engine, qpos, qvel, ctrl, state=None) -> torch.Tensor:
    """qfrc_actuator (..., nv): the single-dof joint actuators at once
    (mujoco gain/bias), then each other transmission in actuator order
    (JAX _actuator_forces): a ball/free motor's gear vector, a fixed
    tendon's coefficients, a spatial tendon's length and moment row or a
    site's wrench (these two need `state`'s kinematics)."""
    qfrc = torch.zeros(qpos.shape[:-1] + (eng.model.nv,), dtype=qpos.dtype, device=qpos.device)
    if eng.model.nu == 0:
        return qfrc
    if eng.single:
        gear = eng.act_gear
        u = torch.clamp(ctrl if len(eng.single) == eng.model.nu
                        else ctrl[..., eng.act_single_idx], eng.act_ctrl_lo, eng.act_ctrl_hi)
        length = gear * qpos[..., eng.act_qposadr]
        velocity = gear * qvel[..., eng.act_dofadr]
        bias = eng.act_bias
        force = (eng.act_gain * u + bias[:, 0] + bias[:, 1] * length + bias[:, 2] * velocity)
        force = torch.clamp(force, eng.act_force_lo, eng.act_force_hi)
        qfrc = qfrc.index_add(-1, eng.act_dofadr, gear * force)
    geometry = None
    for kind, i, c in eng.trn:
        act = eng.model.actuators[i]
        u = ctrl[..., i]
        if act.ctrllimited:
            u = torch.clamp(u, float(act.ctrlrange[0]), float(act.ctrlrange[1]))
        b0, b1, b2 = (float(x) for x in act.bias)
        if kind == "site":
            if state is None:
                raise ValueError("site-transmission actuators need state kinematics")
            moment = _site_moment(c, state)
            vel = torch.sum(moment * qvel, -1)
            force = float(act.gain) * u + b0 + b2 * vel
            moment_ = moment
        elif kind == "spatial":
            if state is None:
                raise ValueError("spatial-tendon actuators need state kinematics")
            if geometry is None:
                geometry = spatial_tendon_geometry(eng, state)
            gear = float(act.gear)
            moment_ = gear * geometry[1][..., c["idx"], :]
            length = gear * geometry[0][..., c["idx"]]
            vel = torch.sum(moment_ * qvel, -1)
            force = float(act.gain) * u + b0 + b1 * length + b2 * vel
        elif kind == "tendon":
            qd = torch.zeros_like(qvel).index_copy(-1, eng.hs_dofadr, qpos[..., eng.hs_qposadr])
            gear = float(act.gear)
            length = gear * (qd @ c["coef"])
            vel = gear * (qvel @ c["coef"])
            force = float(act.gain) * u + b0 + b1 * length + b2 * vel
            moment_ = c["coef"] * gear
        else:
            d, n = act.dofadr, act.ndof
            vel = qvel[..., d:d + n] @ c["gv"]
            force = float(act.gain) * u + b2 * vel
        if act.forcelimited:
            force = torch.clamp(force, float(act.forcerange[0]), float(act.forcerange[1]))
        if kind == "multi":
            qfrc = torch.cat([qfrc[..., :d], qfrc[..., d:d + n] + c["gv"] * force[..., None],
                              qfrc[..., d + n:]], -1)
        else:
            qfrc = qfrc + moment_ * force[..., None]
    return qfrc


def passive_forces(eng: Engine, qpos, qvel, frictionloss: bool = True):
    """Damping, smooth friction loss (frictionloss=True: the penalty tier's
    tanh) and joint springs. Returns (tau, G) with G (..., nv, nv) the
    velocity-derivative of the friction term, for the implicit Euler matrix."""
    tau = -eng.damping * qvel
    g_diag = torch.zeros_like(qvel)
    if frictionloss:
        w_fl = 0.05
        tau = tau - eng.frictionloss * torch.tanh(qvel / w_fl)
        sech2 = 1.0 - torch.tanh(qvel / w_fl) ** 2
        g_diag = g_diag + eng.frictionloss / w_fl * sech2
    if eng.hs_qposadr.shape[0]:
        f = -eng.hs_stiffness * (qpos[..., eng.hs_qposadr] - eng.hs_springref)
        tau = tau.index_add(-1, eng.hs_dofadr, f)
    # ball joints' quaternion springs: tau -= k subQuat(q, q_spring)
    for d, qa, k, qref in eng.ball_springs:
        vec = sp.quat_sub(qpos[..., qa:qa + 4], qref)
        tau = torch.cat([tau[..., :d], tau[..., d:d + 3] + (-k * vec), tau[..., d + 3:]], -1)
    return tau, torch.diag_embed(g_diag)


def _solref_tables(solref, solimp, device, dtype) -> dict:
    """(k_base, b_ref) and the impedance of rows with static solref/solimp."""
    kb, br = contact.solref_kb(solref, solimp)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return dict(k_base=t(kb), b_ref=t(br), imp=contact.Impedance(solimp, device, dtype))


def _limit_force(tab: dict, viol, pos_dot, h: float, a0_pos=None, r_form: bool = False):
    """The limit law (JAX _limit_force). Forward reading, the penalty
    tier's (a0 dropped): f = max(m_eff d(r) (d(r) k_base viol - b pos_dot),
    0) on active rows, capped so that the row pushes out at most at
    RESTITUTION_VCAP. Inverse reading (r_form=True, inverse_dynamics'):
    gain m_eff d/(1 - d) with 1 - d floored at 1e-6, the realised
    acceleration a0_pos subtracted inside the bracket, no cap. Returns the
    force and the implicit damping coefficient m_eff d(r) b. pos_dot and
    a0_pos are in the push-back direction."""
    active = (viol > 0).to(viol.dtype) * tab["lim"]
    d_r = tab["imp"](viol)
    me = tab["meff"]
    gain = me * d_r
    bracket = d_r * tab["k_base"] * viol - tab["b_ref"] * pos_dot
    if a0_pos is not None:
        bracket = bracket - a0_pos
    if r_form:
        gain = gain / torch.clamp(1.0 - d_r, min=1e-6)
    f_c = torch.clamp(gain * bracket, min=0.0) * active
    if not r_form:
        f_c = torch.minimum(f_c, me * torch.clamp(contact.RESTITUTION_VCAP - pos_dot, min=0.0) / h)
    return f_c, me * d_r * tab["b_ref"] * active


def limit_constraint_forces(eng: Engine, qpos, qvel, qacc=None, r_form: bool = False,
                            state: Optional[PhysicsState] = None):
    """Joint-limit, tendon-limit and ball rotation-angle-limit forces
    (JAX _limit_constraint_forces): the penalty tier's forward reading with
    qacc0 = 0 and the restitution cap, or with r_form=True the inverse
    reading at the realised acceleration `qacc` (None: zero). Returns (tau
    (..., nv), G (..., nv, nv)) with G = diag(c) over the joints plus
    sum_t c_t coef_t coef_t^T over the fixed tendons, then the same over
    the spatial tendons with their moment rows (these need `state`'s
    kinematics)."""
    tau = torch.zeros_like(qvel)
    g_diag = torch.zeros_like(qvel)
    G_extra = None
    if eng.lim_hs is not None:
        tab = eng.lim_hs
        q = qpos[..., eng.hs_qposadr]
        v = qvel[..., eng.hs_dofadr]
        below = torch.clamp(tab["lo"] - q, min=0.0)
        above = torch.clamp(q - tab["hi"], min=0.0)
        s = torch.sign(below - above)        # push-back direction in dof space
        a0 = None if qacc is None else s * qacc[..., eng.hs_dofadr]
        f_c, c_l = _limit_force(tab, below + above, s * v, eng.h, a0, r_form)
        tau = tau.index_add(-1, eng.hs_dofadr, s * f_c)
        g_diag = g_diag.index_add(-1, eng.hs_dofadr, c_l)
    if eng.lim_ten is not None:
        tab = eng.lim_ten
        coef = tab["coef"]
        # fixed tendon length L = coef . (qpos gathered at the hinge/slide dofs)
        qd = torch.zeros_like(qvel).index_copy(-1, eng.hs_dofadr, qpos[..., eng.hs_qposadr])
        L = qd @ coef.T
        Ldot = qvel @ coef.T
        below = torch.clamp(tab["lo"] - L, min=0.0)
        above = torch.clamp(L - tab["hi"], min=0.0)
        s = torch.sign(below - above)
        a0 = None if qacc is None else s * (qacc @ coef.T)
        f_c, c_t = _limit_force(tab, below + above, s * Ldot, eng.h, a0, r_form)
        tau = tau + (s * f_c) @ coef
        G_extra = torch.einsum("...t,tn,tm->...nm", c_t, coef, coef)
    if eng.spatial and state is None:
        raise ValueError("spatial-tendon limits need state kinematics")
    if eng.lim_sp is not None:
        # the same law over the state-dependent length, the moment row as J
        tab = eng.lim_sp
        L_sp, M_sp = spatial_tendon_geometry(eng, state)
        Ldot = newton.mv(M_sp, qvel)
        below = torch.clamp(tab["lo"] - L_sp, min=0.0)
        above = torch.clamp(L_sp - tab["hi"], min=0.0)
        s = torch.sign(below - above)
        a0 = None if qacc is None else s * newton.mv(M_sp, qacc)
        f_c, c_t = _limit_force(tab, below + above, s * Ldot, eng.h, a0, r_form)
        tau = tau + newton.mv(M_sp.mT, s * f_c)
        G_sp = torch.einsum("...t,...tn,...tm->...nm", c_t, M_sp, M_sp)
        G_extra = G_sp if G_extra is None else G_extra + G_sp
    # ball rotation-angle limits: a row J = -axis over the ball's dofs
    for d, qa, max_angle, tab in eng.lim_ball:
        rotvec = sp.quat_log(qpos[..., qa:qa + 4])
        angle = torch.sqrt(torch.sum(rotvec * rotvec, -1) + 1e-24)
        axis = rotvec / angle[..., None]
        viol = torch.clamp(angle - max_angle, min=0.0)
        v_row = -torch.sum(axis * qvel[..., d:d + 3], -1)
        a_row = None if qacc is None else -torch.sum(axis * qacc[..., d:d + 3], -1)
        f_c, c_b = (x.reshape(viol.shape)
                    for x in _limit_force(tab, viol, v_row, eng.h, a_row, r_form))
        tau = torch.cat([tau[..., :d], tau[..., d:d + 3] + (-axis * f_c[..., None]),
                         tau[..., d + 3:]], -1)
        Gb = c_b[..., None, None] * axis[..., :, None] * axis[..., None, :]
        pad = torch.zeros(qvel.shape + (qvel.shape[-1],), dtype=qvel.dtype, device=qvel.device)
        pad[..., d:d + 3, d:d + 3] = Gb
        G_extra = pad if G_extra is None else G_extra + pad
    G = torch.diag_embed(g_diag)
    return tau, G if G_extra is None else G + G_extra


def integrate_qpos(eng: Engine, qpos, qvel, h: float) -> torch.Tensor:
    """qpos advanced by qvel over h: slides and hinges linearly, free joints' position
    linearly and quaternion by the local exponential map."""
    out = qpos.clone()
    if eng.hs_qposadr.shape[0]:
        out[..., eng.hs_qposadr] = qpos[..., eng.hs_qposadr] + h * qvel[..., eng.hs_dofadr]
    for qa, da in eng.free_adr:
        out[..., qa:qa + 3] = qpos[..., qa:qa + 3] + h * qvel[..., da:da + 3]
        out[..., qa + 3:qa + 7] = sp.quat_integrate(qpos[..., qa + 3:qa + 7],
                                                    qvel[..., da + 3:da + 6], h)
    for qa, da in eng.ball_adr:
        out[..., qa:qa + 4] = sp.quat_integrate(qpos[..., qa:qa + 4], qvel[..., da:da + 3], h)
    return out


# ---------------------------------------------------------------------------
# inverse dynamics, transmission moments and CoM jacobians (for solver/lqr)
# ---------------------------------------------------------------------------

def inverse_dynamics(eng: Engine, state: PhysicsState,
                     qacc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mj_inverse analog (JAX inverse_dynamics): the generalized force that
    realises `qacc` at the state's (qpos, qvel),

        qfrc_inverse = M qacc + bias - tau_passive - tau_limits - tau_contact

    with the tanh frictionloss in the passive term and the limit and
    contact forces in their inverse reading (r_form) at the given motion,
    so no constraint solve is needed and the result is differentiable.
    qacc=None: zero acceleration, and no M qacc term. One sample or a
    state with a leading K axis (floor pairs only, as the penalty step)."""
    if not eng.has_dynamics:
        raise ValueError("inverse_dynamics needs a snapshot with the engine's fields "
                         "(export_model_arrays(plant=True))")
    with _full_f32():
        qpos, qvel, S = state.qpos, state.qvel, state.S
        I, _ = spatial_inertias(eng, state.xpos, state.xquat)
        bias = bias_forces(eng, S, I, state.body_vel, qvel)
        tau, _ = passive_forces(eng, qpos, qvel, frictionloss=True)
        if eng.has_limits:
            tau = tau + limit_constraint_forces(eng, qpos, qvel, qacc, r_form=True,
                                                state=state)[0]
        if eng.contact is not None:
            tau = tau + contact.contact_terms(eng.contact, state, S, eng.h, qacc=qacc,
                                              r_form=True)[0]
        out = bias - tau
        if qacc is not None:
            out = out + (mass_matrix(eng, S, I) @ qacc[..., None])[..., 0]
    return out


def actuator_moment(eng: Engine, state: Optional[PhysicsState] = None) -> torch.Tensor:
    """(nu, nv) transmission moment, qfrc_actuator = moment^T force (JAX
    actuator_moment, mujoco actuator_moment). Joint, multi-dof and
    fixed-tendon rows are constant; a site's row and a spatial tendon's
    depend on the state's kinematics (the world wrench turns with the
    site's body, the tendon's segments with theirs), so a model with such
    an actuator needs `state`."""
    m = eng.model
    M = np.zeros((m.nu, m.nv))
    state_rows = []
    spatial = {i: c["idx"] for kind, i, c in eng.trn if kind == "spatial"}
    for i, a in enumerate(m.actuators):
        if i in spatial:
            if state is None:
                raise NotImplementedError(
                    "spatial-tendon moments are state-dependent; pass state kinematics "
                    "(actuator_moment(eng, state))")
            state_rows.append(i)
        elif a.site_bodyid >= 0:
            if state is None:
                raise NotImplementedError(
                    "site-transmission moments are state-dependent; pass the state's "
                    "kinematics (actuator_moment(eng, state))")
            state_rows.append(i)
        elif a.tendon_id >= 0:
            M[i] = a.gear * m.tendon_coef[a.tendon_id]
        elif a.ndof > 1:
            M[i, a.dofadr:a.dofadr + a.ndof] = a.gear6[:a.ndof]
        else:
            M[i, a.dofadr] = a.gear
    out = eng.t(M)
    if not state_rows:
        return out
    rows = {i: c for kind, i, c in eng.trn if kind == "site"}
    M_sp = spatial_tendon_geometry(eng, state)[1] if spatial else None
    for i in state_rows:
        row = (float(m.actuators[i].gear) * M_sp[spatial[i]] if i in spatial
               else _site_moment(rows[i], state))
        out = torch.cat([out[:i], row[None], out[i + 1:]], 0)
    return out


def _site_moment(c: dict, state: PhysicsState) -> torch.Tensor:
    """A site actuator's moment row (nv,): the gear wrench in the site
    frame, moved to the world origin and projected on the dofs that move
    the site's body (actuator_forces' site branch)."""
    b, S = c["body"], state.S
    R_b = sp.quat_to_mat(state.xquat[..., b, :])
    p_s = state.xpos[..., b, :] + R_b @ c["pos"]
    R_s = R_b @ c["R"]
    Fw = R_s @ c["g_f"]
    tau0 = R_s @ c["g_t"] + sp.cross(p_s, Fw)
    return ((S[..., :, :3] @ tau0[..., :, None])[..., 0]
            + (S[..., :, 3:] @ Fw[..., :, None])[..., 0]) * c["anc"]


def body_com_jacobian(eng: Engine, state: PhysicsState, bodyid: int) -> torch.Tensor:
    """(3, nv) world translational jacobian of a body's centre of mass
    (mj_jacBodyCom; JAX body_com_jacobian)."""
    R = sp.quat_to_mat(state.xquat[bodyid])
    xipos = state.xpos[bodyid] + R @ eng.body_ipos[bodyid]
    S_ang, S_lin = state.S[:, :3], state.S[:, 3:]
    J = (S_lin + sp.cross(S_ang, xipos[None, :])) * eng.A[bodyid][:, None]
    return J.T


def subtree_com_jacobian(eng: Engine, state: PhysicsState, rootid: int) -> torch.Tensor:
    """(3, nv) jacobian of the mass-weighted CoM of `rootid`'s subtree
    (mj_jacSubtreeCom; JAX subtree_com_jacobian), the bodies' jacobians
    summed in body order."""
    m = eng.model
    in_sub = np.zeros(m.nbody, bool)
    in_sub[rootid] = True
    for b in range(rootid + 1, m.nbody):
        in_sub[b] = in_sub[m.body_parent[b]]
    ids = np.where(in_sub)[0]
    masses = m.body_mass[ids]
    total = float(masses.sum())
    J = torch.zeros((3, m.nv), dtype=state.qpos.dtype, device=state.qpos.device)
    for b, mass in zip(ids.tolist(), masses.tolist()):
        J = J + (mass / total) * body_com_jacobian(eng, state, b)
    return J
