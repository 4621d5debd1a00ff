"""Scalar struct-of-arrays physics step: the plain PyTorch version of the
rollout kernel's physics (ops/scalar_physics.py counterpart).

Every quantity (each qpos component, each mass-matrix entry) is a (K,)
tensor over the MPPI sample lanes, or a Python float where the model makes
it a constant. The model loops run in Python, as the JAX module's do at
trace time, with the same 0/1 folding (fmul/fadd/fsub/fdot), so the f64
results agree with the JAX step to rounding. This is the reference the CUDA
kernel (csrc/rollout_body.cuh) is held against; it runs one small tensor op
per equation and is no yardstick of speed.

Covered: free, ball, slide and hinge joints; joint, multi-dof (ball/free
motor), fixed-tendon and site actuator transmissions; dof damping and
frictionloss; joint springs and limits, ball-joint quaternion springs and
rotation-angle limits; limited fixed tendons; and plane-vs-sphere/capsule/
box/exact-cylinder/mesh penalty contacts -- every robot of the JAX
registry. `unsupported_features` names what a model needs beyond that
(moving planes); such a model raises NotImplementedError here and in
ops/rollout_kernel, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..physics.model import (
    BALL,
    FREE,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_MESH,
    GEOM_PLANE,
    GEOM_SPHERE,
    HINGE,
    SLIDE,
    PhysicsModel,
)
# the planner tier's cap (m/s) on the separation velocity a contact or limit
# may push out at
from ..physics.contact import RESTITUTION_VCAP
from .kernel_math import atan2 as _atan2
_VT_EPS = 5e-3
# (cos, sin) of the exact cylinder's three rim points per cap
_RIM = ((1.0, 0.0), (-0.5, 0.8660254037844386), (-0.5, -0.8660254037844386))

Vec3 = Tuple
Quat = Tuple


def unsupported_features(model: PhysicsModel) -> List[str]:
    """What `model` needs beyond the port's scalar step (empty = covered)."""
    bad = []
    for j in model.joints:
        if j.jtype not in (FREE, BALL, SLIDE, HINGE):
            bad.append(f"joint type {j.jtype}")
    for pair in model.contact_pairs:
        g1, g2 = model.geoms[pair.geom1], model.geoms[pair.geom2]
        if g1.gtype != GEOM_PLANE:
            continue
        if g1.bodyid != 0:
            bad.append("moving planes")
        if g2.gtype in (GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_MESH):
            continue
        bad.append(f"plane-vs-geom type {g2.gtype} (orig {g2.gtype_orig})")
    return sorted(set(bad))


# ---------------------------------------------------------------------------
# tuple algebra over (K,) lanes; constants are python floats (folded)
# ---------------------------------------------------------------------------


def _czero(x) -> bool:
    return isinstance(x, (int, float)) and x == 0.0


def _cone(x) -> bool:
    return isinstance(x, (int, float)) and x == 1.0


def fmul(x, y):
    """Multiply with 0/1 folding of Python-float constants."""
    if _czero(x) or _czero(y):
        return 0.0
    if _cone(x):
        return y
    if _cone(y):
        return x
    return x * y


def fadd(x, y):
    if _czero(x):
        return y
    if _czero(y):
        return x
    return x + y


def fsub(x, y):
    if _czero(y):
        return x
    if _czero(x):
        return -y
    return x - y


def fdot(xs, ys):
    """sum_i xs[i]*ys[i] with zero folding and a balanced reduction tree
    (the JAX module's summation order)."""
    terms = [t for t in (fmul(x, y) for x, y in zip(xs, ys)) if not _czero(t)]
    if not terms:
        return 0.0
    while len(terms) > 1:
        nxt = [fadd(terms[i], terms[i + 1]) for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _imp_scalar(viol, solimp):
    """MuJoCo solimp impedance spline d(r) over a (K,) violation."""
    d0, dmax, width, mid, power = [float(v) for v in solimp]

    if power == int(power) and 1 <= power <= 4:
        def powf(x):
            r = x
            for _ in range(int(power) - 1):
                r = r * x
            return r
    else:
        def powf(x):
            return x ** power

    x = torch.clamp(viol / width, 0.0, 1.0)
    lo = mid * powf(x / mid)
    hi = 1.0 - (1.0 - mid) * powf((1.0 - x) / (1.0 - mid))
    s = torch.where(x < mid, lo, hi)
    return d0 + s * (dmax - d0)


def _solref_kb_scalar(solref, solimp):
    """Static (k_base, b_ref) floats from solref/solimp."""
    tau, zeta = float(solref[0]), float(solref[1])
    dmax = float(solimp[1])
    if tau <= 0:
        raise NotImplementedError("direct (negative) solref not supported")
    return 1.0 / (dmax * dmax * tau * tau * zeta * zeta), 2.0 / (dmax * tau)


def qmul(a: Quat, b: Quat) -> Quat:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return (
        fsub(fsub(fsub(fmul(w1, w2), fmul(x1, x2)), fmul(y1, y2)), fmul(z1, z2)),
        fsub(fadd(fadd(fmul(w1, x2), fmul(x1, w2)), fmul(y1, z2)), fmul(z1, y2)),
        fadd(fadd(fsub(fmul(w1, y2), fmul(x1, z2)), fmul(y1, w2)), fmul(z1, x2)),
        fadd(fsub(fadd(fmul(w1, z2), fmul(x1, y2)), fmul(y1, x2)), fmul(z1, w2)),
    )


def qrot(q: Quat, v: Vec3) -> Vec3:
    """Rotate v by q: v + 2w(u x v) + 2u x (u x v)."""
    w, ux, uy, uz = q
    vx, vy, vz = v
    cx = fsub(fmul(uy, vz), fmul(uz, vy))
    cy = fsub(fmul(uz, vx), fmul(ux, vz))
    cz = fsub(fmul(ux, vy), fmul(uy, vx))
    dx = fsub(fmul(uy, cz), fmul(uz, cy))
    dy = fsub(fmul(uz, cx), fmul(ux, cz))
    dz = fsub(fmul(ux, cy), fmul(uy, cx))
    return (fadd(vx, fmul(2, fadd(fmul(w, cx), dx))),
            fadd(vy, fmul(2, fadd(fmul(w, cy), dy))),
            fadd(vz, fmul(2, fadd(fmul(w, cz), dz))))


def qconj(q: Quat) -> Quat:
    w, x, y, z = q
    return (w, -x if not _czero(x) else 0.0,
            -y if not _czero(y) else 0.0,
            -z if not _czero(z) else 0.0)


def qlog(q: Quat):
    """Rotation vector (axis*angle, folded to [-pi, pi]) of a unit
    quaternion (physics/spatial.quat_log in scalar form), with the
    kernel's polynomial atan2 and its Newton step."""
    w, x, y, z = q
    sin_half = torch.sqrt(x * x + y * y + z * z + 1e-24)
    angle = 2.0 * _atan2(sin_half, w, precise=True)
    angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
    s = angle / sin_half
    return (x * s, y * s, z * s)


def qmat(q: Quat):
    """3x3 rotation as nested tuples R[i][j]."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def cross(a: Vec3, b: Vec3) -> Vec3:
    ax, ay, az = a
    bx, by, bz = b
    return (fsub(fmul(ay, bz), fmul(az, by)),
            fsub(fmul(az, bx), fmul(ax, bz)),
            fsub(fmul(ax, by), fmul(ay, bx)))


def dot3(a: Vec3, b: Vec3):
    return fdot(a, b)


def add3(a: Vec3, b: Vec3) -> Vec3:
    return (fadd(a[0], b[0]), fadd(a[1], b[1]), fadd(a[2], b[2]))


def sub3(a: Vec3, b: Vec3) -> Vec3:
    return (fsub(a[0], b[0]), fsub(a[1], b[1]), fsub(a[2], b[2]))


def scl3(a: Vec3, s) -> Vec3:
    return (fmul(a[0], s), fmul(a[1], s), fmul(a[2], s))


def add6(a, b):
    return tuple(fadd(x, y) for x, y in zip(a, b))


def dot6(a, b):
    return fdot(a, b)


def scl6(a, s):
    return tuple(fmul(x, s) for x in a)


# symmetric 6x6 spatial operators as 21-tuples (row-major upper triangle)
_SYM_IDX = {}
_k = 0
for _i in range(6):
    for _j in range(_i, 6):
        _SYM_IDX[(_i, _j)] = _k
        _SYM_IDX[(_j, _i)] = _k
        _k += 1


def sym_zero():
    return tuple(0.0 for _ in range(21))


def sym_add(a, b):
    return tuple(fadd(x, y) for x, y in zip(a, b))


def sym_scale(a, s):
    return tuple(fmul(x, s) for x in a)


def sym_mat_vec(Isym, v6):
    """I @ v for symmetric 21-tuple I and 6-tuple v."""
    return tuple(
        fdot([Isym[_SYM_IDX[(i, j)]] for j in range(6)], v6) for i in range(6))


def sym_rank1(u6, w):
    """w * u u^T as a 21-tuple."""
    out = []
    for i in range(6):
        for j in range(i, 6):
            out.append(fmul(fmul(w, u6[i]), u6[j]))
    return tuple(out)


def spatial_inertia_sym(mass: float, inertia_diag, com: Vec3, R) -> tuple:
    """21-tuple origin-frame spatial inertia ([w; v0] ordering):
    [[Ic - m cx cx, m cx], [-m cx, m I]] with Ic = R diag R^T about the com."""
    cx_, cy_, cz_ = com
    m = mass
    d0, d1, d2 = [float(x) for x in inertia_diag]
    Ic = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            Ic[i][j] = fdot((d0, d1, d2), (fmul(R[i][0], R[j][0]),
                                           fmul(R[i][1], R[j][1]),
                                           fmul(R[i][2], R[j][2])))
    c2 = cx_ * cx_ + cy_ * cy_ + cz_ * cz_
    c = (cx_, cy_, cz_)
    out = [0.0] * 21
    for i in range(3):
        for j in range(i, 3):
            v = Ic[i][j] - m * c[i] * c[j]
            if i == j:
                v = v + m * c2
            out[_SYM_IDX[(i, j)]] = v
    sk = ((0.0, -cz_, cy_), (cz_, 0.0, -cx_), (-cy_, cx_, 0.0))
    for i in range(3):
        for j in range(3):
            out[_SYM_IDX[(i, j + 3)]] = m * sk[i][j]
    for i in range(3):
        out[_SYM_IDX[(i + 3, i + 3)]] = m
    return tuple(out)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


class StepContext:
    """What cost functions see: scalar-SoA views of the post-step state."""

    def __init__(self):
        self.qpos: List = None
        self.qvel: List = None
        self.ctrl: List = None        # nu scalars, as the rollout applied them
        self.time = None
        self.xpos: Dict[int, Vec3] = {}
        self.xquat: Dict[int, Quat] = {}
        self.body_vel: Dict[int, tuple] = {}   # 6-tuple [w; v0]
        self.params: List = []        # runtime cost parameters
        self.R: Dict[int, tuple] = {}

    def body_R(self, b: int):
        R = self.R.get(b)
        if R is None:
            R = self.R[b] = qmat(self.xquat[b])
        return R

    def body_com_linvel(self, model: PhysicsModel, b: int) -> Vec3:
        R = self.body_R(b)
        ip = [float(x) for x in model.body_ipos[b]]
        xi = add3(self.xpos[b], tuple(
            R[i][0] * ip[0] + R[i][1] * ip[1] + R[i][2] * ip[2] for i in range(3)))
        V = self.body_vel[b]
        w = (V[0], V[1], V[2])
        v0 = (V[3], V[4], V[5])
        return add3(v0, cross(w, xi))


def _fk_scalar(model: PhysicsModel, qpos: List):
    """Unrolled FK: xpos, xquat (body -> tuple) and S (dof -> 6-tuple)."""
    xpos = {0: (0.0, 0.0, 0.0)}
    xquat = {0: (1.0, 0.0, 0.0, 0.0)}
    S: Dict[int, tuple] = {}
    qpos0 = model.qpos0

    for b in range(1, model.nbody):
        p = model.body_parent[b]
        bp = tuple(float(x) for x in model.body_pos[b])
        bq = tuple(float(x) for x in model.body_quat[b])
        pq = xquat[p]
        pos = xpos[p] if bp == (0.0, 0.0, 0.0) else add3(xpos[p], qrot(pq, bp))
        quat = pq if bq == (1.0, 0.0, 0.0, 0.0) else qmul(pq, bq)

        for jidx in model.body_joints[b]:
            jnt = model.joints[jidx]
            if jnt.jtype == FREE:
                a = jnt.qposadr
                pos = (qpos[a], qpos[a + 1], qpos[a + 2])
                qw, qx, qy, qz = qpos[a + 3], qpos[a + 4], qpos[a + 5], qpos[a + 6]
                inv = torch.rsqrt(qw * qw + qx * qx + qy * qy + qz * qz)
                quat = (qw * inv, qx * inv, qy * inv, qz * inv)
                d = jnt.dofadr
                for i in range(3):
                    e = [0.0, 0.0, 0.0]
                    e[i] = 1.0
                    S[d + i] = (0.0, 0.0, 0.0, e[0], e[1], e[2])
                R = qmat(quat)
                for i in range(3):
                    a_w = (R[0][i], R[1][i], R[2][i])
                    S[d + 3 + i] = a_w + cross(pos, a_w)
            elif jnt.jtype == BALL:
                # a quaternion about the joint's anchor; its S rows are the
                # columns of the post-joint rotation, anchored there
                a = jnt.qposadr
                qw, qx, qy, qz = qpos[a], qpos[a + 1], qpos[a + 2], qpos[a + 3]
                inv = torch.rsqrt(qw * qw + qx * qx + qy * qy + qz * qz)
                q4 = (qw * inv, qx * inv, qy * inv, qz * inv)
                jp = tuple(float(x) for x in jnt.pos)
                anchor = add3(pos, qrot(quat, jp)) if jp != (0.0, 0.0, 0.0) else pos
                quat = qmul(quat, q4)
                if jp != (0.0, 0.0, 0.0):
                    pos = sub3(anchor, qrot(quat, jp))
                R = qmat(quat)
                for i in range(3):
                    a_w = (R[0][i], R[1][i], R[2][i])
                    S[jnt.dofadr + i] = a_w + cross(anchor, a_w)
            elif jnt.jtype == SLIDE:
                q = qpos[jnt.qposadr] - float(qpos0[jnt.qposadr])
                ax = tuple(float(x) for x in jnt.axis)
                a_w = qrot(quat, ax)
                pos = add3(pos, scl3(a_w, q))
                S[jnt.dofadr] = (0.0, 0.0, 0.0) + a_w
            elif jnt.jtype == HINGE:
                q = qpos[jnt.qposadr] - float(qpos0[jnt.qposadr])
                ax = tuple(float(x) for x in jnt.axis)
                jp = tuple(float(x) for x in jnt.pos)
                anchor = add3(pos, qrot(quat, jp)) if jp != (0.0, 0.0, 0.0) else pos
                half = 0.5 * q
                s, c = torch.sin(half), torch.cos(half)
                qloc = (c, ax[0] * s, ax[1] * s, ax[2] * s)
                quat = qmul(quat, qloc)
                if jp != (0.0, 0.0, 0.0):
                    pos = sub3(anchor, qrot(quat, jp))
                a_w = qrot(quat, ax)
                S[jnt.dofadr] = a_w + cross(anchor, a_w)
            else:
                raise NotImplementedError(f"joint type {jnt.jtype}")

        xpos[b] = pos
        xquat[b] = quat

    return xpos, xquat, S


def _velocities_and_sdot(model: PhysicsModel, S, qvel):
    """Body spatial velocities V_b and per-dof Sdot*qd terms W_j."""
    V = {0: (0.0,) * 6}
    W: Dict[int, tuple] = {}
    for b in range(1, model.nbody):
        Vcur = V[model.body_parent[b]]
        free_dofs = []
        for jidx in model.body_joints[b]:
            jnt = model.joints[jidx]
            d = jnt.dofadr
            if jnt.jtype == FREE:
                for i in range(6):
                    Vcur = add6(Vcur, scl6(S[d + i], qvel[d + i]))
                free_dofs.append(d)
            elif jnt.jtype == BALL:
                # the three rows are fixed in the post-ball frame: Sdot uses
                # the chain's velocity up to and including the ball's own
                # dofs (model.pred_mask's ball rows)
                for i in range(3):
                    Vcur = add6(Vcur, scl6(S[d + i], qvel[d + i]))
                w1, l1 = Vcur[0:3], Vcur[3:6]
                for i in range(3):
                    w2, l2 = S[d + i][0:3], S[d + i][3:6]
                    cw = cross(w1, w2)
                    cl = add3(cross(w1, l2), cross(l1, w2))
                    W[d + i] = tuple(x * qvel[d + i] for x in (cw + cl))
            else:
                w1, l1 = Vcur[0:3], Vcur[3:6]
                w2, l2 = S[d][0:3], S[d][3:6]
                cw = cross(w1, w2)
                cl = add3(cross(w1, l2), cross(l1, w2))
                W[d] = tuple(x * qvel[d] for x in (cw + cl))
                Vcur = add6(Vcur, scl6(S[d], qvel[d]))
        V[b] = Vcur
        for d in free_dofs:
            for i in range(3):            # world-fixed S: Sdot = 0
                W[d + i] = (0.0,) * 6
            w1, l1 = Vcur[0:3], Vcur[3:6]
            for i in range(3, 6):         # S fixed in the body: Vbody x S
                w2, l2 = S[d + i][0:3], S[d + i][3:6]
                cw = cross(w1, w2)
                cl = add3(cross(w1, l2), cross(l1, w2))
                W[d + i] = tuple(x * qvel[d + i] for x in (cw + cl))
    return V, W


def _chain_dofs(model: PhysicsModel, b: int) -> List[int]:
    return [d for d in range(model.nv) if model.ancestor_mask[b, d] > 0]


def _body_children(model: PhysicsModel) -> Dict[int, List[int]]:
    ch: Dict[int, List[int]] = {b: [] for b in range(model.nbody)}
    for b in range(1, model.nbody):
        ch[model.body_parent[b]].append(b)
    return ch


def scalar_forward(model: PhysicsModel, qpos: Sequence, qvel: Sequence):
    """FK + velocity sweep: what the step and the costs read."""
    xpos, xquat, S = _fk_scalar(model, list(qpos))
    V, W = _velocities_and_sdot(model, S, list(qvel))
    return {"xpos": xpos, "xquat": xquat, "S": S, "V": V, "W": W}


def _limit_force(viol_lo, viol_hi, vel, meff, solref, solimp, h):
    """Penalty-tier limit law with the restitution cap (engine._limit_force
    with qacc0 dropped): returns (s_dir, f >= 0, implicit damping c)."""
    k_base, b_ref = _solref_kb_scalar(solref, solimp)
    below = torch.clamp_min(viol_lo, 0.0)
    above = torch.clamp_min(viol_hi, 0.0)
    viol = below + above
    s_dir = torch.sign(below - above)
    active = (viol > 0).to(viol.dtype)
    d_r = _imp_scalar(viol, solimp)
    f = torch.clamp_min(
        meff * d_r * (d_r * k_base * viol - b_ref * (s_dir * vel)), 0.0) * active
    f = torch.minimum(f, meff * torch.clamp_min(
        RESTITUTION_VCAP - s_dir * vel, 0.0) / float(h))
    return s_dir, f, meff * d_r * b_ref * active


def scalar_step(
    model: PhysicsModel,
    qpos: Sequence,
    qvel: Sequence,
    ctrl: Sequence,
    time,
    fwd: Optional[dict] = None,
) -> Tuple[List, List, StepContext]:
    """One penalty-tier physics step (physics/engine.step solver="penalty").

    qpos/qvel/ctrl: sequences of (K,) tensors. Returns (qpos', qvel', ctx);
    pass `fwd` (from scalar_forward) to reuse the kinematics of qpos/qvel.
    """
    h = model.timestep
    nv = model.nv
    qpos = list(qpos)
    qvel = list(qvel)

    if fwd is None:
        fwd = scalar_forward(model, qpos, qvel)
    xpos, xquat, S = fwd["xpos"], fwd["xquat"], fwd["S"]
    V, W = fwd["V"], fwd["W"]

    Rcache: Dict[int, tuple] = {}

    def getR(b):
        R = Rcache.get(b)
        if R is None:
            R = Rcache[b] = qmat(xquat[b])
        return R

    # --- body spatial inertias (21-sym, origin frame) ---------------------
    Isym: Dict[int, tuple] = {}
    for b in range(1, model.nbody):
        R_b = getR(b)
        ip = tuple(float(x) for x in model.body_ipos[b])
        iq = tuple(float(x) for x in model.body_iquat[b])
        xi = add3(xpos[b], qrot(xquat[b], ip)) if ip != (0.0, 0.0, 0.0) else xpos[b]
        R_i = qmat(qmul(xquat[b], iq)) if iq != (1.0, 0.0, 0.0, 0.0) else R_b
        Isym[b] = spatial_inertia_sym(
            float(model.body_mass[b]), model.body_inertia[b], xi, R_i)

    # --- forces -----------------------------------------------------------
    tau = [0.0] * nv
    g_diag = [0.0] * nv          # implicit diagonal damping terms
    Fext: Dict[int, tuple] = {b: (0.0,) * 6 for b in range(model.nbody)}
    Dcon: Dict[int, tuple] = {}  # per-body 6x6 contact damping (21-sym)

    # actuators, each through its transmission (JAX engine._actuator_forces'
    # branches)
    dof2q = {j.dofadr: j.qposadr for j in model.joints if j.jtype in (SLIDE, HINGE)}
    for i, act in enumerate(model.actuators):
        u = ctrl[i]
        if act.ctrllimited:
            u = torch.clamp(u, float(act.ctrlrange[0]), float(act.ctrlrange[1]))
        b0, b1, b2 = [float(x) for x in act.bias]
        if act.site_bodyid >= 0:
            # a site's wrench (gear6: force, then torque, in the site frame)
            # projected onto the site body's chain; length 0
            b = act.site_bodyid
            sp_l = tuple(float(x) for x in act.site_pos)
            p_s = add3(xpos[b], qrot(xquat[b], sp_l)) if sp_l != (0.0, 0.0, 0.0) else xpos[b]
            sq = tuple(float(x) for x in act.site_quat)
            R_s = qmat(qmul(xquat[b], sq)) if sq != (1.0, 0.0, 0.0, 0.0) else getR(b)
            gv6 = [float(x) for x in act.gear6]
            Fw = tuple(fadd(fadd(fmul(R_s[r][0], gv6[0]), fmul(R_s[r][1], gv6[1])),
                            fmul(R_s[r][2], gv6[2])) for r in range(3))
            tq = tuple(fadd(fadd(fmul(R_s[r][0], gv6[3]), fmul(R_s[r][1], gv6[4])),
                            fmul(R_s[r][2], gv6[5])) for r in range(3))
            tau0 = add3(tq, cross(p_s, Fw))
            chain = _chain_dofs(model, b)
            moment = {d: fadd(dot3(S[d][0:3], tau0), dot3(S[d][3:6], Fw)) for d in chain}
            vel = sum(fmul(moment[d], qvel[d]) for d in chain)
            force = float(act.gain) * u
            if b0:
                force = force + b0
            if b2:
                force = force + b2 * vel
            if act.forcelimited:
                force = torch.clamp(force, float(act.forcerange[0]), float(act.forcerange[1]))
            for d in chain:
                tau[d] = fadd(tau[d], fmul(moment[d], force))
            continue
        if act.tendon_id >= 0:
            # a fixed tendon: length and velocity are the gear-scaled tendon
            # coordinates, the moment gear * its coefficients
            coef = model.tendon_coef[act.tendon_id]
            nz = np.nonzero(coef)[0]
            gear = float(act.gear)
            L = sum(float(coef[d]) * qpos[dof2q[d]] for d in nz)
            Ld = sum(float(coef[d]) * qvel[d] for d in nz)
            force = float(act.gain) * u
            if b0:
                force = force + b0
            if b1:
                force = force + b1 * (gear * L)
            if b2:
                force = force + b2 * (gear * Ld)
            if act.forcelimited:
                force = torch.clamp(force, float(act.forcerange[0]), float(act.forcerange[1]))
            for d in nz:
                tau[d] = fadd(tau[d], fmul(float(coef[d]) * gear, force))
            continue
        if act.ndof > 1:
            # a motor on a ball or free joint: the gear vector over its
            # dofs, the velocity bias on the gear projection of qvel
            gv = [float(x) for x in act.gear6[:act.ndof]]
            vel = sum(fmul(gv[k], qvel[act.dofadr + k]) for k in range(act.ndof))
            force = float(act.gain) * u
            if b2:
                force = force + b2 * vel
            if act.forcelimited:
                force = torch.clamp(force, float(act.forcerange[0]), float(act.forcerange[1]))
            for k in range(act.ndof):
                if gv[k]:
                    tau[act.dofadr + k] = fadd(tau[act.dofadr + k], fmul(gv[k], force))
            continue
        gear = float(act.gear)
        force = float(act.gain) * u
        if b0:
            force = force + b0
        if b1:
            force = force + b1 * (gear * qpos[act.qposadr])
        if b2:
            force = force + b2 * (gear * qvel[act.dofadr])
        if act.forcelimited:
            force = torch.clamp(force, float(act.forcerange[0]),
                                float(act.forcerange[1]))
        tau[act.dofadr] = fadd(tau[act.dofadr], fmul(gear, force))

    for d in range(nv):
        dmp = float(model.dof_damping[d])
        if dmp:
            tau[d] = fsub(tau[d], fmul(dmp, qvel[d]))
        fl = float(model.dof_frictionloss[d])
        if fl:
            w_fl = 0.05
            th = torch.tanh(qvel[d] / w_fl)
            tau[d] = fsub(tau[d], fmul(fl, th))
            g_diag[d] = fadd(g_diag[d], fmul(fl / w_fl, 1.0 - th * th))
    hs_meff = {int(d): float(me)
               for d, me in zip(model.hs_dofadr, model.hs_limit_meff)}
    for jnt in model.joints:
        if jnt.jtype not in (SLIDE, HINGE):
            continue
        d, qa = jnt.dofadr, jnt.qposadr
        if jnt.stiffness:
            tau[d] = fsub(tau[d], float(jnt.stiffness) * (qpos[qa] - float(jnt.springref)))
        if jnt.limited:
            lo, hi = float(jnt.range[0]), float(jnt.range[1])
            s_dir, f_l, c_l = _limit_force(lo - qpos[qa], qpos[qa] - hi, qvel[d],
                                           hs_meff[d], jnt.solref, jnt.solimp, h)
            tau[d] = fadd(tau[d], s_dir * f_l)
            g_diag[d] = fadd(g_diag[d], c_l)

    # ball joints: quaternion springs tau -= k subQuat(q, q_spring) (a
    # local-frame rotation vector), then rotation-angle limits, a row
    # J = -axis over the ball's dofs with the single-dof limit law
    for dofadr, qadr, k, qref in model.ball_springs:
        q4 = (qpos[qadr], qpos[qadr + 1], qpos[qadr + 2], qpos[qadr + 3])
        vec = qlog(qmul(qconj(tuple(float(x) for x in qref)), q4))
        for i in range(3):
            tau[dofadr + i] = fsub(tau[dofadr + i], float(k) * vec[i])
    ball_limit_G: List[Tuple[int, tuple, object]] = []
    for dofadr, qadr, max_angle, bl_solref, bl_solimp, bl_meff in model.ball_limits:
        rotvec = qlog((qpos[qadr], qpos[qadr + 1], qpos[qadr + 2], qpos[qadr + 3]))
        angle = torch.sqrt(dot3(rotvec, rotvec) + 1e-24)
        axis = scl3(rotvec, 1.0 / angle)
        v_row = -(dot3(axis, (qvel[dofadr], qvel[dofadr + 1], qvel[dofadr + 2])))
        _, f_b, c_b = _limit_force(angle - float(max_angle), torch.zeros_like(angle), v_row,
                                   float(bl_meff), bl_solref, bl_solimp, h)
        for i in range(3):
            tau[dofadr + i] = fsub(tau[dofadr + i], axis[i] * f_b)
        ball_limit_G.append((dofadr, axis, c_b))

    # limited fixed tendons
    tendon_G: List[Tuple[np.ndarray, object]] = []
    for t in range(model.tendon_coef.shape[0]):
        if not model.tendon_limited[t]:
            continue
        coef = model.tendon_coef[t]
        nz = np.nonzero(coef)[0]
        L = sum(float(coef[d]) * qpos[dof2q[d]] for d in nz)
        Ldot = sum(float(coef[d]) * qvel[d] for d in nz)
        lo, hi = float(model.tendon_range[t, 0]), float(model.tendon_range[t, 1])
        s_dir, f_t, c_t = _limit_force(
            lo - L, L - hi, Ldot, float(model.tendon_limit_meff[t]),
            model.tendon_limit_solref[t], model.tendon_limit_solimp[t], h)
        f_t = s_dir * f_t
        for d in nz:
            tau[d] = fadd(tau[d], fmul(float(coef[d]), f_t))
        tendon_G.append((coef, c_t))

    # --- contacts: plane vs sphere/capsule/cylinder/box/mesh ----------------
    for pair in model.contact_pairs:
        g1 = model.geoms[pair.geom1]
        g2 = model.geoms[pair.geom2]
        if g1.gtype != GEOM_PLANE:
            continue
        if g1.bodyid != 0:
            raise NotImplementedError("moving planes")
        mu = pair.mu if pair.condim > 1 else 0.0
        qw, qx, qy, qz = [float(v) for v in g1.quat]
        Rp = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
            [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
            [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
        ])
        n_c = tuple(float(x) for x in Rp[:, 2])
        p0_dot_n = float(np.dot(np.asarray(g1.pos), Rp[:, 2]))

        b = g2.bodyid
        gpos_l = tuple(float(x) for x in g2.pos)
        gq_l = tuple(float(x) for x in g2.quat)
        gp = add3(xpos[b], qrot(xquat[b], gpos_l)) if gpos_l != (0, 0, 0) else xpos[b]
        gq = qmul(xquat[b], gq_l) if gq_l != (1.0, 0.0, 0.0, 0.0) else xquat[b]

        pts: List[Tuple[Vec3, object]] = []  # (mid-surface point, phi)
        if g2.gtype == GEOM_SPHERE:
            r = float(g2.size[0])
            phi = dot3(n_c, gp) - p0_dot_n - r
            pts.append((sub3(gp, scl3(n_c, r + 0.5 * phi)), phi))
        elif g2.gtype == GEOM_CAPSULE and g2.gtype_orig == GEOM_CYLINDER:
            # exact cylinder: three rim points per cap, the downhill extreme
            # and two at +-120 deg; near standing the downhill direction
            # falls back to the cylinder's own x-axis
            r, hl = float(g2.size[0]), float(g2.size[1])
            Rg = getR(b) if gq_l == (1.0, 0.0, 0.0, 0.0) else qmat(gq)
            axis = (Rg[0][2], Rg[1][2], Rg[2][2])
            adn = dot3(axis, n_c)
            d_cap = tuple(-(n_c[i] - adn * axis[i]) for i in range(3))
            dn = torch.sqrt(dot3(d_cap, d_cap) + 1e-30)
            ok = dn > 1e-6
            xax = (Rg[0][0], Rg[1][0], Rg[2][0])
            dhat = tuple(torch.where(ok, d_cap[i] / dn, xax[i]) for i in range(3))
            dhat = scl3(dhat, torch.rsqrt(dot3(dhat, dhat)))
            perp = cross(axis, dhat)
            for sgn in (-1.0, 1.0):
                ce = add3(gp, scl3(axis, sgn * hl))
                for ca, sa in _RIM:
                    p_rim = add3(ce, add3(scl3(dhat, r * ca), scl3(perp, r * sa)))
                    phi = dot3(n_c, p_rim) - p0_dot_n
                    pts.append((sub3(p_rim, scl3(n_c, 0.5 * phi)), phi))
        elif g2.gtype == GEOM_CAPSULE:
            r, hl = float(g2.size[0]), float(g2.size[1])
            Rg = getR(b) if gq_l == (1.0, 0.0, 0.0, 0.0) else qmat(gq)
            axis = (Rg[0][2], Rg[1][2], Rg[2][2])
            for sgn in (-1.0, 1.0):
                ce = add3(gp, scl3(axis, sgn * hl))
                phi = dot3(n_c, ce) - p0_dot_n - r
                pts.append((sub3(ce, scl3(n_c, r + 0.5 * phi)), phi))
        elif g2.gtype == GEOM_BOX:
            sx, sy, sz = [float(x) for x in g2.size]
            Rg = getR(b) if gq_l == (1.0, 0.0, 0.0, 0.0) else qmat(gq)
            for cx in (-sx, sx):
                for cy in (-sy, sy):
                    for cz in (-sz, sz):
                        corner = add3(gp, tuple(
                            Rg[i][0] * cx + Rg[i][1] * cy + Rg[i][2] * cz
                            for i in range(3)))
                        phi = dot3(n_c, corner) - p0_dot_n
                        pts.append((sub3(corner, scl3(n_c, 0.5 * phi)), phi))
        elif g2.gtype == GEOM_MESH:
            # every vertex is a candidate point, gated by penetration like a
            # box corner (the array tiers keep the 4 deepest instead)
            Rg = getR(b) if gq_l == (1.0, 0.0, 0.0, 0.0) else qmat(gq)
            for v_loc in g2.mesh_verts:
                vx, vy, vz = [float(x) for x in v_loc]
                w_ = add3(gp, tuple(Rg[i][0] * vx + Rg[i][1] * vy + Rg[i][2] * vz
                                    for i in range(3)))
                phi = dot3(n_c, w_) - p0_dot_n
                pts.append((sub3(w_, scl3(n_c, 0.5 * phi)), phi))
        else:
            raise NotImplementedError(
                f"plane-vs-geom type {g2.gtype} (orig {g2.gtype_orig})")

        k_base, b_ref = _solref_kb_scalar(pair.solref, pair.solimp)
        meff_c = float(pair.m_eff)
        Vb = V[b]
        wb, v0b = Vb[0:3], Vb[3:6]
        marg = float(pair.margin)
        for point, phi in pts:
            v_pt = add3(v0b, cross(wb, point))
            vn = dot3(n_c, v_pt)
            vt = sub3(v_pt, scl3(n_c, vn))
            pen = torch.clamp_min(marg - phi, 0.0)
            active = (phi < marg).to(pen.dtype)
            d_r = _imp_scalar(pen, pair.solimp)
            c_n = meff_c * d_r * b_ref
            fn = torch.clamp_min(
                meff_c * d_r * d_r * k_base * pen - c_n * vn, 0.0) * active
            fn = torch.minimum(
                fn, meff_c * torch.clamp_min(RESTITUTION_VCAP - vn, 0.0) / float(h))
            vt_norm = torch.sqrt(dot3(vt, vt) + _VT_EPS * _VT_EPS)
            ct = mu * fn / vt_norm if mu else 0.0
            f = sub3(scl3(n_c, fn), scl3(vt, ct) if mu else (0.0, 0.0, 0.0))
            trq = cross(point, f)
            Fext[b] = add6(Fext[b], trq + f)
            # D += cn u_z u_z^T + ct (u_x u_x^T + u_y u_y^T), u_a = [p x a; a]
            cn_eff = c_n * active
            ct_eff = ct * active if mu else 0.0
            px, py, pz = point
            if n_c == (0.0, 0.0, 1.0):
                u_x = (0.0, pz, -py, 1.0, 0.0, 0.0)
                u_y = (-pz, 0.0, px, 0.0, 1.0, 0.0)
                u_z = (py, -px, 0.0, 0.0, 0.0, 1.0)
            else:
                nz_ = np.asarray(n_c)
                t1 = np.cross(nz_, [0.0, 0.0, 1.0])
                if np.linalg.norm(t1) < 1e-6:
                    t1 = np.cross(nz_, [0.0, 1.0, 0.0])
                t1 /= np.linalg.norm(t1)
                t2 = np.cross(nz_, t1)

                def u_of(a):
                    ax, ay, az = [float(x) for x in a]
                    return (py * az - pz * ay, pz * ax - px * az,
                            px * ay - py * ax, ax, ay, az)
                u_x, u_y, u_z = u_of(t1), u_of(t2), u_of(n_c)
            D = Dcon.get(b, sym_zero())
            D = sym_add(D, sym_rank1(u_z, cn_eff))
            if mu:
                D = sym_add(D, sym_add(sym_rank1(u_x, ct_eff), sym_rank1(u_y, ct_eff)))
            Dcon[b] = D

    # --- bias forces: origin-frame Newton-Euler with qacc=0 ---------------
    children = _body_children(model)
    a_grav = (0.0, 0.0, 0.0) + tuple(-float(g) for g in model.gravity)
    a_bias: Dict[int, tuple] = {0: a_grav}
    order = list(range(1, model.nbody))
    for b in order:
        a = a_bias[model.body_parent[b]]
        for jidx in model.body_joints[b]:
            jnt = model.joints[jidx]
            for i in range(jnt.ndof):
                a = add6(a, W[jnt.dofadr + i])
        a_bias[b] = a

    f_net: Dict[int, tuple] = {}
    for b in order:
        IV = sym_mat_vec(Isym[b], V[b])
        Ia = sym_mat_vec(Isym[b], a_bias[b])
        w, vl = V[b][0:3], V[b][3:6]
        n_, fl_ = IV[0:3], IV[3:6]
        vxf = add3(cross(w, n_), cross(vl, fl_)) + cross(w, fl_)
        f_net[b] = add6(Ia, vxf)

    F_hat: Dict[int, tuple] = {}
    for b in reversed(order):
        F = add6(f_net[b], tuple(-x for x in Fext[b]))
        for c in children[b]:
            F = add6(F, F_hat[c])
        F_hat[b] = F
    rhs = [None] * nv
    for d in range(nv):
        b = int(model.dof_bodyid[d])
        rhs[d] = fsub(tau[d], dot6(S[d], F_hat[b]))

    # --- composite inertia pass: Mh entries (tree-sparse) -----------------
    IC: Dict[int, tuple] = {}
    for b in reversed(order):
        I_aug = Isym[b]
        if b in Dcon:
            I_aug = sym_add(I_aug, sym_scale(Dcon[b], h))
        for c in children[b]:
            I_aug = sym_add(I_aug, IC[c])
        IC[b] = I_aug

    Mh: Dict[Tuple[int, int], object] = {}
    for d in range(nv):
        b = int(model.dof_bodyid[d])
        Fd = sym_mat_vec(IC[b], S[d])
        for e in _chain_dofs(model, b):
            if e > d:
                continue
            Mh[(d, e)] = dot6(S[e], Fd)
    for d in range(nv):
        extra = float(model.dof_armature[d]) + h * float(model.dof_damping[d])
        Mh[(d, d)] = fadd(fadd(Mh[(d, d)], extra), fmul(h, g_diag[d]))
    for coef, c_act in tendon_G:
        nz = np.nonzero(coef)[0]
        for i_, d in enumerate(nz):
            for e in nz[: i_ + 1]:
                key = (max(d, e), min(d, e))
                Mh[key] = Mh[key] + h * float(coef[d]) * float(coef[e]) * c_act
    # ball limits' implicit damping c_b axis axis^T over the ball's dofs
    # (one chain: every entry is in the pattern)
    for dofadr, axis, c_b in ball_limit_G:
        for i_ in range(3):
            for j_ in range(i_ + 1):
                key = (dofadr + i_, dofadr + j_)
                Mh[key] = Mh[key] + h * c_b * axis[i_] * axis[j_]

    # --- tree-sparse Cholesky + solve -------------------------------------
    # dofs are topologically ordered parents-first; eliminating leaves first
    # (position nv-1-d) gives L exactly the chain pattern: no fill
    chainset = [set(_chain_dofs(model, int(model.dof_bodyid[d]))) for d in range(nv)]

    def Mget(d, e):
        return Mh[(max(d, e), min(d, e))]

    elim = list(range(nv - 1, -1, -1))
    Lc: Dict[Tuple[int, int], object] = {}
    Ldiag_inv = [None] * nv

    def later_chain(d):
        return [e for e in range(d + 1, nv) if d in chainset[e]]

    for d in elim:
        lc = later_chain(d)
        s = fsub(Mget(d, d), fdot([Lc[(d, p)] for p in lc],
                                  [Lc[(d, p)] for p in lc]))
        dinv = torch.rsqrt(s)
        Ldiag_inv[d] = dinv
        Lc[(d, d)] = s * dinv
        for i in sorted(chainset[d]):
            if i >= d:
                break
            v = fsub(Mget(i, d), fdot([Lc[(i, p)] for p in lc],
                                      [Lc[(d, p)] for p in lc]))
            Lc[(i, d)] = v * dinv

    y = {}
    for d in elim:
        lc = later_chain(d)
        v = fsub(rhs[d], fdot([Lc[(d, p)] for p in lc], [y[p] for p in lc]))
        y[d] = v * Ldiag_inv[d]
    qacc_d = {}
    for d in range(nv):
        anc = [i for i in sorted(chainset[d]) if i < d]
        v = fsub(y[d], fdot([Lc[(i, d)] for i in anc],
                            [qacc_d[i] for i in anc]))
        qacc_d[d] = v * Ldiag_inv[d]
    qacc = [qacc_d[d] for d in range(nv)]

    # --- integrate --------------------------------------------------------
    qvel_new = [qvel[d] + h * qacc[d] for d in range(nv)]
    qpos_new = list(qpos)
    for jnt in model.joints:
        if jnt.jtype in (SLIDE, HINGE):
            qpos_new[jnt.qposadr] = qpos[jnt.qposadr] + h * qvel_new[jnt.dofadr]
        elif jnt.jtype == BALL:
            # the local-frame exponential map, as the free joint's rotation
            qa, d = jnt.qposadr, jnt.dofadr
            wx, wy, wz = qvel_new[d], qvel_new[d + 1], qvel_new[d + 2]
            ang = torch.sqrt(wx * wx + wy * wy + wz * wz + 1e-30)
            half = 0.5 * h * ang
            sinc = torch.sin(half) / ang
            dq = (torch.cos(half), wx * sinc, wy * sinc, wz * sinc)
            qn = qmul((qpos[qa], qpos[qa + 1], qpos[qa + 2], qpos[qa + 3]), dq)
            norm_inv = torch.rsqrt(qn[0] ** 2 + qn[1] ** 2 + qn[2] ** 2 + qn[3] ** 2)
            for i in range(4):
                qpos_new[qa + i] = qn[i] * norm_inv
        else:  # FREE
            qa, d = jnt.qposadr, jnt.dofadr
            for i in range(3):
                qpos_new[qa + i] = qpos[qa + i] + h * qvel_new[d + i]
            wx, wy, wz = qvel_new[d + 3], qvel_new[d + 4], qvel_new[d + 5]
            ang2 = wx * wx + wy * wy + wz * wz
            ang = torch.sqrt(ang2 + 1e-30)
            half = 0.5 * h * ang
            sinc = torch.sin(half) / ang
            dq = (torch.cos(half), wx * sinc, wy * sinc, wz * sinc)
            qn = qmul((qpos[qa + 3], qpos[qa + 4], qpos[qa + 5], qpos[qa + 6]), dq)
            norm_inv = torch.rsqrt(qn[0] ** 2 + qn[1] ** 2 + qn[2] ** 2 + qn[3] ** 2)
            for i in range(4):
                qpos_new[qa + 3 + i] = qn[i] * norm_inv

    ctx = StepContext()
    ctx.qpos = qpos_new
    ctx.qvel = qvel_new
    ctx.ctrl = list(ctrl)
    ctx.time = time + h
    ctx.xpos = xpos
    ctx.xquat = xquat
    ctx.body_vel = V
    return qpos_new, qvel_new, ctx


def ctx_from(model: PhysicsModel, fwd: dict, qpos, qvel, ctrl, time) -> StepContext:
    """StepContext view over cached scalar_forward internals."""
    ctx = StepContext()
    ctx.qpos = list(qpos)
    ctx.qvel = list(qvel)
    ctx.ctrl = list(ctrl)
    ctx.time = time
    ctx.xpos = fwd["xpos"]
    ctx.xquat = fwd["xquat"]
    ctx.body_vel = fwd["V"]
    return ctx
