"""Fused MPPI rollout: the CUDA kernel and its plain PyTorch version
(ops/rollout_kernel.py counterpart).

`build_rollout_kernel(...)` returns rollouts(qpos0 (nq,K), qvel0 (nv,K),
time0 (1,K), U (T,nu), noise (T,nu,K), params=None) -> (costs (K,),
qpos_T (nq,K), qvel_T (nv,K)), the JAX layout. Dispatch is by the tensors'
device: a CUDA tensor launches the hand-written kernel (csrc/
rollout_kernel.cu, built by nvcc, loaded with ctypes) or raises; a CPU
tensor runs `rollouts_plain`, the T-step loop of scalar_step +
scalar_forward + cost that the kernel is held against. There is no
fallback from one to the other.

The kernel is table-driven: the model and the cost constants are packed
once into a flat struct (`pack_tables`, mirrored field for field from
rollout_body.cuh with ctypes) that the kernel loops over. It carries every
cost of `KERNEL_COSTS` (humanoid, humanoid_v1, humanoid_hard, quadruped,
quadruped_jl, cartpole, hopper, arm5) by a cost id and each cost's
constants. It refuses what the JAX kernel refuses (spatial tendons, a mesh
in a pair without a plane), moving planes, and what exceeds its capacities.
"""

from __future__ import annotations

import ctypes
import functools
import inspect
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..physics.model import (BALL, FREE, GEOM_BOX, GEOM_CYLINDER, GEOM_MESH, GEOM_PLANE,
                             GEOM_SPHERE, HINGE, SLIDE, PhysicsModel)
from . import _build
from . import kernel_costs
from . import scalar_physics as sph

NP = 16  # runtime cost-parameter slots (kernel_costs.PARAM_SLOTS)

# capacities of csrc/rollout_body.cuh
MAXB, MAXJ, MAXV, MAXQ, MAXU, MAXP, MAXT, MAXTNZ = 32, 32, 32, 40, 32, 64, 4, 8
MAXBALL, MAXTRN, MAXMV = 4, 8, 48
NCOSTW = 16  # cost constants
# the humanoid cost's constants, in hmr::CostW order
_COST_W = ("tx", "ty", "tz", "tvx", "tvy", "w_orient", "w_goal_xy", "w_height",
           "w_swing_x", "w_swing_vel", "w_knee_x", "w_clearance", "w_foot_lift")
_COST_PARAM_TARGET, _COST_PARAM_GAIT = 1, 2
# hmr::COST_* ids of the costs the kernel carries
_COST_ID = {kernel_costs.humanoid: 0, kernel_costs.quadruped: 1, kernel_costs.quadruped_jl: 2,
            kernel_costs.cartpole: 3, kernel_costs.hopper: 4, kernel_costs.humanoid_v1: 5,
            kernel_costs.humanoid_hard: 6, kernel_costs.arm5: 7}
# the hopper cost's constants, in hmr::HopW order
_HOPPER_W = ("target_vel_x", "target_height", "w_pitch", "w_pitch_rate")
_PAIR_SPHERE, _PAIR_CAPSULE, _PAIR_CYLINDER, _PAIR_BOX, _PAIR_MESH = 0, 1, 2, 3, 4
_PAIR_POINTS = {_PAIR_SPHERE: 1, _PAIR_CAPSULE: 2, _PAIR_CYLINDER: 6, _PAIR_BOX: 8}
# hmr::TRN_* transmission kinds
_TRN_MULTI, _TRN_TENDON, _TRN_SITE = 1, 2, 3

MAXTRI = MAXV * (MAXV + 1) // 2
MAXCHOL = 1024  # Cholesky updates over all dof levels
NTOP = 6        # the dof tree's top chain that one lane factors in registers
SOLIMP = 8      # solimp, then 1/width, 1/midpoint, 1/(1 - midpoint)
# one sample's workspace arrays (hmr::WsField order) and their lengths
WS_FIELDS = ("qpos", "qvel", "u", "time", "cost", "xpos", "xquat", "V", "S", "W", "IC",
             "F", "ab", "A", "tau", "gdiag", "rhs", "dinv", "ten_f", "ten_c", "qloc",
             "cscr", "loc", "hinge", "ball", "trn")
_FORWARD = ("qloc", "loc", "hinge")  # forward's scratch, one after the other
_SHARE_A = ("ab",) + _FORWARD        # arrays that live in the mass matrix's space
_SHARE_W = ("cscr",)                 # ... and in W's


def _further_pairs(model: PhysicsModel) -> list:
    """Indices, among the kernel's plane pairs, of the pairs after the first
    on their body: each gets a contact scratch slot."""
    bodies = [model.geoms[p.geom2].bodyid for p in model.contact_pairs
              if model.geoms[p.geom1].gtype == GEOM_PLANE]
    return [i for i, b in enumerate(bodies) if b in bodies[:i]]


def _tendon_rows(model: PhysicsModel) -> list:
    """The fixed tendons in the kernel's ten_ tables: the limited ones and
    those an actuator drives, in tendon order."""
    driven = {a.tendon_id for a in model.actuators if a.tendon_id >= 0}
    return [t for t in range(model.tendon_coef.shape[0])
            if model.tendon_limited[t] or t in driven]


def _transmissions(model: PhysicsModel) -> list:
    """(actuator, kind) of each actuator beyond a single-dof joint's."""
    out = []
    for i, a in enumerate(model.actuators):
        if a.site_bodyid >= 0:
            out.append((i, _TRN_SITE))
        elif a.tendon_id >= 0:
            out.append((i, _TRN_TENDON))
        elif a.ndof > 1:
            out.append((i, _TRN_MULTI))
    return out


def workspace_layout(model: PhysicsModel, nten: int) -> tuple[dict, int]:
    """Offsets (in scalars) of one sample's workspace arrays, sized to the
    model, and the total rounded up to 4 scalars (16-byte steps in f32).
    The bias accelerations and forward's scratch (hinge rotations, local
    poses, hinge anchors and axes, one after the other) share the mass
    matrix's space (csrc/rollout_body.cuh: live in step phases 1-2 and in
    forward, the mass matrix in phases 5-8); the contact scratch shares W's
    (live in phases 2-3, W in forward, phase 1 and phases 4-5)."""
    nb, nv = model.nbody, model.nv
    sizes = {"qpos": model.nq, "qvel": nv, "u": model.nu, "time": 1, "cost": 1,
             "xpos": 3 * nb, "xquat": 4 * nb, "V": 6 * nb, "S": 6 * nv, "W": 6 * nv, "IC": 21 * nb,
             "F": 6 * nb, "ab": 6 * nb, "A": nv * (nv + 1) // 2, "tau": nv,
             "gdiag": nv, "rhs": nv, "dinv": nv, "ten_f": nten, "ten_c": nten,
             "ball": 7 * sum(j.jtype == BALL for j in model.joints),
             "trn": 7 * len(_transmissions(model))}
    # the bias accelerations (step phases 1-2) and the hinge rotations
    # (forward) are dead whenever the mass matrix (phases 5-8) is live
    nj = len(model.joints)
    forward = {"qloc": 4 * nj, "loc": 7 * nb, "hinge": 6 * nj}
    sizes["A"] = max(sizes["A"], sizes.pop("ab"), sum(forward.values()))
    sizes["W"] = max(sizes["W"], 27 * len(_further_pairs(model)))
    off, n = {}, 0
    for name in WS_FIELDS:
        if name in sizes:
            off[name] = n
            n += sizes[name]
    off["ab"], off["cscr"] = off["A"], off["W"]
    at = off["A"]
    for name in _FORWARD:
        off[name] = at
        at += forward[name]
    return off, -(-n // 4) * 4


# CUDA kernel launches since import; callers that count reset it to 0
launches = 0

# hmr::Tables<T> of csrc/rollout_body.cuh, field for field in its order:
# (name, kind, *shape) with kind i = int32, u = uint32, h = int16, s = the scalar T
_FIELDS = (
    ("nbody", "i"), ("nq", "i"), ("nv", "i"), ("nu", "i"), ("npair", "i"),
    ("nten", "i"), ("terminal", "i"), ("clamp_ctrl", "i"), ("cost_id", "i"),
    ("cost_flags", "i"),
    ("cost_body", "i", 4), ("body_parent", "i", MAXB),
    ("body_jnt_adr", "i", MAXB), ("body_jnt_num", "i", MAXB),
    ("jnt_type", "i", MAXJ), ("jnt_qposadr", "i", MAXJ),
    ("jnt_dofadr", "i", MAXJ), ("jnt_limited", "i", MAXJ),
    ("dof_body", "i", MAXV), ("act_dof", "i", MAXU), ("act_qpos", "i", MAXU),
    ("act_ctrllimited", "i", MAXU), ("act_forcelimited", "i", MAXU),
    ("act_trn", "i", MAXU), ("ntrn", "i"), ("trn_kind", "i", MAXTRN),
    ("trn_body", "i", MAXTRN), ("trn_ten", "i", MAXTRN), ("nball", "i"),
    ("ball_jnt", "i", MAXBALL), ("ten_limited", "i", MAXT), ("pair_body", "i", MAXP),
    ("pair_type", "i", MAXP), ("ten_nnz", "i", MAXT),
    ("ten_dof", "i", MAXT, MAXTNZ), ("ten_qpos", "i", MAXT, MAXTNZ),
    ("dof_lc", "u", MAXV), ("dof_anc", "u", MAXV),
    ("off", "i", len(WS_FIELDS)), ("ws_size", "i"), ("njnt", "i"), ("nlvl", "i"),
    ("lvl_adr", "i", MAXB + 1), ("lvl_body", "i", MAXB), ("body_chain", "u", MAXB),
    ("body_child", "u", MAXB), ("acc_adr", "i", MAXB + 1), ("acc_body", "i", MAXB),
    ("body_pair0", "i", MAXB), ("nxpair", "i"), ("xpair", "i", MAXP),
    ("body_xadr", "i", MAXB + 1), ("dof_jnt", "i", MAXV),
    ("dof_acts", "u", MAXV), ("ndlvl", "i"), ("ntop", "i"), ("dlvl_adr", "i", MAXV + 1),
    ("dlvl_dof", "i", MAXV), ("dlvl_mask", "u", MAXV), ("nent", "i"),
    ("ent", "h", MAXTRI), ("ent_adr", "i", MAXV + 1), ("ten_dofmask", "u"),
    ("chol_adr", "i", MAXV + 1), ("chol_ent", "h", MAXCHOL), ("pair_npt", "h", MAXP),
    ("pair_vadr", "h", MAXP),
    ("h", "s"), ("inv_h", "s"), ("gravity", "s", 3), ("body_pos", "s", MAXB, 3),
    ("body_quat", "s", MAXB, 4), ("body_ipos", "s", MAXB, 3),
    ("body_iquat", "s", MAXB, 4), ("body_mass", "s", MAXB),
    ("body_inertia", "s", MAXB, 3), ("jnt_pos", "s", MAXJ, 3),
    ("jnt_axis", "s", MAXJ, 3), ("jnt_qpos0", "s", MAXJ),
    ("jnt_stiffness", "s", MAXJ), ("jnt_springref", "s", MAXJ),
    ("jnt_range", "s", MAXJ, 2), ("jnt_meff", "s", MAXJ),
    ("jnt_kbase", "s", MAXJ), ("jnt_bref", "s", MAXJ),
    ("jnt_solimp", "s", MAXJ, SOLIMP), ("dof_damping", "s", MAXV),
    ("dof_extra", "s", MAXV), ("dof_frictionloss", "s", MAXV),
    ("dof_fl_gain", "s", MAXV), ("act_gear", "s", MAXU), ("act_gain", "s", MAXU),
    ("act_bias", "s", MAXU, 3), ("act_ctrlrange", "s", MAXU, 2),
    ("act_forcerange", "s", MAXU, 2), ("pair_n", "s", MAXP, 3),
    ("pair_p0n", "s", MAXP), ("pair_gpos", "s", MAXP, 3),
    ("pair_gquat", "s", MAXP, 4), ("pair_size", "s", MAXP, 3),
    ("pair_mu", "s", MAXP), ("pair_kbase", "s", MAXP), ("pair_bref", "s", MAXP),
    ("pair_meff", "s", MAXP), ("pair_margin", "s", MAXP),
    ("pair_solimp", "s", MAXP, SOLIMP), ("ten_coef", "s", MAXT, MAXTNZ),
    ("ten_range", "s", MAXT, 2), ("ten_meff", "s", MAXT), ("ten_kbase", "s", MAXT),
    ("ten_bref", "s", MAXT), ("ten_solimp", "s", MAXT, SOLIMP),
    ("trn_gear", "s", MAXTRN, 6), ("trn_pos", "s", MAXTRN, 3), ("trn_quat", "s", MAXTRN, 4),
    ("ball_qref", "s", MAXBALL, 4), ("mesh_vert", "s", MAXMV, 3),
    ("ctrl_lo", "s", MAXU), ("ctrl_hi", "s", MAXU), ("cost_w", "s", NCOSTW),
)


def _ctype(base, shape):
    for n in reversed(shape):
        base = base * n
    return base


def tables_struct(dtype: torch.dtype):
    """ctypes mirror of hmr::Tables<T> (csrc/rollout_body.cuh), same order."""
    base = {"i": ctypes.c_int32, "u": ctypes.c_uint32, "h": ctypes.c_int16,
            "s": {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}[dtype]}
    fields = [(name, _ctype(base[kind], shape)) for name, kind, *shape in _FIELDS]
    return type(f"Tables_{base['s'].__name__}", (ctypes.Structure,),
                {"_fields_": fields})


def _solimp_power_ok(solimp) -> bool:
    p = float(solimp[4])
    return p == int(p) and 1 <= p <= 4


def check_kernel_supported(model: PhysicsModel) -> None:
    """Refuse what the kernel (and the plain step) does not cover: the JAX
    kernel's refusals (spatial tendons -- which no port model carries -- and
    a mesh in a pair without a plane), the features named by
    scalar_physics.unsupported_features, and the kernel's fixed
    capacities."""
    bad = sph.unsupported_features(model)
    for p in model.contact_pairs:
        g1, g2 = model.geoms[p.geom1], model.geoms[p.geom2]
        if GEOM_MESH in (g1.gtype, g2.gtype) and g1.gtype != GEOM_PLANE:
            bad.append("mesh-vs-primitive / mesh-vs-mesh pairs (array engine only, as in JAX)")
    for j in model.joints:
        if j.limited and j.jtype != BALL and not _solimp_power_ok(j.solimp):
            bad.append("joint-limit solimp power outside 1..4")
    for _, _, _, _, si, _ in model.ball_limits:
        if not _solimp_power_ok(si):
            bad.append("ball-limit solimp power outside 1..4")
    for p in model.contact_pairs:
        if model.geoms[p.geom1].gtype == GEOM_PLANE and not _solimp_power_ok(p.solimp):
            bad.append("contact solimp power outside 1..4")
    chain = [set(np.nonzero(model.ancestor_mask[int(model.dof_bodyid[d])])[0])
             for d in range(model.nv)]
    for t in _tendon_rows(model):
        nz = np.nonzero(model.tendon_coef[t])[0]
        if model.tendon_limited[t] and not _solimp_power_ok(model.tendon_limit_solimp[t]):
            bad.append("tendon-limit solimp power outside 1..4")
        if len(nz) > MAXTNZ:
            raise ValueError(f"tendon {t}: {len(nz)} dofs > capacity {MAXTNZ}")
        if model.tendon_limited[t] and any(e not in chain[d] for d in nz for e in nz if e < d):
            bad.append("tendon across branches (mass-matrix fill-in)")
    if any(model.body_parent[b] >= b for b in range(1, model.nbody)):
        bad.append("bodies not ordered parents-first")
    for b, js in enumerate(model.body_joints):
        if js and list(js) != list(range(js[0], js[0] + len(js))):
            bad.append("non-contiguous joints of a body")
        if len(js) > 1 and any(model.joints[j].jtype == FREE for j in js):
            bad.append("free joint sharing its body with other joints")
    if bad:
        raise NotImplementedError(
            "rollout kernel does not cover: " + "; ".join(sorted(set(bad))))
    plane = [p for p in model.contact_pairs if model.geoms[p.geom1].gtype == GEOM_PLANE]
    nmv = sum(len(model.geoms[p.geom2].mesh_verts) for p in plane
              if model.geoms[p.geom2].gtype == GEOM_MESH)
    caps = (("bodies", model.nbody, MAXB), ("joints", len(model.joints), MAXJ),
            ("dofs", model.nv, MAXV), ("qpos", model.nq, MAXQ),
            ("actuators", model.nu, MAXU), ("plane contact pairs", len(plane), MAXP),
            ("limited or driven fixed tendons", len(_tendon_rows(model)), MAXT),
            ("ball joints", sum(j.jtype == BALL for j in model.joints), MAXBALL),
            ("multi-dof, tendon or site transmissions", len(_transmissions(model)), MAXTRN),
            ("mesh vertices on plane pairs", nmv, MAXMV))
    for what, n, cap in caps:
        if n > cap:
            raise ValueError(f"model has {n} {what}; the kernel holds {cap}")


def _cost_constants(cost_factory: Callable, model: PhysicsModel, kw: dict):
    """(cost id, flags, body ids, constants) of the cost for the kernel."""
    if cost_factory not in _COST_ID:
        raise NotImplementedError(
            f"the CUDA rollout kernel carries {sorted(f.__name__ for f in _COST_ID)}, "
            f"not {getattr(cost_factory, '__name__', cost_factory)}")
    a = inspect.signature(cost_factory).bind(model, **kw)
    a.apply_defaults()
    c = a.arguments
    bodies, vals = [0] * 4, []
    flags = 0
    if cost_factory in (kernel_costs.humanoid, kernel_costs.humanoid_v1,
                        kernel_costs.humanoid_hard):
        bodies = [model.body_id(n) for n in
                  ("shin_left", "shin_right", "foot_left", "foot_right")]
    if cost_factory is kernel_costs.humanoid:
        flags = (_COST_PARAM_TARGET * bool(c["param_target"])
                 | _COST_PARAM_GAIT * bool(c["param_gait"]))
        w = dict(zip(("tx", "ty", "tz"), [float(v) for v in c["target"]]))
        w.update(zip(("tvx", "tvy"), [float(v) for v in c["target_vel"]]))
        w.update({k: float(c[k]) for k in _COST_W if k.startswith("w_")})
        vals = [w[k] for k in _COST_W]
    elif cost_factory is kernel_costs.humanoid_hard:
        vals = [float(v) for v in c["target"]] + [float(v) for v in c["target_vel"]]
    elif cost_factory is kernel_costs.humanoid_v1:
        if int(c["step_period"]) < 1:
            raise ValueError(f"step_period {c['step_period']} < 1")
        vals = [float(v) for v in c["target"]] + [float(c["target_vel"]),
                                                  float(int(c["step_period"])),
                                                  float(int(c["horizon"]))]
    elif cost_factory is kernel_costs.hopper:
        flags = _COST_PARAM_GAIT * bool(c["param_gait"])
        vals = [float(c[k]) for k in _HOPPER_W]
    elif cost_factory is kernel_costs.cartpole:
        pass
    elif cost_factory is kernel_costs.arm5:
        bodies = [model.body_id("hand"), 0, 0, 0]
        vals = [float(v) for v in c["target"]] + [float(c[k]) for k in ("w_reach", "w_vel",
                                                                         "w_ctrl")]
    elif cost_factory is kernel_costs.quadruped:
        flags = (_COST_PARAM_TARGET * bool(c["param_goal"])
                 | _COST_PARAM_GAIT * bool(c["param_gait"]))
        home = np.asarray(dict(model.keyframes)["home"])[7:19]
        vals = [float(v) for v in c["goal_xy"]] + [float(x) for x in home]
    else:
        vals = [float(c["target_vel_x"])]
    return _COST_ID[cost_factory], flags, bodies, vals + [0.0] * (NCOSTW - len(vals))


def _pair_kind(geom) -> int:
    if geom.gtype == GEOM_SPHERE:
        return _PAIR_SPHERE
    if geom.gtype == GEOM_BOX:
        return _PAIR_BOX
    if geom.gtype == GEOM_MESH:
        return _PAIR_MESH
    return _PAIR_CYLINDER if geom.gtype_orig == GEOM_CYLINDER else _PAIR_CAPSULE


def _solimp(si) -> list:
    """solimp as the kernel reads it: the five values, then the reciprocals
    of the width, the midpoint and 1 - midpoint."""
    si = [float(x) for x in si]
    return si + [1.0 / si[2], 1.0 / si[3], 1.0 / (1.0 - si[3])]


def pack_tables(model: PhysicsModel, cost_factory: Callable, cost_kwargs: dict,
                ctrl_low, ctrl_high, terminal: bool, dtype: torch.dtype) -> bytes:
    """The kernel's model/cost tables as the bytes of hmr::Tables<T>."""
    check_kernel_supported(model)
    cost_id, flags, cost_bodies, cost_w = _cost_constants(cost_factory, model, cost_kwargs)
    s = tables_struct(dtype)()
    v = {name: np.ctypeslib.as_array(getattr(s, name))
         for name, _, *shape in _FIELDS if shape}
    h = float(model.timestep)
    s.nbody, s.nq, s.nv, s.nu = model.nbody, model.nq, model.nv, model.nu
    s.terminal, s.cost_id, s.cost_flags = int(terminal), cost_id, flags
    s.clamp_ctrl = int(ctrl_low is not None)
    if ctrl_low is not None:
        v["ctrl_lo"][:model.nu] = ctrl_low
        v["ctrl_hi"][:model.nu] = ctrl_high
    v["cost_body"][:] = cost_bodies
    v["cost_w"][:] = cost_w
    s.h, s.inv_h = h, 1.0 / h
    v["gravity"][:] = model.gravity
    nb = model.nbody
    v["body_parent"][:nb] = model.body_parent
    for name in ("body_pos", "body_quat", "body_ipos", "body_iquat",
                 "body_mass", "body_inertia"):
        v[name][:nb] = getattr(model, name)
    for b, js in enumerate(model.body_joints):
        v["body_jnt_adr"][b] = js[0] if js else 0
        v["body_jnt_num"][b] = len(js)
    chain_bits = [sum(1 << d for d in np.nonzero(model.ancestor_mask[b])[0])
                  for b in range(nb)]
    hs_meff = dict(zip(model.hs_dofadr.tolist(), model.hs_limit_meff.tolist()))
    springs = {d: (k, qref) for d, _, k, qref in model.ball_springs}
    limits = {d: lim for d, _, *lim in model.ball_limits}
    balls = []
    for j, jnt in enumerate(model.joints):
        v["jnt_type"][j], v["jnt_qposadr"][j] = jnt.jtype, jnt.qposadr
        v["jnt_dofadr"][j] = jnt.dofadr
        v["jnt_pos"][j], v["jnt_axis"][j] = jnt.pos, jnt.axis
        if jnt.jtype in (SLIDE, HINGE):
            v["jnt_qpos0"][j] = model.qpos0[jnt.qposadr]
            v["jnt_stiffness"][j] = jnt.stiffness
            v["jnt_springref"][j] = jnt.springref
            v["jnt_limited"][j] = int(jnt.limited)
            if jnt.limited:
                v["jnt_range"][j] = jnt.range
                v["jnt_meff"][j] = hs_meff[jnt.dofadr]
                v["jnt_kbase"][j], v["jnt_bref"][j] = sph._solref_kb_scalar(
                    jnt.solref, jnt.solimp)
                v["jnt_solimp"][j] = _solimp(jnt.solimp)
        elif jnt.jtype == BALL:
            # the spring's stiffness and reference; the limit's maximum
            # rotation angle in range[1], and its m_eff, solref and solimp
            k = len(balls)
            balls.append(j)
            if jnt.dofadr in springs:
                v["jnt_stiffness"][j] = springs[jnt.dofadr][0]
                v["ball_qref"][k] = springs[jnt.dofadr][1]
            if jnt.dofadr in limits:
                max_angle, solref, solimp, meff = limits[jnt.dofadr]
                v["jnt_limited"][j] = 1
                v["jnt_range"][j] = (0.0, max_angle)
                v["jnt_meff"][j] = meff
                v["jnt_kbase"][j], v["jnt_bref"][j] = sph._solref_kb_scalar(solref, solimp)
                v["jnt_solimp"][j] = _solimp(solimp)
    s.nball = len(balls)
    v["ball_jnt"][:len(balls)] = balls
    nv = model.nv
    v["dof_body"][:nv] = model.dof_bodyid
    chain = [chain_bits[int(model.dof_bodyid[d])] for d in range(nv)]
    v["dof_anc"][:nv] = [chain[d] & ((1 << d) - 1) for d in range(nv)]
    v["dof_lc"][:nv] = [sum(1 << e for e in range(d + 1, nv) if chain[e] >> d & 1)
                        for d in range(nv)]
    v["dof_damping"][:nv] = model.dof_damping
    v["dof_extra"][:nv] = [float(model.dof_armature[d]) + h * float(model.dof_damping[d])
                           for d in range(nv)]
    v["dof_frictionloss"][:nv] = model.dof_frictionloss
    v["dof_fl_gain"][:nv] = np.asarray(model.dof_frictionloss, dtype=np.float64) / 0.05
    ten_rows = _tendon_rows(model)
    v["act_trn"][:] = -1
    trn = _transmissions(model)
    s.ntrn = len(trn)
    for k, (i, kind) in enumerate(trn):
        act = model.actuators[i]
        v["act_trn"][i], v["trn_kind"][k] = k, kind
        v["trn_gear"][k] = act.gear6
        if kind == _TRN_SITE:
            v["trn_body"][k] = act.site_bodyid
            v["trn_pos"][k], v["trn_quat"][k] = act.site_pos, act.site_quat
        elif kind == _TRN_TENDON:
            v["trn_ten"][k] = ten_rows.index(act.tendon_id)
        else:
            v["trn_gear"][k, act.ndof:] = 0.0
    for i, act in enumerate(model.actuators):
        v["act_dof"][i], v["act_qpos"][i] = act.dofadr, act.qposadr
        v["act_ctrllimited"][i] = int(act.ctrllimited)
        v["act_forcelimited"][i] = int(act.forcelimited)
        v["act_gear"][i], v["act_gain"][i] = act.gear, act.gain
        v["act_bias"][i] = act.bias
        v["act_ctrlrange"][i] = act.ctrlrange
        v["act_forcerange"][i] = act.forcerange
    npair = nmv = 0
    for pair in model.contact_pairs:
        g1, g2 = model.geoms[pair.geom1], model.geoms[pair.geom2]
        if g1.gtype != GEOM_PLANE:
            continue  # the planner tier has floor contacts only
        i = npair
        npair += 1
        qw, qx, qy, qz = [float(x) for x in g1.quat]
        n = np.array([2 * (qx * qz + qw * qy), 2 * (qy * qz - qw * qx),
                      1 - 2 * (qx * qx + qy * qy)])
        v["pair_n"][i] = n
        v["pair_p0n"][i] = float(np.dot(np.asarray(g1.pos), n))
        v["pair_body"][i] = g2.bodyid
        v["pair_type"][i] = kind = _pair_kind(g2)
        if kind == _PAIR_MESH:
            mv = np.asarray(g2.mesh_verts)
            v["pair_vadr"][i], v["pair_npt"][i] = nmv, len(mv)
            v["mesh_vert"][nmv:nmv + len(mv)] = mv
            nmv += len(mv)
        else:
            v["pair_npt"][i] = _PAIR_POINTS[kind]
        v["pair_gpos"][i], v["pair_gquat"][i] = g2.pos, g2.quat
        v["pair_size"][i] = g2.size[:3]
        v["pair_mu"][i] = pair.mu if pair.condim > 1 else 0.0
        v["pair_kbase"][i], v["pair_bref"][i] = sph._solref_kb_scalar(
            pair.solref, pair.solimp)
        v["pair_meff"][i], v["pair_margin"][i] = pair.m_eff, pair.margin
        v["pair_solimp"][i] = _solimp(pair.solimp)
    s.npair = npair
    dof2q = {j.dofadr: j.qposadr for j in model.joints if j.jtype in (SLIDE, HINGE)}
    nten = 0
    for t in ten_rows:
        nz = np.nonzero(model.tendon_coef[t])[0]
        v["ten_limited"][nten] = int(model.tendon_limited[t])
        v["ten_nnz"][nten] = len(nz)
        v["ten_dof"][nten, :len(nz)] = nz
        v["ten_qpos"][nten, :len(nz)] = [dof2q[d] for d in nz]
        v["ten_coef"][nten, :len(nz)] = model.tendon_coef[t, nz]
        v["ten_range"][nten] = model.tendon_range[t]
        v["ten_meff"][nten] = model.tendon_limit_meff[t]
        v["ten_kbase"][nten], v["ten_bref"][nten] = sph._solref_kb_scalar(
            model.tendon_limit_solref[t], model.tendon_limit_solimp[t])
        v["ten_solimp"][nten] = _solimp(model.tendon_limit_solimp[t])
        nten += 1
    s.nten = nten
    _pack_schedule(model, s, v, chain_bits, npair, nten)
    return bytes(s)


def _pack_schedule(model: PhysicsModel, s, v: dict, chain_bits: list, npair: int,
                   nten: int) -> None:
    """The lane-parallel schedule of the kernel: bodies by tree depth, dofs
    by chain depth (the mass-matrix entries grouped by their row's level,
    each level's Cholesky updates), the body/dof sets that fix each sum's
    order, and the workspace layout."""
    nb, nv = model.nbody, model.nv
    s.njnt = len(model.joints)
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[model.body_parent[b]] + 1
    levels = [[b for b in range(1, nb) if depth[b] == lv] for lv in range(1, max(depth) + 1)]
    s.nlvl = len(levels)
    v["lvl_adr"][:len(levels) + 1] = np.cumsum([0] + [len(lv) for lv in levels])
    v["lvl_body"][:nb - 1] = [b for lv in levels for b in lv]
    v["body_chain"][:nb] = chain_bits
    for b in range(1, nb):
        v["body_child"][model.body_parent[b]] |= 1 << b
    # each body's first contact pair, and its further pairs' scratch slots,
    # grouped by body and in pair order within it
    pair_body = [int(b) for b in v["pair_body"][:npair]]
    v["body_pair0"][:] = -1
    for i in reversed(range(npair)):
        v["body_pair0"][pair_body[i]] = i
    further = sorted(_further_pairs(model), key=lambda i: (pair_body[i], i))
    s.nxpair = len(further)
    v["xpair"][:len(further)] = further
    v["body_xadr"][:nb + 1] = np.cumsum(
        [0] + [sum(pair_body[i] == b for i in further) for b in range(nb)])
    # per level, the bodies whose sums the tree accumulation extends
    extends = lambda b: v["body_child"][b] or v["body_xadr"][b + 1] > v["body_xadr"][b]
    acc = [[b for b in lv if extends(b)] for lv in levels]
    v["acc_adr"][:len(acc) + 1] = np.cumsum([0] + [len(lv) for lv in acc])
    v["acc_body"][:sum(map(len, acc))] = [b for lv in acc for b in lv]
    for j, jnt in enumerate(model.joints):
        v["dof_jnt"][jnt.dofadr:jnt.dofadr + jnt.ndof] = j
    # the dofs each actuator drives: its joint's (a ball/free motor's where
    # its gear is nonzero), its tendon's, or its site body's chain
    for i, act in enumerate(model.actuators):
        if act.site_bodyid >= 0:
            dofs = np.nonzero(model.ancestor_mask[act.site_bodyid])[0]
        elif act.tendon_id >= 0:
            dofs = np.nonzero(model.tendon_coef[act.tendon_id])[0]
        else:
            dofs = [act.dofadr + c for c in range(act.ndof)
                    if act.ndof == 1 or act.gear6[c] != 0.0]
        for d in dofs:
            v["dof_acts"][d] |= 1 << i
    # dofs by chain depth; the mass-matrix entries by their row's level;
    # and the entries each level's columns update: rows on the chains above
    anc = [int(x) for x in v["dof_anc"][:nv]]
    ddepth = [bin(a).count("1") for a in anc]
    dlevels = [[d for d in range(nv) if ddepth[d] == lv] for lv in range(max(ddepth) + 1)]
    s.ndlvl = len(dlevels)
    # the top block: leading levels of one dof each, dofs 0, 1, ... (NTOP at most)
    s.ntop = next((i for i, lv in enumerate(dlevels[:NTOP]) if lv != [i]), min(NTOP, len(dlevels)))
    v["dlvl_adr"][:len(dlevels) + 1] = np.cumsum([0] + [len(lv) for lv in dlevels])
    v["dlvl_dof"][:nv] = [d for lv in dlevels for d in lv]
    v["dlvl_mask"][:len(dlevels)] = [sum(1 << d for d in lv) for lv in dlevels]
    rows = {d: [e for e in range(d) if anc[d] >> e & 1] + [d] for d in range(nv)}
    ent = [d | e << 8 for lv in dlevels for d in lv for e in rows[d]]
    v["ent"][:len(ent)] = ent
    s.nent = len(ent)
    v["ent_adr"][:len(dlevels) + 1] = np.cumsum(
        [0] + [sum(len(rows[d]) for d in lv) for lv in dlevels])
    chol, adr = [], [0]
    for lv in dlevels:
        above = 0
        for p in lv:
            above |= anc[p]
        chol += [i | j << 8 for i in range(nv) if above >> i & 1 for j in rows[i]]
        adr.append(len(chol))
    if len(chol) > MAXCHOL:
        raise ValueError(f"model needs {len(chol)} Cholesky updates; the kernel holds {MAXCHOL}")
    v["chol_adr"][:len(adr)] = adr
    v["chol_ent"][:len(chol)] = chol
    s.ten_dofmask = sum(1 << int(d) for t in range(nten) if v["ten_limited"][t]
                        for d in v["ten_dof"][t, :v["ten_nnz"][t]])
    off, s.ws_size = workspace_layout(model, nten)
    v["off"][:] = [off[name] for name in WS_FIELDS]


def rollouts_plain(model: PhysicsModel, running_cost: Callable,
                   terminal_cost: Callable, qpos0, qvel0, time0, U, noise, params,
                   ctrl_low=None, ctrl_high=None, terminal: bool = True):
    """The T-step rollout loop in plain PyTorch (the JAX kernel body,
    ops/rollout_kernel.py:86-126): what the CUDA kernel computes."""
    nq, nv, nu = model.nq, model.nv, model.nu
    h = model.timestep
    qpos = [qpos0[i] for i in range(nq)]
    qvel = [qvel0[i] for i in range(nv)]
    t0 = time0[0]
    np_dtype = np.float32 if t0.dtype == torch.float32 else np.float64
    prm = [params[i] for i in range(NP)]
    fwd = sph.scalar_forward(model, qpos, qvel)
    cost = torch.zeros_like(qpos[0])

    def make_ctx(fwd2, qpos2, qvel2, u, time):
        ctx = sph.ctx_from(model, fwd2, qpos2, qvel2, u, time)
        ctx.params = prm
        return ctx

    for t in range(U.shape[0]):
        u = []
        for i in range(nu):
            ui = U[t, i] + noise[t, i]
            if ctrl_low is not None:
                ui = torch.clamp(ui, float(ctrl_low[i]), float(ctrl_high[i]))
            u.append(ui)
        # the step's start time in the rollout's dtype: t0 + dtype(t) * h
        time = t0 + float(np_dtype(t) * np_dtype(h))
        qpos, qvel, _ = sph.scalar_step(model, qpos, qvel, u, time, fwd=fwd)
        fwd = sph.scalar_forward(model, qpos, qvel)
        cost = cost + running_cost(make_ctx(fwd, qpos, qvel, u, time + h), t)
    if terminal:
        T = U.shape[0]
        cost = cost + terminal_cost(make_ctx(fwd, qpos, qvel, [0.0] * nu, t0 + T * h))
    return cost, torch.stack(qpos), torch.stack(qvel)


def build_rollout_kernel(
    model: PhysicsModel,
    cost_factory: Callable,
    horizon: int,
    ctrl_low: Optional[np.ndarray] = None,
    ctrl_high: Optional[np.ndarray] = None,
    terminal: bool = True,
    cost_kwargs: Optional[dict] = None,
    device="cuda",
):
    """Returns rollouts(qpos0, qvel0, time0, U, noise, params=None) ->
    (costs (K,), qpos_T (nq,K), qvel_T (nv,K)); `rollouts.plain` is the
    plain version on whatever device its inputs are."""
    dev = resolve_device(device)
    check_kernel_supported(model)
    nq, nv, nu = model.nq, model.nv, model.nu
    T = int(horizon)
    kw = dict(cost_kwargs or {})
    if "horizon" in inspect.signature(cost_factory).parameters:
        kw.setdefault("horizon", T)
    running_cost, terminal_cost = cost_factory(model, **kw)
    clo = None if ctrl_low is None else [float(x) for x in ctrl_low]
    chi = None if ctrl_high is None else [float(x) for x in ctrl_high]
    tables, geometry = {}, {}
    if dev.type == "cuda":
        lib = _rollout_lib()
        for dt in (torch.float32, torch.float64):
            raw = pack_tables(model, cost_factory, kw, clo, chi, terminal, dt)
            if lib.hmr_tables_size(int(dt == torch.float64)) != len(raw):
                raise RuntimeError("Tables layout differs between Python and CUDA")
            tables[dt] = torch.frombuffer(bytearray(raw), dtype=torch.uint8).to(dev)
            geometry[dt] = launch_geometry(lib, model, dt,
                                           tables_struct(dt).from_buffer_copy(raw).ws_size)

    def _params(params, ref):
        if params is None:
            return torch.zeros(NP, dtype=ref.dtype, device=ref.device)
        p = torch.as_tensor(params, dtype=ref.dtype, device=ref.device).reshape(-1)
        return torch.nn.functional.pad(p, (0, NP - p.shape[0]))

    def _check(qpos0, qvel0, time0, U, noise):
        K = qpos0.shape[-1]
        want = {"qpos0": (nq, K), "qvel0": (nv, K), "time0": (1, K),
                "U": (T, nu), "noise": (T, nu, K)}
        got = {"qpos0": qpos0, "qvel0": qvel0, "time0": time0, "U": U, "noise": noise}
        for name, shape in want.items():
            x = got[name]
            if tuple(x.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
            if x.dtype != qpos0.dtype or x.device != qpos0.device:
                raise ValueError(f"{name}: {x.dtype} on {x.device}, expected "
                                 f"{qpos0.dtype} on {qpos0.device}")

    def plain(qpos0, qvel0, time0, U, noise, params=None):
        _check(qpos0, qvel0, time0, U, noise)
        return rollouts_plain(model, running_cost, terminal_cost, qpos0, qvel0,
                              time0, U, noise, _params(params, qpos0), clo, chi,
                              terminal)

    def launch(qpos0, qvel0, time0, U, noise, params=None):
        global launches
        _check(qpos0, qvel0, time0, U, noise)
        params = _params(params, qpos0)
        if qpos0.dtype not in tables or qpos0.device != dev:
            raise ValueError(
                f"rollout kernel built for {dev} (f32/f64); got {qpos0.dtype} "
                f"on {qpos0.device}")
        lib = _rollout_lib()
        tab = tables[qpos0.dtype]
        K = qpos0.shape[-1]
        ins = [x.contiguous() for x in (qpos0, qvel0, time0, U, noise, params)]
        cost = torch.empty(K, dtype=qpos0.dtype, device=dev)
        qpos_f = torch.empty(nq, K, dtype=qpos0.dtype, device=dev)
        qvel_f = torch.empty(nv, K, dtype=qpos0.dtype, device=dev)
        fn = lib.hmr_rollout_f64 if qpos0.dtype == torch.float64 else lib.hmr_rollout_f32
        geo = geometry[qpos0.dtype]
        rc = fn(tab.data_ptr(), *[x.data_ptr() for x in ins], cost.data_ptr(),
                qpos_f.data_ptr(), qvel_f.data_ptr(), K, T,
                torch.cuda.current_stream(dev).cuda_stream, geo["samples_per_block"],
                geo["smem_bytes"])
        if rc != 0:
            raise RuntimeError(f"rollout kernel launch failed: cudaError {rc}")
        launches += 1
        return cost, qpos_f, qvel_f

    def rollouts(qpos0, qvel0, time0, U, noise, params=None):
        if qpos0.device.type == "cuda":
            return launch(qpos0, qvel0, time0, U, noise, params)
        if qpos0.device.type == "cpu":
            return plain(qpos0, qvel0, time0, U, noise, params)
        raise ValueError(f"no rollout path for device {qpos0.device}")

    rollouts.plain = plain
    rollouts.geometry = geometry
    rollouts.tables = tables
    return rollouts


def shared_bytes(model: PhysicsModel, dtype: torch.dtype, ws_size: int,
                 samples_per_block: int) -> int:
    """Dynamic shared memory of one block (csrc/rollout_kernel.cu): the
    tables, the runtime parameters, two steps of noise (nu, S) and S
    workspaces of ws_size scalars."""
    es = torch.empty((), dtype=dtype).element_size()
    S = samples_per_block
    return ctypes.sizeof(tables_struct(dtype)) + es * (NP + 2 * model.nu * S + S * ws_size)


def launch_geometry(lib, model: PhysicsModel, dtype: torch.dtype, ws_size: int) -> dict:
    """Samples per block S (a warp each) that keeps the most samples
    resident per SM by the card's occupancy query (the smallest S among
    equals), with its dynamic shared memory."""
    is_double = int(dtype == torch.float64)
    best = None
    for S in range(1, lib.hmr_rollout_max_samples_per_block(is_double) + 1):
        smem = shared_bytes(model, dtype, ws_size, S)
        blocks = lib.hmr_rollout_occupancy(is_double, S, smem)
        if blocks < 0:
            raise RuntimeError(f"rollout kernel occupancy query failed: cudaError {-blocks}")
        if blocks and (best is None or blocks * S > best["resident_samples_per_sm"]):
            best = {"lanes_per_sample": lib.hmr_rollout_lanes(), "samples_per_block": S,
                    "smem_bytes": smem, "blocks_per_sm": blocks,
                    "resident_samples_per_sm": blocks * S, "ws_scalars": ws_size}
    if best is None:
        raise RuntimeError("rollout kernel: one sample's shared memory does not fit a block")
    return best


@functools.lru_cache(maxsize=None)
def _rollout_lib() -> ctypes.CDLL:
    lib = _build.load_library("rollout_kernel.cu")
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    for name in ("hmr_rollout_f32", "hmr_rollout_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 10 + [cint, cint, ptr, cint, cint]
        fn.restype = cint
    for name, args in (("hmr_tables_size", [cint]), ("hmr_rollout_lanes", []),
                       ("hmr_rollout_max_samples_per_block", [cint]),
                       ("hmr_rollout_occupancy", [cint] * 3)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = cint
    return lib
