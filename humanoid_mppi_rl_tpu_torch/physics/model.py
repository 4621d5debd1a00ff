"""Physics model constants for the port (physics/model.py counterpart).

The JAX package compiles MJCF with the host mujoco package. The port needs
neither: the compiled constants are carried across once, as plain arrays,
by `export_model_arrays`, and committed as a snapshot (assets/*.json) that
`load_model` reads. A test regenerates the snapshot from the MJCF so it
cannot go stale.

Two snapshots are kept per robot, both `export_model_arrays(m,
plant=True)`: the fields that the scalar step (ops/scalar_physics) and the
kernel costs read, keyframes included (go1 starts from `home`), and what
the array engine, its contacts and its Newton solver read. assets/
<robot>.json is the planner's model (humanoid, go1, cartpole, hopper; floor
pairs only), which the rollout kernel and the array engine's penalty tier
step; assets/<robot>_plant.json the environment plant, built with the
body-body pairs (envs/tasks.load_plant). Joints are free, ball, slide or
hinge (Joint.jtype); the array engine derives its per-dof type masks (JAX
dof_type_*) from them. Ball joints carry their quaternion springs and
rotation-angle limits (`ball_springs`, `ball_limits`, the JAX tuples);
actuators their multi-dof, fixed-tendon and site transmissions; mesh geoms
their vertices and convex-hull planes (ragged lists in the snapshot).
Spatial tendons, which the port does not cover, are refused by the export
rather than dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np

# Joint types (mujoco.mjtJoint values)
FREE = 0
BALL = 1
SLIDE = 2
HINGE = 3

# Geom types (mujoco.mjtGeom values)
GEOM_PLANE = 0
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")


@dataclasses.dataclass(frozen=True)
class Joint:
    jtype: int
    bodyid: int
    qposadr: int
    dofadr: int
    ndof: int
    pos: np.ndarray       # (3,) anchor in body frame
    axis: np.ndarray      # (3,) axis in body frame
    limited: bool
    range: np.ndarray     # (2,)
    stiffness: float
    springref: float
    solref: np.ndarray    # (2,) limit (timeconst, dampratio)
    solimp: np.ndarray    # (5,) limit impedance


@dataclasses.dataclass(frozen=True)
class Actuator:
    """Actuator: force = gain * ctrl + bias0 + bias1 * length + bias2 *
    velocity, applied through its transmission. A single-dof joint's
    length and velocity are gear*q and gear*qvel; a ball or free joint's
    motor (ndof 3 or 6) drives its dofs by gear6[:ndof] (velocity the gear
    projection of qvel); a fixed tendon's (tendon_id >= 0, ndof 0) are the
    gear-scaled tendon coordinates; a site's (site_bodyid >= 0, ndof 0, no
    refsite) is the wrench gear6 in the site frame (length 0)."""
    dofadr: int
    qposadr: int
    gear: float
    gain: float
    bias: np.ndarray          # (3,)
    ctrllimited: bool
    ctrlrange: np.ndarray     # (2,)
    forcelimited: bool
    forcerange: np.ndarray    # (2,)
    ndof: int = 1
    gear6: np.ndarray = None  # (6,)
    tendon_id: int = -1
    site_bodyid: int = -1
    site_pos: np.ndarray = None   # (3,) body-local
    site_quat: np.ndarray = None  # (4,) body-local


@dataclasses.dataclass(frozen=True)
class Geom:
    gtype: int
    gtype_orig: int       # MJCF type before cylinder->capsule approximation
    bodyid: int
    pos: np.ndarray       # (3,) in body frame
    quat: np.ndarray      # (4,) in body frame
    size: np.ndarray      # (3,)
    # mesh geoms: deduplicated vertices (V, 3) and convex-hull face planes
    # (F, 4) [n; d] with n.x + d <= 0 inside, both in the geom frame
    mesh_verts: np.ndarray = None
    mesh_hull: np.ndarray = None


@dataclasses.dataclass(frozen=True)
class ContactPair:
    geom1: int            # the plane, when one is present
    geom2: int
    mu: float
    solref: np.ndarray    # (2,)
    solimp: np.ndarray    # (5,)
    condim: int
    margin: float
    m_eff: float          # normal effective inertia at qpos0
    # engine fields (plant=True): the summed translational invweight0 of the two
    # bodies (the Newton rows' regularizer base) and mjContact.friction
    invw0: float = 1.0
    friction5: np.ndarray = None  # (5,) slide, slide, torsion, roll, roll


@dataclasses.dataclass(frozen=True)
class PhysicsModel:
    nq: int
    nv: int
    nu: int
    nbody: int
    timestep: float
    gravity: np.ndarray                       # (3,)
    body_parent: Tuple[int, ...]
    body_pos: np.ndarray                      # (nbody, 3)
    body_quat: np.ndarray                     # (nbody, 4)
    body_ipos: np.ndarray                     # (nbody, 3)
    body_iquat: np.ndarray                    # (nbody, 4)
    body_mass: np.ndarray                     # (nbody,)
    body_inertia: np.ndarray                  # (nbody, 3)
    body_names: Tuple[str, ...]
    joints: Tuple[Joint, ...]
    body_joints: Tuple[Tuple[int, ...], ...]
    ancestor_mask: np.ndarray                 # (nbody, nv) 1.0 if dof on chain
    dof_bodyid: np.ndarray                    # (nv,)
    dof_damping: np.ndarray                   # (nv,)
    dof_armature: np.ndarray                  # (nv,)
    dof_frictionloss: np.ndarray              # (nv,)
    actuators: Tuple[Actuator, ...]
    geoms: Tuple[Geom, ...]
    contact_pairs: Tuple[ContactPair, ...]
    tendon_coef: np.ndarray                   # (ntendon, nv) fixed tendons
    tendon_range: np.ndarray                  # (ntendon, 2)
    tendon_limited: np.ndarray                # (ntendon,) bool
    tendon_limit_solref: np.ndarray           # (ntendon, 2)
    tendon_limit_solimp: np.ndarray           # (ntendon, 5)
    tendon_limit_meff: np.ndarray             # (ntendon,)
    qpos0: np.ndarray                         # (nq,)
    hs_dofadr: np.ndarray                     # (nhs,) single-dof joint dofs
    hs_limit_meff: np.ndarray                 # (nhs,) limit effective inertia
    # engine fields (plant=True; None in an export without them): what the
    # array engine, contacts and Newton solver read beyond the scalar step
    pred_mask: np.ndarray = None              # (nv, nv) Sdot predecessor mask
    sdot_zero: np.ndarray = None              # (nv,) 1.0 where Sdot == 0
    hs_qposadr: np.ndarray = None             # (nhs,) single-dof joint qpos
    free_qposadr: np.ndarray = None           # (nfree,)
    free_dofadr: np.ndarray = None            # (nfree,)
    free_bodyid: np.ndarray = None            # (nfree,)
    hs_limit_invw0: np.ndarray = None         # (nhs,) mj dof_invweight0
    tendon_invweight0: np.ndarray = None      # (ntendon,)
    dof_invweight0: np.ndarray = None         # (nv,)
    dof_solref: np.ndarray = None             # (nv, 2) friction-row solref
    dof_solimp: np.ndarray = None             # (nv, 5)
    cone: int = 0                             # 0 pyramidal, 1 elliptic
    impratio: float = 1.0
    keyframes: Tuple[Tuple[str, np.ndarray], ...] = ()  # (name, qpos (nq,))
    # ball joints: (dofadr, qposadr, stiffness, spring reference quaternion)
    # and (dofadr, qposadr, max rotation angle, solref, solimp, m_eff)
    ball_springs: Tuple = ()
    ball_limits: Tuple = ()
    joint_names: Tuple[str, ...] = ()         # one per joint (LQR picks dofs by name)

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)

    def ctrl_range(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-actuator control bounds (-inf/inf where not ctrllimited)."""
        lo = np.array([a.ctrlrange[0] if a.ctrllimited else -np.inf for a in self.actuators])
        hi = np.array([a.ctrlrange[1] if a.ctrllimited else np.inf for a in self.actuators])
        return lo, hi


# ---------------------------------------------------------------------------
# carrying the compiled constants across
# ---------------------------------------------------------------------------

_JOINT_FIELDS = ("jtype", "bodyid", "qposadr", "dofadr", "ndof", "pos", "axis",
                 "limited", "range", "stiffness", "springref", "solref",
                 "solimp")
_ACT_FIELDS = ("dofadr", "qposadr", "gear", "gain", "bias", "ctrllimited",
               "ctrlrange", "forcelimited", "forcerange", "ndof", "gear6", "tendon_id",
               "site_bodyid", "site_pos", "site_quat")
_GEOM_FIELDS = ("gtype", "gtype_orig", "bodyid", "pos", "quat", "size")
_PAIR_FIELDS = ("geom1", "geom2", "mu", "solref", "solimp", "condim",
                "margin", "m_eff")
_MODEL_ARRAYS = ("gravity", "body_parent", "body_pos", "body_quat",
                 "body_ipos", "body_iquat", "body_mass", "body_inertia",
                 "ancestor_mask", "dof_bodyid", "dof_damping", "dof_armature",
                 "dof_frictionloss", "tendon_coef", "tendon_range",
                 "tendon_limited", "tendon_limit_solref",
                 "tendon_limit_solimp", "tendon_limit_meff", "qpos0",
                 "hs_dofadr", "hs_limit_meff")
_MODEL_SCALARS = ("nq", "nv", "nu", "nbody", "timestep")
_PLANT_ARRAYS = ("pred_mask", "sdot_zero", "hs_qposadr", "free_qposadr",
                 "free_dofadr", "free_bodyid", "hs_limit_invw0",
                 "tendon_invweight0", "dof_invweight0", "dof_solref",
                 "dof_solimp")
_PLANT_PAIR_FIELDS = ("invw0", "friction5")
_PLANT_SCALARS = ("cone", "impratio")
_INT_ARRAYS = ("hs_qposadr", "free_qposadr", "free_dofadr", "free_bodyid")
# ragged per-geom arrays (a list per geom, empty where it has none)
_GEOM_RAGGED = ("mesh_verts", "mesh_hull")
# the ball-joint tuples, field by field: (name, width or 0 for a scalar, int)
_BALL_SPRING = (("dofadr", 0, True), ("qposadr", 0, True), ("k", 0, False),
                ("qref", 4, False))
_BALL_LIMIT = (("dofadr", 0, True), ("qposadr", 0, True), ("max_angle", 0, False),
               ("solref", 2, False), ("solimp", 5, False), ("meff", 0, False))
# the site frame of an actuator without a site, as exported
_ACT_ABSENT = {"site_pos": np.zeros(3), "site_quat": np.zeros(4)}


def _refuse_unsupported(m) -> None:
    """Features a PhysicsModel of the JAX package may hold that this port
    cannot represent: spatial (site-chain) tendons, array-engine-only in
    the reference too."""
    if getattr(m, "spatial_tendons", ()):
        raise NotImplementedError("the port cannot carry: spatial tendons")


def _act_field(a, f):
    v = getattr(a, f)
    return _ACT_ABSENT[f] if v is None else np.asarray(v)


def _tuples_to_arrays(rows, fields, prefix) -> Dict[str, np.ndarray]:
    out = {}
    for i, (name, width, is_int) in enumerate(fields):
        vals = [np.asarray(r[i], dtype=np.float64) for r in rows]
        a = np.asarray(vals).reshape((len(rows),) + ((width,) if width else ()))
        out[f"{prefix}{name}"] = a.astype(np.int64) if is_int else a
    return out


def _arrays_to_tuples(a, fields, prefix) -> Tuple:
    cols = []
    for name, width, is_int in fields:
        v = np.asarray(a[prefix + name], dtype=np.float64)
        v = v.reshape((-1,) + ((width,) if width else ()))
        cols.append([int(x) if is_int else (tuple(float(y) for y in x) if width else float(x))
                     for x in v])
    return tuple(zip(*cols)) if cols and cols[0] else ()


def export_model_arrays(m, plant: bool = False) -> Dict[str, object]:
    """Flatten a PhysicsModel (duck-typed: attributes are read, nothing is
    imported) into a dict of numpy arrays, ints, floats and name lists.
    plant=True adds the fields of the array engine (_PLANT_*)."""
    _refuse_unsupported(m)
    d: Dict[str, object] = {k: (int(getattr(m, k)) if k != "timestep"
                                else float(m.timestep)) for k in _MODEL_SCALARS}
    arrays = _MODEL_ARRAYS + (_PLANT_ARRAYS if plant else ())
    for k in arrays:
        d[k] = np.asarray(getattr(m, k))
    if plant:
        d["cone"], d["impratio"] = int(m.cone), float(m.impratio)
    d["body_names"] = [str(n) for n in m.body_names]
    d["joint_names"] = [str(n) for n in m.joint_names]
    d["key_names"] = [str(name) for name, _ in m.keyframes]
    d["key_qpos"] = np.asarray([np.asarray(q) for _, q in m.keyframes]).reshape(-1, m.nq)
    pair_fields = _PAIR_FIELDS + (_PLANT_PAIR_FIELDS if plant else ())
    for prefix, objs, fields in (("jnt_", m.joints, _JOINT_FIELDS),
                                 ("geom_", m.geoms, _GEOM_FIELDS),
                                 ("pair_", m.contact_pairs, pair_fields)):
        for f in fields:
            d[prefix + f] = np.asarray([np.asarray(getattr(o, f)) for o in objs])
    for f in _ACT_FIELDS:
        d["act_" + f] = np.asarray([_act_field(a, f) for a in m.actuators])
    for f in _GEOM_RAGGED:
        d["geom_" + f] = [[] if getattr(g, f, None) is None else np.asarray(getattr(g, f))
                          for g in m.geoms]
    d.update(_tuples_to_arrays(getattr(m, "ball_springs", ()), _BALL_SPRING, "ball_spring_"))
    d.update(_tuples_to_arrays(getattr(m, "ball_limits", ()), _BALL_LIMIT, "ball_limit_"))
    return d


def model_from_arrays(d: Dict[str, object]) -> PhysicsModel:
    """Inverse of export_model_arrays (also accepts the JSON snapshot's
    nested lists)."""
    scalars = _MODEL_SCALARS + _PLANT_SCALARS
    ragged = tuple("geom_" + f for f in _GEOM_RAGGED)
    a = {k: np.asarray(v) for k, v in d.items()
         if k not in scalars and k not in ("body_names", "joint_names", "key_names") + ragged}
    plant = "pred_mask" in d

    def objs(cls, prefix, fields, n):
        out = []
        for i in range(n):
            kw = {}
            for f in fields:
                v = a[prefix + f][i]
                kw[f] = v.copy() if v.ndim else v.item()  # Python scalar
            out.append(cls(**kw))
        return tuple(out)

    nbody = int(d["nbody"])
    joints = objs(Joint, "jnt_", _JOINT_FIELDS, len(a["jnt_jtype"]))
    nu = len(a["act_dofadr"])
    for f, w in (("gear6", 6), ("site_pos", 3), ("site_quat", 4)):
        a["act_" + f] = a["act_" + f].reshape(nu, w)
    acts = tuple(dataclasses.replace(
        act, site_pos=None if act.site_bodyid < 0 else act.site_pos,
        site_quat=None if act.site_bodyid < 0 else act.site_quat)
        for act in objs(Actuator, "act_", _ACT_FIELDS, nu))
    geoms = tuple(dataclasses.replace(g, **{
        f: (np.asarray(d["geom_" + f][i], dtype=np.float64) if len(d["geom_" + f][i]) else None)
        for f in _GEOM_RAGGED})
        for i, g in enumerate(objs(Geom, "geom_", _GEOM_FIELDS, len(a["geom_gtype"]))))
    pairs = objs(ContactPair, "pair_", _PAIR_FIELDS + (_PLANT_PAIR_FIELDS if plant else ()),
                 len(a["pair_geom1"]))
    body_joints = [[] for _ in range(nbody)]
    for i, j in enumerate(joints):
        body_joints[j.bodyid].append(i)
    nv = int(d["nv"])
    ntendon = a["tendon_coef"].reshape(-1, nv).shape[0]
    extra = {}
    if plant:
        for k in _PLANT_ARRAYS:
            extra[k] = a[k].astype(np.int64 if k in _INT_ARRAYS else np.float64)
        extra["pred_mask"] = extra["pred_mask"].reshape(nv, nv)
        extra["tendon_invweight0"] = extra["tendon_invweight0"].reshape(ntendon)
        extra["dof_solref"] = extra["dof_solref"].reshape(nv, 2)
        extra["dof_solimp"] = extra["dof_solimp"].reshape(nv, 5)
        extra["cone"], extra["impratio"] = int(d["cone"]), float(d["impratio"])
    return PhysicsModel(
        nq=int(d["nq"]), nv=nv, nu=int(d["nu"]), nbody=nbody,
        timestep=float(d["timestep"]),
        gravity=a["gravity"].astype(np.float64),
        body_parent=tuple(int(p) for p in a["body_parent"]),
        body_pos=a["body_pos"].astype(np.float64),
        body_quat=a["body_quat"].astype(np.float64),
        body_ipos=a["body_ipos"].astype(np.float64),
        body_iquat=a["body_iquat"].astype(np.float64),
        body_mass=a["body_mass"].astype(np.float64),
        body_inertia=a["body_inertia"].astype(np.float64),
        body_names=tuple(str(n) for n in d["body_names"]),
        joint_names=tuple(str(n) for n in d["joint_names"]),
        joints=joints,
        body_joints=tuple(tuple(b) for b in body_joints),
        ancestor_mask=a["ancestor_mask"].astype(np.float64),
        dof_bodyid=a["dof_bodyid"].astype(np.int64),
        dof_damping=a["dof_damping"].astype(np.float64),
        dof_armature=a["dof_armature"].astype(np.float64),
        dof_frictionloss=a["dof_frictionloss"].astype(np.float64),
        actuators=acts, geoms=geoms, contact_pairs=pairs,
        tendon_coef=a["tendon_coef"].reshape(ntendon, nv).astype(np.float64),
        tendon_range=a["tendon_range"].reshape(ntendon, 2).astype(np.float64),
        tendon_limited=a["tendon_limited"].reshape(ntendon).astype(bool),
        tendon_limit_solref=a["tendon_limit_solref"].reshape(ntendon, 2)
        .astype(np.float64),
        tendon_limit_solimp=a["tendon_limit_solimp"].reshape(ntendon, 5)
        .astype(np.float64),
        tendon_limit_meff=a["tendon_limit_meff"].reshape(ntendon)
        .astype(np.float64),
        qpos0=a["qpos0"].astype(np.float64),
        hs_dofadr=a["hs_dofadr"].astype(np.int64),
        hs_limit_meff=a["hs_limit_meff"].astype(np.float64),
        keyframes=tuple((str(name), q.astype(np.float64)) for name, q in zip(
            d["key_names"], a["key_qpos"].reshape(-1, int(d["nq"])))),
        ball_springs=_arrays_to_tuples(a, _BALL_SPRING, "ball_spring_"),
        ball_limits=_arrays_to_tuples(a, _BALL_LIMIT, "ball_limit_"),
        **extra,
    )


def snapshot_json(d: Dict[str, object]) -> str:
    """Canonical snapshot text: one key per line, floats as their shortest
    round-trip repr, so the text is exact and diffs stay readable."""
    def plain(v):
        if isinstance(v, np.ndarray):
            v = v.tolist()
        if isinstance(v, (list, tuple)):
            return [plain(x) for x in v]
        if isinstance(v, (bool, np.bool_)):
            return int(v)
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        return v
    lines = [f"{json.dumps(k)}: {json.dumps(plain(d[k]))}" for k in sorted(d)]
    return "{\n" + ",\n".join(lines) + "\n}\n"


def snapshot_path(name: str) -> str:
    return os.path.join(ASSET_DIR, f"{name}.json")


def load_model(name: str) -> PhysicsModel:
    """The committed snapshot of a compiled model (assets/<name>.json)."""
    with open(snapshot_path(name)) as f:
        return model_from_arrays(json.load(f))
