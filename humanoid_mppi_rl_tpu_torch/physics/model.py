"""Physics model constants for the port (physics/model.py counterpart).

The JAX package compiles MJCF with the host mujoco package. The port needs
neither: the compiled constants are carried across once, as plain arrays,
by `export_model_arrays`, and committed as a snapshot (assets/*.json) that
`load_model` reads. A test regenerates the snapshot from the MJCF so it
cannot go stale.

Only the fields that the scalar step (ops/scalar_physics) and the kernel
costs read are carried. Features the port does not cover yet (ball joints'
springs/limits, spatial tendons, mesh geoms, multi-dof / tendon / site
actuator transmissions) are refused by the export rather than dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Tuple

import numpy as np

# Joint types (mujoco.mjtJoint values)
FREE = 0
SLIDE = 2
HINGE = 3

# Geom types (mujoco.mjtGeom values)
GEOM_PLANE = 0
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_CYLINDER = 5

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
    """Single-dof joint-transmission actuator:
    force = gain * ctrl + bias0 + bias1 * (gear*q) + bias2 * (gear*qvel)."""
    dofadr: int
    qposadr: int
    gear: float
    gain: float
    bias: np.ndarray          # (3,)
    ctrllimited: bool
    ctrlrange: np.ndarray     # (2,)
    forcelimited: bool
    forcerange: np.ndarray    # (2,)


@dataclasses.dataclass(frozen=True)
class Geom:
    gtype: int
    gtype_orig: int       # MJCF type before cylinder->capsule approximation
    bodyid: int
    pos: np.ndarray       # (3,) in body frame
    quat: np.ndarray      # (4,) in body frame
    size: np.ndarray      # (3,)


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

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)


# ---------------------------------------------------------------------------
# carrying the compiled constants across
# ---------------------------------------------------------------------------

_JOINT_FIELDS = ("jtype", "bodyid", "qposadr", "dofadr", "ndof", "pos", "axis",
                 "limited", "range", "stiffness", "springref", "solref",
                 "solimp")
_ACT_FIELDS = ("dofadr", "qposadr", "gear", "gain", "bias", "ctrllimited",
               "ctrlrange", "forcelimited", "forcerange")
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


def _refuse_unsupported(m) -> None:
    """Features a PhysicsModel of the JAX package may hold that this port
    cannot represent yet (queued in ROADMAP.md)."""
    bad = []
    if getattr(m, "spatial_tendons", ()):
        bad.append("spatial tendons")
    if getattr(m, "ball_springs", ()) or getattr(m, "ball_limits", ()):
        bad.append("ball-joint springs/limits")
    for a in m.actuators:
        if (getattr(a, "ndof", 1) != 1 or getattr(a, "tendon_id", -1) >= 0
                or getattr(a, "site_bodyid", -1) >= 0):
            bad.append("multi-dof / tendon / site actuator transmissions")
            break
    if any(getattr(g, "mesh_verts", None) is not None for g in m.geoms):
        bad.append("mesh geoms")
    if bad:
        raise NotImplementedError(
            "the port cannot carry: " + ", ".join(bad))


def export_model_arrays(m) -> Dict[str, object]:
    """Flatten a PhysicsModel (duck-typed: attributes are read, nothing is
    imported) into a dict of numpy arrays, ints, floats and name lists."""
    _refuse_unsupported(m)
    d: Dict[str, object] = {k: (int(getattr(m, k)) if k != "timestep"
                                else float(m.timestep)) for k in _MODEL_SCALARS}
    for k in _MODEL_ARRAYS:
        d[k] = np.asarray(getattr(m, k))
    d["body_names"] = [str(n) for n in m.body_names]
    for prefix, objs, fields in (("jnt_", m.joints, _JOINT_FIELDS),
                                 ("act_", m.actuators, _ACT_FIELDS),
                                 ("geom_", m.geoms, _GEOM_FIELDS),
                                 ("pair_", m.contact_pairs, _PAIR_FIELDS)):
        for f in fields:
            d[prefix + f] = np.asarray([np.asarray(getattr(o, f)) for o in objs])
    return d


def model_from_arrays(d: Dict[str, object]) -> PhysicsModel:
    """Inverse of export_model_arrays (also accepts the JSON snapshot's
    nested lists)."""
    a = {k: np.asarray(v) for k, v in d.items()
         if k not in _MODEL_SCALARS and k != "body_names"}

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
    acts = objs(Actuator, "act_", _ACT_FIELDS, len(a["act_dofadr"]))
    geoms = objs(Geom, "geom_", _GEOM_FIELDS, len(a["geom_gtype"]))
    pairs = objs(ContactPair, "pair_", _PAIR_FIELDS, len(a["pair_geom1"]))
    body_joints = [[] for _ in range(nbody)]
    for i, j in enumerate(joints):
        body_joints[j.bodyid].append(i)
    nv = int(d["nv"])
    ntendon = a["tendon_coef"].reshape(-1, nv).shape[0]
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
