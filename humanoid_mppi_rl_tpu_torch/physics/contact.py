"""Contact rows of the coupled plant (physics/contact.py counterpart): a
static plane against spheres, capsules, boxes, exact cylinders and meshes;
a mesh against a sphere, capsule, box or another mesh; and the body-body
("self") pairs of spheres, capsules and cylinders (as inscribed capsules;
box self pairs are skipped, as in the JAX engine).

Each plane pair always contributes its points (a sphere one, a capsule its
two end spheres, a box its 8 corners, a cylinder three rim points per cap,
a mesh its 4 deepest vertices), gated to inactive when separated. A
mesh's vertices are ranked by plane distance every step, the deepest
first and the lower vertex index first among equals (as jax.lax.top_k
ranks them), so the row count is static. Self pairs go through a
segment-segment narrowphase over every candidate; the SELF_TOPK deepest
are kept, ranked the same way.

A pair of a mesh and a primitive or another mesh (the JAX engine's
geom-vs-mesh narrowphase, both directions) keeps, in the pair's place
among the plane pairs, MESH_ROWS rows of the mesh's vertices ranked by the
other geom's signed distance (a primitive's, or a mesh's convex-hull
planes'), then MESH_ROWS of the other geom's support points (a sphere's
centre, a capsule's ends, a box's corners, a mesh's vertices) ranked by
the mesh's hull distance. Of the top 2 MESH_ROWS candidates, one within
1 um of a deeper one is moved behind the distinct ones and, if still
kept, made inert with phi = 1e9 (its point ~5e8 m away, as in JAX). Each
row's jacobian is the difference of its two bodies', so a pair of two
dynamic bodies pushes both.

MuJoCo's soft-constraint reference acceleration per row is
aref = -b vn + d(r) k pen, with b = 2/(dmax tau), k = d(r)/(dmax^2 tau^2
zeta^2), (tau, zeta) the pair's solref and d(r) the solimp impedance of the
penetration; physics/newton.py builds its rows from these.

`contact_terms` is the planner ("penalty") tier's decoupled per-row law,
fn = max(d(r) m_eff (d(r) k pen - b vn), 0) capped at the restitution
cap, with the implicit damping matrix G = J^T C J. Its inverse reading
(r_form) is what engine.inverse_dynamics reads. Every row kind takes a
state with a leading K axis (the planners' batch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import spatial as sp
from .model import (GEOM_BOX, GEOM_CAPSULE, GEOM_CYLINDER, GEOM_MESH, GEOM_PLANE,
                    GEOM_SPHERE, PhysicsModel)

# Restitution cap [m/s] of the planner tier: a constraint row may brake an
# approaching contact without bound but may only push it outward until its
# separation velocity reaches this value (soft constraints otherwise store
# deep penetration as spring energy and release it as a catapult)
RESTITUTION_VCAP = 0.5

# The environment (coupled/Newton) tier's cap: legitimate deep-stance frames
# need h*aref up to ~0.6 m/s, while 2.0 m/s still bounds a foot-slam bounce
RESTITUTION_VCAP_ENV = 2.0

# rows kept of the self-contact candidates, ranked by penetration
SELF_TOPK = 8

# tangential velocity regularisation (m/s) of the penalty tier's Coulomb slope
_VT_EPS = 5e-3

# plane-row kinds, and the (cos, sin) of an exact cylinder's three rim
# points per cap (the downhill extreme and two at +-120 deg)
_SPHERE, _CAPSULE, _BOX, _CYLINDER, _MESH = 0, 1, 2, 3, 4
# rows a plane-vs-mesh pair keeps: its deepest vertices
MESH_ROWS = 4
_RIM = ((1.0, 0.0), (-0.5, 0.8660254037844386), (-0.5, -0.8660254037844386))


class Impedance:
    """MuJoCo's solimp impedance spline d(r) (contact.impedance): a sigmoid
    from d0 to dmax over `width` of violation, for rows of static solimp
    (P, 5). Its constants are placed on the device once, so that a step
    copies nothing from the host; a uniform integer power (the default 2)
    is applied by multiplies, as the JAX function does."""

    def __init__(self, solimp, device, dtype):
        si = np.asarray(solimp, dtype=np.float64).reshape(-1, 5)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.width, self.mid = t(si[:, 2]), t(si[:, 3])
        self.d0, self.span = t(si[:, 0]), t(si[:, 1] - si[:, 0])
        power = si[:, 4]
        p0 = float(power[0]) if power.size else 2.0
        self.int_power = (int(p0) if power.size and (power == p0).all()
                          and p0 == int(p0) and 1 <= p0 <= 4 else None)
        self.power = t(power)

    def _pow(self, v):
        if self.int_power is None:
            return v ** self.power
        r = v
        for _ in range(self.int_power - 1):
            r = r * v
        return r

    def __call__(self, pen: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(pen / self.width, 0.0, 1.0)
        lo = self.mid * self._pow(x / self.mid)
        hi = 1.0 - (1.0 - self.mid) * self._pow((1.0 - x) / (1.0 - self.mid))
        return self.d0 + torch.where(x < self.mid, lo, hi) * self.span


def solref_kb(solref, solimp):
    """Static per-row (k_base, b) numpy arrays from solref/solimp:
    aref = -b*vn + d(r)*k_base*pen (positive-solref convention only)."""
    sr = np.asarray(solref, dtype=np.float64).reshape(-1, 2)
    dmax = np.asarray(solimp, dtype=np.float64).reshape(-1, 5)[:, 1]
    tau, zeta = sr[:, 0], sr[:, 1]
    if not (tau > 0).all():
        raise NotImplementedError("direct (negative) solref is not supported")
    return 1.0 / (dmax * dmax * tau * tau * zeta * zeta), 2.0 / (dmax * tau)


def _self_pair_static(model: PhysicsModel):
    """Static numpy arrays of every sphere/capsule/cylinder self pair
    (spheres are segments of half-length 0, cylinders inscribed capsules),
    or None when there is none. Pairs with a box or a mesh are skipped
    here, as the JAX engine skips them (a mesh pair has rows of its own)."""
    ok_types = (GEOM_SPHERE, GEOM_CAPSULE)
    idx = []
    for k, pair in enumerate(model.contact_pairs):
        g1, g2 = model.geoms[pair.geom1], model.geoms[pair.geom2]
        if g1.gtype == GEOM_PLANE or g2.gtype == GEOM_PLANE:
            continue
        if g1.gtype not in ok_types or g2.gtype not in ok_types:
            continue
        idx.append(k)
    if not idx:
        return None

    def half_len(g):
        """Segment half-length: a capsule's own; a cylinder's inscribed
        (minus its radius), so that the round caps stay inside its faces."""
        if g.gtype != GEOM_CAPSULE:
            return 0.0
        if g.gtype_orig == GEOM_CYLINDER:
            return max(float(g.size[1]) - float(g.size[0]), 0.0)
        return float(g.size[1])

    def geom_arrs(which):
        gs = [model.geoms[getattr(model.contact_pairs[k], which)] for k in idx]
        return (np.array([g.bodyid for g in gs]), np.stack([g.pos for g in gs]),
                np.stack([g.quat for g in gs]), np.array([g.size[0] for g in gs]),
                np.array([half_len(g) for g in gs]),
                np.array([g.gtype == GEOM_CAPSULE for g in gs]))

    b1, pos1, quat1, r1, h1, iscap1 = geom_arrs("geom1")
    b2, pos2, quat2, r2, h2, iscap2 = geom_arrs("geom2")
    prs = [model.contact_pairs[k] for k in idx]
    return dict(
        b1=b1, b2=b2, pos1=pos1, quat1=quat1, r1=r1, h1=h1, iscap1=iscap1,
        pos2=pos2, quat2=quat2, r2=r2, h2=h2, iscap2=iscap2,
        mu=np.array([p.mu if p.condim > 1 else 0.0 for p in prs]),
        invw=np.array([p.invw0 for p in prs]),
        solref=np.stack([p.solref for p in prs]), solimp=np.stack([p.solimp for p in prs]),
        capcap=iscap1 & iscap2, margin=np.array([p.margin for p in prs]),
        condim=np.array([p.condim for p in prs], dtype=np.int64),
        meff=np.array([p.m_eff for p in prs]),
        friction5=np.stack([_friction5(p) for p in prs]))


def _friction5(pair) -> np.ndarray:
    return (np.asarray(pair.friction5, dtype=np.float64) if pair.friction5 is not None
            else np.array([pair.mu, pair.mu, 0.005, 1e-4, 1e-4]))


class ContactTables:
    """The static half of collect_contact_rows for one model, on the device:
    the rows in the JAX order (pair by pair; a capsule's -axis end first; a
    mesh pair's vertex rows, then its support-point rows), the plane rows'
    candidate points they are chosen from (a mesh's vertices; every other
    kind's points are its rows), each mesh pair's geometry, and the
    self-pair candidates. The per-row tables (row_body, row_other,
    row_arel, row_margin, plane, plane_meff, plane_imp, mu_plane_static,
    condim_plane) cover every row of the pairs, plane and mesh; the
    candidate and row_plane/row_geom/row_radius/row_rim/row_kind tables
    the plane pairs' rows alone."""

    def __init__(self, model: PhysicsModel, device, dtype):
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
        ix = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
        # candidate points: (geom2 index, plane geom index, point offset in
        # the geom frame, radius, kind, rim (cos, sin), pair); and the rows,
        # as segments of candidates: (first, count, rows kept; 0 = all)
        rows, segs, mesh, groups = [], [], [], []
        for pair in model.contact_pairs:
            g1, g2 = model.geoms[pair.geom1], model.geoms[pair.geom2]
            if g2.gtype == GEOM_MESH and g1.gtype != GEOM_PLANE:
                if g1.bodyid == 0 and g2.bodyid == 0:
                    continue    # both static: nothing to resolve
                groups.append(("mesh", len(mesh)))
                mesh.append(pair)
                continue
            if g1.gtype != GEOM_PLANE:
                continue        # the other body-body pairs are self pairs
            r = float(g2.size[0])
            first = len(rows)
            row = lambda off, rad, kind, rim=(0.0, 0.0): rows.append(
                (pair.geom2, pair.geom1, off, rad, kind, rim, pair))
            if g2.gtype == GEOM_SPHERE:
                row((0.0, 0.0, 0.0), r, _SPHERE)
            elif g2.gtype == GEOM_CAPSULE and g2.gtype_orig == GEOM_CYLINDER:
                for s in (-1.0, 1.0):
                    for rim in _RIM:
                        row((0.0, 0.0, s * float(g2.size[1])), 0.0, _CYLINDER, rim)
            elif g2.gtype == GEOM_CAPSULE:
                for s in (-1.0, 1.0):
                    row((0.0, 0.0, s * float(g2.size[1])), r, _CAPSULE)
            elif g2.gtype == GEOM_BOX:
                sx, sy, sz = [float(x) for x in g2.size]
                for cx in (-sx, sx):
                    for cy in (-sy, sy):
                        for cz in (-sz, sz):
                            row((cx, cy, cz), 0.0, _BOX)
            elif g2.gtype == GEOM_MESH:
                for v in np.asarray(g2.mesh_verts):
                    row(tuple(float(x) for x in v), 0.0, _MESH)
            else:
                raise NotImplementedError(f"plane vs geom type {g2.gtype_orig}")
            n = len(rows) - first
            groups.append(("plane", len(segs)))
            segs.append((first, n, min(MESH_ROWS, n) if g2.gtype == GEOM_MESH else 0))
        # the candidates' own tables (their points and distances: row_off and
        # row_rim are per candidate), then the rows': a mesh segment keeps
        # its MESH_ROWS deepest candidates
        self.has_mesh = any(k for _, _, k in segs)
        cand = rows
        if cand:
            self.cand_kind = np.array([r[4] for r in cand])
            self.row_off, self.cand_radius = t([r[2] for r in cand]), t([r[3] for r in cand])
        if self.has_mesh:
            self.segments = [(a, n, k, ix(np.arange(a, a + n))) for a, n, k in segs]
            rows = [rows[a + i] for a, n, k in segs for i in range(k or n)]
        # the geoms whose world frames a step needs, each once
        geoms = sorted({r[0] for r in rows} | {r[1] for r in rows}
                       | {g for p in mesh for g in (p.geom1, p.geom2)})
        slot = {g: i for i, g in enumerate(geoms)}
        gs = [model.geoms[g] for g in geoms]
        self.geom_body = ix([g.bodyid for g in gs])
        self.geom_pos = t([g.pos for g in gs])
        self.geom_rot = sp.quat_to_mat(t([g.quat for g in gs])) if gs else None
        if cand:
            self.cand_geom = ix([slot[r[0]] for r in cand])
            self.cand_plane = ix([slot[r[1]] for r in cand])
        self.n_plane_pair_rows = len(rows)
        if rows:
            self.row_kind = kind = np.array([r[4] for r in rows])
            self.row_geom = ix([slot[r[0]] for r in rows])
            self.row_plane = ix([slot[r[1]] for r in rows])
            self.row_radius = t([r[3] for r in rows])
            self.row_capsule = ix(kind == _CAPSULE).bool()
            # exact cylinder rims: r cos, r sin of each candidate's rim point
            self.has_cylinder = bool(np.any(kind == _CYLINDER))
            rad = np.array([float(model.geoms[r[0]].size[0]) for r in cand])
            self.row_rim = t([(rc * c, rc * sn) for rc, (c, sn) in
                               zip(rad * (self.cand_kind == _CYLINDER), [r[5] for r in cand])])
        self.mesh_pairs = [_mesh_pair_tables(model, p, slot, t) for p in mesh]
        # every row in the JAX order: (row body, other body, pair), and where
        # it sits in [plane pairs' rows | mesh pairs' rows]
        meta, order, mesh_at = [], [], len(rows)
        kept = [k or n for _, n, k in segs]
        for kind_, i in groups:
            if kind_ == "plane":
                a = sum(kept[:i])
                for j in range(kept[i]):
                    r = rows[a + j]
                    meta.append((model.geoms[r[0]].bodyid, model.geoms[r[1]].bodyid, r[6]))
                    order.append(a + j)
                continue
            mp = self.mesh_pairs[i]
            b1, b2 = mp["body1"], mp["body2"]
            for j in range(mp["kk1"] + mp["kk2"]):
                meta.append((b2, b1, mp["pair"]) if j < mp["kk1"] else (b1, b2, mp["pair"]))
                order.append(mesh_at + j)
            mesh_at += mp["kk1"] + mp["kk2"]
        self.row_order = ix(order) if self.mesh_pairs else None
        self.n_plane = len(meta)
        if meta:
            pairs = [m[2] for m in meta]
            bid, oid = np.array([m[0] for m in meta]), np.array([m[1] for m in meta])
            self.row_body, self.row_other = ix(bid), ix(oid)
            self.row_arel = t(model.ancestor_mask[bid] - model.ancestor_mask[oid])
            self.mu_plane_static = np.array([p.mu if p.condim > 1 else 0.0 for p in pairs])
            self.condim_plane = np.array([p.condim for p in pairs], dtype=np.int64)
            kb, br = solref_kb([p.solref for p in pairs], [p.solimp for p in pairs])
            self.plane = dict(mu=t(self.mu_plane_static), k_base=t(kb), b_ref=t(br),
                              invw=t([p.invw0 for p in pairs]),
                              fri5=t(np.stack([_friction5(p) for p in pairs])))
            self.plane_meff = t([p.m_eff for p in pairs])
            self.row_margin = t([p.margin for p in pairs])
            self.plane_imp = Impedance([p.solimp for p in pairs], device, dtype)
        else:
            self.mu_plane_static = np.zeros(0)
            self.condim_plane = np.zeros(0, dtype=np.int64)
        self.ex, self.ey, self.ez = t(np.eye(3)[0]), t(np.eye(3)[1]), t(np.eye(3)[2])
        st = _self_pair_static(model)
        self.n_self = 0 if st is None else min(SELF_TOPK, st["b1"].shape[0])
        self.condim_self_max = 1
        if st is not None:
            self.condim_self_max = int(st["condim"].max())
            kb, br = solref_kb(st["solref"], st["solimp"])
            self.s = {k: t(st[k]) for k in ("pos1", "quat1", "pos2", "quat2", "h1", "h2",
                                              "r1", "r2", "margin", "mu", "invw",
                                              "friction5", "meff")}
            self.s.update(b1=ix(st["b1"]), b2=ix(st["b2"]), k_base=t(kb), b_ref=t(br),
                          rr=t(st["r1"] + st["r2"]),
                          capcap=torch.as_tensor(st["capcap"], device=device)[:, None])
            self.self_imp = Impedance(st["solimp"], device, dtype)
        self.A = t(model.ancestor_mask)
        self.elliptic = int(model.cone) == 1


_BOX_CORNERS = np.array([[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                         for sz in (-1.0, 1.0)])


def _mesh_pair_tables(model: PhysicsModel, pair, slot: dict, t) -> dict:
    """The constants of one mesh pair (geom2 the mesh, geom1 a sphere,
    capsule, box or mesh): the two geoms' slots in the world-frame tables,
    the mesh's vertices and hull planes, geom1's signed-distance kind and
    support points, and the rows each direction keeps."""
    g1, g2 = model.geoms[pair.geom1], model.geoms[pair.geom2]
    if g1.gtype not in (GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_MESH):
        raise NotImplementedError(f"mesh vs geom type {g1.gtype}")
    verts2 = np.asarray(g2.mesh_verts, dtype=np.float64)
    hl = (max(float(g1.size[1]) - float(g1.size[0]), 0.0) if g1.gtype_orig == GEOM_CYLINDER
          else float(g1.size[1]) if g1.gtype == GEOM_CAPSULE else 0.0)
    if g1.gtype == GEOM_MESH:
        n_pts, rad = len(g1.mesh_verts), 0.0
    elif g1.gtype == GEOM_BOX:
        n_pts, rad = 8, 0.0
    else:
        n_pts, rad = (1 if g1.gtype == GEOM_SPHERE else 2), float(g1.size[0])
    kk1, kk2 = min(MESH_ROWS, len(verts2)), min(MESH_ROWS, n_pts)
    out = dict(pair=pair, kind1=g1.gtype, s1=slot[pair.geom1], s2=slot[pair.geom2],
               body1=g1.bodyid, body2=g2.bodyid, size1=t(np.asarray(g1.size, np.float64)),
               r1=float(g1.size[0]), hl1=hl, rad1=rad, verts2=t(verts2),
               hull2=t(g2.mesh_hull), kk1=kk1, kk2=kk2)
    if g1.gtype == GEOM_MESH:
        out.update(verts1=t(g1.mesh_verts), hull1=t(g1.mesh_hull))
    if g1.gtype == GEOM_BOX:
        out["corners1"] = t(_BOX_CORNERS * np.asarray(g1.size[:3], np.float64))
    for name, kk, n in (("earlier1", kk1, len(verts2)), ("earlier2", kk2, n_pts)):
        nc = min(2 * kk, n)
        out[name] = torch.tril(torch.ones(nc, nc, dtype=torch.bool,
                                          device=out["verts2"].device), -1)
    return out


def _make_frame_tangent(ct: ContactTables, n: torch.Tensor) -> torch.Tensor:
    """mju_makeFrame tangent: t1 = normalize(n x e_x), e_y when n ~ e_x."""
    c1 = sp.cross(n, ct.ex)
    c2 = sp.cross(n, ct.ey)
    use1 = (torch.linalg.vector_norm(c1, dim=-1) > 1e-8)[..., None]
    t = torch.where(use1, c1, c2)
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)


def geom_world(ct: ContactTables, state):
    """World position (..., G, 3) and rotation (..., G, 3, 3) of the
    tables' geoms, for a state with or without a leading K axis."""
    R_b = sp.quat_to_mat(state.xquat[..., ct.geom_body, :])
    pos = state.xpos[..., ct.geom_body, :] + torch.einsum("...gij,gj->...gi", R_b, ct.geom_pos)
    return pos, R_b @ ct.geom_rot


def _jacobian_rows(ct, S, p, Arel, n, t1, t2, elliptic, penalty=False):
    """Contact-frame rows of the relative point jacobian at points p (the
    point jacobian itself too for the penalty tier). Arel (P, nv), or (...,
    P, nv) when the rows' bodies differ by sample (the self rows)."""
    S_ang, S_lin = S[..., :3], S[..., 3:]
    Jp = (S_lin[..., None, :, :] + sp.cross(S_ang[..., None, :, :], p[..., :, None, :])) \
        * Arel[..., None]
    out = dict(JpN=torch.sum(Jp * n[..., :, None, :], -1),
               Jt1=torch.sum(Jp * t1[..., :, None, :], -1),
               Jt2=torch.sum(Jp * t2[..., :, None, :], -1))
    if elliptic:
        # angular rows for condim >= 4 torsional/rolling friction
        Jw = S_ang[..., None, :, :] * Arel[..., None]
        out.update(JwN=torch.sum(Jw * n[..., :, None, :], -1),
                   Jwt1=torch.sum(Jw * t1[..., :, None, :], -1),
                   Jwt2=torch.sum(Jw * t2[..., :, None, :], -1))
    if penalty:
        out["Jp"] = Jp
    return out


def _penalty_fields(rows, n, v_pt, meff):
    """What the penalty law adds to a block of rows: the normal, the
    tangential velocity and its regularised norm, m_eff and the normal
    damping c_n = m_eff d(r) b."""
    vt = v_pt - rows["vn"][..., None] * n
    rows.update(n=n, vt=vt, vt_norm=torch.sqrt(torch.sum(vt * vt, -1) + _VT_EPS * _VT_EPS),
                meff=meff, c_n=meff * rows["d_r"] * rows["b_ref"])


def _candidates(ct: ContactTables, gpos, gR):
    """Every candidate point's centre (..., C, 3) and plane distance
    (..., C): a sphere's centre, a capsule's end, a box corner, a
    cylinder's rim point, a mesh vertex."""
    p_pos, n = gpos[..., ct.cand_plane, :], gR[..., ct.cand_plane, :, 2]
    g_pos, gRr = gpos[..., ct.cand_geom, :], gR[..., ct.cand_geom, :, :]
    c_end = g_pos + torch.einsum("...pij,pj->...pi", gRr, ct.row_off)
    if ct.has_cylinder:
        # rim points: the cap's downhill direction d = -(n - (a.n) a), or the
        # cylinder's x-axis where |d| <= 1e-6 (standing), and its normal
        axis = gRr[..., :, 2]
        d = -(n - torch.sum(axis * n, -1, keepdim=True) * axis)
        dn = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        dhat = torch.where(dn > 1e-6, d / torch.clamp(dn, min=1e-30), gRr[..., :, 0])
        dhat = dhat / torch.linalg.vector_norm(dhat, dim=-1, keepdim=True)
        perp = sp.cross(axis, dhat)
        c_end = c_end + (ct.row_rim[:, 0:1] * dhat + ct.row_rim[:, 1:2] * perp)
    return c_end, torch.sum(n * (c_end - p_pos), -1) - ct.cand_radius


def _keep_deepest(ct: ContactTables, c_end, phi):
    """The rows' points from the candidates: each mesh segment's MESH_ROWS
    deepest (a stable sort on (-phi, index): jax.lax.top_k's order), every
    other candidate as it is."""
    lead = phi.shape[:-1]
    sel = []
    for a, n, k, idx in ct.segments:
        if k:
            order = torch.sort(-phi[..., a:a + n], dim=-1, descending=True, stable=True)
            sel.append(order.indices[..., :k] + a)
        else:
            sel.append(idx.expand(lead + (n,)))
    sel = torch.cat(sel, -1)
    c_end = torch.gather(c_end, -2, sel[..., None].expand(sel.shape + (3,)))
    return c_end, torch.gather(phi, -1, sel)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., V) or (..., V, 3) at the per-sample indices idx (..., k)."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def _plane_geometry(ct: ContactTables, gpos, gR):
    """The plane pairs' rows: contact points, distances, normals and first
    tangents (..., P, ...)."""
    n, axis = gR[..., ct.row_plane, :, 2], gR[..., ct.row_geom, :, 2]
    r = ct.row_radius
    c_end, phi = _candidates(ct, gpos, gR)
    if ct.has_mesh:
        c_end, phi = _keep_deepest(ct, c_end, phi)
    # contact position midway between the surfaces (MuJoCo contact.pos)
    p = c_end - n * (r + 0.5 * phi)[..., None]
    # capsule frame: t1 = the axis projected onto the plane (makeFrame when
    # the capsule stands perpendicular); the other kinds: makeFrame
    mft = _make_frame_tangent(ct, n)
    proj = axis - torch.sum(axis * n, -1, keepdim=True) * n
    pn = torch.linalg.vector_norm(proj, dim=-1)
    t_cap = torch.where((pn > 1e-8)[..., None], proj / torch.clamp(pn, min=1e-30)[..., None],
                        mft)
    return p, phi, n, torch.where(ct.row_capsule[:, None], t_cap, mft)


def _hull_sdf(hull, g_pos, g_R, world):
    """A mesh's convex-hull distance at world points (..., V, 3): the
    largest of its face planes' (exact inside and in a face's region, a
    lower bound near an edge outside), and the deepest face's outward
    normal in the world frame (argmax: the first among equals)."""
    local = (world - g_pos[..., None, :]) @ g_R
    d_all = local @ hull[:, :3].T + hull[:, 3]
    j = torch.argmax(d_all, -1)
    return torch.amax(d_all, -1), hull[:, :3][j] @ g_R.mT


def _prim_sdf(mp: dict, p_pos, p_R, world):
    """Geom1's signed distance at world points (..., V, 3) and its outward
    gradient there (from geom1's surface towards the point)."""
    eps = 1e-12
    if mp["kind1"] == GEOM_MESH:
        return _hull_sdf(mp["hull1"], p_pos, p_R, world)
    if mp["kind1"] == GEOM_BOX:
        s = mp["size1"][:3]
        u = (world - p_pos[..., None, :]) @ p_R
        diff = u - torch.clamp(u, -s, s)
        d = torch.linalg.vector_norm(diff, dim=-1)
        # inside: the distance to the nearest face (negative), the gradient
        # along that face's axis
        face = torch.abs(u) - s
        j = torch.argmax(face, -1)
        g_in = torch.nn.functional.one_hot(j, 3).to(u.dtype) * torch.sign(u)
        out = d > 1e-9
        phi = torch.where(out, d, torch.amax(face, -1))
        g_loc = torch.where(out[..., None], diff / torch.clamp(d, min=eps)[..., None], g_in)
        return phi, g_loc @ p_R.mT
    if mp["kind1"] == GEOM_CAPSULE:
        axis = p_R[..., :, 2]
        tt = torch.clamp(torch.sum((world - p_pos[..., None, :]) * axis[..., None, :], -1),
                         -mp["hl1"], mp["hl1"])
        diff = world - (p_pos[..., None, :] + tt[..., None] * axis[..., None, :])
    else:
        diff = world - p_pos[..., None, :]
    d = torch.linalg.vector_norm(diff, dim=-1)
    return d - mp["r1"], diff / torch.clamp(d, min=eps)[..., None]


def _support_points(mp: dict, p_pos, p_R):
    """Geom1's support points (..., n, 3): a mesh's vertices, a box's
    corners, a capsule's two ends (the -axis one first), a sphere's
    centre."""
    if mp["kind1"] == GEOM_MESH:
        return p_pos[..., None, :] + mp["verts1"] @ p_R.mT
    if mp["kind1"] == GEOM_BOX:
        return p_pos[..., None, :] + mp["corners1"] @ p_R.mT
    if mp["kind1"] == GEOM_CAPSULE:
        axis = p_R[..., :, 2]
        return torch.stack([p_pos - mp["hl1"] * axis, p_pos + mp["hl1"] * axis], -2)
    return p_pos[..., None, :]


def _mesh_rows(ct: ContactTables, pts, radius: float, phi_all, grad_all, kk: int, earlier):
    """The kk deepest of the points (..., V, 3) by phi_all (..., V), their
    gradients grad_all pointing into the row's body: a stable sort for
    jax.lax.top_k's order; of the 2 kk deepest, one within 1 um of a
    deeper one ranks behind the distinct ones (phi + 1e9) and, if kept,
    keeps phi = 1e9, an inert row. Returns points midway between the
    surfaces, distances, normals and first tangents."""
    nc = earlier.shape[0]
    cidx = torch.sort(-phi_all, dim=-1, descending=True, stable=True).indices[..., :nc]
    cand = _take(pts, cidx)
    d2 = torch.sum((cand[..., :, None, :] - cand[..., None, :, :]) ** 2, -1)
    dup = torch.any((d2 < 1e-6 ** 2) & earlier, -1)
    big = 1e9
    rank_phi = _take(phi_all, cidx) + dup.to(phi_all.dtype) * big
    order = torch.sort(-rank_phi, dim=-1, descending=True, stable=True).indices[..., :kk]
    idx = torch.gather(cidx, -1, order)
    phi = torch.where(torch.gather(dup, -1, order), big, _take(phi_all, idx)) - radius
    n = _take(grad_all, idx)
    p = _take(pts, idx) - n * (radius + 0.5 * phi)[..., None]
    return p, phi, n, _make_frame_tangent(ct, n)


def _mesh_geometry(ct: ContactTables, gpos, gR):
    """The mesh pairs' rows in pair order, each pair's mesh vertices against
    geom1's distance, then geom1's support points against the mesh's hull:
    points, distances, normals and first tangents (..., P, ...)."""
    parts = []
    for mp in ct.mesh_pairs:
        p_pos, p_R = gpos[..., mp["s1"], :], gR[..., mp["s1"], :, :]
        g_pos, g_R = gpos[..., mp["s2"], :], gR[..., mp["s2"], :, :]
        world2 = g_pos[..., None, :] + mp["verts2"] @ g_R.mT
        parts.append(_mesh_rows(ct, world2, 0.0, *_prim_sdf(mp, p_pos, p_R, world2),
                                mp["kk1"], mp["earlier1"]))
        pts = _support_points(mp, p_pos, p_R)
        parts.append(_mesh_rows(ct, pts, mp["rad1"], *_hull_sdf(mp["hull2"], g_pos, g_R, pts),
                                mp["kk2"], mp["earlier2"]))
    return [torch.cat([q[i] for q in parts], -1 if i == 1 else -2) for i in range(4)]


def _plane_rows(ct: ContactTables, state, S, penalty=False):
    """The rows of the plane and mesh pairs, in the JAX order."""
    gpos, gR = geom_world(ct, state)
    parts = []
    if ct.n_plane_pair_rows:
        parts.append(_plane_geometry(ct, gpos, gR))
    if ct.mesh_pairs:
        parts.append(_mesh_geometry(ct, gpos, gR))
    if len(parts) == 1 and ct.row_order is None:
        p, phi, n, t1 = parts[0]
    else:
        p, phi, n, t1 = (torch.cat([q[i] for q in parts], d).index_select(d, ct.row_order)
                         for i, d in zip(range(4), (-2, -1, -2, -2)))
    t2 = sp.cross(n, t1)
    V, Vo = state.body_vel[..., ct.row_body, :], state.body_vel[..., ct.row_other, :]
    v_pt = V[..., 3:] + sp.cross(V[..., :3], p) - Vo[..., 3:] - sp.cross(Vo[..., :3], p)
    pen = torch.clamp(ct.row_margin - phi, min=0.0)
    rows = dict(pen=pen, active=(phi < ct.row_margin).to(phi.dtype),
                vn=torch.sum(n * v_pt, -1), vt1=torch.sum(t1 * v_pt, -1),
                vt2=torch.sum(t2 * v_pt, -1), d_r=ct.plane_imp(pen), **ct.plane)
    rows.update(_jacobian_rows(ct, S, p, ct.row_arel, n, t1, t2, ct.elliptic, penalty))
    if penalty:
        _penalty_fields(rows, n, v_pt, ct.plane_meff)
    return rows


def _self_rows(ct: ContactTables, state, S, penalty=False):
    """The SELF_TOPK deepest self-contact rows: clamped segment-segment
    closest points (two refinement passes), contact frame by the MuJoCo
    conventions (capsule-capsule t1 = normalize(n x axis2), otherwise
    Gram-Schmidt of world z against n), relative point jacobians. With a
    leading K axis each sample keeps its own deepest pairs, so the rows'
    bodies and static fields become (K, SELF_TOPK, ...)."""
    s = ct.s

    def world(bids, lpos, lquat):
        xq, xp = state.xquat[..., bids, :], state.xpos[..., bids, :]
        q = sp.quat_mul(xq, lquat)
        return xp + sp.quat_rotate(xq, lpos), sp.quat_rotate(q, ct.ez.expand(q.shape[:-1] + (3,)))

    p1, u1 = world(s["b1"], s["pos1"], s["quat1"])
    p2, u2 = world(s["b2"], s["pos2"], s["quat2"])
    hh1, hh2 = s["h1"], s["h2"]
    d12 = p2 - p1
    bb = torch.sum(u1 * u2, -1)
    dd = torch.sum(u1 * d12, -1)
    ee = torch.sum(u2 * d12, -1)
    den = torch.clamp(1.0 - bb * bb, min=1e-12)
    sc = torch.clamp((dd - bb * ee) / den, -hh1, hh1)
    tc = torch.clamp(torch.sum(u2 * (p1 + sc[..., None] * u1 - p2), -1), -hh2, hh2)
    sc = torch.clamp(torch.sum(u1 * (p2 + tc[..., None] * u2 - p1), -1), -hh1, hh1)
    tc = torch.clamp(torch.sum(u2 * (p1 + sc[..., None] * u1 - p2), -1), -hh2, hh2)
    c1 = p1 + sc[..., None] * u1
    c2 = p2 + tc[..., None] * u2
    dvec = c2 - c1
    dist = torch.sqrt(torch.sum(dvec * dvec, -1) + 1e-24)
    n = dvec / dist[..., None]                                # geom1 -> geom2
    phi = dist - s["rr"]
    pos = c1 + n * (s["r1"] + 0.5 * phi)[..., None]
    gs_z = ct.ez - n[..., 2:3] * n
    gs_y = ct.ey - n[..., 1:2] * n
    gs = torch.where((torch.linalg.vector_norm(gs_z, dim=-1) > 1e-6)[..., None], gs_z, gs_y)
    gs = gs / torch.linalg.vector_norm(gs, dim=-1, keepdim=True)
    cx = sp.cross(n, u2)
    cx = torch.where((torch.linalg.vector_norm(cx, dim=-1) > 1e-8)[..., None], cx, gs)
    cx = cx / torch.linalg.vector_norm(cx, dim=-1, keepdim=True)
    t1 = torch.where(s["capcap"], cx, gs)
    # a row activates when dist < margin; its spring position counts from
    # the margin surface (mjContact.includemargin with gap 0)
    marg = s["margin"]
    pen_all = torch.clamp(marg - phi, min=0.0)
    d_r_all = ct.self_imp(pen_all)
    # jax.lax.top_k: the largest first, the lower index first among equals
    sel = torch.sort(pen_all, dim=-1, descending=True, stable=True).indices[..., :ct.n_self]
    pick = lambda x: _take(x, sel)
    n_k, t1_k, pos_k = pick(n), pick(t1), pick(pos)
    t2_k = sp.cross(n_k, t1_k)
    bid1, bid2 = s["b1"][sel], s["b2"][sel]
    V1, V2 = _take(state.body_vel, bid1), _take(state.body_vel, bid2)
    v_rel = (V2[..., 3:] + sp.cross(V2[..., :3], pos_k) - V1[..., 3:]
             - sp.cross(V1[..., :3], pos_k))
    rows = dict(pen=pick(pen_all), active=(pick(phi) < marg[sel]).to(phi.dtype),
                vn=torch.sum(n_k * v_rel, -1), vt1=torch.sum(t1_k * v_rel, -1),
                vt2=torch.sum(t2_k * v_rel, -1), d_r=pick(d_r_all),
                mu=s["mu"][sel], k_base=s["k_base"][sel], b_ref=s["b_ref"][sel],
                invw=s["invw"][sel], fri5=s["friction5"][sel])
    Arel = ct.A[bid2] - ct.A[bid1]
    rows.update(_jacobian_rows(ct, S, pos_k, Arel, n_k, t1_k, t2_k, ct.elliptic, penalty))
    if penalty:
        _penalty_fields(rows, n_k, v_rel, s["meff"][sel])
    return rows


ROW_FIELDS = ("pen", "active", "vn", "vt1", "vt2", "d_r", "mu", "k_base", "b_ref", "invw",
              "fri5", "JpN", "Jt1", "Jt2", "JwN", "Jwt1", "Jwt2")
# the fields the penalty law reads besides
PENALTY_FIELDS = ("n", "vt", "vt_norm", "Jp", "meff", "c_n")


def collect_contact_rows(ct: ContactTables, state, S: torch.Tensor, penalty: bool = False):
    """All contact rows of the state, the plane and mesh pairs' rows first,
    then the SELF_TOPK self rows: a dict of (P, ...) tensors (the fields of
    ROW_FIELDS that the model's cone needs, and PENALTY_FIELDS when
    `penalty`), or None when the model has no contact pair. A state with a
    leading K axis gives (K, P, ...) rows; the static per-pair fields (mu,
    k_base, b_ref, invw, fri5, meff) stay (P, ...) when the model has no
    self pair (whose rows differ by sample)."""
    blocks = []
    if ct.n_plane:
        blocks.append(_plane_rows(ct, state, S, penalty))
    if ct.n_self:
        blocks.append(_self_rows(ct, state, S, penalty))
    if not blocks:
        return None
    keys = [k for k in ROW_FIELDS + (PENALTY_FIELDS if penalty else ()) if k in blocks[0]]
    if len(blocks) == 1:
        return {k: blocks[0][k] for k in keys}
    lead = state.qpos.shape[:-1]
    out = {}
    for k in keys:
        a, b = blocks[0][k], blocks[1][k]
        if a.dim() < b.dim():
            a = a.expand(lead + a.shape)
        out[k] = torch.cat([a, b], len(lead))
    return out


def contact_force_terms(rows, fn: torch.Tensor):
    """Generalized contact force tau = sum_p J_p^T f_p (normal fn plus the
    regularised Coulomb friction; J the relative point jacobian) and the
    implicit damping matrix G = J^T C J, C = c_n n n^T + c_t (1 - n n^T),
    for rows with or without a leading K axis (JAX contact_force_terms)."""
    c_t = rows["mu"] * fn / rows["vt_norm"]              # Coulomb slope
    ft = -c_t[..., None] * rows["vt"]
    f = fn[..., None] * rows["n"] + ft                    # (..., P, 3) world force
    tau = torch.einsum("...pni,...pi->...n", rows["Jp"], f)
    cn_eff = rows["c_n"] * rows["active"]
    ct_eff = c_t * rows["active"]
    JpN, Jp = rows["JpN"], rows["Jp"]
    # J^T C J = (c_n - c_t) (Jn)(Jn)^T + c_t J J^T
    G = torch.einsum("...p,...pn,...pm->...nm", cn_eff - ct_eff, JpN, JpN)
    G = G + torch.einsum("...p,...pni,...pmi->...nm", ct_eff, Jp, Jp)
    return tau, G


def contact_terms(ct: Optional[ContactTables], state, S: torch.Tensor, h: float,
                  qacc: Optional[torch.Tensor] = None, r_form: bool = False):
    """Decoupled per-row contact forces and implicit damping (JAX
    contact_terms). The forward reading, the penalty tier's (a0 dropped):

        fn = max(d(r) m_eff (d(r) k_base pen - b vn), 0) * active

    capped so that the impulse fn h pushes a row out at most at
    RESTITUTION_VCAP: fn <= m_eff max(VCAP - vn, 0) / h. The inverse
    reading (r_form=True, inverse_dynamics'; mj_inverse's f = (aref - a)/R):
    gain m_eff d/(1 - d) with 1 - d floored at 1e-6, a_n = J_n qacc the
    realised normal acceleration subtracted inside the bracket, and no
    cap, so that the force stays the exact inverse of the given motion.
    Returns (tau (..., nv), G (..., nv, nv)), zeros when the model has no
    pair."""
    rows = None if ct is None else collect_contact_rows(ct, state, S, penalty=True)
    if rows is None:
        z = torch.zeros_like(state.qvel)
        return z, torch.diag_embed(z)
    d_r, meff = rows["d_r"], rows["meff"]
    gain = meff * d_r
    bracket = d_r * rows["k_base"] * rows["pen"] - rows["b_ref"] * rows["vn"]
    if qacc is not None:
        bracket = bracket - torch.einsum("...pn,...n->...p", rows["JpN"], qacc)
    if r_form:
        gain = gain / torch.clamp(1.0 - d_r, min=1e-6)
    fn = torch.clamp(gain * bracket, min=0.0) * rows["active"]
    if not r_form:
        fn = torch.minimum(fn, meff * torch.clamp(RESTITUTION_VCAP - rows["vn"], min=0.0) / h)
    return contact_force_terms(rows, fn)
