"""Primal Newton constraint solver (physics/newton.py counterpart), MuJoCo's
Newton solver for its convex constraint problem:

    qacc = argmin_x  1/2 (x-a0)^T M (x-a0)  +  sum_i s_i(J_i x - aref_i)

with a0 the smooth acceleration and s_i the dual-zone penalty of row or
block i with regularizer R_i:

  - inequality rows (joint/tendon limits, frictionless contact normals,
    pyramidal friction-cone facets): s(u) = u^2/(2R) for u < 0, else 0
  - dof-friction rows (frictionloss): Huber, the force clamped to [-fl, fl]
  - elliptic friction-cone blocks [N, T1, T2(, Wn, Wt1, Wt2)]: top
    (separating) zero, bottom (sticking) independent quadratics, middle
    (sliding) (mu T - N)^2 / (2 R_m)

The problem is strictly convex, so its minimizer is unique. Each iteration
takes an exact Newton step with a 12-step safeguarded line search. The JAX
solver loops while the gradient norm exceeds tol * scale (at most n_iter
times); here the loop runs n_iter times and a mask freezes x once that
condition fails, which gives the same iterates without reading anything
back from the device. With early_exit the loop ends there instead, which
reads the flag back each iteration: Engine.step asks for it on the CPU,
where that costs no device wait.

Every function takes one sample or a state whose fields carry a leading K
axis (the planner's batch, JAX's vmap of the solve): the rows gain the K
axis, the scalars of the solve (ridge, scale, the line search's alpha, lo
and hi, the convergence flag) become (K,) tensors, and the masked loop
freezes each sample on its own, as the vmapped while_loop does; with
early_exit it ends when no sample goes on. The one-sample path runs the
same operations as before on tensors without the K axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .contact import RESTITUTION_VCAP_ENV, ContactTables, Impedance, collect_contact_rows, solref_kb
from .model import HINGE, SLIDE, PhysicsModel

_MINIMP = 1e-4   # mjMINIMP/mjMAXIMP impedance clamps
_MAXIMP = 0.9999


class _Rows(NamedTuple):
    """Constraint rows, [ineq rows | friction rows | elliptic blocks]."""
    J: torch.Tensor          # (C, nv)
    aref: torch.Tensor       # (C,)
    R: torch.Tensor          # (C,) regularizer (impedance-scaled)
    active: torch.Tensor     # (C,) 0/1
    D: torch.Tensor          # (C,) active / R
    n_ineq: int
    n_fric: int
    fl: torch.Tensor         # (n_fric,) frictionloss bounds
    blocks: tuple            # dicts: start, nb, dim, mu (nb, dim-1), mu1 (nb,)


class RowTables:
    """The static half of build_rows for one model on the device: the row
    classes' index sets and the limit and friction rows' constants."""

    def __init__(self, model: PhysicsModel, ct: Optional[ContactTables], device, dtype):
        t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)
        ix = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
        nv = model.nv
        self.nv, self.h = nv, float(model.timestep)
        self.imp_ratio, self.cone = float(model.impratio), int(model.cone)
        self.ct = ct
        self.sgn = t([1.0, -1.0])
        if ct is not None:
            n_plane, n_self = ct.n_plane, ct.n_self
            self_idx = n_plane + np.arange(n_self)
            if self.cone == 1:
                # plane rows grouped by condim, then the self rows
                self.dims = [(dim, ix(np.nonzero(ct.condim_plane == dim)[0]))
                             for dim in (1, 3, 4, 6) if np.any(ct.condim_plane == dim)]
                self.self_idx = ix(self_idx)
            else:
                # self rows are single normal rows when every self candidate
                # is condim 1 (as MuJoCo emits them), pyramid facets otherwise
                frictionless = ct.condim_self_max == 1
                mu = ct.mu_plane_static
                none = np.zeros(0, np.int64)
                self.fr = ix(np.concatenate([np.nonzero(mu > 0)[0],
                                             none if frictionless else self_idx]))
                self.nf = ix(np.concatenate([np.nonzero(mu == 0)[0],
                                             self_idx if frictionless else none]))
        hs = [j for j in model.joints if j.jtype in (SLIDE, HINGE)]
        self.hs_qposadr, self.hs_dofadr = ix(model.hs_qposadr), ix(model.hs_dofadr)
        self.limits = bool(hs) and any(j.limited for j in hs)
        if self.limits:
            self.hs_lo, self.hs_hi = t([j.range[0] for j in hs]), t([j.range[1] for j in hs])
            self.hs_lim = t([float(j.limited) for j in hs])
            kb, br = solref_kb([j.solref for j in hs], [j.solimp for j in hs])
            self.hs_kb, self.hs_br = t(kb), t(br)
            self.hs_imp = Impedance([j.solimp for j in hs], device, dtype)
            E = np.zeros((len(hs), nv))
            E[np.arange(len(hs)), model.hs_dofadr] = 1.0
            self.hs_E = t(E)
            self.hs_invw = t(np.maximum(model.hs_limit_invw0, 1e-12))
        nt = model.tendon_coef.shape[0]
        self.tendons = bool(nt) and bool(np.any(model.tendon_limited))
        if self.tendons:
            self.ten_coef = t(model.tendon_coef)
            self.ten_lo, self.ten_hi = t(model.tendon_range[:, 0]), t(model.tendon_range[:, 1])
            self.ten_lim = t(np.asarray(model.tendon_limited, dtype=np.float64))
            kb, br = solref_kb(model.tendon_limit_solref, model.tendon_limit_solimp)
            self.ten_kb, self.ten_br = t(kb), t(br)
            self.ten_imp = Impedance(model.tendon_limit_solimp, device, dtype)
            self.ten_invw = t(np.maximum(model.tendon_invweight0, 1e-12))
        fl_dofs = np.nonzero(np.asarray(model.dof_frictionloss) > 0)[0]
        self.n_fl = int(fl_dofs.size)
        if self.n_fl:
            kbf, bf = solref_kb(model.dof_solref[fl_dofs], model.dof_solimp[fl_dofs])
            d_f = np.clip(model.dof_solimp[fl_dofs, 0], _MINIMP, _MAXIMP)  # d at pos=0
            E = np.zeros((fl_dofs.size, nv))
            E[np.arange(fl_dofs.size), fl_dofs] = 1.0
            self.fl_dofs, self.fl_E, self.fl_bf = ix(fl_dofs), t(E), t(bf)
            self.fl_R = t((1.0 - d_f) / d_f * np.maximum(model.dof_invweight0[fl_dofs], 1e-12))
            self.fl = t(np.asarray(model.dof_frictionloss)[fl_dofs])


def cho_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for symmetric positive definite A (..., n, n) by Cholesky and
    two triangular solves (no error check, so no wait for the device, and
    no guard that jax.scipy's cho_factor lacks)."""
    L = torch.linalg.cholesky_ex(A).L
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _cap_aref(aref, v_row, h):
    """Restitution cap on contact rows (RESTITUTION_VCAP_ENV): braking is
    unbounded; the outward push is limited to the cap separation velocity,
    floored at zero so that a row already separating keeps its raw aref."""
    return torch.minimum(aref, torch.clamp((RESTITUTION_VCAP_ENV - v_row) / h, min=0.0))


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A x: a matrix-vector product for one sample, x (n,), and the batched
    product for x (K, n) with A (K, m, n) or (m, n)."""
    return A @ x if x.dim() == 1 else (A @ x[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b if a.dim() == 1 else torch.sum(a * b, -1)


def _col(a: torch.Tensor) -> torch.Tensor:
    """A per-sample scalar (K,) as a column (K, 1); a 0-dim one as it is."""
    return a[..., None] if a.dim() else a


def pyramid_rows(rows, fr, sgn: torch.Tensor, base: torch.Tensor):
    """The four pyramid facets of each contact row `fr` (F of them), in
    (row, tangent, sign) order: J (..., F*4, nv), the uncapped
    aref = base - b v and the facet velocity v (..., F*4). Each solver
    caps aref itself."""
    mu_f = rows["mu"][..., fr][..., None, None]
    Jn = rows["JpN"][..., fr, :]
    Jt = torch.stack([rows["Jt1"][..., fr, :], rows["Jt2"][..., fr, :]], -2)
    vt = torch.stack([rows["vt1"][..., fr], rows["vt2"][..., fr]], -1)
    # pyramid rows (F, 2 tangents, 2 signs, nv) -> (F*4, nv)
    Jpyr = Jn[..., :, None, None, :] + mu_f[..., None] * sgn[None, None, :, None] * Jt[..., :, :, None, :]
    vel = rows["vn"][..., fr][..., None, None] + mu_f * sgn[None, None, :] * vt[..., None]
    aref = base[..., fr][..., None, None] - rows["b_ref"][..., fr][..., None, None] * vel
    lead, F = Jn.shape[:-2], fr.shape[0]
    return (Jpyr.reshape(lead + (F * 4, Jn.shape[-1])), aref.reshape(lead + (F * 4,)),
            vel.reshape(lead + (F * 4,)))


class _Limit(NamedTuple):
    """One class of limit rows (the hinge/slide joints' or the tendons'):
    what both solvers read of it."""
    J: torch.Tensor          # (..., n, nv) = s E
    viol: torch.Tensor       # (..., n) distance past the range
    s_rate: torch.Tensor     # (..., n) s times the coordinate's rate
    active: torch.Tensor     # (..., n) 0/1
    kb: torch.Tensor
    br: torch.Tensor
    imp: Impedance
    invw: torch.Tensor


def _limit(x, rate, lo, hi, E, lim, kb, br, imp, invw) -> _Limit:
    below = torch.clamp(lo - x, min=0.0)
    above = torch.clamp(x - hi, min=0.0)
    viol = below + above
    s = torch.sign(below - above)
    return _Limit(s[..., :, None] * E, viol, s * rate, (viol > 0).to(x.dtype) * lim,
                  kb, br, imp, invw)


def limit_rows(rt: RowTables, qpos: torch.Tensor, qvel: torch.Tensor) -> list:
    """The joint-limit rows, then the tendon-limit rows, of the classes the
    model has; each solver forms aref and the regularizer from them."""
    out = []
    if rt.limits:
        out.append(_limit(qpos[..., rt.hs_qposadr], qvel[..., rt.hs_dofadr], rt.hs_lo, rt.hs_hi,
                          rt.hs_E, rt.hs_lim, rt.hs_kb, rt.hs_br, rt.hs_imp, rt.hs_invw))
    if rt.tendons:
        coef = rt.ten_coef
        qd = torch.zeros_like(qvel)
        qd[..., rt.hs_dofadr] = qpos[..., rt.hs_qposadr]
        out.append(_limit(mv(coef, qd), mv(coef, qvel), rt.ten_lo, rt.ten_hi, coef, rt.ten_lim,
                          rt.ten_kb, rt.ten_br, rt.ten_imp, rt.ten_invw))
    return out


def _block(rows, idx, dim, aref_n, R_n, imp_ratio, nv, qvel):
    """One elliptic block class: rows `idx` of the contact rows, `dim` each."""
    Jrows = [rows["JpN"], rows["Jt1"], rows["Jt2"], rows["JwN"], rows["Jwt1"], rows["Jwt2"]][:dim]
    vels = [rows["vn"], rows["vt1"], rows["vt2"]]
    if dim > 3:
        vels += [mv(rows["JwN"], qvel), mv(rows["Jwt1"], qvel), mv(rows["Jwt2"], qvel)]
    fri5 = rows["fri5"][..., idx, :]
    mu1 = torch.clamp(fri5[..., 0], min=1e-9)
    mus = fri5[..., :dim - 1]
    nb = idx.shape[0]
    Jb = torch.stack([Jr[..., idx, :] for Jr in Jrows], -2)
    lead = Jb.shape[:-3]
    # friction-dim aref = -b * v (no position term)
    aref_b = torch.cat([aref_n[..., idx][..., None]]
                       + [(-rows["b_ref"][..., idx] * v[..., idx])[..., None]
                          for v in vels[1:dim]], -1)
    ratio = (mu1[..., None] / torch.clamp(mus, min=1e-12)) ** 2
    R_b = torch.cat([R_n[..., idx][..., None], R_n[..., idx][..., None] * ratio / imp_ratio], -1)
    blk = dict(dim=dim, nb=nb, mu=mus, mu1=mu1)
    return blk, Jb.reshape(lead + (nb * dim, nv)), aref_b.reshape(lead + (-1,)), \
        R_b.reshape(lead + (-1,)), rows["active"][..., idx].repeat_interleave(dim, -1)


def build_rows(rt: RowTables, state, S: torch.Tensor) -> _Rows:
    """All constraint rows of the state, [ineq | friction | elliptic]:
    inequality rows are the frictionless contact normals, the pyramidal
    facets, then the joint and tendon limits. A state with a leading K axis
    gives rows with it: J (K, C, nv), the vectors (K, C)."""
    nv, h = rt.nv, rt.h
    qpos, qvel = state.qpos, state.qvel
    dtype, dev = qpos.dtype, qpos.device
    lead = qpos.shape[:-1]
    Js_i, arefs_i, Rs_i, act_i = [], [], [], []
    blocks, Js_b, arefs_b, Rs_b, act_b = [], [], [], [], []

    rows = collect_contact_rows(rt.ct, state, S) if rt.ct is not None else None
    if rows is not None:
        d_r = torch.clamp(rows["d_r"], _MINIMP, _MAXIMP)
        base = d_r * rows["k_base"] * rows["pen"]
        aref_n = _cap_aref(base - rows["b_ref"] * rows["vn"], rows["vn"], h)
        R_n = (1.0 - d_r) / d_r * torch.clamp(rows["invw"], min=1e-12)
        if rt.cone == 1:
            groups = rt.dims + ([(rt.ct.condim_self_max, rt.self_idx)] if rt.ct.n_self else [])
            for dim, idx in groups:
                if dim == 1:
                    Js_i.append(rows["JpN"][..., idx, :])
                    arefs_i.append(aref_n[..., idx])
                    Rs_i.append(R_n[..., idx])
                    act_i.append(rows["active"][..., idx])
                    continue
                blk, Jb, ab, Rb, actb = _block(rows, idx, dim, aref_n, R_n, rt.imp_ratio, nv,
                                               qvel)
                blocks.append(blk)
                Js_b.append(Jb)
                arefs_b.append(ab)
                Rs_b.append(Rb)
                act_b.append(actb)
        else:
            nf, fr = rt.nf, rt.fr
            if nf.shape[0]:
                Js_i.append(rows["JpN"][..., nf, :])
                arefs_i.append(aref_n[..., nf])
                Rs_i.append(R_n[..., nf])
                act_i.append(rows["active"][..., nf])
            if fr.shape[0]:
                J_p, aref_p, vel = pyramid_rows(rows, fr, rt.sgn, base)
                mu1 = rows["mu"][..., fr]
                # mj_diagApprox pyramid facet law
                R_pyr = ((1.0 - d_r[..., fr]) / d_r[..., fr]
                         * torch.clamp(rows["invw"][..., fr], min=1e-12)
                         * 2.0 * mu1 * mu1 * (1.0 + mu1 * mu1))
                Js_i.append(J_p)
                arefs_i.append(_cap_aref(aref_p, vel, h))
                Rs_i.append(R_pyr.repeat_interleave(4, -1))
                act_i.append(rows["active"][..., fr].repeat_interleave(4, -1))

    for lim in limit_rows(rt, qpos, qvel):
        d_l = torch.clamp(lim.imp(lim.viol), _MINIMP, _MAXIMP)
        Js_i.append(lim.J)
        arefs_i.append(d_l * lim.kb * lim.viol - lim.br * lim.s_rate)
        Rs_i.append((1.0 - d_l) / d_l * lim.invw)
        act_i.append(lim.active)

    Js_f, arefs_f, Rs_f = [], [], []
    if rt.n_fl:
        Js_f.append(rt.fl_E.expand(lead + rt.fl_E.shape))
        arefs_f.append(-rt.fl_bf * qvel[..., rt.fl_dofs])
        Rs_f.append(rt.fl_R.expand(lead + rt.fl_R.shape))

    def cat(parts, width=None):
        if parts:
            return torch.cat(parts, -1 if width is None else -2)
        return torch.zeros(lead + ((0,) if width is None else (0, width)), dtype=dtype, device=dev)

    J_i, J_f, J_b = cat(Js_i, nv), cat(Js_f, nv), cat(Js_b, nv)
    n_ineq, n_fric = J_i.shape[-2], J_f.shape[-2]
    J = torch.cat([J_i, J_f, J_b], -2)
    aref = torch.cat([cat(arefs_i), cat(arefs_f), cat(arefs_b)], -1)
    R = torch.clamp(torch.cat([cat(Rs_i), cat(Rs_f), cat(Rs_b)], -1), min=1e-14)
    active = torch.cat([cat(act_i), torch.ones(lead + (n_fric,), dtype=dtype, device=dev),
                        cat(act_b)], -1)
    out_blocks, off = [], n_ineq + n_fric
    for b in blocks:
        blk = dict(start=off, **b)
        blk["const"] = _block_constants(blk, R, active, rt.imp_ratio)
        out_blocks.append(blk)
        off += b["nb"] * b["dim"]
    fl = rt.fl if rt.n_fl else torch.zeros(0, dtype=dtype, device=dev)
    return _Rows(J=J, aref=aref, R=R, active=active, D=active / R, n_ineq=n_ineq,
                 n_fric=n_fric, fl=fl, blocks=tuple(out_blocks))


def _block_constants(blk, R, active, imp_ratio: float) -> dict:
    """The terms of one elliptic block class that depend on its rows only
    (not on u), formed once per solve."""
    nb, dim, start = blk["nb"], blk["dim"], blk["start"]
    sb = slice(start, start + nb * dim)
    shape = R.shape[:-1] + (nb, dim)
    Rb, mu = R[..., sb].reshape(shape), blk["mu1"]
    ab = active[..., sb].reshape(shape)[..., 0]
    return dict(ab=ab, scale=blk["mu"] / mu[..., None], Db=ab[..., None] / Rb,
                Rm=Rb[..., 0] * (1.0 + mu * mu / imp_ratio))


def _block_zone(blk, u: torch.Tensor, imp_ratio: float):
    """One elliptic block class at u: its zone masks and the terms its
    gradient and curvature share."""
    nb, dim, start = blk["nb"], blk["dim"], blk["start"]
    z = dict(blk["const"], ub=u[..., start:start + nb * dim].reshape(u.shape[:-1] + (nb, dim)),
             mu=blk["mu1"])
    mu = z["mu"]
    N = z["ub"][..., 0]
    z["up"] = z["ub"][..., 1:] * z["scale"]
    z["T"] = T = torch.sqrt(torch.sum(z["up"] * z["up"], -1) + 1e-24)
    z["top"] = N >= mu * T
    z["bottom"] = T * imp_ratio <= -mu * N
    z["wv"] = mu * T - N
    return z


def _block_grad(z, zero):
    g_bot = z["ub"] * z["Db"]
    mu, wv, Rm, T = z["mu"], z["wv"], z["Rm"], z["T"]
    g_mid_N = -wv / Rm
    g_mid_t = (mu * wv / (Rm * T))[..., None] * z["up"] * z["scale"]
    g_mid = torch.cat([g_mid_N[..., None], g_mid_t], -1) * z["ab"][..., None]
    return torch.where(z["top"][..., None], zero,
                       torch.where(z["bottom"][..., None], g_bot, g_mid))


def _sgrad(rows: _Rows, u: torch.Tensor, imp_ratio: float, want_hess: bool):
    """Zone gradients g = ds/du (..., C) and, with want_hess, the diagonal
    curvature w (..., C) and each block class's Hessians (..., nb, dim,
    dim). The row forces are f = -g."""
    D = rows.D
    dtype, lead = u.dtype, u.shape[:-1]
    ni, nf = rows.n_ineq, rows.n_fric
    gs, ws, Hblks = [], [], []
    Di, ui = D[..., :ni], u[..., :ni]
    neg = (ui < 0).to(dtype)
    gs.append(Di * ui * neg)
    if want_hess:
        ws.append(Di * neg)
    if nf:
        Df, uf = D[..., ni:ni + nf], u[..., ni:ni + nf]
        gs.append(torch.clamp(Df * uf, -rows.fl, rows.fl))
        if want_hess:
            ws.append(Df * (torch.abs(Df * uf) < rows.fl).to(dtype))
    zero = torch.zeros((), dtype=dtype, device=u.device) if rows.blocks else None
    for blk in rows.blocks:
        nb, dim = blk["nb"], blk["dim"]
        z = _block_zone(blk, u, imp_ratio)
        gs.append(_block_grad(z, zero).reshape(lead + (-1,)))
        if want_hess:
            mu, wv, Rm, T, sc = z["mu"], z["wv"], z["Rm"], z["T"], z["scale"]
            ws.append(torch.zeros(lead + (nb * dim,), dtype=dtype, device=u.device))
            eye_t = torch.eye(dim - 1, dtype=dtype, device=u.device)
            H_bot = torch.diag_embed(z["Db"])
            c = 1.0 / Rm
            us = z["up"] / T[..., None] * sc
            H_Nt = -(mu * c)[..., None] * us
            outer = us[..., :, None] * us[..., None, :]
            H_tt = ((mu * mu * c)[..., None, None] * outer
                    + (mu * wv / (Rm * T))[..., None, None]
                    * (eye_t * (sc * sc)[..., :, None] - outer))
            H_mid = torch.zeros(us.shape[:-1] + (dim, dim), dtype=dtype, device=u.device)
            H_mid[..., 0, 0] = c
            H_mid[..., 0, 1:] = H_Nt
            H_mid[..., 1:, 0] = H_Nt
            H_mid[..., 1:, 1:] = H_tt
            H_blk = torch.where(z["top"][..., None, None], zero,
                                torch.where(z["bottom"][..., None, None], H_bot, H_mid))
            Hblks.append(H_blk * z["ab"][..., None, None])
    cat = lambda parts: parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    if want_hess:
        return cat(gs), cat(ws), Hblks
    return cat(gs)


def _phi_deriv(rows: _Rows, u0, du, alpha, mMdx, c_lin, imp_ratio):
    """phi'(alpha) and phi''(alpha) along the search direction
    (c_lin = dx.M.(x-a0), mMdx = dx.M.dx, du = J dx). A block's curvature
    du.H.du is taken in closed form, without forming H: c (dN - mu us.dt)^2
    + k (|sc dt|^2 - (us.dt)^2) in the middle zone (c = 1/Rm, k = mu wv /
    (Rm T), us the unit tangent force direction times sc), sum Db du^2 at
    the bottom, 0 on top."""
    u = u0 + _col(alpha) * du
    dtype = u.dtype
    if u.dim() == 1:
        tot = lambda x, nd=1: torch.sum(x)
    else:
        tot = lambda x, nd=1: torch.sum(x, tuple(range(-nd, 0)))
    ni, nf = rows.n_ineq, rows.n_fric
    D = rows.D
    # rows of one class only (the humanoid's): no slicing
    Di, ui, dui = ((D, u, du) if ni == D.shape[-1]
                   else (D[..., :ni], u[..., :ni], du[..., :ni]))
    neg = (ui < 0).to(dtype)
    d1 = c_lin + alpha * mMdx + tot(Di * ui * neg * dui)
    d2 = mMdx + tot(Di * neg * dui * dui)
    if nf:
        Df, uf, duf = D[..., ni:ni + nf], u[..., ni:ni + nf], du[..., ni:ni + nf]
        d1 = d1 + tot(torch.clamp(Df * uf, -rows.fl, rows.fl) * duf)
        d2 = d2 + tot(Df * (torch.abs(Df * uf) < rows.fl).to(dtype) * duf * duf)
    zero = torch.zeros((), dtype=dtype, device=u.device) if rows.blocks else None
    for blk in rows.blocks:
        nb, dim, start = blk["nb"], blk["dim"], blk["start"]
        z = _block_zone(blk, u, imp_ratio)
        dub = du[..., start:start + nb * dim].reshape(du.shape[:-1] + (nb, dim))
        d1 = d1 + tot(_block_grad(z, zero) * dub, 2)
        mu, wv, Rm, T, sc = z["mu"], z["wv"], z["Rm"], z["T"], z["scale"]
        us = z["up"] / T[..., None] * sc
        dN, dt = dub[..., 0], dub[..., 1:]
        ust = torch.sum(us * dt, -1)
        mid = ((dN - mu * ust) ** 2 / Rm
               + mu * wv / (Rm * T) * (torch.sum(sc * sc * dt * dt, -1) - ust * ust))
        bot = torch.sum(z["Db"] * dub * dub, -1)
        q = torch.where(z["top"], zero, torch.where(z["bottom"], bot, mid * z["ab"]))
        d2 = d2 + tot(q)
    return d1, d2


def solve_qacc(rt: RowTables, M, a0, rows: _Rows, n_iter: int = 30, tol: float = 1e-12,
               early_exit: bool = False):
    """Newton-minimize the primal objective. Returns (qacc, f_rows,
    iterations taken): n_iter masked iterations, x frozen from the first at
    which |grad| <= tol * scale (the JAX while_loop's exit), so that nothing
    waits for the device. With early_exit the loop ends there instead, with
    the same result, at the cost of reading the flag back each iteration.
    A batch (a0 (K, nv), M (K, nv, nv), rows over K) freezes each sample
    at its own exit, and its early exit waits for the last sample."""
    dtype, dev = a0.dtype, a0.device
    lead = a0.shape[:-1]
    imp_ratio = rt.imp_ratio
    J, aref = rows.J, rows.aref
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    if lead:
        ridge = (1e-10 * torch.amax(diag, -1))[..., None, None]
        norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    else:
        ridge = 1e-10 * torch.max(diag)
        norm = torch.linalg.vector_norm
    eye = torch.eye(rt.nv, dtype=dtype, device=dev)
    scale = torch.clamp(norm(mv(M, a0)), min=1.0)

    def gradient(x, hess):
        u = mv(J, x) - aref
        out = _sgrad(rows, u, imp_ratio, hess)
        g = out[0] if hess else out
        grad = mv(M, x - a0) + mv(J.mT, g)
        if not hess:
            return grad
        _, w, Hblks = out
        H = M + (J.mT * w[..., None, :]) @ J + ridge * eye
        for blk, Hb in zip(rows.blocks, Hblks):
            nb, dim, start = blk["nb"], blk["dim"], blk["start"]
            Jb = J[..., start:start + nb * dim, :].reshape(lead + (nb, dim, rt.nv))
            H = H + torch.einsum("...bdi,...bde,...bej->...ij", Jb, Hb, Jb)
        return u, grad, H

    x = a0
    gn = norm(gradient(x, False))
    taken = torch.zeros(lead, dtype=torch.int32, device=dev)
    for _ in range(n_iter):
        go = gn > tol * scale
        if early_exit and not bool(go.any()):
            # converged: the remaining iterations would leave x, gn and taken
            # as they are
            break
        u, grad, H = gradient(x, True)
        dx = -cho_solve(H, grad)
        du = mv(J, dx)
        mMdx = _dot(dx, mv(M, dx))
        c_lin = _dot(dx, mv(M, x - a0))
        # safeguarded 1-D Newton on phi'(alpha) (phi convex, phi'' >= dx M dx)
        alpha = torch.ones(lead, dtype=dtype, device=dev)
        lo = torch.zeros(lead, dtype=dtype, device=dev)
        hi = torch.full(lead, 16.0, dtype=dtype, device=dev)
        for _ in range(12):
            d1, d2 = _phi_deriv(rows, u, du, alpha, mMdx, c_lin, imp_ratio)
            lo = torch.where(d1 < 0, alpha, lo)
            hi = torch.where(d1 > 0, alpha, hi)
            step = alpha - d1 / torch.clamp(d2, min=1e-30)
            inside = (step > lo) & (step < hi)
            alpha = torch.where(inside, step, 0.5 * (lo + hi))
        x_new = x + _col(alpha) * dx
        gn_new = norm(gradient(x_new, False))
        x = torch.where(_col(go), x_new, x)
        gn = torch.where(go, gn_new, gn)
        taken = taken + go.to(torch.int32)
    u = mv(J, x) - aref
    return x, -_sgrad(rows, u, imp_ratio, False), taken


def newton_constraint_forces(eng, state, S, a0, M, n_iter: int = 30,
                             info: Optional[dict] = None,
                             early_exit: bool = False) -> torch.Tensor:
    """Coupled constraint solve by primal Newton: tau (..., nv) = J^T f,
    the generalized constraint force (mj qfrc_constraint analog), for one
    sample or a K batch. `info`, when a dict, receives "iterations" (device
    int, (K,) for a batch), "rows" (the row count) and "active_rows"
    (device). `early_exit` as solve_qacc's."""
    rows = build_rows(eng.rows, state, S)
    if rows.J.shape[-2] == 0:
        return torch.zeros_like(a0)
    _, f, taken = solve_qacc(eng.rows, M, a0, rows, n_iter=n_iter, early_exit=early_exit)
    if info is not None:
        info.update(iterations=taken, rows=rows.J.shape[-2], active_rows=rows.active.sum(-1))
    return mv(rows.J.mT, f)
