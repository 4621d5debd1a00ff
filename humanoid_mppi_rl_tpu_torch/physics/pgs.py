"""The legacy dual constraint solver, step(solver="coupled_pgs") (JAX
physics/engine.py `_coupled_constraint_terms`): MuJoCo's regularized
constraint QP over the pyramidal contact rows and the joint and tendon
limit rows,

    f = argmin_{f >= 0}  1/2 f^T (A + R) f - f^T (aref - J qacc0),

A = J M^-1 J^T and R = (1 - d)/d diagApprox, solved by n_iter sweeps of a
4-colour projected Gauss-Seidel (the rows of one pyramid slot update
together, each divided by its same-slot active |A| row sum), then four
block-pivoting active-set steps (a masked Cholesky solve on the working
set with a small ridge), keeping whichever of the two has the lower
objective. The forces are applied explicitly, tau = J^T f.

As in the JAX tier: contact rows are capped at the planner's restitution
cap (RESTITUTION_VCAP), limit rows are not; every self row takes pyramid
facets; the contact rows' aref uses the impedance before its clamp; the
dof frictionloss stays the passive tanh. A masked solve whose matrix is
not positive definite gives NaN, as jax's Cholesky does, so the objective
test keeps the sweeps' forces. One sample, or a state with a leading K
axis.
"""

from __future__ import annotations

import numpy as np
import torch

from .contact import RESTITUTION_VCAP, collect_contact_rows
from .newton import _MAXIMP, _MINIMP, limit_rows, mv, pyramid_rows


class PGSTables:
    """The static half of the solve for one engine: the contact rows'
    frictionless and pyramid index sets and every row's pyramid slot."""

    def __init__(self, eng):
        m = eng.model
        if np.any(m.tendon_limited[m.spatial_tendon_ids]):
            # JAX keeps this legacy tier for triage only
            raise NotImplementedError(
                "spatial-tendon limits unsupported in the coupled_pgs tier (use the default "
                "coupled/newton or penalty tier)")
        ct, rt = eng.contact, eng.rows
        ix = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=eng.device)
        slots = []
        self.nf = self.fr = None
        if ct is not None and ct.n_plane + ct.n_self:
            mu = np.asarray(ct.mu_plane_static, dtype=np.float64)
            fr = np.concatenate([np.nonzero(mu > 0)[0], ct.n_plane + np.arange(ct.n_self)])
            nf = np.nonzero(mu == 0)[0]
            self.nf, self.fr = ix(nf), ix(fr)
            slots += [np.zeros(nf.size, np.int64), np.tile(np.arange(4), fr.size)]
        if rt.limits:
            slots.append(np.zeros(rt.hs_lo.shape[0], np.int64))
        if rt.tendons:
            slots.append(np.zeros(rt.ten_lo.shape[0], np.int64))
        slot = np.concatenate(slots) if slots else np.zeros(0, np.int64)
        self.n_rows = slot.size
        self.slot = ix(slot)
        self.slots = sorted(set(slot.tolist()))
        self.same_slot = torch.as_tensor(slot[:, None] == slot[None, :], dtype=eng.dtype,
                                         device=eng.device)


def _factor(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of A, NaN where A is not positive
    definite (jax.scipy's cho_factor)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def _solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B from A's lower Cholesky factor L, B (..., n, m)."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def pgs_constraint_forces(eng, state, S, L0: torch.Tensor, qacc0: torch.Tensor,
                          n_iter: int = 25) -> torch.Tensor:
    """tau (..., nv) = J^T f for the coupled_pgs rows of `state`, given
    M's lower Cholesky factor L0 and the smooth acceleration qacc0."""
    pt, rt = eng.pgs, eng.rows
    lead, h = state.qpos.shape[:-1], eng.h
    if pt.n_rows == 0:
        return torch.zeros_like(qacc0)
    cap = lambda aref, v: torch.minimum(aref, torch.clamp((RESTITUTION_VCAP - v) / h, min=0.0))
    Js, arefs, imps, actives, dapx = [], [], [], [], []
    if pt.nf is not None:
        rows = collect_contact_rows(eng.contact, state, S)
        kb, br, pen, d_r = rows["k_base"], rows["b_ref"], rows["pen"], rows["d_r"]
        base = d_r * kb * pen
        nf, fr = pt.nf, pt.fr
        if nf.shape[0]:
            vn = rows["vn"][..., nf]
            Js.append(rows["JpN"][..., nf, :])
            arefs.append(cap(base[..., nf] - br[..., nf] * vn, vn))
            imps.append(d_r[..., nf])
            actives.append(rows["active"][..., nf])
            dapx.append(rows["invw"][..., nf].expand(lead + nf.shape))
        if fr.shape[0]:
            J_p, aref_p, vel = pyramid_rows(rows, fr, rt.sgn, base)
            rep = lambda x: x[..., fr].repeat_interleave(4, -1)
            mu1 = rows["mu"]
            Js.append(J_p)
            arefs.append(cap(aref_p, vel))
            imps.append(rep(d_r))
            actives.append(rep(rows["active"]))
            # the pyramid facet's diagApprox: invw0 2 mu^2 (1 + mu^2)
            d = rep(rows["invw"] * 2.0 * mu1 * mu1 * (1.0 + mu1 * mu1))
            dapx.append(d.expand(lead + d.shape[-1:]))
    for lim in limit_rows(rt, state):
        d_l = lim.imp(lim.viol)
        Js.append(lim.J)
        arefs.append(d_l * lim.kb * lim.viol - lim.br * lim.s_rate)
        imps.append(d_l)
        actives.append(lim.active)
        dapx.append(lim.invw.expand(lead + lim.invw.shape))

    J = torch.cat(Js, -2)
    aref = torch.cat(arefs, -1)
    d_all = torch.clamp(torch.cat(imps, -1), _MINIMP, _MAXIMP)
    active = torch.cat(actives, -1)
    Amat = J @ _solve(L0, J.mT)                      # J M^-1 J^T
    Adiag = torch.clamp(torch.diagonal(Amat, dim1=-2, dim2=-1), min=1e-10)
    R = (1.0 - d_all) / d_all * torch.clamp(torch.cat(dapx, -1), min=1e-12)
    rhs = aref - mv(J, qacc0)
    D = torch.maximum(torch.sum(torch.abs(Amat) * pt.same_slot * active[..., None, :], -1),
                      Adiag) + R

    f = torch.zeros_like(rhs)
    for _ in range(n_iter):
        # a slot no row takes leaves f as it is
        for s in pt.slots:
            resid = rhs - mv(Amat, f) - R * f
            fs = torch.clamp(f + resid / D, min=0.0) * active
            f = torch.where(pt.slot == s, fs, f)

    H = Amat + torch.diag_embed(R)
    ridge = 1e-9 * torch.amax(Adiag, -1)
    Sw = active * (f > 0.0).to(f.dtype)
    fp = f
    for _ in range(4):
        Hm = Sw[..., :, None] * Sw[..., None, :] * H + torch.diag_embed(1.0 - Sw + ridge[..., None])
        fs = _solve(_factor(Hm), (Sw * rhs)[..., None])[..., 0]
        fp = torch.clamp(fs, min=0.0) * active
        grad = mv(H, fp) - rhs
        Sw = active * ((fs > 0.0) | (grad < 0.0)).to(f.dtype)
    obj = lambda x: 0.5 * torch.sum(x * mv(H, x), -1) - torch.sum(x * rhs, -1)
    keep = obj(fp) < obj(f)
    f = torch.where(keep[..., None] if lead else keep, fp, f)
    return mv(J.mT, f)
