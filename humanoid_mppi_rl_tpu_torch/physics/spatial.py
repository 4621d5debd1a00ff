"""Quaternion and 6D spatial-vector algebra (physics/spatial.py counterpart).

Conventions
-----------
- Quaternions are (w, x, y, z), matching MuJoCo.
- Spatial (Plucker) vectors are 6D ``[angular(3); linear(3)]`` in the world
  frame with the moment taken about the world origin. A rigid body with
  angular velocity ``w`` whose body-fixed point at the world origin moves
  with velocity ``v0`` has spatial velocity ``[w; v0]``; the body-fixed point
  at world position ``p`` moves with ``v0 + w x p``.
- Spatial forces are ``[torque-about-origin(3); force(3)]``.

Every function takes leading batch dimensions and builds no constant from
host data, so nothing here copies to the device or waits for it.
"""

from __future__ import annotations

import math

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, broadcasting the leading ones."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_mul(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*p."""
    w1, x1, y1, z1 = torch.movedim(q, -1, 0)
    w2, x2, y2, z2 = torch.movedim(p, -1, 0)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q (active rotation, world = R(q) @ body)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for rotation of `angle` about unit `axis`."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def quat_log(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation vector (axis * angle, folded to [-pi, pi]) of a unit
    quaternion: MuJoCo mju_quat2Vel at dt=1, in the local frame."""
    w = q[..., 0]
    im = q[..., 1:]
    sin_half = torch.linalg.vector_norm(im, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
    axis = im / torch.clamp(sin_half, min=eps)[..., None]
    return axis * angle[..., None]


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """MuJoCo mju_subQuat: the local rotation vector taking qb to qa."""
    return quat_log(quat_mul(quat_conj(qb), qa))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) from quaternion."""
    w, x, y, z = torch.movedim(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_integrate(q: torch.Tensor, omega_local: torch.Tensor, h: float) -> torch.Tensor:
    """Integrate a quaternion by local-frame angular velocity over time h
    (MuJoCo mju_quatIntegrate, the exponential map q' = q * exp(h w / 2)).
    sqrt(|w|^2 + 1e-24) and sin(half)/angle keep it smooth at w = 0."""
    a2 = torch.sum(omega_local * omega_local, dim=-1, keepdim=True)
    angle = torch.sqrt(a2 + 1e-24)
    half = 0.5 * h * angle
    sinc = torch.sin(half) / angle
    dq = torch.cat([torch.cos(half), omega_local * sinc], dim=-1)
    return quat_normalize(quat_mul(q, dq))


# ---------------------------------------------------------------------------
# 3D / spatial helpers
# ---------------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix: skew(v) @ u = v x u."""
    x, y, z = torch.movedim(v, -1, 0)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def motion_cross(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v1 x v2 (both motion vectors [w; v])."""
    w1, l1 = v1[..., :3], v1[..., 3:]
    w2, l2 = v2[..., :3], v2[..., 3:]
    return torch.cat([cross(w1, w2), cross(w1, l2) + cross(l1, w2)], dim=-1)


def motion_cross_force(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f (motion v=[w;vl], force f=[n;fl])."""
    w, vl = v[..., :3], v[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(vl, fl), cross(w, fl)], dim=-1)


def spatial_inertia_origin(mass: torch.Tensor, inertia_diag: torch.Tensor,
                           com_world: torch.Tensor, rot_world: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about the world origin, ordering [w; v0]:

        I^O = [[ I_c - m cx cx,  m cx ],
               [     -m cx,      m 1  ]]

    with cx = skew(com) and I_c = R diag(i) R^T; mass (...,), inertia_diag
    and com_world (..., 3), rot_world (..., 3, 3)."""
    R = rot_world
    Ic = torch.einsum("...ij,...j,...kj->...ik", R, inertia_diag, R)
    cx = skew(com_world)
    m = mass[..., None, None].expand(cx.shape[:-2] + (1, 1))
    eye = torch.eye(3, dtype=Ic.dtype, device=Ic.device)
    top = torch.cat([Ic - m * (cx @ cx), m * cx], dim=-1)
    bot = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def force_at_point(force: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Spatial force [torque_about_origin; force] of a pure force applied at
    world point `point`."""
    return torch.cat([cross(point, force), force], dim=-1)
