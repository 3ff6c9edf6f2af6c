"""Quaternion / SO(3) utilities, the port of ``mini_opt_tpu/utils/so3.py``
(so3.py:21-205) that the transform chains, IK and the SE(3) graphs use.

Quaternions are ``(..., 4)`` tensors in ``[w, x, y, z]`` layout; every
function works in any float dtype and on any leading shape, and under
``torch.func.vmap``. Euler convention as the reference: ``XYZ`` means
``R = Rx(a) @ Ry(b) @ Rz(c)``, and rotation derivatives are in the right
(body-frame) tangent of SO(3): ``dR = R @ skew(w)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops._common import _div


def quat_identity(dtype=torch.float64, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_multiply(q1, q2):
    """Hamilton product q1 * q2 (wxyz layout)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion q: R(q) @ v."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    # v' = v + 2w (u x v) + 2 u x (u x v)
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q):
    """Rotation matrix of q; shape (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_exp(w):
    """Exponential map so(3) -> SO(3) as a quaternion (wxyz), with the
    Taylor branch near zero."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta_sq, torch.finfo(w.dtype).tiny))
    small = theta_sq < 1e-16
    half = 0.5 * theta
    # sin(t/2)/t with Taylor fallback 0.5 - t^2/48
    k = torch.where(
        small, 0.5 - _div(theta_sq, 48.0), torch.sin(half) / torch.where(small, torch.ones_like(theta), theta)
    )
    return torch.cat([torch.cos(half), k * w], dim=-1)


def quat_log(q):
    """Log map SO(3) -> so(3): rotation vector of q (wxyz layout)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # the short arc
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    vn_sq = torch.sum(v * v, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp_min(vn_sq, torch.finfo(q.dtype).tiny))
    angle = 2.0 * torch.atan2(vn, w)
    small = vn_sq < 1e-24
    one = torch.ones_like(w)
    scale = torch.where(small, 2.0 / torch.where(small, one, w), angle / torch.where(small, one, vn))
    return scale * v


def skew3(v):
    """Skew-symmetric cross-product matrix [v]_x, shape (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def mod_pi(angle):
    """Wrap angle(s) into (-pi, pi]. The whole turns subtracted are
    detached: their derivative is zero, and under ``torch.func.jacfwd`` a
    Python scalar times floor's zero tangent comes out float64, which would
    turn a float32 Jacobian into float64."""
    turns = torch.floor(_div(angle + math.pi, 2.0 * math.pi)).detach()
    return angle - 2.0 * math.pi * turns


def _axis_quat(angle, axis: int):
    half = 0.5 * angle
    c, s = torch.cos(half), torch.sin(half)
    z = torch.zeros_like(angle)
    parts = [c, z, z, z]
    parts[1 + axis] = s
    return torch.stack(parts, dim=-1)


class SO3FromEulerAngles(NamedTuple):
    """Rotation from XYZ euler angles and the Jacobian of the SO(3) right
    tangent with respect to the angles (math::SO3FromEulerAngles_)."""

    q: torch.Tensor  # (..., 4)
    rotation_D_angles: torch.Tensor  # (..., 3, 3)


def quat_from_euler_angles_xyz(angles_xyz):
    """The quaternion of R = Rx(a) @ Ry(b) @ Rz(c) alone (the ``q`` of
    so3_from_euler_angles_xyz, by the same operations)."""
    a, b, c = angles_xyz[..., 0], angles_xyz[..., 1], angles_xyz[..., 2]
    return quat_multiply(_axis_quat(a, 0), quat_multiply(_axis_quat(b, 1), _axis_quat(c, 2)))


def so3_from_euler_angles_xyz(angles_xyz) -> SO3FromEulerAngles:
    """R = Rx(a) @ Ry(b) @ Rz(c) and d(right tangent)/d(angles): for XYZ
    order the columns are (Ry Rz)^T e_x, Rz^T e_y and e_z."""
    b, c = angles_xyz[..., 1], angles_xyz[..., 2]
    q = quat_from_euler_angles_xyz(angles_xyz)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    zeros = torch.zeros_like(b)
    ones = torch.ones_like(b)
    col_a = torch.stack([cb * cc, -cb * sc, sb], dim=-1)
    col_b = torch.stack([sc, cc, zeros], dim=-1)
    col_c = torch.stack([zeros, zeros, ones], dim=-1)
    return SO3FromEulerAngles(q=q, rotation_D_angles=torch.stack([col_a, col_b, col_c], dim=-1))


def euler_angles_xyz_from_quat(q):
    """Inverse of so3_from_euler_angles_xyz: (a, b, c) with
    R = Rx(a) Ry(b) Rz(c), valid away from cos(b) = 0."""
    r = quat_to_matrix(q)
    b = torch.asin(torch.clamp(r[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-r[..., 1, 2], r[..., 2, 2])
    c = torch.atan2(-r[..., 0, 1], r[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def quat_from_matrix(R):
    """Quaternion (w, x, y, z) of rotation matrices ``(..., 3, 3)``, the
    branchless Shepperd method: all four candidate quaternions (one per
    largest component), the one of the largest diagonal combination picked
    by a one-hot product, the w >= 0 representative, normalized. Exact at
    180-degree rotations, where the trace formula divides by ~0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    lead = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], dim=-1)
    cands = torch.stack(
        [
            torch.stack([lead[..., 0], m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, lead[..., 1], m01 + m10, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m01 + m10, lead[..., 2], m12 + m21], dim=-1),
            torch.stack([m10 - m01, m02 + m20, m12 + m21, lead[..., 3]], dim=-1),
        ],
        dim=-2,
    )  # (..., 4, 4); candidate k has leading term 4 q_k^2
    sel = torch.nn.functional.one_hot(torch.argmax(lead, dim=-1), 4).to(R.dtype)
    q = torch.matmul(sel[..., None, :], cands)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -torch.ones_like(q[..., :1]), torch.ones_like(q[..., :1]))
    return q / torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), torch.finfo(R.dtype).tiny))
