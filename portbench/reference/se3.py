"""Batched SE(3) operations on quaternion+translation tensors.

PyTorch port of `gmmloc_tpu/geometry/se3.py`. A pose is a pair
    q : (..., 4)  unit quaternion, Hamilton convention, (w, x, y, z)
    t : (..., 3)  translation
mapping points as x' = R(q) @ x + t. The se(3) tangent convention matches
g2o::SE3Quat::log/exp: xi = [omega, upsilon] (rotation first),
t = V(omega) @ upsilon. Every function broadcasts over leading dims.
"""

from __future__ import annotations

import torch


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q):
    # the sign flip as a negation (no host-made tensor: capturable in a CUDA graph)
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def quat_rotate(q, v):
    """Rotate vectors v (...,3) by quaternions q (...,4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    uv = cross(qv, v)
    uuv = cross(qv, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q):
    w, x, y, z = q.unbind(-1)
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
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix (...,3,3) -> quaternion (w,x,y,z), Shepperd's
    method, branch-free by selecting the max-trace candidate."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(s, a, b, c, d):
        return torch.stack([a / s, b / s, c / s, d / s], -1)

    s = torch.sqrt(torch.clamp(tr + 1.0, min=1e-12)) * 2.0
    qw = cand(s, 0.25 * s * s, m21 - m12, m02 - m20, m10 - m01)
    s = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    qx = cand(s, m21 - m12, 0.25 * s * s, m01 + m10, m02 + m20)
    s = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=1e-12)) * 2.0
    qy = cand(s, m02 - m20, m01 + m10, 0.25 * s * s, m12 + m21)
    s = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=1e-12)) * 2.0
    qz = cand(s, m10 - m01, m02 + m20, m12 + m21, 0.25 * s * s)
    use_w = tr > 0.0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = torch.where(
        use_w[..., None], qw,
        torch.where(use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)),
    )
    return quat_normalize(q)


def identity(dtype=torch.float32, device=None):
    return quat_identity(dtype, device), torch.zeros(3, dtype=dtype, device=device)


def compose(qa, ta, qb, tb):
    """(qa,ta) * (qb,tb): apply b first, then a."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def apply(q, t, x):
    """Map points x (...,3)."""
    return quat_rotate(q, x) + t


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], z, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], z], -1),
        ],
        dim=-2,
    )


def so3_exp(omega):
    """Rodrigues: omega (...,3) -> quaternion."""
    theta2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    half = 0.5 * theta
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    s = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return quat_normalize(torch.cat([w, omega * s], dim=-1))


def so3_log(q):
    """Quaternion -> rotation vector omega (...,3)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-9
    scale = torch.where(
        small, 2.0 / torch.clamp(w, min=1e-9), theta / torch.clamp(vn, min=1e-24)
    )
    return v * scale


def _eye3_like(om):
    return torch.eye(3, dtype=om.dtype, device=om.device).expand(om.shape)


def _v_matrix(omega):
    """Left Jacobian V(omega) of SO(3) (g2o SE3 exp convention)."""
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    Om = skew(omega)
    Om2 = Om @ Om
    small = theta2 < 1e-12
    a = torch.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24),
    )
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-24),
    )
    return _eye3_like(Om) + a * Om + b * Om2


def _v_matrix_inv(omega):
    theta2 = torch.sum(omega * omega, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    Om = skew(omega)
    Om2 = Om @ Om
    small = theta2 < 1e-12
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * theta * torch.cos(0.5 * theta)
         / torch.clamp(torch.sin(0.5 * theta), min=1e-24))
        / torch.clamp(theta2, min=1e-24),
    )
    return _eye3_like(Om) - 0.5 * Om + coef * Om2


def exp(xi):
    """se(3) exp, g2o convention: xi = [omega, upsilon] (...,6)."""
    omega, upsilon = xi[..., :3], xi[..., 3:]
    q = so3_exp(omega)
    t = torch.einsum("...ij,...j->...i", _v_matrix(omega), upsilon)
    return q, t


def log(q, t):
    """SE3 -> [omega, upsilon] (...,6), inverse of exp."""
    omega = so3_log(q)
    upsilon = torch.einsum("...ij,...j->...i", _v_matrix_inv(omega), t)
    return torch.cat([omega, upsilon], dim=-1)


def adjoint(q, t):
    """Adjoint for xi=[omega, upsilon]: (...,6,6),
    Ad * [w;u] = [R w ; skew(t) R w + R u]."""
    R = quat_to_matrix(q)
    Z = torch.zeros_like(R)
    top = torch.cat([R, Z], dim=-1)
    bot = torch.cat([skew(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def boxplus(q, t, xi):
    """Left-multiplicative update exp(xi) * (q,t), quaternion renormalized
    (f32 iteration chains drift the norm)."""
    dq, dt = exp(xi)
    qn, tn = compose(dq, dt, q, t)
    qn = qn / torch.linalg.norm(qn, dim=-1, keepdim=True)
    return qn, tn
