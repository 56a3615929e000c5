"""SO3 / SE3 Lie-group operations on torch tensors.

Counterpart of ``nerf_vo_tpu/core/lie.py``. Storage convention (lietorch's):
an SE3 element is a 7-vector ``[tx, ty, tz, qx, qy, qz, qw]`` (translation +
unit quaternion, scalar-last); a tangent vector is a 6-vector ``[rho, phi]``,
translation first.

Every function broadcasts over leading batch dimensions and is safe under
``torch.func`` transforms: the small-angle branches are Taylor expansions
selected with ``torch.where`` on numerically safe operands.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _stack(xs, dim=-1):
    return torch.stack(xs, dim=dim)


# ---------------------------------------------------------------------------
# quaternion primitives (scalar-last [x, y, z, w])
# ---------------------------------------------------------------------------

def quat_identity(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(q1, q2):
    """Hamilton product, scalar-last."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return _stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by unit quaternion(s) q."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    uv = torch.linalg.cross(qv, v, dim=-1)
    uuv = torch.linalg.cross(qv, uv, dim=-1)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = _stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ])
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Rotation matrix -> scalar-last quaternion (Shepperd's method, branchless)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidate solutions, one per largest diagonal element / trace
    qw0 = torch.sqrt((1.0 + tr).clamp(min=_EPS)) / 2.0
    c0 = _stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0]) / (
        4.0 * qw0[..., None]
    )
    qx1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp(min=_EPS)) / 2.0
    c1 = _stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12]) / (
        4.0 * qx1[..., None]
    )
    qy2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp(min=_EPS)) / 2.0
    c2 = _stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20]) / (
        4.0 * qy2[..., None]
    )
    qz3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp(min=_EPS)) / 2.0
    c3 = _stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01]) / (
        4.0 * qz3[..., None]
    )

    best = torch.argmax(_stack([tr, m00, m11, m22]), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., 3:4] < 0, -q, q)  # canonical w >= 0 hemisphere
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

def so3_hat(phi):
    """3-vector -> skew-symmetric matrix."""
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    m = _stack([zero, -z, y, z, zero, -x, -y, x, zero])
    return m.reshape(phi.shape[:-1] + (3, 3))


def so3_exp_quat(phi):
    """SO3 exponential map -> quaternion (scalar-last)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq.clamp(min=_EPS))
    small = theta_sq < 1e-8
    half = 0.5 * theta
    # sin(x/2)/x with Taylor fallback
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([phi * k, w], dim=-1)


def so3_log(q):
    """Quaternion -> rotation vector (axis * angle)."""
    q = torch.where(q[..., 3:4] < 0, -q, q)  # canonical hemisphere
    qv = q[..., :3]
    qw = q[..., 3:4].clamp(-1.0, 1.0)
    n_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    n = torch.sqrt(n_sq.clamp(min=_EPS))
    angle = 2.0 * torch.atan2(n, qw)
    small = n_sq < 1e-12
    k = torch.where(small, 2.0 / qw.clamp(min=_EPS), angle / n)
    return qv * k


def so3_left_jacobian(phi):
    """Left Jacobian J_l of SO3: exp((phi + dphi)^) ≈ exp(J_l dphi ^) exp(phi^)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq.clamp(min=_EPS))
    small = theta_sq < 1e-8
    Phi = so3_hat(phi)
    Phi2 = Phi @ Phi
    a = torch.where(
        small, 0.5 - theta_sq / 24.0,
        (1 - torch.cos(theta)) / theta_sq.clamp(min=_EPS),
    )
    b = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (theta_sq * theta).clamp(min=_EPS),
    )
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return eye + a[..., None, None] * Phi + b[..., None, None] * Phi2


# ---------------------------------------------------------------------------
# SE3 — 7-vector [t(3), q(4)]
# ---------------------------------------------------------------------------

def se3_identity(shape=(), dtype=torch.float32, device=None):
    g = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    return g


def se3_t(g):
    return g[..., :3]


def se3_q(g):
    return g[..., 3:7]


def se3_make(t, q):
    batch = torch.broadcast_shapes(t.shape[:-1], q.shape[:-1])
    return torch.cat(
        [t.expand(batch + (3,)), q.expand(batch + (4,))], dim=-1
    )


def se3_inv(g):
    q_inv = quat_conj(se3_q(g))
    t_inv = -quat_rotate(q_inv, se3_t(g))
    return se3_make(t_inv, q_inv)


def se3_mul(g1, g2):
    """Group composition g1 * g2 (apply g2 first, then g1)."""
    q = quat_mul(se3_q(g1), se3_q(g2))
    t = se3_t(g1) + quat_rotate(se3_q(g1), se3_t(g2))
    return se3_make(t, quat_normalize(q))


def se3_act(g, p):
    """Apply SE3 transform to 3D point(s)."""
    return quat_rotate(se3_q(g), p) + se3_t(g)


def se3_matrix(g):
    """7-vector -> homogeneous 4x4 matrix."""
    R = quat_to_matrix(se3_q(g))
    t = se3_t(g)[..., None]
    top = torch.cat([R, t], dim=-1)
    # made on the device (no host copy, so a CUDA graph can hold it)
    bottom = g.new_zeros(g.shape[:-1] + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(m):
    return se3_make(m[..., :3, 3], matrix_to_quat(m[..., :3, :3]))


def se3_exp(xi):
    """SE3 exponential map. xi = [rho(3), phi(3)] -> 7-vector."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    t = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    return se3_make(t, q)


def se3_log(g):
    """SE3 logarithm map -> [rho(3), phi(3)]."""
    phi = so3_log(se3_q(g))
    Jl = so3_left_jacobian(phi)
    rho = torch.linalg.solve(Jl, se3_t(g)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_retract(g, xi):
    """Left-multiplicative retraction: exp(xi) * g  (matches lietorch retr)."""
    return se3_mul(se3_exp(xi), g)


def se3_normalize(g):
    return se3_make(se3_t(g), quat_normalize(se3_q(g)))


def se3_interp(g0, g1, alpha):
    """Geodesic interpolation between two SE3 elements (slerp-style)."""
    xi = se3_log(se3_mul(se3_inv(g0), g1))
    return se3_mul(g0, se3_exp(alpha[..., None] * xi))


def se3_adjoint(g):
    """6x6 adjoint matrix of an SE3 element (tangent [rho, phi] convention)."""
    R = quat_to_matrix(se3_q(g))
    tR = so3_hat(se3_t(g)) @ R
    top = torch.cat([R, tR], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)
