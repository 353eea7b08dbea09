"""Quaternion / rotation library in PyTorch (wxyz, like MuJoCo).

Port of `gym_kmanip_tpu/utils/rotations.py`. Every torch function works on
the last axis and broadcasts over leading batch dimensions. The `*_np`
twins are float64 numpy versions for the host-side model loader.
"""

import numpy as np
import torch

_EPS = 1e-12


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit length."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (wxyz)."""
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


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product on the last axis, broadcasting like `jnp.cross`."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (body->world)."""
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


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse for (approximately) unit quaternions."""
    return quat_conj(q)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q: R(q)^T @ v."""
    return quat_rotate(quat_conj(q), v)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (wxyz), MuJoCo's mju_mat2Quat.

    Branch-free like the JAX version: the four Shepperd candidates, the one
    with the largest pivot selected per matrix, normalized, w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    case = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(case == 0, qw, torch.where(case == 1, qx, torch.where(case == 2, qy, qz)))
    q = normalize(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Log map: unit quaternion -> rotation vector (angle * axis), the angle
    wrapped to (-pi, pi]; near the identity angle/|v| -> 2/w (the JAX
    version's branches)."""
    w = q[..., 0]
    v = q[..., 1:]
    sq = torch.sum(v * v, dim=-1)
    small = sq < 1e-14
    vn = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    angle = 2.0 * torch.atan2(vn, w)
    angle = torch.where(angle > torch.pi, angle - 2 * torch.pi, angle)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / vn)
    return v * scale[..., None]


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """3D velocity v with qb ⊗ exp(v/2) = qa, in qb's local frame (MuJoCo's
    mju_subQuat)."""
    return quat_log(quat_mul(quat_conj(qb), qa))


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate unit quaternion by world-frame angular velocity omega*dt.

    Keeps the small-angle Taylor branch (and the double-where safe norm)
    of the JAX version, so the result is smooth at omega = 0."""
    rot = omega * dt
    sq = torch.sum(rot * rot, dim=-1, keepdim=True)
    small = sq < 1e-14
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    scale = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    dq = torch.cat([w, scale * rot], dim=-1)
    return normalize(quat_mul(dq, q))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit quaternion for rotation of `angle` radians about unit `axis`."""
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def euler_xyz_to_quat(euler: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles -> quaternion: R = Rz(e2) Ry(e1) Rx(e0)."""
    ex, ey, ez = euler.unbind(-1)
    one, zero = torch.ones_like(ex), torch.zeros_like(ex)
    qx = quat_from_axis_angle(torch.stack([one, zero, zero], -1), ex)
    qy = quat_from_axis_angle(torch.stack([zero, one, zero], -1), ey)
    qz = quat_from_axis_angle(torch.stack([zero, zero, one], -1), ez)
    return quat_mul(qz, quat_mul(qy, qx))


def euler_seq_to_quat(euler: torch.Tensor) -> torch.Tensor:
    """MJCF <body euler="...">: MuJoCo's default eulerseq="xyz" is extrinsic
    x-y-z, as `euler_xyz_to_quat`."""
    return euler_xyz_to_quat(euler)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> extrinsic x-y-z Euler angles (scipy "xyz" convention)."""
    m = quat_to_mat(q)
    ex = torch.atan2(m[..., 2, 1], m[..., 2, 2])
    ey = torch.asin(torch.clamp(-m[..., 2, 0], -1.0, 1.0))
    ez = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    return torch.stack([ex, ey, ez], dim=-1)


# ---- float64 numpy twins for the host-side model loader ----


def quat_mul_np(a, b) -> np.ndarray:
    w1, x1, y1, z1 = np.asarray(a, dtype=np.float64)
    w2, x2, y2, z2 = np.asarray(b, dtype=np.float64)
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def quat_rotate_np(q, v) -> np.ndarray:
    w = float(q[0])
    u = np.asarray(q[1:], dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_to_mat_np(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, dtype=np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def euler_xyz_to_quat_np(e) -> np.ndarray:
    ex, ey, ez = np.asarray(e, dtype=np.float64)
    qx = np.array([np.cos(0.5 * ex), np.sin(0.5 * ex), 0.0, 0.0])
    qy = np.array([np.cos(0.5 * ey), 0.0, np.sin(0.5 * ey), 0.0])
    qz = np.array([np.cos(0.5 * ez), 0.0, 0.0, np.sin(0.5 * ez)])
    return quat_mul_np(qz, quat_mul_np(qy, qx))
