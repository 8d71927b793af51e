"""Quaternion math, xyzw convention, batched over arbitrary leading axes.

Port of test_isaacgym_tpu/math/quat.py, function for function and in the
same order of operations, so both packages round alike. The reference
framework uses xyzw quaternions throughout (the reference's
examples/maths.py:39-41 and the scipy `R.from_quat` interop of every
controller).

Shapes: every function accepts `(..., 4)` quats / `(..., 3)` vectors and
broadcasts over leading axes — the env/actor batch dims of the simulator.
"""
from __future__ import annotations

import torch


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def quat_identity(shape=(), dtype=torch.float32, device="cuda"):
    """Identity quaternion (0,0,0,1) broadcast to `shape + (4,)`."""
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_normalize(q):
    return q / _norm(q, keepdim=True).clamp_min(1e-12)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_inverse(q):
    """Inverse for (possibly non-unit) quaternions."""
    return quat_conjugate(q) / torch.sum(q * q, dim=-1, keepdim=True).clamp_min(1e-12)


def quat_mul(a, b):
    """Hamilton product a*b (xyzw)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vector v by quaternion q: q * v * q^-1."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_rotate_inverse(q, v):
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v - qw * t + _cross(qv, t)


def quat_from_angle_axis(angle, axis):
    """angle: (...,), axis: (..., 3) (need not be unit)."""
    axis = axis / _norm(axis, keepdim=True).clamp_min(1e-12)
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([axis * s[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_to_angle_axis(q):
    """Returns (angle in [0, pi], axis). Angle ~0 -> axis (1,0,0)."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    sin_half = _norm(q[..., :3])
    angle = 2.0 * torch.atan2(sin_half, q[..., 3])
    safe = sin_half > 1e-8
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=q.dtype, device=q.device)
    axis = torch.where(
        safe[..., None],
        q[..., :3] / torch.where(safe, sin_half, torch.ones_like(sin_half))[..., None],
        x_axis,
    )
    return angle, axis


def quat_from_euler_zyx(roll, pitch, yaw):
    """Matches gymapi.Quat.from_euler_zyx semantics: intrinsic Z(yaw)Y(pitch)X(roll),
    i.e. R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def quat_to_euler_zyx(q):
    """Inverse of quat_from_euler_zyx -> (roll, pitch, yaw)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (w * x + y * z)
    cosr_cosp = 1.0 - 2.0 * (x * x + y * y)
    roll = torch.atan2(sinr_cosp, cosr_cosp)
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    siny_cosp = 2.0 * (w * z + x * y)
    cosy_cosp = 1.0 - 2.0 * (y * y + z * z)
    yaw = torch.atan2(siny_cosp, cosy_cosp)
    return roll, pitch, yaw


def quat_to_matrix(q):
    """Rotation matrix (..., 3, 3) from xyzw quaternion."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
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


def matrix_to_quat(m):
    """xyzw quaternion from rotation matrix (..., 3, 3). Branchless Shepperd."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def case_w():
        s = torch.sqrt((tr + 1.0).clamp_min(1e-12)) * 2.0
        return torch.stack(
            [(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s, 0.25 * s], -1
        )

    def case_x():
        s = torch.sqrt((1.0 + m00 - m11 - m22).clamp_min(1e-12)) * 2.0
        return torch.stack(
            [0.25 * s, (m01 + m10) / s, (m02 + m20) / s, (m21 - m12) / s], -1
        )

    def case_y():
        s = torch.sqrt((1.0 + m11 - m00 - m22).clamp_min(1e-12)) * 2.0
        return torch.stack(
            [(m01 + m10) / s, 0.25 * s, (m12 + m21) / s, (m02 - m20) / s], -1
        )

    def case_z():
        s = torch.sqrt((1.0 + m22 - m00 - m11).clamp_min(1e-12)) * 2.0
        return torch.stack(
            [(m02 + m20) / s, (m12 + m21) / s, 0.25 * s, (m10 - m01) / s], -1
        )

    qw, qx, qy, qz = case_w(), case_x(), case_y(), case_z()
    # pick branch per element (vectorized; no data-dependent control flow)
    use_w = tr > 0.0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = torch.where(
        use_w[..., None], qw,
        torch.where(use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)),
    )
    return quat_normalize(q)


def quat_integrate(q, omega, dt):
    """Integrate orientation by world-frame angular velocity omega over dt
    (first-order: q' = normalize(q + dt/2 * [omega,0]*q), matching the
    semi-implicit scheme used by rigid body engines)."""
    omega_q = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = 0.5 * dt * quat_mul(omega_q, q)
    return quat_normalize(q + dq)


def quat_exp_map(v):
    """Exponential coordinates (..., 3) -> quaternion (rotation by |v| about v)."""
    angle = _norm(v)
    axis = v / angle.clamp_min(1e-12)[..., None]
    small = angle < 1e-8
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    axis = torch.where(small[..., None], x_axis, axis)
    return quat_from_angle_axis(angle, axis)


def quat_log_map(q):
    """Quaternion -> exponential coordinates (angle*axis)."""
    angle, axis = quat_to_angle_axis(q)
    return angle[..., None] * axis


def orientation_error(desired, current):
    """Axis-angle orientation error used by IK/OSC controllers
    (the reference's examples/franka_cube_ik_osc.py:30-33): cc = q_d * q_c^-1,
    error = axis * angle expressed via quat components."""
    cc = quat_mul(desired, quat_conjugate(current))
    return cc[..., :3] * torch.sign(cc[..., 3:4])
