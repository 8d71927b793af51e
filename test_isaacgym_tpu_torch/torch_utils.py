"""`isaacgym.torch_utils` equivalent on torch tensors.

Port of test_isaacgym_tpu/torch_utils.py, torch only: the JAX module's
functions take torch tensors or jax arrays and return the same kind; these
take torch tensors, as the reference's do (its
examples/franka_cube_ik_osc.py:19,36-49 imports the quaternion helpers).
`to_torch` puts its tensor on `device`, "cuda:0" unless asked otherwise;
the JAX module's ignores the argument. Quaternions are xyzw.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(x, dtype=torch.float, device="cuda:0", requires_grad=False):
    """The reference's signature: a copy of `x` on `device` (float32 where
    `dtype` is None, as the JAX module's)."""
    return torch.tensor(np.asarray(x), dtype=dtype or torch.float32, device=device,
                        requires_grad=requires_grad)


def normalize(x, eps: float = 1e-9):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=eps)


def quat_unit(q):
    return normalize(q)


def quat_mul(a, b):
    x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    ww = (z1 + x1) * (x2 + y2)
    yy = (w1 - y1) * (w2 + z2)
    zz = (w1 + y1) * (w2 - z2)
    xx = ww + yy + zz
    qq = 0.5 * (xx + (z1 - x1) * (x2 - y2))
    w = qq - ww + (z1 - y1) * (y2 - z2)
    x = qq - xx + (x1 + w1) * (x2 + w2)
    y = qq - yy + (w1 - x1) * (y2 + z2)
    z = qq - zz + (z1 + y1) * (w2 - x2)
    return torch.stack([x, y, z, w], -1)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], -1)


def quat_apply(q, v):
    """Rotate vector v by quat q (xyzw)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.cross(xyz, v, -1)
    return v + w * t + torch.cross(xyz, t, -1)


quat_rotate = quat_apply


def quat_rotate_inverse(q, v):
    return quat_apply(quat_conjugate(q), v)


def quat_from_angle_axis(angle, axis):
    axis = normalize(axis)
    half = angle * 0.5
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None]
    return torch.cat([xyz, w], -1)


def quat_to_angle_axis(q):
    w = q[..., 3]
    angle = 2.0 * torch.acos(w.clamp(-1.0, 1.0))
    s = torch.sqrt((1.0 - w * w).clamp(min=1e-12))
    axis = q[..., :3] / s[..., None]
    return angle, axis


def get_euler_xyz(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    s = 2 * (w * y - z * x)
    pitch = torch.asin(s.clamp(-1, 1))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def quat_from_euler_xyz(roll, pitch, yaw):
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    w = cr * cp * cy + sr * sp * sy
    return torch.stack([x, y, z, w], -1)


def orientation_error(desired, current):
    """Axis-angle-ish error used by the reference OSC controllers
    (franka_cube_ik_osc.py:46-49)."""
    qr = quat_mul(desired, quat_conjugate(current))
    return qr[..., 0:3] * qr[..., 3:4].sign()


def tensor_clamp(x, lo, hi):
    return torch.max(torch.min(x, hi), lo)


def get_axis_params(value, axis_idx, x=0.0, y=0.0, z=0.0, dtype=np.float32, n_dims=3):
    """Reference helper: dense vector with `value` at axis_idx."""
    zs = np.zeros(n_dims)
    zs[axis_idx] = 1.0
    params = np.where(zs == 1.0, value, zs)
    params[0] = x if x != 0.0 else params[0]
    params[1] = y if y != 0.0 else params[1]
    if n_dims > 2:
        params[2] = z if z != 0.0 else params[2]
    return list(params.astype(dtype))
