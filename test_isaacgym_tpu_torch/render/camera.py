"""Camera transforms, view/projection matrices and the pixel projection.

Port of the projection functions of test_isaacgym_tpu/render/camera.py:
`world_to_pixel` and `quat_inv_j` on tensors, and the numpy helpers
`look_at_quat`, `mat_to_quat_np`, `quat_to_mat_np`, `view_matrix` and
`proj_matrix`. The batched `CameraSensor` waits for rendering (ROADMAP.md
Queue 1, item 13).

Conventions (the reference scripts consume these matrices, its
test/test06_isaacgym_vecenv.py:447-448 and common/controller6.py:216-246):

- Camera frame: +x optical axis (forward), +y left, +z up, the IsaacGym
  camera-transform convention the reference's controllers assume
  (controller6.py:234-246 remaps with [[0,-1,0],[0,0,-1],[1,0,0]]).
- `view_matrix` (4x4, row-vector convention): p_gl_row = [p_w, 1] @ V where
  the GL camera basis is right=-y_cam, up=+z_cam, backward=-x_cam.
- `proj_matrix` (4x4, row-vector GL): [0,0]=1/tan(hfov/2),
  [1,1]=(w/h)/tan(hfov/2) (vertical fov from aspect), z mapped to [-1,1].
- Pixel projection: u = w/2 * (1 + P00 * (-y_cam/x_cam)),
  v = h/2 * (1 - P11 * (z_cam/x_cam)); row 0 is the TOP of the image.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.config import CameraProperties
from ..math.quat import quat_rotate


def look_at_quat(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """xyzw quat with +x pointing eye->target, `up` as up as possible
    (pass (0,1,0) under UP_AXIS_Y)."""
    f = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    n = np.linalg.norm(f)
    f = f / n if n > 1e-9 else np.array([1.0, 0, 0])
    up = np.asarray(up, np.float64)
    if abs(f @ up) > 0.999:
        up = np.array([0.0, 1.0, 0.0]) if abs(up[2]) > 0.5 else np.array([0.0, 0.0, 1.0])
    left = np.cross(up, f)
    left /= np.linalg.norm(left)
    z = np.cross(f, left)
    R = np.stack([f, left, z], axis=1)  # columns: x=forward, y=left, z=up
    return mat_to_quat_np(R)


def mat_to_quat_np(m) -> np.ndarray:
    w = np.sqrt(max(0.0, 1 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
    if w > 1e-6:
        x = (m[2, 1] - m[1, 2]) / (4 * w)
        y = (m[0, 2] - m[2, 0]) / (4 * w)
        z = (m[1, 0] - m[0, 1]) / (4 * w)
    else:
        x = np.sqrt(max(0.0, 1 + m[0, 0] - m[1, 1] - m[2, 2])) / 2
        x = x if m[2, 1] - m[1, 2] >= 0 else -x
        y = np.sqrt(max(0.0, 1 - m[0, 0] + m[1, 1] - m[2, 2])) / 2
        y = y if m[0, 2] - m[2, 0] >= 0 else -y
        z = np.sqrt(max(0.0, 1 - m[0, 0] - m[1, 1] + m[2, 2])) / 2
        z = z if m[1, 0] - m[0, 1] >= 0 else -z
    q = np.array([x, y, z, w], np.float64)
    return q / np.linalg.norm(q)


def quat_to_mat_np(q) -> np.ndarray:
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def view_matrix(pos, quat) -> np.ndarray:
    """Row-vector view matrix (see module docstring)."""
    R = quat_to_mat_np(np.asarray(quat, np.float64))
    right = -R[:, 1]
    up = R[:, 2]
    backward = -R[:, 0]
    B = np.stack([right, up, backward], axis=1)  # (3,3) columns = GL basis
    V = np.eye(4)
    V[:3, :3] = B
    V[3, :3] = -np.asarray(pos, np.float64) @ B
    return V


def proj_matrix(props: CameraProperties) -> np.ndarray:
    t = np.tan(np.deg2rad(props.horizontal_fov) / 2)
    aspect = props.width / props.height
    n, f = props.near_plane, props.far_plane
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / t
    P[1, 1] = aspect / t
    P[2, 2] = (f + n) / (n - f)
    P[2, 3] = -1.0
    P[3, 2] = 2 * f * n / (n - f)
    return P


def world_to_pixel(cam_pos, cam_quat, points, props: CameraProperties):
    """Batched projection world points (..., 3) -> pixel (..., 2) + depth.

    Matches the reference controllers' pinhole chain (controller6.py
    world2pixel with fx = width/2 at the default 90-degree fov)."""
    rel = quat_rotate(quat_inv_j(cam_quat), points - cam_pos)
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    t = np.tan(np.deg2rad(props.horizontal_fov) / 2)
    fx = props.width / 2 / t
    fy = fx
    depth = x.clamp_min(1e-7)
    u = props.width / 2 + fx * (-y / depth)
    v = props.height / 2 + fy * (-z / depth)
    return torch.stack([u, v], dim=-1), x


def quat_inv_j(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)
