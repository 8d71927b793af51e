"""Batched camera sensors: transforms, view/projection matrices.

Port of test_isaacgym_tpu/render/camera.py: `CameraSensor` (one camera per
env, its pose a pair of tensors with a leading env axis, free-standing
(`set_camera_location` / `set_camera_transform`, the reference's
examples/multiple_camera_envs.py:74) or attached to a rigid body
(`attach_camera_to_body(..., FOLLOW_TRANSFORM)`, the reference's
test/test02_isaacgym_camera.py:285)), `world_to_pixel` and `quat_inv_j` on
tensors, and the numpy helpers `look_at_quat`, `mat_to_quat_np`,
`quat_to_mat_np`, `view_matrix` and `proj_matrix`. `look_at_quat_t` and
`CameraSensor.set_locations` aim every env's camera at once on the device
(the port's batched form of a per-env `set_location` loop).

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

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.config import CameraProperties
from ..math.quat import cross, quat_mul, quat_rotate

FOLLOW_POSITION = 0
FOLLOW_TRANSFORM = 1


@dataclasses.dataclass
class CameraSensor:
    """One camera per env (cameras created in the per-env loop with identical
    properties collapse into one batched sensor). The pose is env-local
    tensors on `device`; `fov_per_env` and the attachment are host values."""

    props: CameraProperties
    num_envs: int
    # free-standing pose, env-local (N, 3/4)
    pos: Optional[torch.Tensor] = None
    quat: Optional[torch.Tensor] = None
    # attachment (None if free)
    body: Optional[int] = None  # env body index
    local_pos: Optional[torch.Tensor] = None
    local_quat: Optional[torch.Tensor] = None
    follow_mode: int = FOLLOW_TRANSFORM
    enable_tensors: bool = False
    destroyed: bool = False
    # optional per-env horizontal fov override (degrees): runtime camera
    # zoom as ONE camera with an (N,) fov array instead of the reference's
    # 90-cameras-per-env workaround (test11_servo_vecenv_camerazoom.py:327-335)
    fov_per_env: Optional[np.ndarray] = None
    # last rendered images (N, H, W, .)
    color: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    segmentation: Optional[torch.Tensor] = None
    # optical flow (N, H, W, 2) in pixels, rendered once a consumer asks for
    # IMAGE_OPTICAL_FLOW (want_flow flips on first request)
    flow: Optional[torch.Tensor] = None
    want_flow: bool = False
    device: str = "cuda"

    def __post_init__(self):
        n, dev = self.num_envs, torch.device(self.device)
        ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
        if self.pos is None:
            self.pos = torch.zeros((n, 3), device=dev)
        if self.quat is None:
            self.quat = ident.repeat(n, 1)
        self.local_pos = torch.zeros((n, 3), device=dev)
        self.local_quat = ident.repeat(n, 1)

    # ------------------------------------------------------------------
    def ensure_envs(self, n: int):
        """Grow per-env pose tensors (cameras are created inside the per-env
        loop, before the final env count is known)."""
        cur = self.pos.shape[0]
        if n <= cur:
            return

        def pad(a, fill):
            return torch.cat([a, torch.tensor(fill, dtype=a.dtype, device=a.device).repeat(n - cur, 1)])

        self.pos = pad(self.pos, [0.0, 0.0, 0.0])
        self.quat = pad(self.quat, [0.0, 0.0, 0.0, 1.0])
        self.local_pos = pad(self.local_pos, [0.0, 0.0, 0.0])
        self.local_quat = pad(self.local_quat, [0.0, 0.0, 0.0, 1.0])
        self.num_envs = n

    def set_location(self, env_idx: int, eye, target, up=(0.0, 0.0, 1.0)):
        """Aim the camera at `target` from `eye` (env-local), x-forward with
        the sim's up axis as roll reference (gym.set_camera_location)."""
        self.ensure_envs(env_idx + 1)
        eye = np.asarray(eye, np.float64)
        self.pos[env_idx] = torch.as_tensor(eye, dtype=torch.float32)
        self.quat[env_idx] = torch.as_tensor(
            look_at_quat(eye, np.asarray(target, np.float64), up), dtype=torch.float32)
        self.body = None

    def set_locations(self, eye, target, up=(0.0, 0.0, 1.0)):
        """set_location of every env at once: eye, target (N, 3) env-local
        tensors on the sensor's device (no host copy)."""
        self.ensure_envs(eye.shape[0])
        self.pos = eye.to(torch.float32)
        self.quat = look_at_quat_t(eye, target, up)
        self.body = None

    def set_transform(self, env_idx: int, pos, quat):
        self.ensure_envs(env_idx + 1)
        self.pos[env_idx] = torch.as_tensor(np.asarray(pos, np.float32))
        self.quat[env_idx] = torch.as_tensor(np.asarray(quat, np.float32))
        self.body = None

    def set_horizontal_fov(self, env_idx: int, fov_deg: float):
        """Per-env runtime zoom (fov is a per-env tensor in the renderer)."""
        if self.fov_per_env is None:
            self.fov_per_env = np.full(self.num_envs, self.props.horizontal_fov, np.float32)
        if env_idx >= len(self.fov_per_env):
            self.fov_per_env = np.concatenate([
                self.fov_per_env,
                np.full(env_idx + 1 - len(self.fov_per_env), self.props.horizontal_fov, np.float32),
            ])
        self.fov_per_env[env_idx] = fov_deg

    def attach(self, body: int, local_pos, local_quat, follow_mode=FOLLOW_TRANSFORM):
        self.body = int(body)
        self.local_pos[:] = torch.as_tensor(np.asarray(local_pos, np.float32))
        self.local_quat[:] = torch.as_tensor(np.asarray(local_quat, np.float32))
        self.follow_mode = follow_mode

    # ------------------------------------------------------------------
    def world_pose(self, state, origins):
        """(pos (N,3), quat (N,4)) world-space camera pose from sim state."""
        self.ensure_envs(state.root_pos.shape[0])
        if self.body is None:
            return self.pos + origins, self.quat
        bp = state.body_pos[:, self.body]
        bq = state.body_quat[:, self.body]
        if self.follow_mode == FOLLOW_POSITION:
            return bp + self.local_pos, self.local_quat
        return bp + quat_rotate(bq, self.local_pos), quat_mul(bq, self.local_quat)

    def env_pose(self, state, origins):
        p, q = self.world_pose(state, origins)
        return p - origins, q

    # ------------------------------------------------------------------
    def proj_matrix(self) -> np.ndarray:
        return proj_matrix(self.props)

    def view_matrix(self, state, origins, env_idx: int) -> np.ndarray:
        p, q = self.world_pose(state, origins)
        return view_matrix(p[env_idx].cpu().numpy().astype(np.float64),
                           q[env_idx].cpu().numpy().astype(np.float64))


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


def look_at_quat_t(eye, target, up=(0.0, 0.0, 1.0)):
    """`look_at_quat` of each row of eye, target (N, 3) tensors, on their
    device: the same branches (a view along `up` takes the other up axis;
    the matrix-to-quaternion branch on w), f32."""
    up_t = torch.tensor(up, dtype=eye.dtype, device=eye.device).expand_as(eye)
    f = target - eye
    n = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    f = torch.where(n > 1e-9, f / n, torch.tensor([1.0, 0.0, 0.0], device=eye.device))
    alt = [0.0, 1.0, 0.0] if abs(up[2]) > 0.5 else [0.0, 0.0, 1.0]
    along = (f * up_t).sum(-1, keepdim=True).abs() > 0.999
    up_t = torch.where(along, torch.tensor(alt, device=eye.device), up_t)
    left = cross(up_t, f)
    left = left / torch.linalg.vector_norm(left, dim=-1, keepdim=True)
    z = cross(f, left)
    m = torch.stack([f, left, z], dim=-1)  # columns: x=forward, y=left, z=up

    def e(i, j):
        return m[:, i, j]

    w = torch.sqrt((1 + e(0, 0) + e(1, 1) + e(2, 2)).clamp_min(0.0)) / 2
    ws = torch.where(w > 1e-6, w, 1.0)
    q_w = torch.stack([(e(2, 1) - e(1, 2)) / (4 * ws), (e(0, 2) - e(2, 0)) / (4 * ws),
                       (e(1, 0) - e(0, 1)) / (4 * ws), w], -1)
    x = torch.sqrt((1 + e(0, 0) - e(1, 1) - e(2, 2)).clamp_min(0.0)) / 2
    y = torch.sqrt((1 - e(0, 0) + e(1, 1) - e(2, 2)).clamp_min(0.0)) / 2
    zz = torch.sqrt((1 - e(0, 0) - e(1, 1) + e(2, 2)).clamp_min(0.0)) / 2
    q_x = torch.stack([torch.where(e(2, 1) - e(1, 2) >= 0, x, -x),
                       torch.where(e(0, 2) - e(2, 0) >= 0, y, -y),
                       torch.where(e(1, 0) - e(0, 1) >= 0, zz, -zz), w], -1)
    q = torch.where((w > 1e-6)[:, None], q_w, q_x)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


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
