"""Visual-servo gimbal control, batched.

Port of test_isaacgym_tpu/control/servo.py: the pixel-error -> gimbal-angle
algorithm of the reference's servo controllers (its
common/secondary_control_vecenv.py:99-200 `servo_ext_pixel`; the scalar
original servo_controller.py:108-182, itself a port of a validated C++
Eigen routine). Given where the target currently lands on the image,
compute roll/pitch/yaw for the camera gimbal so the optical axis re-centers
it.

Conventions: camera body frame x-forward/y-left/z-up, pixel origin top-left,
+u right, +v down. `camera_matrix` is the 3x3 pinhole intrinsics (fx, fy,
cx, cy), a tensor on the caller's device.
"""
from __future__ import annotations

import torch

from ..math.quat import cross
from ..math.spatial import skew


def camera_matrix(width: int, height: int, hfov_deg: float, device="cuda") -> torch.Tensor:
    """Pinhole intrinsics matching the world_to_pixel chain (fx = w/2 /
    tan(hfov/2); the reference uses fx = width/2 at its default 90-degree
    fov, controller6.py:151-155)."""
    t = torch.tan(torch.deg2rad(torch.tensor(hfov_deg, dtype=torch.float32)) / 2)
    fx = float(width / 2 / t)
    return torch.tensor(
        [[fx, 0.0, width / 2], [0.0, fx, height / 2], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def pixel_to_ray(pixel, cam_matrix):
    """Pixel (..., 2) -> unit ray (..., 3) in the camera BODY frame
    (x forward, y left, z up). Inverse of the projection
    u = cx + fx*(-y/x), v = cy + fy*(-z/x)."""
    fx = cam_matrix[0, 0]
    fy = cam_matrix[1, 1]
    cx = cam_matrix[0, 2]
    cy = cam_matrix[1, 2]
    y = -(pixel[..., 0] - cx) / fx
    z = -(pixel[..., 1] - cy) / fy
    v = torch.stack([torch.ones_like(y), y, z], dim=-1)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _yaw_of(v):
    return torch.atan2(v[..., 1], v[..., 0])


def _center_plus(pixel_move, cam_matrix):
    """The image center (cx, cy) + pixel_move (..., 2)."""
    return cam_matrix[:2, 2] + pixel_move


def servo_ext_pixel(cam_rot, pixel_move, cam_matrix):
    """Gimbal angles (..., 3) [roll, pitch, yaw] (radians) that rotate the
    camera so a target seen at center+pixel_move moves to the image center.

    cam_rot: (..., 3, 3) current camera rotation (world <- camera body).
    pixel_move: (..., 2) target pixel offset from the image center.

    Algorithm (the reference's, re-expressed in x-forward coordinates):
      1. ray to the target in camera frame, rotated to world: v_w
      2. yaw  = heading of v_w (rotate optical axis onto the target azimuth)
      3. pitch = elevation difference between the optical axis and v_w
      4. roll = 0 (the two-axis re-center is exact; the reference's roll term
         only compensates its zxy euler composition)
    Output convention matches a zyx (yaw-pitch) gimbal applied in world frame.
    """
    ray_target = pixel_to_ray(_center_plus(pixel_move, cam_matrix), cam_matrix)
    v_w = (cam_rot * ray_target[..., None, :]).sum(-1)  # world
    axis_w = cam_rot[..., :, 0]  # current optical axis in world

    yaw = _yaw_of(v_w) - _yaw_of(axis_w)
    # wrap to [-pi, pi]
    yaw = torch.atan2(torch.sin(yaw), torch.cos(yaw))
    pitch_target = torch.asin(torch.clamp(v_w[..., 2], -1.0, 1.0))
    pitch_axis = torch.asin(torch.clamp(axis_w[..., 2], -1.0, 1.0))
    # camera pitches DOWN with positive gimbal pitch about +y (left) axis
    pitch = pitch_axis - pitch_target
    roll = torch.zeros_like(yaw)
    return torch.stack([roll, pitch, yaw], dim=-1)


def gimbal_rot(rpy):
    """World-frame yaw-pitch(-roll) gimbal increment: R = Rz(yaw) Ry(pitch).
    Applied as R_new = gimbal_rot(servo) @ R_cam, after which the target ray
    coincides with the optical axis (the property the reference's
    servo_controller.py:169-177's C++ original asserts with
    errorVector.norm() < 1e-6)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)

    def mat(rows):
        return torch.stack([torch.stack(row, -1) for row in rows], -2)

    Rz = mat([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
    Ry = mat([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
    Rx = mat([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
    return Rz @ Ry @ Rx


def align_axis_to(cam_rot, v_w):
    """Minimal rotation taking the optical axis onto unit direction v_w
    (world frame): R' = R_align @ cam_rot."""
    axis_w = cam_rot[..., :, 0]
    c = torch.clamp((axis_w * v_w).sum(-1), -1.0, 1.0)
    cr = cross(axis_w, v_w)
    s = torch.linalg.vector_norm(cr, dim=-1)
    k = cr / s.clamp_min(1e-9)[..., None]
    K = skew(k)
    eye = torch.eye(3, dtype=cam_rot.dtype, device=cam_rot.device)
    R_align = eye + s[..., None, None] * K + (1.0 - c)[..., None, None] * (K @ K)
    # angle ~ pi (antipodal): rotate about the camera up axis instead
    up = cam_rot[..., :, 2]
    Ku = skew(up)
    R_flip = eye + 2.0 * (Ku @ Ku)  # 180 deg about up
    R_align = torch.where(
        (s > 1e-7)[..., None, None],
        R_align,
        torch.where((c > 0.0)[..., None, None], eye, R_flip),
    )
    # re-orthonormalize: repeated float32 Rodrigues composition drifts off
    # SO(3) multiplicatively (det grows ~0.2%/step without this)
    return _orthonormalize(R_align @ cam_rot)


def _orthonormalize(R):
    """Project (..., 3, 3) near-rotations back onto SO(3) (Gram-Schmidt on
    the forward/up columns)."""
    x = R[..., :, 0]
    z = R[..., :, 2]
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-9)
    z = z - (z * x).sum(-1)[..., None] * x
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-9)
    y = cross(z, x)
    return torch.stack([x, y, z], dim=-1)


def recenter_rotation(cam_rot, pixel_move, cam_matrix):
    """One-call servo step: new camera rotation with the target re-centered.

    Uses the exact minimal rotation aligning the optical axis with the target
    ray (axis-angle about their cross product): equivalent to the reference's
    yaw-pitch-roll gimbal solution where that is defined, and free of the
    gimbal-lock singularity when the camera looks straight up/down (the UAV
    envs START looking straight down). The reported rpy is still the
    yaw/pitch decomposition for API parity with servo_ext_pixel."""
    rpy = servo_ext_pixel(cam_rot, pixel_move, cam_matrix)
    ray = pixel_to_ray(_center_plus(pixel_move, cam_matrix), cam_matrix)
    v_w = (cam_rot * ray[..., None, :]).sum(-1)
    return align_axis_to(cam_rot, v_w), rpy

