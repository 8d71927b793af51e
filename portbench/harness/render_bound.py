"""The least time of a frame of the ray-cast renderer (render/raster.py's
`render_camera_batch` with `shape_world_poses`, the cell
ant_camera-4096-frames): the work of a frame counted from its shape, that
is envs, image width and height, shapes by kind and the ground, not from
any implementation, against the published H100 SXM peaks (NVIDIA's data
sheet, dense, at 700 W; harness/roofline.py). A 3x3 rotation applied to a
vector is a matrix product here (15); the work that does not depend on
the ray is counted once an env.

f32 operations (a multiply, add, compare, select, min, sqrt, division or
tangent each count one):
per env, once a frame:
  the camera: forward = target - eye normalized (3 + 5 + 1 + 3), left =
    up x forward normalized (6 + 9), up' = forward x left (6); its world
    position eye + origin (3); the focal length w / 2 / tan(fov / 2) (3)  39
per env and shape:
  the shape's world frame: the quaternion product of its body's and its
    own (28), its rotation matrix (24), its centre body R x local + body
    pos (15 + 3); the camera in the shape's frame R^T (o - c) (3 + 15)    88
  the ray-independent terms of its test: a sphere's |o|^2 - r^2 (7)        7
    a capsule's ox^2 + oy^2 - r^2 (5), each end sphere's o -+ hl z (1)
    and |o - c|^2 - r^2 (7)                                               21
per ray (a pixel):
  its direction: the camera-frame (1, -u/f, -v/f) (2) normalized (5 + 1 +
    3), turned to the world (15)                                          26
per ray and shape, that shape kind's own test in the shape's frame:
  the direction in the shape's frame (15) and the nearest so far (2)      17
  sphere: b = o.d (5), b^2 - q (2), sqrt (1), t = -b - sqrt (2), the
    hit's test: disc >= 0, t > eps, and, select (4)                       14
  capsule: the cylinder: a = dx^2 + dy^2 (3), b = ox dx + oy dy (3), b^2
    - a c (3), sqrt (1), t = (-b - sqrt) / a (3), z = oz + t dz (2), the
    hit's test: disc >= 0, t > eps, |z| <= hl, a > 0, three ands, select
    (9); each end sphere as a sphere (14 + 14); the least of three (2)    54
per ray, with a ground plane: d.n (5), t = (dist - o.n) / d.n with o.n
  once an env (1 + a guard's compare and select 2), the hit's test (4),
  ground or shape nearer (2 compares, 2 selects)                          16
per ray, shading the hit: the point o + t d (6); into the shape's frame
  R^T (p - c) (3 + 15); the normal, a capsule's p - (0, 0, clamp(z))
  (3); to the world (15), normalized (9); Lambert -n.l clamped (8);
  albedo x (ambient + colour x Lambert) (9); the ground's albedo or the
  sky's colour instead (6); clamped to [0, 1] (6)                         80
per ray, packing: the view depth t (d . forward) (6), the far plane's
  test and select (3), the colour x 255 to uint8 (6), the segmentation's
  select (1)                                                              16

Bytes, the least a frame moves: each env's shape table in (a shape's
world position and quaternion, size, colour, kind and segmentation id:
14 x 4 B) and its camera's eye and target (6 x 4 B); out, 12 B a pixel:
RGBA8, the float32 depth and the int32 segmentation id.
"""
from __future__ import annotations

from .roofline import PEAK_BYTES, PEAK_F32_OPS

OPS_ENV = 39
OPS_ENV_SHAPE = 88
OPS_ENV_SPHERE, OPS_ENV_CAPSULE = 7, 21
OPS_RAY = 26
OPS_RAY_SHAPE = 17
OPS_RAY_SPHERE, OPS_RAY_CAPSULE = 14, 54
OPS_RAY_GROUND = 16
OPS_RAY_SHADE, OPS_RAY_PACK = 80, 16
BYTES_SHAPE = 14 * 4
BYTES_CAMERA = 6 * 4
BYTES_PIXEL = 12


def frame_ops(envs, width, height, spheres, capsules, ground) -> int:
    """f32 operations of one frame of every env's camera."""
    shapes = spheres + capsules
    per_env = (OPS_ENV + shapes * OPS_ENV_SHAPE + spheres * OPS_ENV_SPHERE
               + capsules * OPS_ENV_CAPSULE)
    per_ray = (OPS_RAY + shapes * OPS_RAY_SHAPE + spheres * OPS_RAY_SPHERE
               + capsules * OPS_RAY_CAPSULE + ground * OPS_RAY_GROUND + OPS_RAY_SHADE
               + OPS_RAY_PACK)
    return envs * (per_env + width * height * per_ray)


def frame_bytes(envs, width, height, spheres, capsules, ground) -> int:
    """Bytes one frame of every env's camera moves at the least."""
    return envs * ((spheres + capsules) * BYTES_SHAPE + BYTES_CAMERA
                   + width * height * BYTES_PIXEL)


def render_bound(**work):
    """(least ms of a frame, "operations" or "bytes") of the work
    `render.work`: envs, width, height, spheres, capsules, ground (0 or 1)."""
    t_ops = frame_ops(**work) / PEAK_F32_OPS * 1e3
    t_bytes = frame_bytes(**work) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
