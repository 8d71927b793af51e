"""Scalar math types of the reference-compatible API surface.

Port of test_isaacgym_tpu/gymapi/mathtypes.py (numpy only, copied). Mirrors
the capability of gymapi.Vec3/Quat/Transform/Velocity exercised by the
reference's examples/maths.py (ops, euler/axis-angle constructors,
rotate/transform_point/transform_vector/inverse, numpy dtype bridges) and the
structured dtypes of the classic state API (the reference's
test/test04_isaacgym_vel.py:344-387, examples/joint_monkey.py:112).
Quaternions are xyzw (maths.py:39-41).

These are host-side convenience types for scripting; the hot path uses the
batched tensors of `test_isaacgym_tpu_torch.math`.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np

from ..assets.types import (
    DOF_STATE_DTYPE,
    QUAT_DTYPE,
    RIGID_BODY_STATE_DTYPE,
    TRANSFORM_DTYPE,
    VEC3_DTYPE,
    VELOCITY_DTYPE,
)

__all__ = ["Vec3", "Quat", "Transform", "Velocity", "DofState", "RigidBodyState"]


class Vec3:
    dtype = VEC3_DTYPE
    __slots__ = ("x", "y", "z")

    def __init__(self, x=0.0, y=0.0, z=0.0):
        self.x, self.y, self.z = float(x), float(y), float(z)

    # -- algebra (examples/maths.py:21-94) --
    def __add__(self, o):
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s):
        if isinstance(s, Vec3):
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __truediv__(self, s):
        if isinstance(s, Vec3):
            return Vec3(self.x / s.x, self.y / s.y, self.z / s.z)
        return Vec3(self.x / s, self.y / s, self.z / s)

    def __eq__(self, o):
        return isinstance(o, Vec3) and (self.x, self.y, self.z) == (o.x, o.y, o.z)

    def dot(self, o) -> float:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o) -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length(self) -> float:
        return math.sqrt(self.dot(self))

    def length_sq(self) -> float:
        return self.dot(self)

    def normalize(self) -> "Vec3":
        l = self.length()
        return self / l if l > 0 else Vec3(self.x, self.y, self.z)

    # -- numpy bridge (maths.py:113-140) --
    def to_numpy(self):
        a = np.zeros(1, dtype=VEC3_DTYPE)[0]
        a["x"], a["y"], a["z"] = self.x, self.y, self.z
        return a

    @staticmethod
    def from_numpy(a) -> "Vec3":
        return Vec3(float(a["x"]), float(a["y"]), float(a["z"]))

    @staticmethod
    def from_buffer(buf) -> "Vec3":
        b = np.asarray(buf).reshape(-1)
        return Vec3(b[0], b[1], b[2])

    def to_list(self):
        return [self.x, self.y, self.z]

    def __iter__(self):
        return iter((self.x, self.y, self.z))

    def __repr__(self):
        return f"Vec3({self.x:g}, {self.y:g}, {self.z:g})"


class Quat:
    """xyzw quaternion (examples/maths.py:39-41 convention)."""

    dtype = QUAT_DTYPE
    __slots__ = ("x", "y", "z", "w")

    def __init__(self, x=0.0, y=0.0, z=0.0, w=1.0):
        self.x, self.y, self.z, self.w = float(x), float(y), float(z), float(w)

    @staticmethod
    def from_axis_angle(axis: Vec3, angle: float) -> "Quat":
        ax = axis.normalize()
        h = 0.5 * angle
        s = math.sin(h)
        return Quat(ax.x * s, ax.y * s, ax.z * s, math.cos(h))

    @staticmethod
    def from_euler_zyx(roll: float, pitch: float, yaw: float) -> "Quat":
        """Intrinsic z-y-x (yaw-pitch-roll) — gymapi.Quat.from_euler_zyx
        (examples/maths.py:45)."""
        cr, sr = math.cos(roll / 2), math.sin(roll / 2)
        cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
        cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
        return Quat(
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        )

    def to_euler_zyx(self) -> Tuple[float, float, float]:
        """Returns (roll, pitch, yaw)."""
        x, y, z, w = self.x, self.y, self.z, self.w
        roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        s = 2 * (w * y - z * x)
        pitch = math.copysign(math.pi / 2, s) if abs(s) >= 1 else math.asin(s)
        yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return (roll, pitch, yaw)

    def __mul__(self, o):
        if isinstance(o, Quat):
            return Quat(
                self.w * o.x + self.x * o.w + self.y * o.z - self.z * o.y,
                self.w * o.y - self.x * o.z + self.y * o.w + self.z * o.x,
                self.w * o.z + self.x * o.y - self.y * o.x + self.z * o.w,
                self.w * o.w - self.x * o.x - self.y * o.y - self.z * o.z,
            )
        if isinstance(o, Vec3):
            return self.rotate(o)
        return NotImplemented

    def rotate(self, v: Vec3) -> "Vec3":
        q = Vec3(self.x, self.y, self.z)
        t = q.cross(v) * 2.0
        return v + t * self.w + q.cross(t)

    def normalize(self) -> "Quat":
        n = math.sqrt(self.x**2 + self.y**2 + self.z**2 + self.w**2)
        if n == 0:
            return Quat()
        return Quat(self.x / n, self.y / n, self.z / n, self.w / n)

    def inverse(self) -> "Quat":
        return Quat(-self.x, -self.y, -self.z, self.w)

    conjugate = inverse

    def length(self) -> float:
        return math.sqrt(self.x**2 + self.y**2 + self.z**2 + self.w**2)

    def to_numpy(self):
        a = np.zeros(1, dtype=QUAT_DTYPE)[0]
        a["x"], a["y"], a["z"], a["w"] = self.x, self.y, self.z, self.w
        return a

    @staticmethod
    def from_numpy(a) -> "Quat":
        return Quat(float(a["x"]), float(a["y"]), float(a["z"]), float(a["w"]))

    @staticmethod
    def from_buffer(buf) -> "Quat":
        b = np.asarray(buf).reshape(-1)
        return Quat(b[0], b[1], b[2], b[3])

    def to_list(self):
        return [self.x, self.y, self.z, self.w]

    def __iter__(self):
        return iter((self.x, self.y, self.z, self.w))

    def __eq__(self, o):
        return isinstance(o, Quat) and self.to_list() == o.to_list()

    def __repr__(self):
        return f"Quat({self.x:g}, {self.y:g}, {self.z:g}, {self.w:g})"


class Transform:
    dtype = TRANSFORM_DTYPE
    __slots__ = ("p", "r")

    def __init__(self, p: Vec3 = None, r: Quat = None):
        self.p = p if p is not None else Vec3()
        self.r = r if r is not None else Quat()

    def transform_point(self, v: Vec3) -> Vec3:
        return self.r.rotate(v) + self.p

    def transform_vector(self, v: Vec3) -> Vec3:
        return self.r.rotate(v)

    def inverse(self) -> "Transform":
        ri = self.r.inverse()
        return Transform(ri.rotate(self.p) * -1.0, ri)

    def __mul__(self, o: "Transform") -> "Transform":
        return Transform(self.transform_point(o.p), self.r * o.r)

    def to_numpy(self):
        a = np.zeros(1, dtype=TRANSFORM_DTYPE)[0]
        a["p"] = self.p.to_numpy()
        a["r"] = self.r.to_numpy()
        return a

    @staticmethod
    def from_numpy(a) -> "Transform":
        return Transform(Vec3.from_numpy(a["p"]), Quat.from_numpy(a["r"]))

    @staticmethod
    def from_buffer(buf) -> "Transform":
        """7 floats [px py pz qx qy qz qw] OR one structured ('p','r') pose
        record (the rigid_body_states['pose'] rows —
        examples/transforms.py:103-123)."""
        a = np.asarray(buf)
        if a.dtype.names and "p" in a.dtype.names:
            p, r = a["p"], a["r"]
            return Transform(
                Vec3(float(p["x"]), float(p["y"]), float(p["z"])),
                Quat(float(r["x"]), float(r["y"]), float(r["z"]), float(r["w"])),
            )
        b = np.asarray(buf, dtype=np.float64).reshape(-1)
        return Transform(Vec3(b[0], b[1], b[2]), Quat(b[3], b[4], b[5], b[6]))

    def __repr__(self):
        return f"Transform(p={self.p}, r={self.r})"


class Velocity:
    dtype = VELOCITY_DTYPE
    __slots__ = ("linear", "angular")

    def __init__(self, linear: Vec3 = None, angular: Vec3 = None):
        self.linear = linear if linear is not None else Vec3()
        self.angular = angular if angular is not None else Vec3()

    def __repr__(self):
        return f"Velocity(linear={self.linear}, angular={self.angular})"


class DofState:
    """Namespace for the classic DOF-state structured dtype
    (examples/joint_monkey.py:112)."""

    dtype = DOF_STATE_DTYPE


class RigidBodyState:
    """Namespace for the classic rigid-body-state structured dtype
    ({pose:{p,r}, vel:{linear,angular}})."""

    dtype = RIGID_BODY_STATE_DTYPE
