"""CCLVF pursuit guidance, batched.

Port of test_isaacgym_tpu/control/guidance.py: the circular-loiter Lyapunov
vector field the reference's UAV/car vecenvs use (its common/controller3.py
`cclvf`/`cclvf2`: a vehicle at distance r from the target converges onto a
loiter circle of radius `radius` and circulates it at `speed`).

The field, for offset (x, y) = pos - target, r = |xy|:
    c     = min(r, rd) / max(r, rd)
    k     = speed / sqrt(r^4 + (c^2 - 2) rd^2 r^2 + rd^4)
    vx    = -k * (x (r^2 - rd^2) / r + c rd y)
    vy    = -k * (y (r^2 - rd^2) / r - c rd x)
    vz    = -(z - z_target)
which is radial attraction to the circle plus tangential circulation, with
speed normalized so |v_xy| == speed everywhere.
"""
from __future__ import annotations

import torch


def cclvf(pos, target, speed: float, radius: float):
    """Batched loiter vector field. pos/target (..., 3) -> velocity (..., 3).

    Matches cclvf2's z behavior: vz = -(z - z_target) (altitude P-control)."""
    x = pos[..., 0] - target[..., 0]
    y = pos[..., 1] - target[..., 1]
    z = pos[..., 2] - target[..., 2]
    r = torch.sqrt(x * x + y * y)
    r = r.clamp_min(0.01)
    rd = radius
    c = torch.where(r < rd, r / rd, rd / r)
    r_rd = r * r - rd * rd
    k = speed / torch.sqrt(r**4 + (c * c - 2.0) * rd * rd * r * r + rd**4)
    vx = -k * (x * r_rd / r + c * rd * y)
    vy = -k * (y * r_rd / r - c * rd * x)
    vz = -z
    return torch.stack([vx, vy, vz], dim=-1)


def heading_quat(vel):
    """xyzw quat yawing +x toward the horizontal velocity direction (the
    car/uav heading write of the reference's vecenv loops, test06:426-441)."""
    yaw = torch.atan2(vel[..., 1], vel[..., 0])
    half = yaw / 2
    zeros = torch.zeros_like(half)
    return torch.stack([zeros, zeros, torch.sin(half), torch.cos(half)], dim=-1)
