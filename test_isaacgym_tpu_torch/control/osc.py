"""Task-space controllers: damped-least-squares IK and operational-space
control with nullspace posture.

Port of test_isaacgym_tpu/control/osc.py (the reference's torch controllers
of examples/franka_cube_ik_osc.py and franka_osc.py). Batched over envs; the
6x6/7x7 inverses are unrolled batched Cholesky solves (utils/linalg.py).
"""
from __future__ import annotations

import math

import torch

from ..math.quat import orientation_error  # re-export for env code  # noqa: F401
from ..utils.linalg import spd_solve


def control_ik(j_eef, dpose, damping: float = 0.05):
    """u = J^T (J J^T + lambda^2 I)^-1 dpose.

    j_eef: (N, 6, D), dpose: (N, 6) -> (N, D) joint position deltas.
    """
    jt = j_eef.transpose(-1, -2)
    lmbda = torch.eye(6, dtype=j_eef.dtype, device=j_eef.device) * (damping**2)
    A = j_eef @ jt + lmbda
    return (jt @ spd_solve(A, dpose)[..., None])[..., 0]


def control_osc(
    j_eef,
    mm,
    dpose,
    dof_pos,
    dof_vel,
    hand_vel,
    default_dof_pos,
    kp: float = 150.0,
    kd: float | None = None,
    kp_null: float = 10.0,
    kd_null: float | None = None,
):
    """Operational-space torque with nullspace posture hold.

    j_eef: (N, 6, D) end-effector jacobian (arm dofs only)
    mm: (N, D, D) mass matrix (arm dofs)
    dpose: (N, 6) [pos_err, orn_err]; hand_vel: (N, 6) [lin, ang]
    dof_pos/dof_vel: (N, D); default_dof_pos: (D,) posture target.
    Returns torque (N, D).
    """
    if kd is None:
        kd = 2.0 * math.sqrt(kp)
    if kd_null is None:
        kd_null = 2.0 * math.sqrt(kp_null)
    jt = j_eef.transpose(-1, -2)
    # inverse-free form: X = M^-1 J^T, Lambda^-1 = J X; every apply of
    # Lambda = (J M^-1 J^T)^-1 becomes one more unrolled-Cholesky solve.
    X = spd_solve(mm, jt)  # (N, D, 6)
    m_eef_inv = j_eef @ X  # (N, 6, 6)
    u = jt @ spd_solve(m_eef_inv, (kp * dpose - kd * hand_vel))[..., None]

    # nullspace posture torque (roboticsproceedings.org/rss07/p31.pdf, as in
    # the reference's control_osc)
    j_eef_inv = spd_solve(m_eef_inv, X.transpose(-1, -2))  # Lambda J M^-1
    q_err = torch.remainder(default_dof_pos - dof_pos + math.pi, 2 * math.pi) - math.pi
    u_null = kd_null * -dof_vel + kp_null * q_err
    u_null = mm @ u_null[..., None]
    d = mm.shape[-1]
    proj = torch.eye(d, dtype=mm.dtype, device=mm.device) - jt @ j_eef_inv
    u = u + proj @ u_null
    return u[..., 0]
