"""The least time of the XPBD soft solve (physics/soft.py's substep, the
cell soft_body-1024-press): the work of the published iteration counted
from the shape of the problem, not from any implementation, against the
published H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W;
harness/roofline.py). A kernel that keeps an env's mesh in shared memory
and reads each input once still reads at most 100%.

f32 operations (a multiply, add, compare, select, sqrt or division each
count one), per tet and iteration:
  F = Ds Dm^-1: the 3 edge vectors (9), the 3x3 product (27 + 18)      54
  deviatoric C_D = |F|_F: squares and sum (17), sqrt (1); dC/dF = F / C_D
    (1 reciprocal + 9); corners 1-3's gradients (dC/dF) Dm^-T (45);
    corner 0's, minus their sum (9); sum_c w_c |g_c|^2 (4 x 6 + 3);
    the multiplier step -(C + alpha lam) / (wsum + alpha) x relaxed
    Jacobi scale (6) and lam += (1)                                    116
  hydrostatic C_H = det F - gamma: the cofactor, 3 crosses (27); det F
    from its first column (5); - gamma (1); gradients (45 + 9); sum_c
    w_c |g_c|^2 (27); the multiplier step (7)                          121
  corrections w_c dlam g_c, 4 corners x 2 constraints x (1 + 3)         32
  their per-vertex sums into the positions, 4 x 2 x 3                   24
per vertex and iteration:
  the ground plane: distance (5 + 2), clamp (1), push (6)              14
per vertex, collider and iteration (a box in its own frame):
  p - c (3), rotate in (15), |rel| - half (6), inside (5), the nearest
    face (2), its target (2) and the replaced coordinate (1), rotate
    out and + c (18), select (3)                                       55
per vertex and substep, once:
  predict v + h g, x + h v (12); ground friction: depth (7), approach
    (9), motion (3), its tangent (11) and length (7), kept share (5),
    the subtraction (10); velocity (p - x) / h (6); damping (6)         76
per tet and substep, once: the two compliances 1/(mu V h^2) and
  1/(lambda V h^2) (6), the damping's max over the tet's corners (4)   10
per env and substep, once: mu, lambda and 1 + mu/lambda from E and nu  11

Bytes, the least a substep moves: each env's positions and velocities in
and out (4 x V x 3 x 4 B), its materials (E, nu, damping: 12 B) and each
collider's pose and size (10 x 4 B); the mesh's constants once (per tet:
4 int32 indices, Dm^-1, the rest volume and the relaxed Jacobi scale,
4 x 4 + 36 + 4 + 4 B; per vertex: the inverse mass, 4 B).
"""
from __future__ import annotations

from .roofline import PEAK_BYTES, PEAK_F32_OPS

OPS_TET_ITER = 54 + 116 + 121 + 32 + 24
OPS_VERT_ITER = 14
OPS_VERT_COLLIDER_ITER = 55
OPS_VERT_SUBSTEP = 76
OPS_TET_SUBSTEP = 10
OPS_ENV_SUBSTEP = 11
BYTES_VERT_ENV = 4 * 3 * 4
BYTES_ENV = 12
BYTES_COLLIDER_ENV = 10 * 4
BYTES_TET = 4 * 4 + 36 + 4 + 4
BYTES_VERT = 4


def substep_ops(envs, verts, tets, colliders, iterations) -> int:
    """f32 operations of one substep of every env."""
    per_iter = tets * OPS_TET_ITER + verts * (OPS_VERT_ITER + colliders * OPS_VERT_COLLIDER_ITER)
    once = verts * OPS_VERT_SUBSTEP + tets * OPS_TET_SUBSTEP + OPS_ENV_SUBSTEP
    return envs * (iterations * per_iter + once)


def substep_bytes(envs, verts, tets, colliders) -> int:
    """Bytes one substep of every env moves at the least."""
    per_env = verts * BYTES_VERT_ENV + BYTES_ENV + colliders * BYTES_COLLIDER_ENV
    return envs * per_env + tets * BYTES_TET + verts * BYTES_VERT


def xpbd_bound(envs, verts, tets, colliders, iterations, substeps):
    """(least ms of a step's soft solve, "operations" or "bytes")."""
    t_ops = substeps * substep_ops(envs, verts, tets, colliders, iterations) / PEAK_F32_OPS * 1e3
    t_bytes = substeps * substep_bytes(envs, verts, tets, colliders) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
