"""Spatial (6D) vector algebra for articulated rigid-body dynamics.

Port of test_isaacgym_tpu/math/spatial.py, function for function and in the
same order of operations.

World-frame formulation: all spatial quantities are expressed in world-aligned
axes about a common origin O (the actor root position, so magnitudes stay
small in f32 even when envs are spread over a large grid).

Conventions (Featherstone):
  motion vector  v = [omega(3), v_O(3)]   (angular first)
  force  vector  f = [n_O(3),   f(3)]     (torque about O first)

Everything is batched over arbitrary leading axes; these are the primitives
the CRBA / RNEA of physics/dynamics.py are built from.
"""
from __future__ import annotations

import torch

from .quat import cross as _cross


def cross_motion(v, u):
    """Spatial motion cross product  v x_m u."""
    w, vo = v[..., :3], v[..., 3:]
    uw, uo = u[..., :3], u[..., 3:]
    return torch.cat([_cross(w, uw), _cross(w, uo) + _cross(vo, uw)], dim=-1)


def cross_force(v, f):
    """Spatial force cross product  v x_f f  (dual of cross_motion)."""
    w, vo = v[..., :3], v[..., 3:]
    n, fo = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, n) + _cross(vo, fo), _cross(w, fo)], dim=-1)


def inertia_mul(m, com, ic, v):
    """Apply spatial inertia (mass m, com position `com` relative to O,
    world-frame rotational inertia about com `ic` (...,3,3)) to motion vector v.

    Returns the spatial momentum [H_O, L]:
      L   = m * (v_O + omega x com)
      H_O = Ic @ omega + com x L
    """
    w, vo = v[..., :3], v[..., 3:]
    lin = m[..., None] * (vo + _cross(w, com))
    ang = torch.einsum("...ij,...j->...i", ic, w) + _cross(com, lin)
    return torch.cat([ang, lin], dim=-1)


def dot(f, v):
    """Scalar pairing of a force vector with a motion vector."""
    return torch.sum(f * v, dim=-1)


def inertia_params_add(a, b):
    """Sum two spatial inertias given as (m, com, Ic) param triples about the
    same origin O. Returns the composite (m, com, Ic) triple."""
    ma, ca, ia = a
    mb, cb, ib = b
    m = ma + mb
    msafe = m.clamp_min(1e-12)
    com = (ma[..., None] * ca + mb[..., None] * cb) / msafe[..., None]

    def shift(mi, ci, ii):
        # parallel axis: inertia about new com
        d = ci - com
        d2 = torch.sum(d * d, dim=-1)
        eye = torch.eye(3, dtype=d.dtype, device=d.device)
        outer = d[..., :, None] * d[..., None, :]
        return ii + mi[..., None, None] * (d2[..., None, None] * eye - outer)

    ic = shift(ma, ca, ia) + shift(mb, cb, ib)
    return m, com, ic


def _unpack3(A):
    return [[A[..., i, j] for j in range(3)] for i in range(3)]


def _pack3(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def mm3(A, B):
    """Batched 3x3 matmul in scalar component form."""
    a = _unpack3(A)
    b = _unpack3(B)
    return _pack3(
        [[sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    )


def sandwich3(R, I):
    """R @ I @ R^T in scalar component form (see mm3)."""
    r = _unpack3(R)
    a = _unpack3(I)
    t = [
        [sum(r[i][k] * a[k][j] for k in range(3)) for j in range(3)]
        for i in range(3)
    ]
    return _pack3(
        [[sum(t[i][k] * r[l][k] for k in range(3)) for l in range(3)]
         for i in range(3)]
    )


def skew(v):
    """(...,3) -> (...,3,3) cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    rows = torch.stack([z, -w, y, w, z, -x, -y, x, z], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def motion_subspace_revolute(axis_w, anchor_w):
    """World-frame motion subspace column for a revolute joint with world axis
    `axis_w` passing through world point `anchor_w`, about origin O=0."""
    return torch.cat([axis_w, _cross(anchor_w, axis_w)], dim=-1)


def motion_subspace_prismatic(axis_w):
    return torch.cat([torch.zeros_like(axis_w), axis_w], dim=-1)


def point_velocity(v, p):
    """Velocity of the body-fixed point currently at world position p (relative
    to origin O), given spatial velocity v about O."""
    w, vo = v[..., :3], v[..., 3:]
    return vo + _cross(w, p)


def force_at_point(force, torque, p):
    """Spatial force about O from a linear force and torque applied at point p."""
    return torch.cat([torque + _cross(p, force), force], dim=-1)
