"""Rigid transforms as (pos, quat-xyzw) tensor pairs.

Port of test_isaacgym_tpu/math/transform.py: functional equivalents of
gymapi.Transform algebra, batched over leading axes.
"""
from __future__ import annotations

import torch

from .quat import (
    quat_identity,
    quat_inverse,
    quat_mul,
    quat_rotate,
)


def transform_identity(shape=(), dtype=torch.float32, device="cuda"):
    pos = torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device)
    return pos, quat_identity(shape, dtype, device)


def transform_apply(pos, quat, point):
    """Apply transform to a point (rotate then translate):
    gymapi.Transform.transform_point."""
    return pos + quat_rotate(quat, point)


def transform_vector(quat, vec):
    """Rotate a direction vector (no translation):
    gymapi.Transform.transform_vector."""
    return quat_rotate(quat, vec)


def transform_mul(pos_a, quat_a, pos_b, quat_b):
    """Compose: result maps X through B then A (A @ B)."""
    return pos_a + quat_rotate(quat_a, pos_b), quat_mul(quat_a, quat_b)


def transform_inverse(pos, quat):
    qi = quat_inverse(quat)
    return -quat_rotate(qi, pos), qi
