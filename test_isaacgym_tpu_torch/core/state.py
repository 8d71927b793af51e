"""Simulation state and runtime parameters as NamedTuples of torch tensors.

Port of test_isaacgym_tpu/core/state.py. Field names, shapes and dtypes are
the JAX package's, so `from_numpy` carries a JAX `SimState` / `PhysParams`
across field by field. Layouts match the reference tensors:

  root state row  = [pos(3), quat-xyzw(4), linvel(3), angvel(3)]   (N, A, 13)
  dof state row   = [pos, vel]                                      (N, D, 2)
  body state row  = like root                                       (N, B, 13)
  contact force   =                                                 (N, B, 3)

`PhysParams` holds everything the reference exposes through property setters
(DOF props, rigid-body/shape props, gravity) with a leading env axis, so
domain randomization is a tensor update.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor


class SimState(NamedTuple):
    # actor roots (N, A, ...)
    root_pos: Tensor
    root_quat: Tensor
    root_linvel: Tensor
    root_angvel: Tensor
    # generalized joint coordinates (N, D)
    dof_pos: Tensor
    dof_vel: Tensor
    # derived rigid-body states (N, B, ...), refreshed by step()
    body_pos: Tensor
    body_quat: Tensor
    body_linvel: Tensor
    body_angvel: Tensor
    # net contact force per body (N, B, 3)
    contact_force: Tensor
    # sim clock
    time: Tensor  # scalar f32
    steps: Tensor  # scalar i32
    # cross-step warm-start impulses of the static contact table and FEM
    # vertex state: None until those paths are ported
    warm_n: Optional[Tensor] = None
    warm_t: Optional[Tensor] = None
    soft_pos: Optional[Tensor] = None
    soft_vel: Optional[Tensor] = None

    @property
    def num_envs(self):
        return self.root_pos.shape[0]

    def root_state_tensor(self, origins=None):
        """(N*A, 13) view matching acquire_actor_root_state_tensor; positions
        are env-LOCAL when `origins` (N, 3) is given."""
        n, a = self.root_pos.shape[:2]
        pos = self.root_pos if origins is None else self.root_pos - origins[:, None, :]
        return torch.cat(
            [pos, self.root_quat, self.root_linvel, self.root_angvel], dim=-1
        ).reshape(n * a, 13)

    def body_state_tensor(self, origins=None):
        n, b = self.body_pos.shape[:2]
        pos = self.body_pos if origins is None else self.body_pos - origins[:, None, :]
        return torch.cat(
            [pos, self.body_quat, self.body_linvel, self.body_angvel], dim=-1
        ).reshape(n * b, 13)

    def dof_state_tensor(self):
        n, d = self.dof_pos.shape
        return torch.stack([self.dof_pos, self.dof_vel], dim=-1).reshape(n * d, 2)

    def with_root_state_tensor(self, tensor, origins=None):
        """set_actor_root_state_tensor (env-local in, if origins)."""
        n, a = self.root_pos.shape[:2]
        t = tensor.reshape(n, a, 13)
        pos = t[..., 0:3] if origins is None else t[..., 0:3] + origins[:, None, :]
        return self._replace(
            root_pos=pos.contiguous(),
            root_quat=t[..., 3:7].contiguous(),
            root_linvel=t[..., 7:10].contiguous(),
            root_angvel=t[..., 10:13].contiguous(),
        )


class PhysParams(NamedTuple):
    """Runtime-mutable physical parameters, leading env axis N."""

    # per-DOF (N, D)
    dof_stiffness: Tensor
    dof_damping: Tensor
    dof_armature: Tensor
    dof_friction: Tensor
    dof_lower: Tensor
    dof_upper: Tensor
    dof_has_limits: Tensor  # bool
    dof_max_effort: Tensor
    dof_max_velocity: Tensor
    dof_drive_mode: Tensor  # int32; 0 none 1 pos 2 vel 3 effort
    # per-body (N, B)
    body_mass: Tensor
    body_com: Tensor  # (N, B, 3) in link frame
    body_inertia: Tensor  # (N, B, 3, 3) about com, link frame
    body_disable_gravity: Tensor  # bool (N, B)
    # per-shape (N, S)
    shape_friction: Tensor
    shape_restitution: Tensor
    shape_size: Tensor  # (N, S, 3)
    shape_pos: Tensor  # (N, S, 3) shape offset in link frame
    # per-attractor (N, T)
    attractor_stiffness: Tensor
    attractor_damping: Tensor
    attractor_force_limit: Tensor
    # globals
    gravity: Tensor  # (3,)
    # per-soft-instance FEM materials (N, S_soft); None without soft bodies
    soft_youngs: Optional[Tensor] = None
    soft_poissons: Optional[Tensor] = None
    soft_damping: Optional[Tensor] = None


class Actions(NamedTuple):
    """Per-step control inputs (the reference's set_dof_*_tensor /
    apply_*_force_tensors / attractor targets collapsed into one tuple)."""

    dof_pos_target: Tensor  # (N, D)
    dof_vel_target: Tensor  # (N, D)
    dof_effort: Tensor  # (N, D)
    body_force: Tensor  # (N, B, 3) ENV_SPACE (world axes)
    body_torque: Tensor  # (N, B, 3)
    body_force_pos: Tensor  # (N, B, 3) world application points
    use_force_pos: Tensor  # bool scalar
    # attractors: (N, T, 3/4) pose targets + enable mask (N, T)
    attractor_target_pos: Tensor
    attractor_target_quat: Tensor
    attractor_enabled: Tensor


def zero_actions(
    num_envs: int, num_dofs: int, num_bodies: int, num_attractors: int = 0, device="cuda"
):
    def f(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    T = max(num_attractors, 0)
    return Actions(
        dof_pos_target=f(num_envs, num_dofs),
        dof_vel_target=f(num_envs, num_dofs),
        dof_effort=f(num_envs, num_dofs),
        body_force=f(num_envs, num_bodies, 3),
        body_torque=f(num_envs, num_bodies, 3),
        body_force_pos=f(num_envs, num_bodies, 3),
        use_force_pos=f(dtype=torch.bool),
        attractor_target_pos=f(num_envs, T, 3),
        attractor_target_quat=f(num_envs, T, 4),
        attractor_enabled=f(num_envs, T, dtype=torch.bool),
    )


def from_numpy(fields: dict, cls, device):
    """Build a `cls` (SimState, PhysParams or Actions) on `device` from a dict
    of numpy arrays keyed by field name — the carry-across from the JAX
    package (`{k: np.asarray(v) for k, v in jax_state._asdict().items()}`).
    64-bit numbers narrow to 32 bits as jax does without x64; other dtypes
    (float32, int32, bool) are kept; None stays None; fields missing from
    the dict take the class default. The tensors are copies: they never
    alias the caller's arrays."""
    unknown = set(fields) - set(cls._fields)
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    narrow = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
    out = {}
    for k, v in fields.items():
        if v is None:
            out[k] = None
            continue
        a = np.asarray(v)
        a = np.array(a, dtype=narrow.get(a.dtype, a.dtype), order="C", copy=True)
        out[k] = torch.from_numpy(a).to(device)
    return cls(**out)


def to_numpy(value) -> dict:
    """Inverse of `from_numpy`: a dict of numpy arrays (None stays None)."""
    return {
        k: (None if v is None else v.detach().cpu().numpy())
        for k, v in value._asdict().items()
    }
