"""Domain randomization as functions over PhysParams / render state.

Port of test_isaacgym_tpu/randomize.py. It replaces the reference's ad-hoc
`random.uniform` loops (its examples/domain_randomization.py:163-197: every
N frames a random camera pose, per-body color and texture, light params, an
image dump) with updates drawn from an explicit `torch.Generator` in place
of the JAX package's key. Physics randomization (masses, friction, gains) is
a tensor update because every randomizable quantity lives in PhysParams
with a leading env axis.

All functions: (gen, params, ...) -> new params. Every draw goes through
`_u` (uniform) or `_n` (the light's normal draw), in the order the JAX
package splits its key; the generator lives on the device of the tensors it
fills.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .core.state import PhysParams


def _u(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _n(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


# -- physics ------------------------------------------------------------------
def randomize_shape_friction(gen, params: PhysParams, lo=0.5, hi=1.5) -> PhysParams:
    f = params.shape_friction
    return params._replace(shape_friction=_u(gen, f.shape, lo, hi, f.device))


def randomize_restitution(gen, params: PhysParams, lo=0.0, hi=0.7) -> PhysParams:
    r = params.shape_restitution
    return params._replace(shape_restitution=_u(gen, r.shape, lo, hi, r.device))


def randomize_body_mass(gen, params: PhysParams, scale_lo=0.8, scale_hi=1.2) -> PhysParams:
    """Multiplicative mass scaling (inertia scales with mass)."""
    m = params.body_mass
    s = _u(gen, m.shape, scale_lo, scale_hi, m.device)
    return params._replace(body_mass=m * s, body_inertia=params.body_inertia * s[..., None, None])


def randomize_dof_gains(gen, params: PhysParams, kp_scale=(0.8, 1.2), kd_scale=(0.8, 1.2)) -> PhysParams:
    kp, kd = params.dof_stiffness, params.dof_damping
    return params._replace(
        dof_stiffness=kp * _u(gen, kp.shape, *kp_scale, kp.device),
        dof_damping=kd * _u(gen, kd.shape, *kd_scale, kd.device),
    )


def randomize_gravity(gen, params: PhysParams, scale=(0.9, 1.1)) -> PhysParams:
    g = params.gravity
    return params._replace(gravity=g * _u(gen, (), *scale, g.device))


def randomize_shape_scale(gen, params: PhysParams, scale=(0.9, 1.1)) -> PhysParams:
    """Per-shape geometric scale (sizes + offsets), mass untouched: the
    visual/collision-size axis of DR."""
    size = params.shape_size
    s = _u(gen, size.shape[:2] + (1,), *scale, size.device)
    return params._replace(shape_size=size * s, shape_pos=params.shape_pos * s)


# -- rendering ----------------------------------------------------------------
def randomize_colors(gen, shape_color) -> torch.Tensor:
    """(N, S, 3) new albedos (domain_randomization.py:174-180) of the shape
    of `shape_color`, a tensor on the generator's device."""
    return _u(gen, shape_color.shape, 0.05, 1.0, shape_color.device)


def randomize_light(gen, device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(color, ambient, direction) like set_light_parameters randomization
    (domain_randomization.py:183-186)."""
    color = _u(gen, (3,), 0.4, 1.0, device)
    ambient = _u(gen, (3,), 0.1, 0.5, device)
    d = _n(gen, (3,), device)
    d = torch.cat([d[:2], -d[2:].abs() - 0.5])  # from above
    return color, ambient, d / torch.linalg.vector_norm(d)


def randomize_camera_pose(gen, num_envs: int, center, radius=(2.0, 4.0), height=(0.5, 2.5),
                          device="cuda"):
    """(pos (N,3), look_target (N,3)) random orbit poses around `center`
    (domain_randomization.py:169-172)."""
    theta = _u(gen, (num_envs,), 0.0, 2 * math.pi, device)
    r = _u(gen, (num_envs,), *radius, device)
    h = _u(gen, (num_envs,), *height, device)
    center = torch.as_tensor(center, dtype=torch.float32, device=device).expand(num_envs, 3)
    pos = center + torch.stack([r * torch.cos(theta), r * torch.sin(theta), h], -1)
    return pos, center


# -- composite ----------------------------------------------------------------
@dataclasses.dataclass
class DomainRandomizer:
    """Composable randomization schedule: `maybe(gen, params, step)` applies
    the enabled randomizations every `interval` steps (the reference's
    every-100-frames pattern, domain_randomization.py:163)."""

    interval: int = 100
    friction: Optional[Tuple[float, float]] = (0.5, 1.5)
    restitution: Optional[Tuple[float, float]] = None
    mass_scale: Optional[Tuple[float, float]] = (0.8, 1.2)
    gain_scale: Optional[Tuple[float, float]] = None
    gravity_scale: Optional[Tuple[float, float]] = None

    def apply(self, gen, params: PhysParams) -> PhysParams:
        if self.friction is not None:
            params = randomize_shape_friction(gen, params, *self.friction)
        if self.restitution is not None:
            params = randomize_restitution(gen, params, *self.restitution)
        if self.mass_scale is not None:
            params = randomize_body_mass(gen, params, *self.mass_scale)
        if self.gain_scale is not None:
            params = randomize_dof_gains(gen, params, self.gain_scale, self.gain_scale)
        if self.gravity_scale is not None:
            params = randomize_gravity(gen, params, self.gravity_scale)
        return params

    def maybe(self, gen, params: PhysParams, step) -> PhysParams:
        """Conditional application on the step counter (an int or a tensor
        on the params' device): the update is computed, then selected by
        `torch.where`, so a tensor counter needs no host sync."""
        do = torch.as_tensor(step, device=params.gravity.device) % self.interval == 0
        new = self.apply(gen, params)
        return PhysParams(*[None if b is None else torch.where(do, a, b)
                            for a, b in zip(new, params)])
