"""Procedural primitive assets: gym.create_box / create_sphere / create_capsule
(the reference's examples/franka_cube_ik_osc.py:156, interop_torch.py:56,
body_physics_props.py:92).

Mesh assets (create_mesh_asset) need the hull and SDF builders and come
with the SDF slice of the port."""
from __future__ import annotations

import numpy as np

from .types import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_SPHERE,
    AssetSpec,
    GeomSpec,
    LinkSpec,
    compute_default_inertia,
)


def _single_body_asset(name: str, geom: GeomSpec, density: float, **opts) -> AssetSpec:
    link = LinkSpec(name="base")
    link.geoms.append(geom)
    link.visuals.append(geom)
    compute_default_inertia(link, density)
    return AssetSpec(name=name, links=[link], **opts)


def create_box(sx: float, sy: float, sz: float, density: float = 1000.0, **opts) -> AssetSpec:
    """Full extents sx,sy,sz (gymapi semantics); stored as half-extents."""
    g = GeomSpec(GEOM_BOX, (sx / 2, sy / 2, sz / 2))
    return _single_body_asset(f"box_{sx}x{sy}x{sz}", g, density, **opts)


def create_sphere(radius: float, density: float = 1000.0, **opts) -> AssetSpec:
    g = GeomSpec(GEOM_SPHERE, (radius,))
    return _single_body_asset(f"sphere_{radius}", g, density, **opts)


def create_capsule(radius: float, half_length: float, density: float = 1000.0, **opts) -> AssetSpec:
    g = GeomSpec(GEOM_CAPSULE, (radius, half_length))
    return _single_body_asset(f"capsule_{radius}_{half_length}", g, density, **opts)
