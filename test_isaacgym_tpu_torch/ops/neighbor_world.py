"""Neighbor-list contacts for LARGE mixed free-body worlds (boxes + spheres).

Port of test_isaacgym_tpu/ops/neighbor_world.py, so far only the spec:
`build_spec` decides, exactly as the JAX package does, which free bodies
leave the static contact table for the neighbor-list path. The path's solve
(broadphase top-k lists, box narrowphase, the Jacobi solve) is not ported
yet, so physics/contacts.py raises NotImplementedError when a scene gets a
spec here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# single-shape free bodies a world needs before it takes the neighbor-list
# path, and the neighbors kept per body (the JAX package's values)
MIN_BODIES = 64
K_NEIGHBORS = 12


class NeighborWorldSpec(NamedTuple):
    """Static description of one env's large free-body world."""

    shape_idx: np.ndarray  # (F,) env shape indices
    free_idx: np.ndarray  # (F,) free-body batch indices
    body_slot: np.ndarray  # (F,) env body slots
    is_box: np.ndarray  # (F,) bool (False = sphere)
    allow: np.ndarray  # (F, F) bool, j > i collidable pairs
    k_neighbors: int
    ground_spheres: bool  # False: sphere ground rows owned elsewhere
    has_ground: bool
    plane_n: np.ndarray  # (3,)
    plane_d: float
    plane_friction: float
    plane_restitution: float
    # local shape offset/rotation in the body frame (projectiles.py-style
    # worlds carry shape origins — the reference's examples/projectiles.py:120).
    # Identity rows are the common case and fold away in the fused pose math.
    local_pos: np.ndarray = None  # (F, 3)
    local_quat: np.ndarray = None  # (F, 4)


def build_spec(scene, exclude_sphere_pairs: bool = False) -> Optional[NeighborWorldSpec]:
    """Pick the single-shape sphere/box free bodies of `scene` when there
    are at least MIN_BODIES of them AND they are not a pure-sphere set
    (pure spheres take the dense path in sphere_world).

    With exclude_sphere_pairs=True (the sphere-world path coexists) this
    spec skips sphere-sphere pairs and sphere ground rows — it handles only
    the pairs that involve a box."""
    from ..core.scene import SHAPE_BOX, SHAPE_SPHERE

    fg = scene.free_group
    if fg is None:
        return None
    sh = scene.shapes
    rows = []
    for fi, b in enumerate(fg.body_slot):
        s = np.nonzero(sh.body_slot == b)[0]
        # single-shape sphere/box free bodies; local shape offset/rotation
        # is allowed (folded into the per-substep pose math, for
        # projectiles.py-style shape origins).
        # BUT the fused pose math treats the shape center as the COM
        # (inertia arms, vc = v + w x arm), so a link whose explicit
        # <inertial> COM is NOT at the geom origin must take the general
        # path or its torque arms are about the wrong point. Auto-derived
        # inertia stays eligible: there the geom center IS the physical
        # COM by construction.
        if len(s) == 1 and sh.kind[s[0]] in (SHAPE_SPHERE, SHAPE_BOX):
            link = scene.actors[fg.slots[fi]].asset.links[0]
            if getattr(link, "explicit_inertial", False) and (
                np.linalg.norm(scene.body_com[b] - sh.pos[s[0]]) > 1e-6
            ):
                continue
            rows.append((int(s[0]), fi, int(b), sh.kind[s[0]] == SHAPE_BOX))
    if len(rows) < MIN_BODIES or not any(r[3] for r in rows):
        return None
    shape_idx = np.array([r[0] for r in rows], np.int32)
    free_idx = np.array([r[1] for r in rows], np.int32)
    body_slot = np.array([r[2] for r in rows], np.int32)
    is_box = np.array([r[3] for r in rows], bool)
    local_pos = np.asarray(sh.pos[shape_idx], np.float32)
    local_quat = np.asarray(sh.quat[shape_idx], np.float32)

    grp = sh.collision_group[shape_idx]
    flt = sh.collision_filter[shape_idx]
    gi, gj = grp[:, None], grp[None, :]
    allow = (gi == gj) | (gi == -1) | (gj == -1)
    allow &= (flt[:, None] & flt[None, :]) == 0
    allow &= np.triu(np.ones_like(allow), 1) > 0  # each pair once, j > i
    if exclude_sphere_pairs:
        allow &= is_box[:, None] | is_box[None, :]

    has_ground = scene.ground is not None and scene.heightfield is None
    if has_ground:
        n = np.asarray(scene.ground.normal, np.float32)
        n = n / max(np.linalg.norm(n), 1e-9)
        pd = float(scene.ground.distance)
        pf = float(scene.ground.static_friction)
        pr = float(scene.ground.restitution)
    else:
        n, pd, pf, pr = np.array([0, 0, 1], np.float32), 0.0, 1.0, 0.0
    return NeighborWorldSpec(
        shape_idx=shape_idx,
        free_idx=free_idx,
        body_slot=body_slot,
        is_box=is_box,
        allow=np.asarray(allow, bool),
        k_neighbors=int(min(K_NEIGHBORS, len(rows) - 1)),
        ground_spheres=not exclude_sphere_pairs,
        has_ground=has_ground,
        plane_n=n,
        plane_d=pd,
        plane_friction=pf,
        plane_restitution=pr,
        local_pos=local_pos,
        local_quat=local_quat,
    )
