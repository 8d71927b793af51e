"""Scene construction: the host-side env factory.

Port of test_isaacgym_tpu/core/scene.py. The build is the same host numpy
code, so both packages get the same scene from the same calls; only
`finalize(device)` differs: it returns the initial `SimState` / `PhysParams`
as torch tensors instead of jax arrays.

Replaces the reference's create_sim/create_env/create_actor handle registry
(SURVEY.md §3.1): the build phase is eager host Python accumulating specs;
`finalize()` compiles them into a `Scene` — static topology arrays grouped for
batched execution — plus the initial `SimState` / `PhysParams` tensors.

Grouping strategy (the heterogeneous-actors-per-env problem, SURVEY.md §7.3.5):
  - every articulated actor slot joins an `ArtGroup` keyed by its AssetSpec, so
    identical robots across slots share one (env, copy) batched dynamics call;
  - all single-body free actors merge into ONE `FreeGroup` stepped as a flat
    (N, F) rigid-body batch (this is what makes 1080-balls-style scenes fast);
  - fixed single bodies become static colliders.

All envs must be homogeneous (same actor layout) — true of every reference
script; the builder enforces it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..assets.types import (
    DOF_MODE_NONE,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_MESH,
    GEOM_SPHERE,
    JOINT_FIXED,
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    JOINT_SPHERICAL,
    AssetSpec,
    JointSpec,
    LinkSpec,
    _quat_mul_np,
    _quat_to_mat_np,
)
from .config import PlaneParams, SimParams


def _vec3t(v):
    """Coerce gymapi.Vec3-style objects (reference scripts assign
    sim_params.gravity = gymapi.Vec3(...)) to a plain tuple."""
    if hasattr(v, "x"):
        return (float(v.x), float(v.y), float(v.z))
    return tuple(float(q) for q in v)

# integer joint codes used in topology arrays
JT_ROOT = 0
JT_REVOLUTE = 1
JT_PRISMATIC = 2
JT_FIXED = 3

# integer geometry codes
SHAPE_SPHERE = 0
SHAPE_BOX = 1
SHAPE_CAPSULE = 2
SHAPE_MESH = 3


def expand_asset(asset: AssetSpec) -> Tuple[List[LinkSpec], np.ndarray, np.ndarray]:
    """Expand spherical joints into 3 revolute sub-joints with interposed
    massless links. Returns (sim_links, body_of_link, dof_of_link) where
    body_of_link maps sim links to asset body indices (-1 for synthetic) and
    dof_of_link maps sim links to asset dof indices (-1 if no dof)."""
    sim_links: List[LinkSpec] = []
    body_of, dof_of = [], []
    remap = {}  # asset link idx -> sim link idx
    dof_idx = 0
    for bi, l in enumerate(asset.links):
        j = l.joint
        if j is None or j.num_dofs <= 1:
            nl = dataclasses.replace(l)
            if j is not None and l.parent >= 0:
                nl.parent = remap[l.parent]
            sim_links.append(nl)
            remap[bi] = len(sim_links) - 1
            body_of.append(bi)
            dof_of.append(dof_idx if (j is not None and j.num_dofs == 1) else -1)
            dof_idx += 0 if j is None else j.num_dofs if j.num_dofs == 1 else 0
        elif j.jtype == JOINT_SPHERICAL:
            # three revolute joints about the joint frame's x, y, z axes
            parent_sim = remap[l.parent]
            axes = [(1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0)]
            for k in range(3):
                last = k == 2
                jj = dataclasses.replace(
                    j,
                    name=f"{j.name}_{'xyz'[k]}",
                    jtype=JOINT_REVOLUTE,
                    axis=axes[k],
                    parent_pos=j.parent_pos if k == 0 else (0, 0, 0),
                    parent_quat=j.parent_quat if k == 0 else (0, 0, 0, 1),
                    child_pos=j.child_pos if last else (0, 0, 0),
                    child_quat=j.child_quat if last else (0, 0, 0, 1),
                )
                if last:
                    nl = dataclasses.replace(l, parent=parent_sim, joint=jj)
                    sim_links.append(nl)
                    remap[bi] = len(sim_links) - 1
                    body_of.append(bi)
                else:
                    sim_links.append(
                        LinkSpec(
                            name=f"{l.name}__sph{k}",
                            parent=parent_sim,
                            joint=jj,
                            mass=1e-4,
                            inertia=np.eye(3) * 1e-7,
                        )
                    )
                    body_of.append(-1)
                dof_of.append(dof_idx)
                dof_idx += 1
                parent_sim = len(sim_links) - 1
        else:
            raise NotImplementedError(f"joint type {j.jtype} with {j.num_dofs} dofs")
    return sim_links, np.asarray(body_of), np.asarray(dof_of)


@dataclasses.dataclass
class ArtGroup:
    """One articulated asset type; K copies (actor slots) per env."""

    asset: AssetSpec
    slots: List[int]
    # sim topology (Ls links after expansion)
    parent: np.ndarray  # (Ls,)
    jtype: np.ndarray  # (Ls,) JT_*
    axis: np.ndarray  # (Ls, 3) joint axis in joint frame
    jp_pos: np.ndarray  # (Ls, 3) joint frame in parent link coords
    jp_quat: np.ndarray  # (Ls, 4)
    jc_pos: np.ndarray  # (Ls, 3) child link frame in joint coords
    jc_quat: np.ndarray  # (Ls, 4)
    body_of_link: np.ndarray  # (Ls,) -> asset body index or -1
    dof_of_link: np.ndarray  # (Ls,) -> group dof index or -1
    mass: np.ndarray  # (Ls,) default masses (synthetic links included)
    com: np.ndarray  # (Ls, 3)
    inertia: np.ndarray  # (Ls, 3, 3)
    fixed_base: bool = False
    # env-layout offsets for each copy
    actor_slots: np.ndarray = None  # (K,)
    body_start: np.ndarray = None  # (K,) into env body axis
    dof_start: np.ndarray = None  # (K,) into env dof axis

    @property
    def num_links(self):
        return len(self.parent)

    @property
    def num_dofs(self):
        return int((self.dof_of_link >= 0).sum())

    @property
    def num_bodies(self):
        return int((self.body_of_link >= 0).sum())


@dataclasses.dataclass
class FreeGroup:
    """All free single-rigid-body actors in an env, as one flat batch."""

    slots: np.ndarray  # (F,) actor slot indices
    body_slot: np.ndarray  # (F,) env body axis indices
    linear_damping: np.ndarray  # (F,)
    angular_damping: np.ndarray
    max_linear_velocity: np.ndarray
    max_angular_velocity: np.ndarray

    @property
    def count(self):
        return len(self.slots)


@dataclasses.dataclass
class StaticGroup:
    """Fixed-base single-body actors: static colliders only."""

    slots: np.ndarray
    body_slot: np.ndarray


@dataclasses.dataclass
class ShapeSet:
    """All collision shapes of one env, flattened (S shapes)."""

    body_slot: np.ndarray  # (S,)
    kind: np.ndarray  # (S,) SHAPE_*
    size: np.ndarray  # (S, 3)
    pos: np.ndarray  # (S, 3) in link frame
    quat: np.ndarray  # (S, 4)
    friction: np.ndarray  # (S,) defaults
    restitution: np.ndarray
    collision_group: np.ndarray  # (S,) actor collision group (env idx or -1)
    collision_filter: np.ndarray  # (S,) bitmask; shared-bit => no collision
    actor_slot: np.ndarray  # (S,)
    hull_id: np.ndarray = None  # (S,) index into Scene.hulls, -1 for primitives
    sdf_id: np.ndarray = None  # (S,) index into Scene.sdfs, -1 = no SDF
    sample_id: np.ndarray = None  # (S,) index into Scene.samples, -1 = none

    @property
    def count(self):
        return len(self.body_slot)


@dataclasses.dataclass
class HeightField:
    """Static terrain heightfield — the device-native collision representation
    for triangle-mesh terrain (SURVEY.md N10: terrain stays a heightfield;
    the trimesh is for rendering). data is in METERS (vertical scale applied);
    row i, col j sits at world (offset_x + i*hs, offset_y + j*hs)."""

    data: np.ndarray  # (R, C) float32 meters
    horizontal_scale: float
    offset_x: float = 0.0
    offset_y: float = 0.0


@dataclasses.dataclass
class AttractorMeta:
    """One 6-DOF virtual spring-damper on a body (template; per-env gains and
    targets live in PhysParams/Actions — SURVEY.md N5,
    the reference's examples/franka_attractor.py:89-133)."""

    slot: int  # actor slot
    body: int  # env body index
    offset_pos: np.ndarray  # (3,) attachment offset in link frame
    offset_quat: np.ndarray  # (4,)
    axes: int  # AXIS_* bitmask
    stiffness: float
    damping: float
    force_limit: float
    target_pos: np.ndarray  # (3,) initial world target
    target_quat: np.ndarray  # (4,)


@dataclasses.dataclass
class ActorMeta:
    """Host-side registry entry for one actor slot (per env)."""

    name: str
    asset: AssetSpec
    slot: int
    body_start: int
    body_count: int
    dof_start: int
    dof_count: int
    shape_start: int
    shape_count: int
    group: int
    filter: int
    seg_id: int = 0


@dataclasses.dataclass
class Scene:
    """Finalized static scene description (host side; arrays are numpy — the
    stepper lifts what it needs to device constants)."""

    sim_params: SimParams
    num_envs: int
    env_origins: np.ndarray  # (N, 3)
    actors: List[ActorMeta]
    art_groups: List[ArtGroup]
    free_group: Optional[FreeGroup]
    static_group: Optional[StaticGroup]
    shapes: ShapeSet
    ground: Optional[PlaneParams]
    num_bodies_per_env: int
    num_dofs_per_env: int
    # initial values (for PhysParams construction)
    init_dof_props: np.ndarray  # structured (D,) DOF_PROPS_DTYPE defaults
    body_mass: np.ndarray  # (B,)
    body_com: np.ndarray  # (B, 3)
    body_inertia: np.ndarray  # (B, 3, 3)
    body_disable_gravity: np.ndarray  # (B,)
    linear_damping: np.ndarray  # (B,)
    angular_damping: np.ndarray  # (B,)
    # terrain heightfield (optional, set via add_heightfield)
    heightfield: Optional[object] = None
    # convex hull vertex sets (local, centered) indexed by ShapeSet.hull_id
    hulls: List[np.ndarray] = dataclasses.field(default_factory=list)
    # SDF voxel grids (assets.sdf.SdfGrid) indexed by ShapeSet.sdf_id
    sdfs: List[object] = dataclasses.field(default_factory=list)
    # surface sample probe sets (P,3) indexed by ShapeSet.sample_id
    samples: List[np.ndarray] = dataclasses.field(default_factory=list)
    # attractor templates (env 0 layout; all envs homogeneous)
    attractors: List[AttractorMeta] = dataclasses.field(default_factory=list)
    # per-env attractor init values (N, T, .) used to seed Actions/PhysParams
    attractor_init: Optional[dict] = None
    # FEM soft-body world (physics/soft.SoftWorld) — None without `<fem>` links
    soft: Optional[object] = None

    @property
    def num_actors_per_env(self):
        return len(self.actors)

    def find_actor(self, name: str) -> ActorMeta:
        for a in self.actors:
            if a.name == name:
                return a
        raise KeyError(name)


def _np_quat_rotate(q, v):
    """Rotate vector v by xyzw quaternion q (host-side numpy)."""
    qv, qw = np.asarray(q[:3]), float(q[3])
    t = 2.0 * np.cross(qv, v)
    return v + qw * t + np.cross(qv, t)


@dataclasses.dataclass
class _ProtoActor:
    asset: AssetSpec
    pos: np.ndarray
    quat: np.ndarray
    name: str
    group: int
    filter: int
    seg_id: int


class SceneBuilder:
    def __init__(self, sim_params: Optional[SimParams] = None):
        self.sim_params = sim_params or SimParams()
        self.ground: Optional[PlaneParams] = None
        self.envs: List[List[_ProtoActor]] = []
        self.env_origins: List[np.ndarray] = []
        self._grid_cols = 1
        self.heightfield = None
        self.attractors: List[List[AttractorMeta]] = []

    # -- build API ----------------------------------------------------------
    def add_ground(self, plane: PlaneParams):
        plane.normal = _vec3t(plane.normal)
        self.ground = plane

    def create_env(self, lower, upper, per_row: int) -> int:
        """Grid placement identical in spirit to gym.create_env
        (the reference's test/test06_isaacgym_vecenv.py:292-296).

        The grid tiles the two HORIZONTAL axes: (x, y) under UP_AXIS_Z,
        (x, z) under UP_AXIS_Y — the up_axis consumption the reference's
        test_graphics_up.py:42-43 relies on."""
        i = len(self.envs)
        lower = np.asarray(lower, dtype=np.float64)
        upper = np.asarray(upper, dtype=np.float64)
        ext = upper - lower
        row, col = divmod(i, max(per_row, 1))
        from .config import UP_AXIS_Y

        if self.sim_params.up_axis == UP_AXIS_Y:
            origin = np.array([col * ext[0], 0.0, row * ext[2]])
        else:
            origin = np.array([col * ext[0], row * ext[1], 0.0])
        self.envs.append([])
        self.env_origins.append(origin)
        return i

    def create_actor(
        self,
        env_idx: int,
        asset: AssetSpec,
        pos=(0, 0, 0),
        quat=(0, 0, 0, 1),
        name: str = "",
        group: int = 0,
        filter: int = 0,
        seg_id: int = 0,
    ) -> int:
        actors = self.envs[env_idx]
        actors.append(
            _ProtoActor(
                asset,
                np.asarray(pos, dtype=np.float64),
                np.asarray(quat, dtype=np.float64),
                name or f"actor{len(actors)}",
                group,
                filter,
                seg_id,
            )
        )
        return len(actors) - 1

    def add_heightfield(
        self,
        heightfield_raw: np.ndarray,
        horizontal_scale: float,
        vertical_scale: float = 1.0,
        offset_x: float = 0.0,
        offset_y: float = 0.0,
    ):
        """gym.add_heightfield equivalent; also the collision backend for
        add_triangle_mesh'ed terrain (examples/terrain_creation.py:113-119)."""
        self.heightfield = HeightField(
            data=np.asarray(heightfield_raw, np.float32) * vertical_scale,
            horizontal_scale=horizontal_scale,
            offset_x=offset_x,
            offset_y=offset_y,
        )

    def add_trimesh_as_heightfield(self, vertices, triangles, offset_x=0.0, offset_y=0.0):
        """Rasterize a terrain trimesh back into a heightfield for contact.
        Exact when the mesh is a regular grid (the terrain_utils output);
        otherwise bins vertices by max-z per cell."""
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        xs = np.unique(np.round(v[:, 0], 6))
        ys = np.unique(np.round(v[:, 1], 6))
        if len(xs) * len(ys) == len(v) and len(xs) > 1 and len(ys) > 1:
            hs = float(np.diff(xs).min())
            order = np.lexsort((np.round(v[:, 1], 6), np.round(v[:, 0], 6)))
            grid = v[order, 2].reshape(len(xs), len(ys))
            self.heightfield = HeightField(
                data=grid,
                horizontal_scale=hs,
                offset_x=float(xs[0]) + offset_x,
                offset_y=float(ys[0]) + offset_y,
            )
            return
        # irregular mesh: bin by max z
        n = max(int(np.sqrt(len(v))), 2)
        x0, x1 = v[:, 0].min(), v[:, 0].max()
        y0, y1 = v[:, 1].min(), v[:, 1].max()
        hs = max((x1 - x0), (y1 - y0)) / n
        R = int((x1 - x0) / hs) + 2
        C = int((y1 - y0) / hs) + 2
        grid = np.full((R, C), v[:, 2].min(), np.float32)
        xi = np.clip(((v[:, 0] - x0) / hs).astype(int), 0, R - 1)
        yi = np.clip(((v[:, 1] - y0) / hs).astype(int), 0, C - 1)
        np.maximum.at(grid, (xi, yi), v[:, 2])
        self.heightfield = HeightField(
            data=grid, horizontal_scale=hs,
            offset_x=float(x0) + offset_x, offset_y=float(y0) + offset_y,
        )

    def add_attractor(
        self,
        env_idx: int,
        slot: int,
        body: int,
        offset_pos=(0, 0, 0),
        offset_quat=(0, 0, 0, 1),
        axes: int = 63,
        stiffness: float = 0.0,
        damping: float = 0.0,
        force_limit: float = np.inf,
        target_pos=(0, 0, 0),
        target_quat=(0, 0, 0, 1),
    ) -> int:
        """body is the asset-local rigid body index of the actor at `slot`
        (resolved to the env body axis at finalize)."""
        while len(self.attractors) < len(self.envs):
            self.attractors.append([])
        lst = self.attractors[env_idx]
        lst.append(
            AttractorMeta(
                slot=slot,
                body=body,
                offset_pos=np.asarray(offset_pos, np.float64),
                offset_quat=np.asarray(offset_quat, np.float64),
                axes=axes,
                stiffness=stiffness,
                damping=damping,
                force_limit=force_limit,
                target_pos=np.asarray(target_pos, np.float64),
                target_quat=np.asarray(target_quat, np.float64),
            )
        )
        return len(lst) - 1

    # -- finalize -----------------------------------------------------------
    def finalize(self, device="cuda"):
        """Compile the build into (Scene, SimState, PhysParams). The scene's
        tables stay numpy on the host; state and params are torch tensors on
        `device`."""
        from ..assets.types import DOF_PROPS_DTYPE
        from .state import PhysParams, SimState, from_numpy

        assert self.envs, "no envs created"
        n_envs = len(self.envs)
        layout0 = [(id(a.asset), a.asset.num_bodies) for a in self.envs[0]]
        for e in self.envs[1:]:
            assert [(id(a.asset), a.asset.num_bodies) for a in e] == layout0, (
                "all envs must have identical actor layout for the batched path"
            )

        protos = self.envs[0]
        A = len(protos)

        # --- slot layout ---------------------------------------------------
        actors: List[ActorMeta] = []
        body_ofs = 0
        dof_ofs = 0
        shape_rows = []
        shape_ofs = 0
        for slot, p in enumerate(protos):
            nb = p.asset.num_bodies
            nd = p.asset.num_dofs
            ns = sum(len(l.geoms) for l in p.asset.links)
            actors.append(
                ActorMeta(
                    name=p.name,
                    asset=p.asset,
                    slot=slot,
                    body_start=body_ofs,
                    body_count=nb,
                    dof_start=dof_ofs,
                    dof_count=nd,
                    shape_start=shape_ofs,
                    shape_count=ns,
                    group=p.group,
                    filter=p.filter,
                    seg_id=p.seg_id,
                )
            )
            body_ofs += nb
            dof_ofs += nd
            shape_ofs += ns
        B, D = body_ofs, dof_ofs

        # --- groups --------------------------------------------------------
        art_map: Dict[int, ArtGroup] = {}
        free_slots, static_slots = [], []
        for slot, p in enumerate(protos):
            a = p.asset
            if a.num_dofs == 0 and a.num_bodies == 1:
                (static_slots if a.fix_base_link else free_slots).append(slot)
                continue
            key = id(a)
            if key not in art_map:
                sim_links, body_of, dof_of = expand_asset(a)
                Ls = len(sim_links)
                g = ArtGroup(
                    asset=a,
                    slots=[],
                    parent=np.array([l.parent for l in sim_links]),
                    jtype=np.array(
                        [
                            JT_ROOT
                            if l.joint is None
                            else {
                                JOINT_REVOLUTE: JT_REVOLUTE,
                                JOINT_PRISMATIC: JT_PRISMATIC,
                                JOINT_FIXED: JT_FIXED,
                            }[l.joint.jtype]
                            for l in sim_links
                        ]
                    ),
                    axis=np.array(
                        [l.joint.axis if l.joint else (0, 0, 1) for l in sim_links],
                        dtype=np.float64,
                    ),
                    jp_pos=np.array(
                        [l.joint.parent_pos if l.joint else (0, 0, 0) for l in sim_links],
                        dtype=np.float64,
                    ),
                    jp_quat=np.array(
                        [l.joint.parent_quat if l.joint else (0, 0, 0, 1) for l in sim_links],
                        dtype=np.float64,
                    ),
                    jc_pos=np.array(
                        [l.joint.child_pos if l.joint else (0, 0, 0) for l in sim_links],
                        dtype=np.float64,
                    ),
                    jc_quat=np.array(
                        [l.joint.child_quat if l.joint else (0, 0, 0, 1) for l in sim_links],
                        dtype=np.float64,
                    ),
                    body_of_link=body_of,
                    dof_of_link=dof_of,
                    mass=np.array([l.mass for l in sim_links]),
                    com=np.array([l.com for l in sim_links], dtype=np.float64),
                    inertia=np.array([l.inertia for l in sim_links]),
                    fixed_base=a.fix_base_link,
                )
                art_map[key] = g
            art_map[key].slots.append(slot)

        for g in art_map.values():
            g.actor_slots = np.array(g.slots)
            g.body_start = np.array([actors[s].body_start for s in g.slots])
            g.dof_start = np.array([actors[s].dof_start for s in g.slots])

        free_group = None
        if free_slots:
            free_group = FreeGroup(
                slots=np.array(free_slots),
                body_slot=np.array([actors[s].body_start for s in free_slots]),
                linear_damping=np.array(
                    [protos[s].asset.linear_damping for s in free_slots]
                ),
                angular_damping=np.array(
                    [protos[s].asset.angular_damping for s in free_slots]
                ),
                max_linear_velocity=np.array(
                    [protos[s].asset.max_linear_velocity for s in free_slots]
                ),
                max_angular_velocity=np.array(
                    [protos[s].asset.max_angular_velocity for s in free_slots]
                ),
            )
        static_group = None
        if static_slots:
            static_group = StaticGroup(
                slots=np.array(static_slots),
                body_slot=np.array([actors[s].body_start for s in static_slots]),
            )

        # --- shapes --------------------------------------------------------
        sh_body, sh_kind, sh_size, sh_pos, sh_quat = [], [], [], [], []
        sh_fric, sh_rest, sh_group, sh_filter, sh_slot = [], [], [], [], []
        sh_hull, sh_sdf, sh_samp = [], [], []
        hulls: List[np.ndarray] = []
        sdfs: List[object] = []
        samples: List[np.ndarray] = []
        hull_of_geom: Dict[int, int] = {}  # id(GeomSpec) -> hull index (dedupe)
        sdf_of_geom: Dict[int, int] = {}
        samp_of_geom: Dict[int, int] = {}
        for slot, p in enumerate(protos):
            meta = actors[slot]
            for li, l in enumerate(p.asset.links):
                for g in l.geoms:
                    sh_body.append(meta.body_start + li)
                    hull_id = -1
                    sdf_id = samp_id = -1
                    if g.kind == GEOM_MESH and getattr(g, "sdf", None) is not None:
                        if id(g) not in sdf_of_geom:
                            sdf_of_geom[id(g)] = len(sdfs)
                            sdfs.append(g.sdf)
                        sdf_id = sdf_of_geom[id(g)]
                    if g.kind == GEOM_MESH and getattr(g, "sdf_samples", None) is not None:
                        if id(g) not in samp_of_geom:
                            samp_of_geom[id(g)] = len(samples)
                            samples.append(np.asarray(g.sdf_samples, np.float32))
                        samp_id = samp_of_geom[id(g)]
                    if g.kind == GEOM_SPHERE:
                        sh_kind.append(SHAPE_SPHERE)
                        sh_size.append((g.size[0], 0, 0))
                    elif g.kind == GEOM_BOX:
                        sh_kind.append(SHAPE_BOX)
                        sh_size.append(tuple(g.size))
                    elif g.kind in (GEOM_CAPSULE, GEOM_CYLINDER):
                        sh_kind.append(SHAPE_CAPSULE)
                        sh_size.append((g.size[0], g.size[1], 0))
                    elif g.kind == GEOM_MESH:
                        sh_kind.append(SHAPE_MESH)
                        if g.vertices is not None and len(g.vertices):
                            h = (g.vertices.max(0) - g.vertices.min(0)) / 2
                            sh_size.append(tuple(np.maximum(h, 1e-4)))
                            if id(g) in hull_of_geom:
                                hull_id = hull_of_geom[id(g)]
                            else:
                                hull_id = len(hulls)
                                hulls.append(
                                    np.asarray(
                                        g.vertices - g.mesh_center(), np.float32
                                    )
                                )
                                hull_of_geom[id(g)] = hull_id
                        else:
                            sh_size.append((0.05, 0.05, 0.05))
                    else:
                        sh_kind.append(SHAPE_SPHERE)
                        sh_size.append((0.05, 0, 0))
                    # shape origin in the LINK frame: geom origin offset plus
                    # the rotated mesh-AABB center (identity for primitives)
                    center = g.center()
                    sh_hull.append(hull_id)
                    sh_sdf.append(sdf_id)
                    sh_samp.append(samp_id)
                    sh_pos.append(center)
                    sh_quat.append(tuple(g.quat))
                    sh_fric.append(g.friction)
                    sh_rest.append(g.restitution)
                    sh_group.append(p.group)
                    sh_filter.append(p.filter)
                    sh_slot.append(slot)
        shapes = ShapeSet(
            body_slot=np.array(sh_body, dtype=np.int32) if sh_body else np.zeros(0, np.int32),
            kind=np.array(sh_kind, dtype=np.int32) if sh_kind else np.zeros(0, np.int32),
            size=np.array(sh_size, dtype=np.float64).reshape(-1, 3),
            pos=np.array(sh_pos, dtype=np.float64).reshape(-1, 3),
            quat=np.array(sh_quat, dtype=np.float64).reshape(-1, 4),
            friction=np.array(sh_fric, dtype=np.float64),
            restitution=np.array(sh_rest, dtype=np.float64),
            collision_group=np.array(sh_group, dtype=np.int32) if sh_group else np.zeros(0, np.int32),
            collision_filter=np.array(sh_filter, dtype=np.int32) if sh_filter else np.zeros(0, np.int32),
            actor_slot=np.array(sh_slot, dtype=np.int32) if sh_slot else np.zeros(0, np.int32),
            hull_id=np.array(sh_hull, dtype=np.int32) if sh_hull else np.zeros(0, np.int32),
            sdf_id=np.array(sh_sdf, dtype=np.int32) if sh_sdf else np.zeros(0, np.int32),
            sample_id=np.array(sh_samp, dtype=np.int32) if sh_samp else np.zeros(0, np.int32),
        )

        # --- default body/dof params --------------------------------------
        body_mass = np.zeros(B)
        body_com = np.zeros((B, 3))
        body_inertia = np.zeros((B, 3, 3))
        body_dis_grav = np.zeros(B, dtype=bool)
        lin_damp = np.zeros(B)
        ang_damp = np.zeros(B)
        init_dof_props = np.zeros(D, dtype=DOF_PROPS_DTYPE)
        for slot, p in enumerate(protos):
            meta = actors[slot]
            for li, l in enumerate(p.asset.links):
                bi = meta.body_start + li
                body_mass[bi] = l.mass
                body_com[bi] = l.com
                body_inertia[bi] = l.inertia
                body_dis_grav[bi] = p.asset.disable_gravity
                lin_damp[bi] = p.asset.linear_damping
                ang_damp[bi] = p.asset.angular_damping
            if meta.dof_count:
                init_dof_props[meta.dof_start : meta.dof_start + meta.dof_count] = (
                    p.asset.dof_properties()
                )

        # --- attractors ------------------------------------------------------
        while len(self.attractors) < n_envs:
            self.attractors.append([])
        T = len(self.attractors[0])
        for e, lst in enumerate(self.attractors):
            assert len(lst) == T, "all envs must have identical attractor layout"
        attr_template = []
        for t, a in enumerate(self.attractors[0]):
            m = actors[a.slot]
            attr_template.append(
                dataclasses.replace(a, body=m.body_start + a.body)
            )
        attr_init = {
            "stiffness": np.array(
                [[a.stiffness for a in lst] for lst in self.attractors], np.float32
            ).reshape(n_envs, T),
            "damping": np.array(
                [[a.damping for a in lst] for lst in self.attractors], np.float32
            ).reshape(n_envs, T),
            "force_limit": np.array(
                [[a.force_limit for a in lst] for lst in self.attractors], np.float32
            ).reshape(n_envs, T),
            "target_pos": np.array(
                [
                    [self.env_origins[e] + a.target_pos for a in lst]
                    for e, lst in enumerate(self.attractors)
                ],
                np.float32,
            ).reshape(n_envs, T, 3),
            "target_quat": np.array(
                [[a.target_quat for a in lst] for lst in self.attractors], np.float32
            ).reshape(n_envs, T, 4),
        }

        # --- soft bodies ----------------------------------------------------
        from ..physics.soft import build_soft_world

        soft = build_soft_world(protos, actors, shapes, self.env_origins[0], hulls)

        scene = Scene(
            sim_params=self.sim_params,
            num_envs=n_envs,
            env_origins=np.asarray(self.env_origins),
            actors=actors,
            art_groups=list(art_map.values()),
            free_group=free_group,
            static_group=static_group,
            shapes=shapes,
            ground=self.ground,
            num_bodies_per_env=B,
            num_dofs_per_env=D,
            init_dof_props=init_dof_props,
            body_mass=body_mass,
            body_com=body_com,
            body_inertia=body_inertia,
            body_disable_gravity=body_dis_grav,
            linear_damping=lin_damp,
            angular_damping=ang_damp,
            heightfield=self.heightfield,
            hulls=hulls,
            sdfs=sdfs,
            samples=samples,
            attractors=attr_template,
            attractor_init=attr_init,
            soft=soft,
        )

        # --- initial state -------------------------------------------------
        f32 = np.float32
        root_pos = np.zeros((n_envs, A, 3), f32)
        root_quat = np.zeros((n_envs, A, 4), f32)
        root_quat[..., 3] = 1.0
        for e in range(n_envs):
            for slot, p in enumerate(self.envs[e]):
                root_pos[e, slot] = self.env_origins[e] + p.pos
                root_quat[e, slot] = p.quat
        fields = dict(
            root_pos=root_pos,
            root_quat=root_quat,
            root_linvel=np.zeros((n_envs, A, 3), f32),
            root_angvel=np.zeros((n_envs, A, 3), f32),
            dof_pos=np.zeros((n_envs, D), f32),
            dof_vel=np.zeros((n_envs, D), f32),
            body_pos=np.zeros((n_envs, B, 3), f32),
            body_quat=np.tile(np.array([0, 0, 0, 1], f32), (n_envs, B, 1)),
            body_linvel=np.zeros((n_envs, B, 3), f32),
            body_angvel=np.zeros((n_envs, B, 3), f32),
            contact_force=np.zeros((n_envs, B, 3), f32),
            time=np.zeros((), f32),
            steps=np.zeros((), np.int32),
        )
        if soft is not None:
            sp0 = soft.verts0[None] + np.asarray(self.env_origins, f32)[:, None]
            fields.update(soft_pos=sp0.astype(f32),
                          soft_vel=np.zeros((n_envs, soft.num_verts, 3), f32))
        state = from_numpy(fields, SimState, device)

        p = init_dof_props
        tile = lambda x: np.tile(np.asarray(x, f32), (n_envs,) + (1,) * np.ndim(x))
        fields = dict(
            dof_stiffness=tile(p["stiffness"]),
            dof_damping=tile(p["damping"]),
            dof_armature=tile(p["armature"]),
            dof_friction=tile(p["friction"]),
            dof_lower=tile(p["lower"]),
            dof_upper=tile(p["upper"]),
            dof_has_limits=(
                np.tile(p["hasLimits"], (n_envs, 1)) if D else np.zeros((n_envs, 0), bool)
            ),
            dof_max_effort=tile(p["effort"]),
            dof_max_velocity=tile(p["velocity"]),
            dof_drive_mode=(
                np.tile(p["driveMode"].astype(np.int32), (n_envs, 1))
                if D
                else np.zeros((n_envs, 0), np.int32)
            ),
            body_mass=tile(body_mass),
            body_com=tile(body_com),
            body_inertia=tile(body_inertia),
            body_disable_gravity=np.tile(body_dis_grav, (n_envs, 1)),
            shape_friction=tile(shapes.friction) if shapes.count else np.zeros((n_envs, 0), f32),
            shape_restitution=tile(shapes.restitution) if shapes.count else np.zeros((n_envs, 0), f32),
            shape_size=tile(shapes.size) if shapes.count else np.zeros((n_envs, 0, 3), f32),
            shape_pos=tile(shapes.pos) if shapes.count else np.zeros((n_envs, 0, 3), f32),
            attractor_stiffness=attr_init["stiffness"],
            attractor_damping=attr_init["damping"],
            attractor_force_limit=attr_init["force_limit"],
            gravity=np.asarray(_vec3t(self.sim_params.gravity), f32),
        )
        if soft is not None:
            fields.update(
                soft_youngs=tile(np.array([i.youngs for i in soft.instances])),
                soft_poissons=tile(np.array([i.poissons for i in soft.instances])),
                soft_damping=tile(np.array([i.damping for i in soft.instances])),
            )
        params = from_numpy(fields, PhysParams, device)
        return scene, state, params
