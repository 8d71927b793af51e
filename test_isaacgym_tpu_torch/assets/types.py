"""Static asset specifications.

Port of test_isaacgym_tpu/assets/types.py (numpy only). An `AssetSpec` is
the constant description of an articulated rigid body produced by the
URDF/MJCF importers or the primitive constructors. It replaces the
reference's native asset handle (`gym.load_asset` — the reference's
test/test01_isaacgym_asset.py:177-181): pure Python/numpy data, read at
scene build time, never inside the step.

Conventions: quats xyzw; geometry sizes are half-extents for boxes, (radius,)
for spheres, (radius, half_length) for capsules/cylinders (axis = local z).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

# Joint types (string enums keep specs printable; the scene builder maps them
# to ints). Mirrors gymapi.DOF_* / joint type strings
# (the reference's test/test01_isaacgym_asset.py:27-33).
JOINT_FIXED = "fixed"
JOINT_REVOLUTE = "revolute"
JOINT_PRISMATIC = "prismatic"
JOINT_SPHERICAL = "spherical"
JOINT_FLOATING = "floating"

DOF_ROTATION = 0
DOF_TRANSLATION = 1

# Drive modes, numeric values match gymapi.DOF_MODE_*
DOF_MODE_NONE = 0
DOF_MODE_POS = 1
DOF_MODE_VEL = 2
DOF_MODE_EFFORT = 3

GEOM_SPHERE = "sphere"
GEOM_BOX = "box"
GEOM_CAPSULE = "capsule"
GEOM_CYLINDER = "cylinder"
GEOM_MESH = "mesh"
GEOM_PLANE = "plane"

# numpy record dtype matching gymapi's DOF properties array
# (the reference's examples/joint_monkey.py:121-126, dof_controls.py:90-94)
DOF_PROPS_DTYPE = np.dtype(
    [
        ("hasLimits", np.bool_),
        ("lower", np.float32),
        ("upper", np.float32),
        ("driveMode", np.int32),
        ("velocity", np.float32),
        ("effort", np.float32),
        ("stiffness", np.float32),
        ("damping", np.float32),
        ("friction", np.float32),
        ("armature", np.float32),
    ]
)

# Rigid body state structured dtype for the classic per-handle API
# ({pose:{p,r}, vel:{linear,angular}} — the reference's test/test04_isaacgym_vel.py:344-387)
VEC3_DTYPE = np.dtype([("x", np.float32), ("y", np.float32), ("z", np.float32)])
QUAT_DTYPE = np.dtype(
    [("x", np.float32), ("y", np.float32), ("z", np.float32), ("w", np.float32)]
)
TRANSFORM_DTYPE = np.dtype([("p", VEC3_DTYPE), ("r", QUAT_DTYPE)])
VELOCITY_DTYPE = np.dtype([("linear", VEC3_DTYPE), ("angular", VEC3_DTYPE)])
RIGID_BODY_STATE_DTYPE = np.dtype(
    [("pose", TRANSFORM_DTYPE), ("vel", VELOCITY_DTYPE)]
)
DOF_STATE_DTYPE = np.dtype([("pos", np.float32), ("vel", np.float32)])


@dataclasses.dataclass
class GeomSpec:
    kind: str
    size: Tuple[float, ...] = ()
    pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    quat: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    mesh_path: Optional[str] = None
    mesh_scale: Optional[Tuple[float, float, float]] = None
    vertices: Optional[np.ndarray] = None  # (V,3) for meshes (collision hull)
    faces: Optional[np.ndarray] = None
    # SDF collision (SURVEY.md N9): `<sdf resolution="N"/>` in URDF collision
    # requests a voxel SDF grid for this mesh; `sdf` carries a prebuilt
    # (e.g. analytic) assets.sdf.SdfGrid directly
    sdf_resolution: Optional[int] = None
    sdf: Optional[object] = None
    sdf_samples: Optional[np.ndarray] = None  # (P,3) surface contact probes
    #   (full-mesh FPS, AABB-centered frame; meshes that contact an SDF
    #   shape probe it with these points)
    # full-resolution render mesh kept from before convex hulling, in the
    # shape's AABB-centered frame (render/raster.py visual triangle pass —
    # used when the link carries no separate <visual> mesh)
    visual_vertices: Optional[np.ndarray] = None
    visual_faces: Optional[np.ndarray] = None
    color: Optional[Tuple[float, float, float]] = None
    friction: float = 1.0
    restitution: float = 0.0
    density: Optional[float] = None

    def volume(self) -> float:
        if self.kind == GEOM_SPHERE:
            return 4.0 / 3.0 * np.pi * self.size[0] ** 3
        if self.kind == GEOM_BOX:
            hx, hy, hz = self.size
            return 8.0 * hx * hy * hz
        if self.kind == GEOM_CAPSULE:
            r, hl = self.size
            return np.pi * r * r * (2 * hl) + 4.0 / 3.0 * np.pi * r**3
        if self.kind == GEOM_CYLINDER:
            r, hl = self.size
            return np.pi * r * r * (2 * hl)
        if self.kind == GEOM_MESH and self.vertices is not None and len(self.vertices):
            lo = self.vertices.min(0)
            hi = self.vertices.max(0)
            return float(np.prod(np.maximum(hi - lo, 1e-9)))
        return 1e-6

    def unit_inertia(self) -> np.ndarray:
        """Rotational inertia about the geom's own com for unit mass, in the
        geom frame (diagonal, 3x3)."""
        if self.kind == GEOM_SPHERE:
            r = self.size[0]
            i = 0.4 * r * r
            return np.diag([i, i, i])
        if self.kind == GEOM_BOX:
            hx, hy, hz = self.size
            return np.diag(
                [
                    (hy * hy + hz * hz) / 3.0,
                    (hx * hx + hz * hz) / 3.0,
                    (hx * hx + hy * hy) / 3.0,
                ]
            )
        if self.kind in (GEOM_CAPSULE, GEOM_CYLINDER):
            r, hl = self.size
            # cylinder approx (capsule caps folded in) — z axis
            izz = 0.5 * r * r
            ixx = (3 * r * r + (2 * hl) ** 2) / 12.0
            return np.diag([ixx, ixx, izz])
        if self.kind == GEOM_MESH and self.vertices is not None and len(self.vertices):
            lo, hi = self.vertices.min(0), self.vertices.max(0)
            h = np.maximum((hi - lo) * 0.5, 1e-6)
            return np.diag(
                [
                    (h[1] ** 2 + h[2] ** 2) / 3.0,
                    (h[0] ** 2 + h[2] ** 2) / 3.0,
                    (h[0] ** 2 + h[1] ** 2) / 3.0,
                ]
            )
        return np.eye(3) * 1e-4

    def mesh_center(self) -> np.ndarray:
        """Vertex-AABB center in the GEOM frame (zero for primitives).

        The mesh shape/hull/SDF frames are all AABB-centered; composing with
        the collision `<origin>` is the caller's job: the shape origin in the
        LINK frame is `pos + R(quat) @ mesh_center()`."""
        if self.kind == GEOM_MESH and self.vertices is not None and len(self.vertices):
            return (self.vertices.min(0) + self.vertices.max(0)) * 0.5
        return np.zeros(3)

    def center(self) -> np.ndarray:
        """Shape origin in the LINK frame (geom origin + rotated AABB center)."""
        return np.asarray(self.pos, np.float64) + _quat_to_mat_np(
            self.quat
        ) @ self.mesh_center()


@dataclasses.dataclass
class JointSpec:
    name: str
    jtype: str  # JOINT_*
    # joint frame expressed in the PARENT link frame
    parent_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    parent_quat: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    # child link frame expressed in the joint frame (usually identity for URDF)
    child_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    child_quat: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    has_limits: bool = False
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 1e9
    velocity: float = 1e9
    damping: float = 0.0
    friction: float = 0.0
    armature: float = 0.0
    stiffness: float = 0.0
    drive_mode: int = DOF_MODE_NONE

    @property
    def num_dofs(self) -> int:
        if self.jtype in (JOINT_REVOLUTE, JOINT_PRISMATIC):
            return 1
        if self.jtype == JOINT_SPHERICAL:
            return 3
        if self.jtype == JOINT_FLOATING:
            return 6
        return 0


@dataclasses.dataclass
class LinkSpec:
    name: str
    parent: int = -1  # index into AssetSpec.links; -1 = root
    joint: Optional[JointSpec] = None  # inbound joint (None for root)
    mass: float = 0.0
    com: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    inertia: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((3, 3)))
    geoms: List[GeomSpec] = dataclasses.field(default_factory=list)
    visuals: List[GeomSpec] = dataclasses.field(default_factory=list)
    explicit_inertial: bool = False
    # FEM soft-body payload (URDF `<fem>` link — the FleX path of
    # the reference's assets/urdf/icosphere.urdf); the link itself stays a
    # massless rigid placeholder, the tet mesh is simulated by physics/soft.py
    fem: Optional["FemSpec"] = None


@dataclasses.dataclass
class FemSpec:
    """Parsed `<fem>` element: tet mesh + material defaults
    (the reference's examples/soft_body.py:86-92 reads youngs/poissons/
    damping per soft body)."""

    verts: np.ndarray  # (V, 3) in the fem frame
    tets: np.ndarray  # (T, 4) int32
    origin_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    origin_quat: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    density: float = 1000.0
    youngs: float = 1e5
    poissons: float = 0.45
    damping: float = 0.0
    attach_distance: float = 0.0


def zero_config_link_pose(asset: "AssetSpec", link_idx: int):
    """Pose of link `link_idx` in the ASSET ROOT frame at q = 0: compose the
    inbound joint origin transforms up the parent chain (joint motion is zero,
    so only the fixed parent/child offsets contribute)."""
    p = np.zeros(3)
    q = np.array([0.0, 0.0, 0.0, 1.0])
    chain = []
    i = link_idx
    while i >= 0:
        chain.append(i)
        i = asset.links[i].parent
    for i in reversed(chain):
        j = asset.links[i].joint
        if j is None:
            continue
        jp = np.asarray(j.parent_pos, np.float64)
        jq = np.asarray(j.parent_quat, np.float64)
        p = p + _rot_np(q, jp)
        q = _quat_mul_np(q, jq)
        cp = np.asarray(j.child_pos, np.float64)
        cq = np.asarray(j.child_quat, np.float64)
        p = p + _rot_np(q, cp)
        q = _quat_mul_np(q, cq)
    return p, q


def _rot_np(q, v):
    qv, qw = np.asarray(q[:3]), float(q[3])
    t = 2.0 * np.cross(qv, v)
    return np.asarray(v) + qw * t + np.cross(qv, t)


@dataclasses.dataclass
class AssetSpec:
    name: str
    links: List[LinkSpec] = dataclasses.field(default_factory=list)
    fix_base_link: bool = False
    disable_gravity: bool = False
    linear_damping: float = 0.0
    angular_damping: float = 0.0
    max_linear_velocity: float = 1000.0
    max_angular_velocity: float = 64.0
    default_dof_drive_mode: int = DOF_MODE_NONE
    file: Optional[str] = None
    # AssetOptions.thickness: collision margin, consumed by the soft-body
    # solver (soft_body.py:77 sets 0.1 "to avoid interpenetrations")
    thickness: float = 0.0

    # ---- derived topology -------------------------------------------------
    @property
    def num_bodies(self) -> int:
        return len(self.links)

    @property
    def joints(self) -> List[JointSpec]:
        return [l.joint for l in self.links if l.joint is not None]

    @property
    def num_joints(self) -> int:
        return len(self.joints)

    @property
    def num_dofs(self) -> int:
        return sum(j.num_dofs for j in self.joints)

    def rigid_body_names(self) -> List[str]:
        return [l.name for l in self.links]

    def rigid_body_dict(self) -> dict:
        return {l.name: i for i, l in enumerate(self.links)}

    def joint_names(self) -> List[str]:
        return [j.name for j in self.joints]

    def joint_dict(self) -> dict:
        return {j.name: i for i, j in enumerate(self.joints)}

    def dof_names(self) -> List[str]:
        out = []
        for j in self.joints:
            n = j.num_dofs
            if n == 1:
                out.append(j.name)
            else:
                out.extend(f"{j.name}_{ax}" for ax in ("x", "y", "z", "rx", "ry", "rz")[:n])
        return out

    def dof_dict(self) -> dict:
        return {n: i for i, n in enumerate(self.dof_names())}

    def dof_types(self) -> List[int]:
        out = []
        for j in self.joints:
            if j.jtype == JOINT_PRISMATIC:
                out.extend([DOF_TRANSLATION] * j.num_dofs)
            elif j.jtype == JOINT_FLOATING:
                out.extend([DOF_TRANSLATION] * 3 + [DOF_ROTATION] * 3)
            else:
                out.extend([DOF_ROTATION] * j.num_dofs)
        return out

    def dof_properties(self) -> np.ndarray:
        """Default per-DOF properties record array (gymapi layout)."""
        props = np.zeros(self.num_dofs, dtype=DOF_PROPS_DTYPE)
        i = 0
        for j in self.joints:
            for _ in range(j.num_dofs):
                props[i]["hasLimits"] = j.has_limits
                props[i]["lower"] = j.lower
                props[i]["upper"] = j.upper
                props[i]["driveMode"] = (
                    j.drive_mode if j.drive_mode != DOF_MODE_NONE else self.default_dof_drive_mode
                )
                props[i]["velocity"] = j.velocity
                props[i]["effort"] = j.effort
                props[i]["stiffness"] = j.stiffness
                props[i]["damping"] = j.damping
                props[i]["friction"] = j.friction
                props[i]["armature"] = j.armature
                i += 1
        return props


def _quat_to_mat_np(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def compute_default_inertia(link: LinkSpec, density: float) -> None:
    """Fill in mass/com/inertia for links without explicit <inertial>, from
    collision geometry volume x density (IsaacGym computes missing inertia from
    geometry; AssetOptions.density — the reference's examples/body_physics_props.py:85)."""
    geoms = link.geoms or link.visuals
    if not geoms:
        link.mass = 1e-3
        link.inertia = np.eye(3) * 1e-6
        return
    total_m = 0.0
    com = np.zeros(3)
    parts = []
    for g in geoms:
        rho = g.density if g.density is not None else density
        m = rho * g.volume()
        c = g.center()
        parts.append((m, c, g))
        total_m += m
        com += m * c
    com /= max(total_m, 1e-12)
    inertia = np.zeros((3, 3))
    for m, c, g in parts:
        R = _quat_to_mat_np(g.quat)
        ic = m * (R @ g.unit_inertia() @ R.T)
        d = c - com
        inertia += ic + m * ((d @ d) * np.eye(3) - np.outer(d, d))
    link.mass = float(total_m)
    link.com = tuple(com)
    link.inertia = inertia


def collapse_fixed_joints(asset: AssetSpec) -> AssetSpec:
    """Merge links connected by fixed joints into their parent
    (AssetOptions.collapse_fixed_joints — the reference's examples/kuka_bin.py:160).
    The root link is never merged away."""
    keep = [i for i, l in enumerate(asset.links) if i == 0 or l.joint is None or l.joint.jtype != JOINT_FIXED]
    if len(keep) == len(asset.links):
        return asset

    # world-of-parent composition done purely with numpy
    def compose(p1, q1, p2, q2):
        return tuple(np.asarray(p1) + _quat_to_mat_np(q1) @ np.asarray(p2)), tuple(
            _quat_mul_np(q1, q2)
        )

    # offset of each link within its merge target
    target = list(range(len(asset.links)))
    off_pos = [np.zeros(3) for _ in asset.links]
    off_quat = [np.array([0.0, 0.0, 0.0, 1.0]) for _ in asset.links]
    new_links: List[LinkSpec] = []
    remap = {}
    for i, l in enumerate(asset.links):
        if i == 0 or (l.joint is not None and l.joint.jtype != JOINT_FIXED):
            remap[i] = len(new_links)
            nl = LinkSpec(
                name=l.name,
                parent=-1 if l.parent < 0 else remap[target[l.parent]],
                joint=l.joint,
                mass=l.mass,
                com=l.com,
                inertia=l.inertia.copy(),
                geoms=list(l.geoms),
                visuals=list(l.visuals),
                explicit_inertial=l.explicit_inertial,
            )
            # fold the fixed-chain offset of the parent into the joint frame
            if l.joint is not None and l.parent >= 0:
                pp, pq = off_pos[l.parent], off_quat[l.parent]
                jp, jq = compose(pp, pq, l.joint.parent_pos, l.joint.parent_quat)
                nl.joint = dataclasses.replace(l.joint, parent_pos=jp, parent_quat=tuple(jq))
            new_links.append(nl)
            target[i] = i
        else:
            # merge into parent's target
            t = target[l.parent]
            target[i] = t
            pp, pq = off_pos[l.parent], off_quat[l.parent]
            p, q = compose(pp, pq, l.joint.parent_pos, l.joint.parent_quat)
            p, q = compose(p, q, l.joint.child_pos, l.joint.child_quat)
            off_pos[i] = np.asarray(p)
            off_quat[i] = np.asarray(q)
            tgt = new_links[remap[t]]
            R = _quat_to_mat_np(q)
            # merge inertia (parallel axis into target frame)
            m2 = l.mass
            c2 = np.asarray(p) + R @ np.asarray(l.com)
            i2 = R @ l.inertia @ R.T
            m1, c1 = tgt.mass, np.asarray(tgt.com)
            m = m1 + m2
            c = (m1 * c1 + m2 * c2) / max(m, 1e-12)
            def shift(mi, ci, ii):
                d = ci - c
                return ii + mi * ((d @ d) * np.eye(3) - np.outer(d, d))
            tgt.inertia = shift(m1, c1, tgt.inertia) + shift(m2, c2, i2)
            tgt.mass, tgt.com = m, tuple(c)
            # re-frame geoms
            for g in list(l.geoms):
                gp = np.asarray(p) + R @ np.asarray(g.pos)
                gq = _quat_mul_np(q, g.quat)
                tgt.geoms.append(dataclasses.replace(g, pos=tuple(gp), quat=tuple(gq)))
            for g in list(l.visuals):
                gp = np.asarray(p) + R @ np.asarray(g.pos)
                gq = _quat_mul_np(q, g.quat)
                tgt.visuals.append(dataclasses.replace(g, pos=tuple(gp), quat=tuple(gq)))
    return dataclasses.replace(asset, links=new_links)


def _quat_mul_np(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )
