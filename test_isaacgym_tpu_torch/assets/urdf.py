"""URDF importer -> AssetSpec.

Port of test_isaacgym_tpu/assets/urdf.py (host numpy, no torch). Handles:
  - box/sphere/capsule/cylinder/mesh geometry (collision + visual); a
    collision mesh becomes its convex hull of at most `max_hull_verts`
    vertices, and keeps the full mesh for rendering
  - `package://` mesh paths resolved against the asset root (the
    reference's assets/urdf/uav/urdf/rq-1-predator-mae-uav.urdf:14)
  - missing <inertial> -> density-based defaults (IsaacGym behavior)
  - fixed / revolute / continuous / prismatic / spherical joints, limits and
    dynamics
  - mimic-free trees only
  - collapse_fixed (AssetOptions.collapse_fixed_joints)
  - `<sdf resolution="N"/>` in a mesh collision element: a voxel SDF grid of
    the full mesh (quantized to assets.sdf.SDF_RES) and 256 surface probes,
    both taken before hulling (the reference's nut-bolt URDFs)
  - `<fem>` soft-body links: a `<tetmesh>` `.tet` file, the material tags
    and the origin (physics/soft.py simulates the mesh)
  - `use_mesh_materials`: a visual OBJ's MTL diffuse colors override the
    URDF's `<material>` (AssetOptions.use_mesh_materials)
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from .mesh import convex_hull_vertices, load_mesh
from .types import (
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
    GeomSpec,
    JointSpec,
    LinkSpec,
    _quat_to_mat_np,
    collapse_fixed_joints,
    compute_default_inertia,
)

_JOINT_TYPES = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
    "spherical": JOINT_SPHERICAL,  # IsaacGym URDF extension
    "floating": JOINT_FIXED,  # not used by reference assets
    "planar": JOINT_FIXED,
}


def _floats(s: Optional[str], default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _rpy_to_quat(rpy):
    """URDF rpy = extrinsic XYZ (== intrinsic ZYX with reversed order) -> xyzw."""
    r, p, y = rpy
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ]
    )


def _parse_origin(el):
    if el is None:
        return np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])
    xyz = _floats(el.get("xyz"), [0, 0, 0])
    rpy = _floats(el.get("rpy"), [0, 0, 0])
    return xyz, _rpy_to_quat(rpy)


def _resolve_mesh_path(filename: str, urdf_dir: str, asset_root: str) -> str:
    if filename.startswith("package://"):
        rel = filename[len("package://") :]
        # search asset_root and urdf ancestors for the package dir
        cands = [
            os.path.join(asset_root, rel),
            os.path.join(asset_root, "urdf", rel),
            os.path.join(os.path.dirname(urdf_dir), rel),
            os.path.join(os.path.dirname(os.path.dirname(urdf_dir)), rel),
        ]
        for c in cands:
            if os.path.exists(c):
                return c
        return cands[0]
    if os.path.isabs(filename):
        return filename
    # plain relative paths: the reference's assets resolve some against the
    # URDF's directory, others against the asset root or its parent (e.g.
    # ycb/011_banana/collision.obj inside urdf/ycb/011_banana/*.urdf)
    cands = [
        os.path.join(urdf_dir, filename),
        os.path.join(asset_root, filename),
        os.path.join(asset_root, "urdf", filename),
        os.path.join(os.path.dirname(urdf_dir), filename),
    ]
    for c in cands:
        if os.path.exists(c):
            return c
    return cands[0]


def _parse_geometry(geo_el, origin_el, urdf_dir, asset_root, load_meshes):
    pos, quat = _parse_origin(origin_el)
    g = geo_el.find("geometry")
    if g is None:
        return None
    for child in g:
        tag = child.tag
        if tag == "box":
            size = _floats(child.get("size"), [1, 1, 1]) * 0.5
            return GeomSpec(GEOM_BOX, tuple(size), tuple(pos), tuple(quat))
        if tag == "sphere":
            return GeomSpec(
                GEOM_SPHERE, (float(child.get("radius", 0.5)),), tuple(pos), tuple(quat)
            )
        if tag == "cylinder":
            r = float(child.get("radius", 0.5))
            l = float(child.get("length", 1.0))
            return GeomSpec(GEOM_CYLINDER, (r, l * 0.5), tuple(pos), tuple(quat))
        if tag == "capsule":
            r = float(child.get("radius", 0.5))
            l = float(child.get("length", 1.0))
            return GeomSpec(GEOM_CAPSULE, (r, l * 0.5), tuple(pos), tuple(quat))
        if tag == "mesh":
            fn = child.get("filename", "")
            scale = _floats(child.get("scale"), [1, 1, 1])
            path = _resolve_mesh_path(fn, urdf_dir, asset_root)
            verts = faces = None
            if load_meshes:
                verts, faces = load_mesh(path)
                if verts is not None:
                    verts = (verts * scale).astype(np.float32)
            return GeomSpec(
                GEOM_MESH, (), tuple(pos), tuple(quat), mesh_path=path,
                mesh_scale=tuple(scale), vertices=verts, faces=faces,
            )
    return None


_sdf_res_warned = set()


def mesh_material_color(mesh_path: str):
    """Mean diffuse (Kd) color of an OBJ's MTL materials, or None.

    AssetOptions.use_mesh_materials pulls materials from the mesh file
    instead of the URDF override (the reference's examples/
    graphics_materials.py:77-88). The renderer shades one albedo per shape,
    so mesh-level materials reduce to the mean Kd. Best effort, as in the
    JAX package: a file that cannot be read or parsed gives None."""
    try:
        if not mesh_path or not mesh_path.lower().endswith(".obj"):
            return None
        mtl = None
        with open(mesh_path) as f:
            for line in f:
                if line.startswith("mtllib"):
                    mtl = os.path.join(os.path.dirname(mesh_path), line.split(None, 1)[1].strip())
                    break
        if mtl is None or not os.path.exists(mtl):
            return None
        kds = []
        with open(mtl) as f:
            for line in f:
                if line.startswith("Kd "):
                    kds.append([float(x) for x in line.split()[1:4]])
        if not kds:
            return None
        return tuple(np.mean(np.asarray(kds), axis=0).tolist())
    except Exception:  # noqa: BLE001 — material parsing is best-effort
        return None


def _log_sdf_res_once(path: str, requested: int) -> None:
    """All SDF grids in a scene stack into one (K, R, R, R) device tensor, so
    per-asset `<sdf resolution>` requests are quantized to assets.sdf.SDF_RES;
    say so once per asset instead of silently ignoring the request."""
    if path not in _sdf_res_warned:
        _sdf_res_warned.add(path)
        from .sdf import SDF_RES

        print(
            f"[test_isaacgym_tpu_torch] {os.path.basename(path)}: <sdf resolution="
            f"{requested}> quantized to the scene-wide grid size {SDF_RES}"
        )


def load_urdf(
    asset_root: str,
    filename: str,
    fix_base_link: bool = False,
    collapse_fixed: bool = False,
    density: float = 1000.0,
    default_dof_drive_mode: int = 0,
    armature: float = 0.0,
    load_meshes: bool = True,
    max_hull_verts: int = 64,
    use_mesh_materials: bool = False,
) -> AssetSpec:
    path = os.path.join(asset_root, filename)
    tree = ET.parse(path)
    robot = tree.getroot()
    urdf_dir = os.path.dirname(path)

    links_by_name = {}
    for el in robot.findall("link"):
        name = el.get("name")
        l = LinkSpec(name=name)
        inertial = el.find("inertial")
        if inertial is not None:
            mass_el = inertial.find("mass")
            l.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            ipos, iquat = _parse_origin(inertial.find("origin"))
            l.com = tuple(ipos)
            inr = inertial.find("inertia")
            if inr is not None:
                ixx = float(inr.get("ixx", 0))
                iyy = float(inr.get("iyy", 0))
                izz = float(inr.get("izz", 0))
                ixy = float(inr.get("ixy", 0))
                ixz = float(inr.get("ixz", 0))
                iyz = float(inr.get("iyz", 0))
                I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
                # rotate into link frame
                R = _quat_to_mat_np(iquat)
                l.inertia = R @ I @ R.T
            else:
                l.inertia = np.eye(3) * 1e-3
            l.explicit_inertial = l.mass > 0
        for c in el.findall("collision"):
            g = _parse_geometry(c, c.find("origin"), urdf_dir, asset_root, load_meshes)
            if g is not None:
                if g.kind == GEOM_MESH and g.vertices is not None:
                    sdf_el = c.find("sdf")
                    if sdf_el is not None:
                        # grid and surface probes of the FULL mesh (concave
                        # thread detail) before convex hulling, in the
                        # mesh-AABB-centered frame the scene's shape origin
                        # uses (GeomSpec.center applies the collision
                        # <origin> offset)
                        from .sdf import SDF_RES, farthest_point_sample, sdf_from_mesh

                        g.sdf_resolution = int(sdf_el.get("resolution", 256))
                        if g.sdf_resolution != SDF_RES:
                            _log_sdf_res_once(path, g.sdf_resolution)
                        g.sdf = sdf_from_mesh(g.vertices, g.faces)
                        g.sdf_samples = farthest_point_sample(
                            g.vertices - g.mesh_center(), 256
                        )
                    if g.faces is not None and len(g.faces):
                        # keep the full mesh for the visual triangle pass
                        # (AABB-centered = shape frame) before hulling
                        g.visual_vertices = g.vertices - g.mesh_center()
                        g.visual_faces = np.asarray(g.faces, np.int32)
                    g.vertices = convex_hull_vertices(g.vertices, max_hull_verts)
                l.geoms.append(g)
        for v in el.findall("visual"):
            g = _parse_geometry(v, v.find("origin"), urdf_dir, asset_root, load_meshes)
            if g is not None:
                mat = v.find("material")
                if mat is not None:
                    col = mat.find("color")
                    if col is not None:
                        rgba = _floats(col.get("rgba"), [0.7, 0.7, 0.7, 1])
                        g.color = tuple(rgba[:3])
                if use_mesh_materials and g.kind == GEOM_MESH:
                    mc = mesh_material_color(g.mesh_path)
                    if mc is not None:
                        g.color = mc  # mesh file materials win
                l.visuals.append(g)
        # propagate visual color to the link's collision geoms (the renderer
        # ray-casts collision proxies; visual-only colors would be invisible)
        vis_col = next((v.color for v in l.visuals if v.color is not None), None)
        if vis_col is not None:
            for cg in l.geoms:
                if cg.color is None:
                    cg.color = vis_col
        fem_el = el.find("fem")
        if fem_el is not None:
            # FleX soft-body link (the reference's assets/urdf/icosphere.urdf):
            # tet mesh + material defaults; simulated by physics/soft.py
            from ..physics.soft import load_tet
            from .types import FemSpec

            def _val(tag, default):
                e = fem_el.find(tag)
                return float(e.get("value")) if e is not None else default

            fpos, fquat = _parse_origin(fem_el.find("origin"))
            tm = fem_el.find("tetmesh")
            tv, tt = load_tet(_resolve_mesh_path(tm.get("filename"), urdf_dir, asset_root))
            l.fem = FemSpec(
                verts=tv,
                tets=tt,
                origin_pos=tuple(fpos),
                origin_quat=tuple(fquat),
                density=_val("density", 1000.0),
                youngs=_val("youngs", 1e5),
                poissons=_val("poissons", 0.45),
                damping=_val("damping", 0.0),
                attach_distance=_val("attachDistance", 0.0),
            )
        if not l.explicit_inertial:
            compute_default_inertia(l, density)
        if l.fem is not None and l.mass == 0.0 and not l.geoms:
            # massless rigid placeholder for the soft link: keep the joint
            # chain SPD without affecting dynamics
            l.mass = 1e-3
            l.inertia = np.eye(3) * 1e-6
        links_by_name[name] = l

    # joints define the tree
    children = {}
    joint_of_child = {}
    for jel in robot.findall("joint"):
        jt = _JOINT_TYPES.get(jel.get("type", "fixed"), JOINT_FIXED)
        parent = jel.find("parent").get("link")
        child = jel.find("child").get("link")
        pos, quat = _parse_origin(jel.find("origin"))
        axis = _floats(
            jel.find("axis").get("xyz") if jel.find("axis") is not None else None,
            [1, 0, 0],
        )
        n = np.linalg.norm(axis)
        axis = axis / n if n > 1e-9 else np.array([1.0, 0, 0])
        limit = jel.find("limit")
        dyn = jel.find("dynamics")
        j = JointSpec(
            name=jel.get("name"),
            jtype=jt,
            parent_pos=tuple(pos),
            parent_quat=tuple(quat),
            axis=tuple(axis),
            armature=armature,
        )
        if limit is not None:
            if limit.get("lower") is not None or limit.get("upper") is not None:
                if jel.get("type") != "continuous":
                    j.has_limits = True
                j.lower = float(limit.get("lower", 0))
                j.upper = float(limit.get("upper", 0))
            j.effort = float(limit.get("effort", 1e9) or 1e9)
            j.velocity = float(limit.get("velocity", 1e9) or 1e9)
        elif jt == JOINT_REVOLUTE and jel.get("type") == "revolute":
            j.has_limits = True  # revolute without limit tag: URDF requires limits
        if dyn is not None:
            j.damping = float(dyn.get("damping", 0))
            j.friction = float(dyn.get("friction", 0))
        children.setdefault(parent, []).append(child)
        joint_of_child[child] = (parent, j)

    # find root: link that is never a child
    all_children = set(joint_of_child)
    roots = [n for n in links_by_name if n not in all_children]
    if not roots:
        raise ValueError(f"no root link found in {path}")
    root = roots[0]

    # topological ordering (DFS preserving declaration order)
    order = []

    def visit(name):
        order.append(name)
        for c in children.get(name, []):
            visit(c)

    visit(root)

    index = {n: i for i, n in enumerate(order)}
    links = []
    for n in order:
        l = links_by_name[n]
        if n in joint_of_child:
            pname, j = joint_of_child[n]
            l.parent = index[pname]
            l.joint = j
        links.append(l)

    asset = AssetSpec(
        name=robot.get("name", os.path.basename(filename)),
        links=links,
        fix_base_link=fix_base_link,
        default_dof_drive_mode=default_dof_drive_mode,
        file=path,
    )
    if collapse_fixed:
        asset = collapse_fixed_joints(asset)
    return asset
