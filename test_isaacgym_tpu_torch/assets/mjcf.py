"""MJCF importer -> AssetSpec.

Port of test_isaacgym_tpu/assets/mjcf.py (host numpy, no torch). It reads
the MJCF subset the reference's assets use (its examples/joint_monkey.py
loads nv_humanoid and nv_ant, domain_randomization.py:76 an MJCF too):
  - <compiler angle="degree|radian" eulerseq>
  - nested <default> classes (`class`, `childclass`) with joint/geom
    attribute inheritance
  - bodies with pos/quat/euler/axisangle/zaxis; <freejoint> or
    <joint type="free"> roots; hinge/slide/ball joints
  - geoms: capsule (incl. fromto), sphere, box, cylinder, ellipsoid, mesh
  - per-joint damping/stiffness/armature/frictionloss/range, degrees ->
    radians; <inertial> with diaginertia/fullinertia, density-based mass
    otherwise
  - <actuator> is ignored (the env sets drive modes and efforts)

MuJoCo uses wxyz quats in XML; converted to xyzw here.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

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
    compute_default_inertia,
    _quat_mul_np,
    _quat_to_mat_np,
)


def _floats(s, default):
    if s is None:
        return np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _wxyz_to_xyzw(q):
    return np.array([q[1], q[2], q[3], q[0]])


def _euler_to_quat(e, eulerseq="xyz"):
    # MJCF euler: extrinsic rotations in compiler eulerseq order (default xyz)
    q = np.array([0.0, 0.0, 0.0, 1.0])
    for axis_name, ang in zip(eulerseq, e):
        axis = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1]}[axis_name]
        h = ang / 2.0
        qa = np.array([axis[0] * np.sin(h), axis[1] * np.sin(h), axis[2] * np.sin(h), np.cos(h)])
        q = _quat_mul_np(qa, q)  # extrinsic: premultiply
    return q


def _body_quat(el, deg2rad, eulerseq):
    if el.get("quat") is not None:
        return _wxyz_to_xyzw(_floats(el.get("quat"), [1, 0, 0, 0]))
    if el.get("euler") is not None:
        return _euler_to_quat(_floats(el.get("euler"), [0, 0, 0]) * deg2rad, eulerseq)
    if el.get("axisangle") is not None:
        aa = _floats(el.get("axisangle"), [0, 0, 1, 0])
        ax = aa[:3] / max(np.linalg.norm(aa[:3]), 1e-9)
        h = aa[3] * deg2rad / 2
        return np.array([ax[0] * np.sin(h), ax[1] * np.sin(h), ax[2] * np.sin(h), np.cos(h)])
    if el.get("zaxis") is not None:
        z = _floats(el.get("zaxis"), [0, 0, 1])
        z = z / max(np.linalg.norm(z), 1e-9)
        # quat rotating (0,0,1) to z
        v = np.cross([0, 0, 1], z)
        c = z[2]
        s = np.linalg.norm(v)
        if s < 1e-9:
            return np.array([1.0, 0, 0, 0]) if c < 0 else np.array([0.0, 0, 0, 1])
        ax = v / s
        h = np.arctan2(s, c) / 2
        return np.array([ax[0] * np.sin(h), ax[1] * np.sin(h), ax[2] * np.sin(h), np.cos(h)])
    return np.array([0.0, 0.0, 0.0, 1.0])


class _Defaults:
    """Resolved attribute defaults per (class, tag)."""

    def __init__(self):
        self.stack: Dict[str, Dict[str, Dict[str, str]]] = {"": {}}

    def child(self, class_name, parent_class):
        merged = {
            tag: dict(attrs) for tag, attrs in self.stack.get(parent_class, {}).items()
        }
        self.stack[class_name] = merged
        return merged

    def apply(self, el, class_name, tag):
        attrs = dict(self.stack.get(class_name, {}).get(tag, {}))
        attrs.update({k: v for k, v in el.attrib.items()})
        return attrs


def _collect_defaults(defaults: _Defaults, el, class_name=""):
    table = defaults.stack.setdefault(class_name, {})
    for child in el:
        if child.tag == "default":
            sub = child.get("class", "")
            defaults.child(sub, class_name)
            _collect_defaults(defaults, child, sub)
        else:
            merged = dict(table.get(child.tag, {}))
            merged.update(child.attrib)
            table[child.tag] = merged


def load_mjcf(
    asset_root: str,
    filename: str,
    fix_base_link: bool = False,
    density: float = 1000.0,
    default_dof_drive_mode: int = 0,
    armature: float = 0.0,
) -> AssetSpec:
    path = os.path.join(asset_root, filename)
    tree = ET.parse(path)
    root_el = tree.getroot()

    compiler = root_el.find("compiler")
    # MJCF default angle unit is degrees
    deg2rad = np.pi / 180.0
    eulerseq = "xyz"
    if compiler is not None:
        if compiler.get("angle", "degree") == "radian":
            deg2rad = 1.0
        eulerseq = compiler.get("eulerseq", "xyz")

    defaults = _Defaults()
    for d in root_el.findall("default"):
        _collect_defaults(defaults, d, d.get("class", ""))

    option = root_el.find("option")
    mj_density = density

    links = []
    link_index = {}

    def parse_geom(el, class_name):
        attrs = defaults.apply(el, el.get("class", class_name), "geom")
        gtype = attrs.get("type", "capsule" if "fromto" in attrs else "sphere")
        if gtype == "plane":
            return None  # world plane handled by ground-plane API
        pos = _floats(attrs.get("pos"), [0, 0, 0])
        quat = np.array([0.0, 0, 0, 1])
        if "quat" in attrs:
            quat = _wxyz_to_xyzw(_floats(attrs["quat"], [1, 0, 0, 0]))
        elif "euler" in attrs:
            quat = _euler_to_quat(_floats(attrs["euler"], [0, 0, 0]) * deg2rad, eulerseq)
        size = _floats(attrs.get("size"), [0.05])
        g_density = float(attrs.get("density", mj_density))
        friction = _floats(attrs.get("friction"), [1.0, 0.005, 0.0001])
        rgba = _floats(attrs.get("rgba"), [0.7, 0.7, 0.7, 1])
        color = tuple(rgba[:3])

        if "fromto" in attrs:
            ft = _floats(attrs["fromto"], [0, 0, 0, 0, 0, 1])
            a, b = ft[:3], ft[3:]
            mid = (a + b) / 2
            d = b - a
            length = np.linalg.norm(d)
            if length > 1e-9:
                z = d / length
                v = np.cross([0, 0, 1], z)
                s = np.linalg.norm(v)
                c = z[2]
                if s < 1e-9:
                    quat = np.array([0.0, 0, 0, 1]) if c > 0 else np.array([1.0, 0, 0, 0])
                else:
                    ax = v / s
                    h = np.arctan2(s, c) / 2
                    quat = np.array(
                        [ax[0] * np.sin(h), ax[1] * np.sin(h), ax[2] * np.sin(h), np.cos(h)]
                    )
            pos = mid
            r = size[0]
            if gtype == "capsule":
                return GeomSpec(
                    GEOM_CAPSULE, (float(r), float(length / 2)), tuple(pos), tuple(quat),
                    color=color, friction=float(friction[0]), density=g_density,
                )
            if gtype == "cylinder":
                return GeomSpec(
                    GEOM_CYLINDER, (float(r), float(length / 2)), tuple(pos), tuple(quat),
                    color=color, friction=float(friction[0]), density=g_density,
                )
            if gtype == "box":
                return GeomSpec(
                    GEOM_BOX, (float(size[1] if len(size) > 1 else r), float(size[1] if len(size) > 1 else r), float(length / 2)),
                    tuple(pos), tuple(quat), color=color, friction=float(friction[0]),
                    density=g_density,
                )
        if gtype == "sphere":
            return GeomSpec(
                GEOM_SPHERE, (float(size[0]),), tuple(pos), tuple(quat),
                color=color, friction=float(friction[0]), density=g_density,
            )
        if gtype == "capsule":
            r, hl = float(size[0]), float(size[1] if len(size) > 1 else size[0])
            return GeomSpec(
                GEOM_CAPSULE, (r, hl), tuple(pos), tuple(quat),
                color=color, friction=float(friction[0]), density=g_density,
            )
        if gtype == "cylinder":
            r, hl = float(size[0]), float(size[1] if len(size) > 1 else size[0])
            return GeomSpec(
                GEOM_CYLINDER, (r, hl), tuple(pos), tuple(quat),
                color=color, friction=float(friction[0]), density=g_density,
            )
        if gtype == "box":
            sz = [float(x) for x in (size if len(size) == 3 else [size[0]] * 3)]
            return GeomSpec(
                GEOM_BOX, tuple(sz), tuple(pos), tuple(quat),
                color=color, friction=float(friction[0]), density=g_density,
            )
        if gtype == "ellipsoid":
            sz = [float(x) for x in (size if len(size) == 3 else [size[0]] * 3)]
            return GeomSpec(  # approximated as box-inertia sphere-collision
                GEOM_SPHERE, (float(min(sz)),), tuple(pos), tuple(quat),
                color=color, friction=float(friction[0]), density=g_density,
            )
        if gtype == "mesh":
            return GeomSpec(
                GEOM_MESH, (), tuple(pos), tuple(quat), mesh_path=attrs.get("mesh"),
                color=color, friction=float(friction[0]), density=g_density,
            )
        return None

    def parse_body(el, parent_idx, class_name, free_root):
        attrs_class = el.get("childclass", class_name)
        name = el.get("name", f"body{len(links)}")
        pos = _floats(el.get("pos"), [0, 0, 0])
        quat = _body_quat(el, deg2rad, eulerseq)

        joints = el.findall("joint")
        freejoint = el.find("freejoint")
        is_free = freejoint is not None or any(
            defaults.apply(j, j.get("class", attrs_class), "joint").get("type") == "free"
            for j in joints
        )

        # Build the chain: MuJoCo allows multiple joints per body; we expand
        # into intermediate massless links (chain of 1-dof joints), keeping the
        # final link as the named body.
        jspecs = []
        if not is_free:
            for j in joints:
                ja = defaults.apply(j, j.get("class", attrs_class), "joint")
                jtype = ja.get("type", "hinge")
                if jtype == "free":
                    continue
                axis = _floats(ja.get("axis"), [0, 0, 1])
                n = np.linalg.norm(axis)
                axis = axis / n if n > 1e-9 else np.array([0.0, 0, 1])
                jpos = _floats(ja.get("pos"), [0, 0, 0])
                rng = ja.get("range")
                has_limits = ja.get("limited", "false") in ("true", "1") or rng is not None
                lo = hi = 0.0
                scale = deg2rad if jtype == "hinge" else 1.0
                if rng is not None:
                    lo, hi = [float(x) * scale for x in rng.split()]
                jspecs.append(
                    JointSpec(
                        name=ja.get("name", f"{name}_joint{len(jspecs)}"),
                        jtype={
                            "hinge": JOINT_REVOLUTE,
                            "slide": JOINT_PRISMATIC,
                            "ball": JOINT_SPHERICAL,
                        }.get(jtype, JOINT_REVOLUTE),
                        parent_pos=tuple(jpos),
                        axis=tuple(axis),
                        has_limits=has_limits,
                        lower=lo,
                        upper=hi,
                        damping=float(ja.get("damping", 0)),
                        stiffness=float(ja.get("stiffness", 0)),
                        armature=float(ja.get("armature", armature)),
                        friction=float(ja.get("frictionloss", 0)),
                        effort=float(ja.get("effort", 1e9)),
                    )
                )

        # link for this body
        l = LinkSpec(name=name)
        inertial = el.find("inertial")
        if inertial is not None:
            l.mass = float(inertial.get("mass", 0))
            l.com = tuple(_floats(inertial.get("pos"), [0, 0, 0]))
            diag = inertial.get("diaginertia")
            if diag is not None:
                l.inertia = np.diag(_floats(diag, [1e-3] * 3))
            full = inertial.get("fullinertia")
            if full is not None:
                v = _floats(full, [1e-3] * 6)
                l.inertia = np.array(
                    [[v[0], v[3], v[4]], [v[3], v[1], v[5]], [v[4], v[5], v[2]]]
                )
            l.explicit_inertial = l.mass > 0
        for g in el.findall("geom"):
            gs = parse_geom(g, attrs_class)
            if gs is not None:
                l.geoms.append(gs)
                l.visuals.append(gs)
        if not l.explicit_inertial:
            compute_default_inertia(l, mj_density)

        if not jspecs:
            # rigidly attached (or free root handled by floating base)
            l.parent = parent_idx
            l.joint = (
                JointSpec(name=f"{name}_fixed", jtype=JOINT_FIXED,
                          parent_pos=tuple(pos), parent_quat=tuple(quat))
                if parent_idx >= 0
                else None
            )
            idx = len(links)
            links.append(l)
        else:
            # first joint carries the body offset; MuJoCo joints attach in
            # order listed, innermost last: expand chain parent -> ... -> body.
            cur_parent = parent_idx
            cur_off_pos, cur_off_quat = tuple(pos), tuple(quat)
            for k, j in enumerate(jspecs):
                is_last = k == len(jspecs) - 1
                # joint frame: body frame offset by joint pos (axis in body coords)
                jj = JointSpec(**{**j.__dict__})
                jj.parent_pos = tuple(
                    np.asarray(cur_off_pos)
                    + _quat_to_mat_np(cur_off_quat) @ _floats(None, j.parent_pos)
                )
                jj.parent_quat = cur_off_quat
                # after the first expansion, subsequent joints sit at the body
                # frame origin (already offset)
                jj.child_pos = tuple(-np.asarray(j.parent_pos))
                if is_last:
                    l.parent = cur_parent
                    l.joint = jj
                    idx = len(links)
                    links.append(l)
                else:
                    inter = LinkSpec(
                        name=f"{name}__j{k}",
                        parent=cur_parent,
                        joint=jj,
                        mass=1e-4,
                        inertia=np.eye(3) * 1e-7,
                    )
                    links.append(inter)
                    cur_parent = len(links) - 1
                    cur_off_pos, cur_off_quat = (0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0)

        body_idx = idx
        for sub in el.findall("body"):
            parse_body(sub, body_idx, attrs_class, False)
        return body_idx

    world = root_el.find("worldbody")
    top_bodies = world.findall("body")
    if not top_bodies:
        raise ValueError(f"no bodies in {path}")

    # reference assets have a single kinematic tree root
    parse_body(top_bodies[0], -1, "", True)
    root_has_freejoint = (
        top_bodies[0].find("freejoint") is not None
        or any(
            defaults.apply(j, j.get("class", ""), "joint").get("type", "hinge") == "free"
            for j in top_bodies[0].findall("joint")
        )
    )
    # root body world offset becomes the default spawn pose (kept in spec via
    # root link having no joint; create_actor's pose overrides it)

    return AssetSpec(
        name=root_el.get("model", os.path.basename(filename)),
        links=links,
        fix_base_link=fix_base_link or not root_has_freejoint,
        default_dof_drive_mode=default_dof_drive_mode,
        file=path,
    )
