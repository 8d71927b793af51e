"""Minimal OBJ/STL/DAE mesh loading for collision geometry.

Port of test_isaacgym_tpu/assets/mesh.py (host numpy, the same code).
Meshes become convex-hull vertex sets that the contact table consumes
(physics/contacts.py, the hull kinds). Missing mesh files (the reference
repo strips its large blobs) degrade to None, so asset loading never fails
on them.
"""
from __future__ import annotations

import os
import struct
from typing import Optional, Tuple

import numpy as np


def load_mesh(path: str) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Returns (vertices (V,3) float32, faces (F,3) int32) or (None, None)."""
    if not path or not os.path.exists(path):
        return None, None
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".obj":
            return _load_obj(path)
        if ext == ".stl":
            return _load_stl(path)
        if ext == ".dae":
            return _load_dae(path)
    except Exception:
        return None, None
    return None, None


def _load_obj(path):
    verts, faces = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts:
        return None, None
    return (
        np.asarray(verts, dtype=np.float32),
        np.asarray(faces, dtype=np.int32) if faces else None,
    )


def _load_stl(path):
    with open(path, "rb") as f:
        header = f.read(80)
        if header[:5] == b"solid" and b"facet" in open(path, "rb").read(2048):
            return _load_stl_ascii(path)
        (n,) = struct.unpack("<I", f.read(4))
        data = np.fromfile(f, dtype=np.uint8, count=n * 50)
    if len(data) < n * 50:
        return None, None
    rec = data.reshape(n, 50)
    tri = rec[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)
    verts = tri.reshape(-1, 3)
    uniq, inv = np.unique(verts.round(6), axis=0, return_inverse=True)
    faces = inv.reshape(n, 3).astype(np.int32)
    return uniq.astype(np.float32), faces


def _load_stl_ascii(path):
    verts = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            t = line.split()
            if t and t[0] == "vertex":
                verts.append([float(t[1]), float(t[2]), float(t[3])])
    if not verts:
        return None, None
    v = np.asarray(verts, dtype=np.float32)
    n = len(v) // 3
    uniq, inv = np.unique(v.round(6), axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv[: n * 3].reshape(n, 3).astype(np.int32)


def _load_dae(path):
    """Small COLLADA reader: positions + triangulated faces.

    Handles <triangles> and <polylist> primitives with interleaved index
    streams (VERTEX input offset within stride = max offset + 1), the
    <unit meter=.../> scale, and multiple <geometry> nodes (concatenated
    in file-local coordinates — the repo's assets use identity scene
    transforms). Enough fidelity for visual-mesh rendering
    (graphics_materials.py-class scenes); not a general COLLADA importer."""
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    root = tree.getroot()

    def tag(e):
        return e.tag.rsplit("}", 1)[-1]

    scale = 1.0
    for u in root.iter():
        if tag(u) == "unit":
            scale = float(u.get("meter", 1.0))
            break

    all_v, all_f = [], []
    for geom in root.iter():
        if tag(geom) != "geometry":
            continue
        mesh = next((c for c in geom if tag(c) == "mesh"), None)
        if mesh is None:
            continue
        # id -> float data of each <source>
        sources = {}
        for src in mesh:
            if tag(src) != "source":
                continue
            fa = next((c for c in src.iter() if tag(c) == "float_array"), None)
            if fa is not None and fa.text:
                sources[src.get("id")] = np.fromstring(
                    fa.text, sep=" ", dtype=np.float32
                )
        # <vertices> indirection: its POSITION input names the real source
        vert_src = {}
        for vs in mesh:
            if tag(vs) == "vertices":
                for inp in vs:
                    if (
                        tag(inp) == "input"
                        and inp.get("semantic") == "POSITION"
                    ):
                        vert_src[vs.get("id")] = inp.get("source", "").lstrip(
                            "#"
                        )
        for prim in mesh:
            if tag(prim) not in ("triangles", "polylist"):
                continue
            v_off, v_src, stride = 0, None, 1
            for inp in prim:
                if tag(inp) != "input":
                    continue
                off = int(inp.get("offset", 0))
                stride = max(stride, off + 1)
                if inp.get("semantic") == "VERTEX":
                    v_off = off
                    v_src = inp.get("source", "").lstrip("#")
            p_el = next((c for c in prim if tag(c) == "p"), None)
            if p_el is None or not p_el.text or v_src is None:
                continue
            src_id = vert_src.get(v_src, v_src)
            pos = sources.get(src_id)
            if pos is None or len(pos) < 9:
                continue
            verts = pos.reshape(-1, 3) * scale
            idx = np.fromstring(p_el.text, sep=" ", dtype=np.int64)
            vidx = idx[v_off::stride]
            if tag(prim) == "polylist":
                vc_el = next(
                    (c for c in prim if tag(c) == "vcount"), None
                )
                vcount = (
                    np.fromstring(vc_el.text, sep=" ", dtype=np.int64)
                    if vc_el is not None and vc_el.text
                    else np.full(len(vidx) // 3, 3, np.int64)
                )
                faces = []
                k = 0
                for c in vcount:
                    for j in range(1, c - 1):  # fan-triangulate
                        faces.append((vidx[k], vidx[k + j], vidx[k + j + 1]))
                    k += c
                faces = np.asarray(faces, np.int64)
            else:
                faces = vidx.reshape(-1, 3)
            base = sum(len(v) for v in all_v)
            all_v.append(verts.astype(np.float32))
            all_f.append(faces + base)
    if not all_v:
        return None, None
    v = np.concatenate(all_v, 0)
    f = np.concatenate(all_f, 0) if all_f else None
    if f is not None and (len(f) == 0 or f.max() >= len(v)):
        f = None
    return v, (f.astype(np.int32) if f is not None else None)


def convex_hull_vertices(verts: np.ndarray, max_verts: int = 64) -> np.ndarray:
    """Convex hull vertex set, decimated to <= max_verts (farthest-point
    sampling). The hull narrowphase takes a fixed small vertex budget."""
    try:
        from scipy.spatial import ConvexHull

        hull = ConvexHull(verts)
        hv = verts[hull.vertices]
    except Exception:
        hv = verts
    if len(hv) <= max_verts:
        return hv.astype(np.float32)
    # farthest point sampling
    sel = [int(np.argmax(np.linalg.norm(hv - hv.mean(0), axis=1)))]
    d = np.linalg.norm(hv - hv[sel[0]], axis=1)
    for _ in range(max_verts - 1):
        i = int(np.argmax(d))
        sel.append(i)
        d = np.minimum(d, np.linalg.norm(hv - hv[i], axis=1))
    return hv[sel].astype(np.float32)
