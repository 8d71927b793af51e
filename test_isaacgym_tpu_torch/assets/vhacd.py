"""Convex decomposition at asset-load time.

Port of test_isaacgym_tpu/assets/vhacd.py (host numpy). The reference
delegates VHACD to PhysX cooking (its examples/convex_decomposition.py:
81-98). Here decomposition runs on the host through the repository's native
C++ tool (`native/vhacd_tool.cpp`, built as `native/build/vhacd_tool`), with
the hulls cached per mesh hash in this package's own cache directory under
the git-ignored `build/`, so a run never depends on runtime mesh cooking.

Unlike the JAX package, which keeps the mesh's single convex hull when the
tool is missing or fails, `decompose_mesh` raises with the tool's stderr: a
silent single hull hides the failure.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
from typing import List, Optional

import numpy as np

from .types import GEOM_MESH, AssetSpec

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
_CACHE_DIR = os.path.join(_ROOT, "build", "vhacd_cache")
_TOOL = os.path.join(_ROOT, "native", "build", "vhacd_tool")


def _mesh_hash(vertices: np.ndarray, params) -> str:
    h = hashlib.sha1(np.ascontiguousarray(vertices, np.float32).tobytes())
    h.update(
        f"{params.resolution}:{params.max_convex_hulls}:{params.max_num_vertices_per_ch}".encode()
    )
    return h.hexdigest()


def decompose_mesh(vertices: np.ndarray, faces: Optional[np.ndarray], params) -> List[np.ndarray]:
    """Returns a list of convex hull vertex arrays for one mesh. Raises
    RuntimeError if the tool is missing or fails."""
    os.makedirs(_CACHE_DIR, exist_ok=True)
    key = _mesh_hash(vertices, params)
    cache = os.path.join(_CACHE_DIR, key + ".npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return [z[k] for k in sorted(z.files)]
    if faces is None:
        faces = np.zeros((0, 3), np.int32)
    if not os.path.exists(_TOOL):
        raise RuntimeError(f"VHACD tool not built: {_TOOL} (native/build.sh builds it)")
    vin = os.path.join(_CACHE_DIR, key + ".in.npy")
    fin = os.path.join(_CACHE_DIR, key + ".faces.npy")
    np.save(vin, np.asarray(vertices, np.float32))
    np.save(fin, np.asarray(faces, np.int32))
    out = subprocess.run(
        [_TOOL, vin, fin, str(params.max_convex_hulls), str(params.max_num_vertices_per_ch),
         str(params.resolution), cache + ".raw"],
        capture_output=True,
        timeout=300,
    )
    if out.returncode != 0 or not os.path.exists(cache + ".raw"):
        raise RuntimeError(
            f"VHACD tool failed (exit {out.returncode}) on a mesh of {len(vertices)} vertices: "
            f"{out.stderr.decode(errors='replace').strip()}")
    hulls = _read_raw_hulls(cache + ".raw")
    # written aside, then renamed: a reader never sees half a cache file
    np.savez(cache + ".tmp.npz", **{f"h{i:03d}": h for i, h in enumerate(hulls)})
    os.replace(cache + ".tmp.npz", cache)
    return hulls


def _read_raw_hulls(path: str) -> List[np.ndarray]:
    """Tool output format: int32 num_hulls, then per hull int32 nverts +
    float32 verts*3."""
    hulls = []
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(4), np.int32)[0])
        for _ in range(n):
            nv = int(np.frombuffer(f.read(4), np.int32)[0])
            v = np.frombuffer(f.read(12 * nv), np.float32).reshape(nv, 3)
            hulls.append(v.copy())
    return hulls


def decompose_asset(asset: AssetSpec, params) -> None:
    """Replace each mesh geom's hull by its decomposition (in place).

    The importer pre-reduces mesh geoms to convex-hull vertices for the
    default single-hull path; decomposition reloads the RAW mesh (verts +
    faces) from disk so the splitter sees the true surface."""
    from .mesh import load_mesh

    for l in asset.links:
        new_geoms = []
        for g in l.geoms:
            if g.kind != GEOM_MESH:
                new_geoms.append(g)
                continue
            verts, faces = (g.vertices, g.faces)
            if g.mesh_path and os.path.exists(g.mesh_path):
                rv, rf = load_mesh(g.mesh_path)
                if rv is not None and len(rv):
                    scale = getattr(g, "mesh_scale", None)
                    verts, faces = rv, rf
                    if scale is not None:
                        verts = verts * np.asarray(scale, np.float32)
            if verts is None or not len(verts):
                new_geoms.append(g)
                continue
            for hv in decompose_mesh(verts, faces, params):
                new_geoms.append(dataclasses.replace(g, vertices=hv, faces=None))
        l.geoms = new_geoms
