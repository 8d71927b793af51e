"""Host-side visual-mesh preparation for the ray-cast renderer.

Port of test_isaacgym_tpu/render/meshtools.py (host numpy, copied). The
reference renders real visual triangle meshes with optional smooth
per-vertex normals (`mesh_normal_mode=COMPUTE_PER_VERTEX`, the reference's
examples/graphics_materials.py:30, kuka_bin.py:111). The renderer keeps the
per-ray triangle loop dense and bounds its size offline: every visual mesh
is decimated to a fixed triangle budget by vertex clustering, per-vertex
normals are computed on the full-resolution mesh first and carried through,
and the table of (tri, corner-normal) rows is built once on the host. The
convex-hull raycast remains the cheap LOD for culled/large scenes
(render/raster.py)."""
from __future__ import annotations

import numpy as np


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted smooth per-vertex normals (COMPUTE_PER_VERTEX)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.clip(ln, 1e-12, None)).astype(np.float32)


def decimate(
    verts: np.ndarray,
    faces: np.ndarray,
    target_tris: int,
    normals: np.ndarray | None = None,
):
    """Vertex-clustering decimation to <= target_tris triangles.

    Deterministic: clusters on a uniform grid whose resolution is bisected
    until the face budget holds. Returns (verts', faces', normals') where
    normals' are the cluster-averaged smooth normals of the input mesh
    (computed here if not given)."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    if normals is None:
        normals = vertex_normals(v, f)
    if len(f) <= target_tris:
        return v, f.astype(np.int32), np.asarray(normals, np.float32)

    lo, hi = v.min(0), v.max(0)
    ext = np.maximum(hi - lo, 1e-9)

    def cluster(res: int):
        cell = np.clip(((v - lo) / ext * res).astype(np.int64), 0, res - 1)
        cid = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, inv = np.unique(cid, return_inverse=True)
        nv = np.zeros((len(uniq), 3), np.float64)
        nn = np.zeros((len(uniq), 3), np.float64)
        cnt = np.zeros(len(uniq), np.float64)
        np.add.at(nv, inv, v)
        np.add.at(nn, inv, normals)
        np.add.at(cnt, inv, 1.0)
        nv /= cnt[:, None]
        ln = np.linalg.norm(nn, axis=-1, keepdims=True)
        nn = nn / np.clip(ln, 1e-12, None)
        nf = inv[f]
        keep = (
            (nf[:, 0] != nf[:, 1])
            & (nf[:, 1] != nf[:, 2])
            & (nf[:, 0] != nf[:, 2])
        )
        nf = nf[keep]
        # dedupe faces that collapsed onto each other (sorted-key dedupe
        # merges opposite windings of degenerate thin sheets too — fine,
        # the renderer shades double-sided)
        key = np.sort(nf, 1)
        _, first = np.unique(key, axis=0, return_index=True)
        nf = nf[np.sort(first)]
        return nv.astype(np.float32), nf.astype(np.int32), nn.astype(
            np.float32
        )

    lo_res, hi_res = 1, 64
    best = cluster(lo_res)
    # largest grid resolution whose decimation fits the budget
    while lo_res < hi_res:
        mid = (lo_res + hi_res + 1) // 2
        cand = cluster(mid)
        if len(cand[1]) <= target_tris:
            best, lo_res = cand, mid
        else:
            hi_res = mid - 1
    return best


def triangle_table(verts, faces, normals, smooth: bool):
    """Flatten to per-corner arrays: tri_v (T, 3, 3), tri_n (T, 3, 3).
    smooth=False uses flat face normals (FROM_ASSET fallback semantics)."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    tv = v[f]  # (T, 3, 3)
    if smooth:
        tn = np.asarray(normals, np.float32)[f]
    else:
        fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        ln = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.clip(ln, 1e-12, None)
        tn = np.repeat(fn[:, None, :], 3, 1)
    return tv, tn.astype(np.float32)
