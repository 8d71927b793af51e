"""Surface probe sampling for mesh assets.

Part of test_isaacgym_tpu/assets/sdf.py (host numpy, the same code): only
`farthest_point_sample`, which `create_mesh_asset` calls. The voxel and
analytic SDF grids, the procedural bolt and the K_PT_SDF narrowphase that
reads them are a later slice of the port (ROADMAP.md Queue 1, item 10: SDF
contact and nut-bolt).
"""
from __future__ import annotations

import numpy as np


def farthest_point_sample(verts: np.ndarray, n: int) -> np.ndarray:
    """Greedy FPS: n well-spread surface sample points (contact probes)."""
    v = np.asarray(verts, np.float32)
    if len(v) <= n:
        reps = int(np.ceil(n / max(len(v), 1)))
        return np.tile(v, (reps, 1))[:n]
    out = np.empty((n, 3), np.float32)
    out[0] = v[0]
    d = np.linalg.norm(v - out[0], axis=1)
    for i in range(1, n):
        j = int(np.argmax(d))
        out[i] = v[j]
        d = np.minimum(d, np.linalg.norm(v - v[j], axis=1))
    return out
