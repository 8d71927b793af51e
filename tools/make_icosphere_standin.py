#!/usr/bin/env python3
"""Write the code-built stand-in of the reference's icosphere soft body.

    python tools/make_icosphere_standin.py [ROOT]

The reference's icosphere.urdf and icosphere.tet are not in the repository.
This writes both under ROOT (default:
test_isaacgym_tpu_torch/assets/data/icosphere_standin), laid out as the
reference's assets are, so `load_urdf(ROOT, "urdf/icosphere.urdf")` loads
it:

  * icosphere.tet in the reference's format (`v x y z`, `t i j k l`, 0-based):
    a unit ball whose surface is the subdivision-2 icosphere (162 vertices,
    320 triangles, as the reference's), tetrahedralized by
    scipy.spatial.Delaunay over the surface, two interior shells (the
    directions of the icosahedron's 20 face centres at radius 0.65, its 12
    corners at 0.3) and the centre, every tet wound to a positive volume;
  * icosphere.urdf: a fixed base, the prismatic `rail` along y driving a
    2 x 2 m press plate of half-thickness 0.25 centred 1.0 above the rail's
    zero, and the `<fem>` link at origin (0, -0.5, 0) with Young's 1e5 and
    Poisson 0.45 (the values examples/soft_body.py and tests/test_soft.py
    read off the reference's file); the rail has no `<limit effort>`.

The script checks that the boundary faces are exactly the icosphere's 320
triangles and that no tet is a sliver, and prints the tet count, the
smallest tet volume over the mean and the largest vertex valence. The output
is deterministic: running this again rewrites the same bytes.
"""
from __future__ import annotations

import os
import sys

import numpy as np

URDF = "urdf/icosphere.urdf"
TET = "urdf/icosphere.tet"
SURFACE_SUBDIVISIONS = 2
# radii of the interior shells: the icosahedron's face-centre directions,
# then its corners; then the centre
FACE_SHELL, CORNER_SHELL = 0.65, 0.3
# a tet's volume over that of the regular tet of its rms edge length: 1 for
# a regular tet, near 0 for a sliver
MIN_QUALITY = 0.3

_ICO_F = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9), (5, 11, 4),
          (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8),
          (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]


def icosphere(subdivisions):
    """(vertices (V, 3) on the unit sphere, faces (F, 3) wound outward) of
    the icosahedron with each face split in four `subdivisions` times, the
    new vertices pushed out to the sphere."""
    t = (1 + 5 ** 0.5) / 2
    # the icosahedron's 12 corners: cyclic permutations of (0, +-1, +-t)
    base = np.array([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t), (0, 1, t),
                     (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
                    np.float64)
    verts = list(base / np.linalg.norm(base, axis=1, keepdims=True))
    faces = list(_ICO_F)
    for _ in range(subdivisions):
        mids = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mids[key] = len(verts) - 1
            return mids[key]

        split = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    return np.asarray(verts), np.asarray(faces, np.int64)


def tet_mesh():
    """(vertices (V, 3) float64, tets (T, 4) int, surface faces (320, 3))
    of the stand-in ball; the first 162 vertices are the surface's."""
    from scipy.spatial import Delaunay

    surf, faces = icosphere(SURFACE_SUBDIVISIONS)
    corners, tris = icosphere(0)
    centres = corners[tris].mean(1)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    verts = np.concatenate([surf, centres * FACE_SHELL, corners * CORNER_SHELL, np.zeros((1, 3))])
    tets = np.asarray(Delaunay(verts).simplices, np.int64)
    tets = tets[np.lexsort(tets.T[::-1])]  # rows in order, for stable output
    neg = tet_volumes(verts, tets) < 0
    tets[neg] = tets[neg][:, [0, 2, 1, 3]]
    return verts, tets, faces


def tet_volumes(verts, tets):
    a, b, c, d = (verts[tets[:, k]] for k in range(4))
    return np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a) / 6.0


def quality(verts, tets):
    """Each tet's volume over that of the regular tet of its rms edge."""
    p = verts[tets]
    edges = np.stack([p[:, j] - p[:, i] for i in range(4) for j in range(i + 1, 4)], 1)
    rms = np.sqrt((edges ** 2).sum(-1).mean(1))
    return np.abs(tet_volumes(verts, tets)) / (rms ** 3 / (6 * np.sqrt(2)))


def boundary_faces(tets):
    """Sorted vertex triples of the faces that lie in exactly one tet."""
    count = {}
    for tet in tets:
        for skip in range(4):
            key = tuple(sorted(int(v) for k, v in enumerate(tet) if k != skip))
            count[key] = count.get(key, 0) + 1
    return sorted(k for k, n in count.items() if n == 1)


def check(verts, tets, faces):
    """Raise unless the boundary is the icosphere's triangles and no tet is
    a sliver; return (tets, smallest volume / mean, largest valence)."""
    if boundary_faces(tets) != sorted(tuple(sorted(int(v) for v in f)) for f in faces):
        raise ValueError("the tet mesh's boundary is not the icosphere surface")
    vol = tet_volumes(verts, tets)
    if (vol <= 0).any() or quality(verts, tets).min() < MIN_QUALITY:
        raise ValueError("the tet mesh has a sliver")
    return len(tets), float(vol.min() / vol.mean()), int(np.bincount(tets.ravel()).max())


def urdf_text():
    return f"""<?xml version="1.0"?>
<!-- code-built stand-in of the reference's icosphere.urdf
     (tools/make_icosphere_standin.py). Values marked PLAUSIBLE are not
     fixed by anything in this repository. -->
<robot name="icosphere">
  <link name="base">
    <inertial>
      <mass value="1.0"/>
      <inertia ixx="0.01" ixy="0" ixz="0" iyy="0.01" iyz="0" izz="0.01"/>
    </inertial>
  </link>
  <!-- the press rail; limits and velocity PLAUSIBLE, no effort limit -->
  <joint name="rail" type="prismatic">
    <parent link="base"/>
    <child link="press"/>
    <axis xyz="0 1 0"/>
    <limit lower="-1.5" upper="0.5" velocity="1.0"/>
  </joint>
  <link name="press">
    <visual>
      <origin xyz="0 1.0 0"/>
      <geometry>
        <box size="2 0.5 2"/>
      </geometry>
    </visual>
    <collision>
      <origin xyz="0 1.0 0"/>
      <geometry>
        <box size="2 0.5 2"/>
      </geometry>
    </collision>
  </link>
  <joint name="fem_mount" type="fixed">
    <parent link="base"/>
    <child link="fem"/>
  </joint>
  <link name="fem">
    <fem>
      <origin xyz="0 -0.5 0" rpy="0 0 0"/>
      <!-- density and damping PLAUSIBLE -->
      <density value="1000"/>
      <youngs value="1e5"/>
      <poissons value="0.45"/>
      <damping value="0.0"/>
      <attachDistance value="0.0"/>
      <tetmesh filename="{os.path.basename(TET)}"/>
    </fem>
  </link>
</robot>
"""


def write(root):
    """Write the .tet and the URDF under root; return check()'s numbers."""
    verts, tets, faces = tet_mesh()
    os.makedirs(os.path.join(root, os.path.dirname(URDF)), exist_ok=True)
    lines = ["# code-built stand-in of the reference's icosphere.tet "
             "(tools/make_icosphere_standin.py)"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"t {a} {b} {c} {d}" for a, b, c, d in tets]
    with open(os.path.join(root, TET), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, URDF), "w") as f:
        f.write(urdf_text())
    # check what a reader gets: the vertices rounded as written
    written = np.array([[float(x) for x in l.split()[1:]] for l in lines if l[0] == "v"])
    return check(written, tets, faces)


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        here, "test_isaacgym_tpu_torch", "assets", "data", "icosphere_standin")
    n, vmin, valence = write(root)
    print(f"wrote {os.path.join(root, URDF)}: {n} tets, smallest volume / mean "
          f"{vmin:.4f}, largest vertex valence {valence}")
