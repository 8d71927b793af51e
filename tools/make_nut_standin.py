#!/usr/bin/env python3
"""Write the code-built stand-in of the reference's M4 nut at 5x scale.

    python tools/make_nut_standin.py [ROOT]

The reference's nut_m4_tight OBJ is not in the repository. This writes a
closed, threaded hex-nut triangle mesh and its URDF under ROOT (default:
test_isaacgym_tpu_torch/assets/data/nut_standin), laid out as the
reference's assets are, so `load_urdf(ROOT,
"urdf/nut_bolt/nut_m4_tight_SI_5x.urdf")` loads it:

  * 0.035 m across flats and 0.016 m high (the nut constants of the
    reference's franka_nut_bolt_ik_osc.py, at 5x), flats facing +-x;
  * a right-hand internal thread with the parameters measured off the real
    nut (pitch 0.7 mm, minor radius 1.62 mm, major radius 2.08 mm, at 5x):
    radius clip(major - slope * du, minor, major), du the distance of the
    helical phase z - pitch * theta / 2pi from the groove, with the flank
    slope of the procedural bolt (assets/sdf.py::BoltSpec), so the flanks
    of nut and bolt run parallel 0.65 mm apart radially;
  * the mesh centred on the URDF origin, so a scan for the mating height in
    the mesh's centred frame places the actor as well;
  * `<sdf resolution="256"/>` in the collision element, as the reference's
    nut-bolt URDFs ask for SDF collision.

The output is numpy-only and deterministic: running this again rewrites
the same bytes.
"""
from __future__ import annotations

import os
import sys

import numpy as np

SCALE = 5.0
ACROSS_FLATS = 0.035
HEIGHT = 0.016
PITCH = 0.7e-3 * SCALE
MINOR_R = 1.62e-3 * SCALE  # the thread's crest (innermost radius)
MAJOR_R = 2.08e-3 * SCALE  # the groove's root
# the procedural bolt's flank slope, (major - minor) / (pitch / 4)
SLOPE = (1.95e-3 - 1.50e-3) / (0.25 * 0.7e-3)
N_THETA = 36  # angular samples of the thread (10 deg; 30 + 60k lie on them)
N_Z = 121  # rings along the height (0.133 mm apart)
URDF = "urdf/nut_bolt/nut_m4_tight_SI_5x.urdf"
OBJ = "nut_m4_tight_SI_5x.obj"


def nut_radius(z, theta):
    """Radius of the internal thread surface at height z and angle theta."""
    u = np.mod(z - PITCH * theta / (2 * np.pi), PITCH)
    du = np.minimum(u, PITCH - u)  # distance to the groove's phase
    return np.clip(MAJOR_R - SLOPE * du, MINOR_R, MAJOR_R)


def nut_mesh():
    """(vertices (V, 3) float64, faces (F, 3) int) of the closed nut, every
    face wound with its normal out of the solid."""
    th = 2 * np.pi * np.arange(N_THETA) / N_THETA
    zz = np.linspace(-HEIGHT / 2, HEIGHT / 2, N_Z)
    T, Z = np.meshgrid(th, zz)  # (N_Z, N_THETA)
    R = nut_radius(Z, T)
    tube = np.stack([R * np.cos(T), R * np.sin(T), Z], -1).reshape(-1, 3)
    corner_r = ACROSS_FLATS / 2 / np.cos(np.pi / 6)
    phi = np.pi / 6 + np.pi / 3 * np.arange(6)  # corners at 30 + 60k deg
    ring = np.stack([corner_r * np.cos(phi), corner_r * np.sin(phi)], -1)
    hexv = np.concatenate([np.c_[ring, np.full(6, -HEIGHT / 2)],
                           np.c_[ring, np.full(6, HEIGHT / 2)]])
    verts = np.concatenate([tube, hexv])
    bot_c, top_c = len(tube), len(tube) + 6

    def v(i, j):
        return i * N_THETA + j % N_THETA

    faces = []
    # the threaded bore: normals toward the axis
    for i in range(N_Z - 1):
        for j in range(N_THETA):
            faces.append((v(i, j), v(i + 1, j), v(i, j + 1)))
            faces.append((v(i, j + 1), v(i + 1, j), v(i + 1, j + 1)))
    # the hex sides: normals outward
    for k in range(6):
        k1 = (k + 1) % 6
        faces.append((bot_c + k, bot_c + k1, top_c + k))
        faces.append((bot_c + k1, top_c + k1, top_c + k))
    # the end caps: each bore segment fans to the hex corner nearest its
    # middle; where that corner changes, a triangle joins the two corners
    step = 2 * np.pi / N_THETA

    def owner(j):
        mid = (j + 0.5) * step
        return int(np.round((mid - np.pi / 6) / (np.pi / 3))) % 6

    for ring_i, c0, up in ((0, bot_c, False), (N_Z - 1, top_c, True)):
        for j in range(N_THETA):
            a, b, c = v(ring_i, j), v(ring_i, j + 1), c0 + owner(j)
            faces.append((a, c, b) if up else (a, b, c))
            prev = owner(j - 1)
            if prev != owner(j):
                ca, cb = c0 + prev, c0 + owner(j)
                faces.append((a, ca, cb) if up else (a, cb, ca))
    return verts, np.asarray(faces, np.int64)


def urdf_text():
    return f"""<?xml version="1.0"?>
<robot name="nut_m4_tight_SI_5x">
  <link name="nut">
    <visual>
      <geometry>
        <mesh filename="{OBJ}" scale="1 1 1"/>
      </geometry>
    </visual>
    <collision>
      <geometry>
        <mesh filename="{OBJ}" scale="1 1 1"/>
      </geometry>
      <sdf resolution="256"/>
    </collision>
  </link>
</robot>
"""


def write(root):
    d = os.path.join(root, os.path.dirname(URDF))
    os.makedirs(d, exist_ok=True)
    verts, faces = nut_mesh()
    lines = ["# code-built stand-in of the M4 nut at 5x (tools/make_nut_standin.py)"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces]
    with open(os.path.join(d, OBJ), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, URDF), "w") as f:
        f.write(urdf_text())
    return len(verts), len(faces)


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    root = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        here, "test_isaacgym_tpu_torch", "assets", "data", "nut_standin")
    nv, nf = write(root)
    print(f"wrote {os.path.join(root, URDF)}: {nv} vertices, {nf} faces")
